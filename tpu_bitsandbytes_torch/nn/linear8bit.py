"""Linear8bit: the row-wise int8 linear layer.

``forward`` is the JAX package's weight-only int8 product: the int8
weight widened to the compute dtype, an f32 product, the row scale / 127
on the output, cast once, then the bias (the activations are not
quantized; that is :class:`~.OutlierAwareLinear`'s). JAX leaves it to an
XLA fusion, so it is plain torch. ``use_cache`` keeps the dequantized
weight and multiplies by it instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..functional import (dequantize_rowwise, div_exact, quantize_rowwise,
                          to_tensor)
from .base import Module, compute_dtype_of, full_precision


class Linear8bit(Module):
    QUANTIZED_KEYS = ("weight_int8", "weight_scales")

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None, use_cache: bool = False,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.use_cache = bool(use_cache)
        self.compute_dtype = compute_dtype
        self.register_buffer("weight_int8", torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("weight_scales", torch.ones(
            (out_features,), dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            (out_features,), dtype=compute_dtype, device=device)
            if bias else None)
        self._weight_cache: Optional[torch.Tensor] = None

    def _get_weight(self) -> torch.Tensor:
        if self.use_cache and self._weight_cache is not None:
            return self._weight_cache
        weight = self.dequantize()
        if self.use_cache:
            self._weight_cache = weight
        return weight

    def clear_cache(self) -> None:
        self._weight_cache = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.dot import dot_f32
        if self.use_cache:
            weight = self._get_weight()
            out = x.to(weight.dtype) @ weight.t()
            return out if self.bias is None else out + self.bias
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).to(self.compute_dtype)
        out = dot_f32(x2, self.weight_int8)
        out = (out * div_exact(self.weight_scales, 127.0)[None, :]).to(
            self.compute_dtype).reshape(*lead, -1)
        return out if self.bias is None else out + self.bias

    def _quantize(self, w: torch.Tensor) -> None:
        w_int8, w_scales = quantize_rowwise(w)
        self.weight_int8, self.weight_scales = w_int8, w_scales
        self.clear_cache()

    @classmethod
    def from_linear(cls, linear, device=None, use_cache: bool = False,
                    compute_dtype=None) -> "Linear8bit":
        """Quantize a Linear-like module, on ``device`` or where its
        weight lies."""
        weight = to_tensor(linear.weight).detach()
        device = weight.device if device is None else device
        bias = getattr(linear, "bias", None)
        if compute_dtype is None:
            compute_dtype = compute_dtype_of(weight)
        layer = cls(weight.shape[1], weight.shape[0], bias=bias is not None,
                    device=device, use_cache=use_cache,
                    compute_dtype=compute_dtype)
        layer._quantize(weight.to(device))
        if bias is not None:
            layer.bias = to_tensor(bias).detach().to(device, compute_dtype)
        return layer

    def dequantize(self) -> torch.Tensor:
        return dequantize_rowwise(self.weight_int8, self.weight_scales,
                                  dtype=self.compute_dtype)

    def load(self, state_dict: dict, prefix: str) -> None:
        dev = self.weight_int8.device
        w_key = prefix + "weight"
        if w_key in state_dict:
            self._quantize(full_precision(
                "Linear8bit", w_key, to_tensor(state_dict[w_key], dev)))
        if prefix + "weight_int8" in state_dict:
            self.weight_int8 = to_tensor(state_dict[prefix + "weight_int8"],
                                         dev, torch.int8)
            self.clear_cache()
        if prefix + "weight_scales" in state_dict:
            self.weight_scales = to_tensor(
                state_dict[prefix + "weight_scales"], dev, torch.float32)
            self.clear_cache()
        b_key = prefix + "bias"
        if b_key in state_dict and self.bias is not None:
            self.bias = to_tensor(state_dict[b_key], dev, self.compute_dtype)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")
