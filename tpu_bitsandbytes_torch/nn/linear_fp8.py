"""LinearFP8: the FP8 E4M3 linear layer: uint8 E4M3 bits and an f32
scale per row; ``forward`` is :func:`~..functional.matmul_fp8_e4m3`."""

from __future__ import annotations

import torch

from ..functional import (dequantize_fp8_e4m3, matmul_fp8_e4m3,
                          quantize_fp8_e4m3, to_tensor)
from .base import Module, compute_dtype_of, full_precision


class LinearFP8(Module):
    QUANTIZED_KEYS = ("weight_fp8", "weight_scales")

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.compute_dtype = compute_dtype
        self.register_buffer("weight_fp8", torch.zeros(
            (out_features, in_features), dtype=torch.uint8, device=device))
        self.register_buffer("weight_scales", torch.ones(
            (out_features,), dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            (out_features,), dtype=compute_dtype, device=device)
            if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.in_features) if x.dim() > 2 else x
        out = matmul_fp8_e4m3(x2, self.weight_fp8, self.weight_scales,
                              self.bias, self.compute_dtype)
        return out.reshape(*lead, self.out_features) if x.dim() > 2 else out

    @classmethod
    def from_linear(cls, linear, device=None, compute_dtype=None
                    ) -> "LinearFP8":
        """Quantize a Linear-like module, on ``device`` or where its
        weight lies."""
        weight = to_tensor(linear.weight).detach()
        device = weight.device if device is None else device
        bias = getattr(linear, "bias", None)
        if compute_dtype is None:
            compute_dtype = compute_dtype_of(weight)
        layer = cls(weight.shape[1], weight.shape[0], bias=bias is not None,
                    device=device, compute_dtype=compute_dtype)
        layer.weight_fp8, layer.weight_scales = quantize_fp8_e4m3(
            weight.to(device))
        if bias is not None:
            layer.bias = to_tensor(bias).detach().to(device, compute_dtype)
        return layer

    def dequantize(self) -> torch.Tensor:
        return dequantize_fp8_e4m3(self.weight_fp8, self.weight_scales,
                                   self.compute_dtype)

    def load(self, state_dict: dict, prefix: str) -> None:
        dev = self.weight_fp8.device
        w_key = prefix + "weight"
        if w_key in state_dict:
            self.weight_fp8, self.weight_scales = quantize_fp8_e4m3(
                full_precision("LinearFP8", w_key,
                               to_tensor(state_dict[w_key], dev)))
        if prefix + "weight_fp8" in state_dict:
            self.weight_fp8 = to_tensor(state_dict[prefix + "weight_fp8"],
                                        dev, torch.uint8)
        if prefix + "weight_scales" in state_dict:
            self.weight_scales = to_tensor(
                state_dict[prefix + "weight_scales"], dev, torch.float32)
        b_key = prefix + "bias"
        if b_key in state_dict and self.bias is not None:
            self.bias = to_tensor(state_dict[b_key], dev, self.compute_dtype)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}, quant_type=fp8_e4m3")
