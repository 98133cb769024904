"""Linear4bit: the NF4/FP4 quantized linear layer.

The packed flat uint8 weight and its :class:`QuantState`; ``forward`` is
:func:`~..functional.matmul_4bit`, so on a card it runs kernel K5 up to
M = 256 rows and the dequantized weight's product above that, as the JAX
package does. Checkpoints keep the JAX keys (``weight``, ``bias``,
``weight_quant_state`` as :meth:`QuantState.as_dict`); a full-precision
``weight`` is requantized on load, and a blocksize or quant_type that
differs from the layer's is taken from the checkpoint with a warning.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..functional import (QuantState, _pad_k, dequantize_4bit, matmul_4bit,
                          quantize_4bit, to_tensor)
from .base import FLOAT_DTYPES, Module, compute_dtype_of


class Linear4bit(Module):
    """4-bit quantized linear layer: ``weight`` is the packed flat uint8
    of :func:`quantize_4bit` of [out_features, in_features], and
    ``weight_quant_state`` its absmax (double-quantized with
    ``compress_statistics``), blocksize and dtype."""

    QUANTIZED_KEYS = ("weight", "weight_quant_state")

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None,
                 compute_dtype=torch.bfloat16, quant_type: str = "nf4",
                 blocksize: int = 64, compress_statistics: bool = False):
        super().__init__()
        if quant_type not in ("nf4", "fp4"):
            raise ValueError(
                f"quant_type must be 'nf4' or 'fp4', got {quant_type}")
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.compute_dtype = compute_dtype
        self.quant_type = quant_type
        self.blocksize = int(blocksize)
        self.compress_statistics = bool(compress_statistics)
        packed = out_features * _pad_k(in_features, blocksize) // 2
        self.register_buffer("weight", torch.zeros(
            (packed,), dtype=torch.uint8, device=device))
        self.register_buffer("bias", torch.zeros(
            (out_features,), dtype=compute_dtype, device=device)
            if bias else None)
        self.weight_quant_state: Optional[QuantState] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight_quant_state is None:
            raise RuntimeError("Weight not quantized. Call from_linear() or "
                               "load weights first.")
        return matmul_4bit(x, self.weight, self.weight_quant_state,
                           self.bias, compute_dtype=self.compute_dtype)

    def _quantize(self, w: torch.Tensor) -> None:
        packed, state = quantize_4bit(
            w.to(self.weight.device), blocksize=self.blocksize,
            compress_statistics=self.compress_statistics,
            quant_type=self.quant_type)
        self.weight, self.weight_quant_state = packed, state

    @classmethod
    def from_linear(cls, linear, device=None, compute_dtype=None,
                    quant_type: str = "nf4", blocksize: int = 64,
                    compress_statistics: bool = False) -> "Linear4bit":
        """Quantize a Linear-like module (``.weight`` [N, K], optional
        ``.bias``), on ``device`` or where its weight lies."""
        weight = to_tensor(linear.weight).detach()
        bias = getattr(linear, "bias", None)
        device = weight.device if device is None else device
        if compute_dtype is None:
            compute_dtype = compute_dtype_of(weight)
        n, k = weight.shape
        layer = cls(k, n, bias=bias is not None, device=device,
                    compute_dtype=compute_dtype, quant_type=quant_type,
                    blocksize=blocksize,
                    compress_statistics=compress_statistics)
        layer._quantize(weight)
        if bias is not None:
            layer.bias = to_tensor(bias).detach().to(device, compute_dtype)
        return layer

    @classmethod
    def from_arrays(cls, weight, bias=None, **kwargs) -> "Linear4bit":
        """Quantize a raw weight [N, K] (and bias)."""
        src = torch.nn.Module()
        src.weight, src.bias = to_tensor(weight), (
            None if bias is None else to_tensor(bias))
        return cls.from_linear(src, **kwargs)

    def dequantize(self) -> torch.Tensor:
        """The weight [out_features, in_features] in the state's dtype."""
        if self.weight_quant_state is None:
            raise RuntimeError("Weight not quantized")
        return dequantize_4bit(self.weight, self.weight_quant_state)

    @property
    def quant_state(self) -> Optional[QuantState]:
        return self.weight_quant_state

    def extra_tensors(self):
        st = self.weight_quant_state
        while st is not None:
            yield st.absmax
            st = st.state2

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        if self.weight_quant_state is not None:
            self.weight_quant_state = self.weight_quant_state.to(
                self.weight.device)
        return self

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        if self.weight_quant_state is not None:
            destination[prefix + "weight_quant_state"] = (
                self.weight_quant_state.as_dict())

    def load(self, state_dict: dict, prefix: str) -> None:
        dev = self.weight.device
        qs_key = prefix + "weight_quant_state"
        if qs_key in state_dict:
            loaded = state_dict[qs_key]
            loaded_bs = loaded.get("blocksize", 64)
            if loaded_bs != self.blocksize:
                warnings.warn(
                    f"Linear4bit blocksize mismatch: layer has blocksize="
                    f"{self.blocksize}, checkpoint has blocksize={loaded_bs}. "
                    f"Using checkpoint blocksize.", UserWarning)
                self.blocksize = loaded_bs
            loaded_qt = loaded.get("quant_type", "nf4")
            if loaded_qt != self.quant_type:
                warnings.warn(
                    f"Linear4bit quant_type mismatch: layer has quant_type="
                    f"'{self.quant_type}', checkpoint has quant_type="
                    f"'{loaded_qt}'. Using checkpoint quant_type.",
                    UserWarning)
                self.quant_type = loaded_qt
            self.weight_quant_state = QuantState.from_dict(loaded, dev)
        w_key = prefix + "weight"
        if w_key in state_dict:
            w = to_tensor(state_dict[w_key], dev)
            if w.dtype in FLOAT_DTYPES:
                self._quantize(w)       # a full-precision checkpoint
            else:
                self.weight = w.to(torch.uint8).reshape(-1)
        b_key = prefix + "bias"
        if b_key in state_dict and self.bias is not None:
            self.bias = to_tensor(state_dict[b_key], dev, self.compute_dtype)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}, quant_type={self.quant_type}, "
                f"blocksize={self.blocksize}")


class Params4bit:
    """A packed tensor that reports the logical (unpacked) shape of its
    quant state: bitsandbytes' tensor subclass, as the JAX package's shim
    for HF-style integrations."""

    def __init__(self, data: Optional[torch.Tensor] = None,
                 requires_grad: bool = False,
                 quant_state: Optional[QuantState] = None):
        self.data = (data if data is not None
                     else torch.zeros((0,), dtype=torch.uint8))
        self.requires_grad = requires_grad
        self.quant_state = quant_state

    @property
    def shape(self):
        if self.quant_state is not None:
            if isinstance(self.quant_state, QuantState):
                return tuple(self.quant_state.shape)
            return tuple(self.quant_state.get("shape", self.data.shape))
        return tuple(self.data.shape)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.data.detach().cpu().numpy(), dtype=dtype)
