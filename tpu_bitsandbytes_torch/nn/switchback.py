"""SwitchBackLinear: int8 forward, full-precision backward.

:func:`switchback_matmul` is a ``torch.autograd.Function`` (the JAX
package's ``custom_vjp``): the forward multiplies by the dequantized int8
weight, the backward gives ``dx = g @ W_fp`` against the trainable master
weight ``weight_fp``, ``dW_fp = g.T @ x`` and the bias gradient, as a
dense linear layer with the master weight would; the int8 weight takes
none. ``sync_weights`` requantizes the int8 copy from the
master after an optimizer step.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..functional import dequantize_rowwise, quantize_rowwise, to_tensor
from .base import FLOAT_DTYPES, Module, compute_dtype_of


class _SwitchBack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_q, w_fp, bias):
        ctx.save_for_backward(x, w_fp)
        ctx.has_bias = bias is not None
        out = x @ w_q.t()
        return out if bias is None else out + bias

    @staticmethod
    def backward(ctx, g):
        x, w_fp = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        # the products a dense linear's backward takes (mm's: g @ W, and
        # (x.T @ g).T), so the gradients equal that layer's bit for bit
        dx = (g2 @ w_fp.to(g2.dtype)).reshape(x.shape).to(x.dtype)
        dw_fp = (x2.to(g2.dtype).t() @ g2).t().to(w_fp.dtype)
        db = g2.sum(dim=0) if ctx.has_bias else None
        return dx, None, dw_fp, db


def switchback_matmul(x: torch.Tensor, w_q: torch.Tensor,
                      w_fp: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ w_q.T + bias`` forward; backward against ``w_fp``."""
    return _SwitchBack.apply(x, w_q, w_fp, bias)


class SwitchBackLinear(Module):
    """An int8-forward, fp-backward linear layer for training: the int8
    buffers (forward) beside the master weight ``weight_fp`` and ``bias``,
    both ``torch.nn.Parameter``s (backward and optimizer)."""

    QUANTIZED_KEYS = ("weight_fp", "weight_int8", "weight_scales")

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, compute_dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.compute_dtype = compute_dtype
        self.register_buffer("weight_int8", torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("weight_scales", torch.ones(
            (out_features,), dtype=torch.float32, device=device))
        self.weight_fp = torch.nn.Parameter(torch.zeros(
            (out_features, in_features), dtype=compute_dtype, device=device))
        self.bias = (torch.nn.Parameter(torch.zeros(
            (out_features,), dtype=compute_dtype, device=device))
            if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        w_q = dequantize_rowwise(self.weight_int8, self.weight_scales,
                                 dtype=self.compute_dtype).detach()
        out = switchback_matmul(x.reshape(-1, self.in_features), w_q,
                                self.weight_fp, self.bias)
        return out.reshape(*x.shape[:-1], self.out_features)

    @torch.no_grad()
    def sync_weights(self) -> None:
        """Requantize the int8 forward weight from the master."""
        self.weight_int8, self.weight_scales = quantize_rowwise(
            self.weight_fp)

    _update_int8_weights = sync_weights

    @classmethod
    def from_linear(cls, linear, device=None) -> "SwitchBackLinear":
        """Convert a Linear-like module, on ``device`` or where its weight
        lies; the int8 weight comes from the master weight as cast."""
        weight = to_tensor(linear.weight).detach()
        device = weight.device if device is None else device
        bias = getattr(linear, "bias", None)
        dtype = compute_dtype_of(weight)
        layer = cls(weight.shape[1], weight.shape[0], bias=bias is not None,
                    compute_dtype=dtype, device=device)
        with torch.no_grad():
            layer.weight_fp.copy_(weight)
            if bias is not None:
                layer.bias.copy_(to_tensor(bias).detach())
        layer.sync_weights()
        return layer

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        # the master weight first, as the JAX package orders its keys
        d = {}
        super()._save_to_state_dict(d, prefix, keep_vars)
        for key in ("weight_fp", "weight_int8", "weight_scales", "bias"):
            if prefix + key in d:
                destination[prefix + key] = d[prefix + key]

    def load(self, state_dict: dict, prefix: str) -> None:
        dev = self.weight_int8.device
        w_key, fp_key = prefix + "weight", prefix + "weight_fp"
        if w_key in state_dict:
            w = to_tensor(state_dict[w_key], dev)
            if w.dtype not in FLOAT_DTYPES:
                raise ValueError(
                    f"SwitchBackLinear: '{w_key}' must be full-precision "
                    f"to load as the master weight, got {w.dtype}")
            self.weight_fp.data = w.to(self.compute_dtype)
            self.sync_weights()
        if fp_key in state_dict:
            self.weight_fp.data = to_tensor(state_dict[fp_key], dev,
                                            self.compute_dtype)
            if prefix + "weight_int8" not in state_dict:
                self.sync_weights()
        if prefix + "weight_int8" in state_dict:
            self.weight_int8 = to_tensor(state_dict[prefix + "weight_int8"],
                                         dev, torch.int8)
        if prefix + "weight_scales" in state_dict:
            self.weight_scales = to_tensor(
                state_dict[prefix + "weight_scales"], dev, torch.float32)
        b_key = prefix + "bias"
        if b_key in state_dict and self.bias is not None:
            self.bias.data = to_tensor(state_dict[b_key], dev,
                                       self.compute_dtype)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class SwitchBackLinearCallback:
    """The :class:`SwitchBackLinear` layers of a model; ``sync()``
    requantizes them all."""

    def __init__(self, model: torch.nn.Module):
        self.switchback_layers = [m for m in model.modules()
                                  if isinstance(m, SwitchBackLinear)]

    def sync(self) -> None:
        for layer in self.switchback_layers:
            layer.sync_weights()
