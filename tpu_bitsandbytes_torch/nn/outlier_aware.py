"""OutlierAwareLinear: LLM.int8()'s mixed-precision linear layer.

Outlier input columns are found in the weight at conversion (column max
above ``threshold`` x the mean |w|, on numpy, the JAX package's rule) and
kept in the compute dtype; the rest is row-wise int8. ``forward`` quantizes
each row of x to int8, takes the exact int32 product
(:func:`~..functional.int8_dot`) and scales it on the output, with the
outlier columns of x zeroed there (the int8 weight has them zeroed too)
and multiplied by the kept columns instead.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..functional import (_over, _round_int8, div_exact, int8_dot,
                          quantize_rowwise, to_tensor)
from .base import Module, compute_dtype_of, full_precision


class OutlierAwareLinear(Module):
    QUANTIZED_KEYS = ("weight_int8", "weight_scales", "outlier_indices",
                      "outlier_weights")
    OPTIONAL_KEYS = ("threshold",)

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, threshold: float = 6.0,
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.threshold = float(threshold)
        self.compute_dtype = compute_dtype
        self.register_buffer("weight_int8", torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("weight_scales", torch.ones(
            (out_features,), dtype=torch.float32, device=device))
        self.register_buffer("outlier_indices", torch.zeros(
            (0,), dtype=torch.int32, device=device))
        self.register_buffer("outlier_weights", torch.zeros(
            (out_features, 0), dtype=compute_dtype, device=device))
        self.register_buffer("bias", torch.zeros(
            (out_features,), dtype=compute_dtype, device=device)
            if bias else None)

    @property
    def num_outliers(self) -> int:
        return int(self.outlier_indices.shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.in_features)
        if self.num_outliers > 0:
            idx = self.outlier_indices.long()
            x_main = x2.index_fill(1, idx, 0.0)
            out = self._int8_matmul(x_main) + (
                x2[:, idx].to(self.compute_dtype)
                @ self.outlier_weights.t()).to(self.compute_dtype)
        else:
            out = self._int8_matmul(x2)
        out = out.reshape(*lead, self.out_features)
        return out if self.bias is None else out + self.bias

    def _int8_matmul(self, x2: torch.Tensor) -> torch.Tensor:
        """x quantized per row, the exact int8 product, the two scales on
        the output."""
        x32 = x2.to(torch.float32)
        x_absmax = x32.abs().amax(dim=-1).clamp(min=1e-8)
        x_int8 = _round_int8(x32 * _over(127.0, x_absmax)[:, None])
        acc = int8_dot(x_int8, self.weight_int8).to(torch.float32)
        out = (acc * div_exact(x_absmax, 127.0)[:, None]
               * div_exact(self.weight_scales, 127.0)[None, :])
        return out.to(self.compute_dtype)

    @classmethod
    def from_linear(cls, linear, threshold: float = 6.0, device=None
                    ) -> "OutlierAwareLinear":
        """Convert a Linear-like module, on ``device`` or where its weight
        lies."""
        weight = to_tensor(linear.weight).detach()
        device = weight.device if device is None else device
        bias = getattr(linear, "bias", None)
        dtype = compute_dtype_of(weight)
        layer = cls(weight.shape[1], weight.shape[0], bias=bias is not None,
                    threshold=threshold, compute_dtype=dtype, device=device)
        layer._quantize_from(weight)
        if bias is not None:
            layer.bias = to_tensor(bias).detach().to(device, dtype)
        return layer

    def _quantize_from(self, weight: torch.Tensor) -> None:
        """Find the outlier columns of a float weight (on numpy, as the
        JAX package does) and fill the int8 and the kept buffers."""
        dev = self.weight_int8.device
        w_np = weight.detach().to(torch.float32).cpu().numpy()
        col_max = np.abs(w_np).max(axis=0)
        mean_abs = np.abs(w_np).mean()
        outliers = np.where(col_max > self.threshold * mean_abs)[0]
        w_main = w_np.copy()
        w_main[:, outliers] = 0.0
        self.outlier_indices = torch.from_numpy(
            outliers.astype(np.int32)).to(dev)
        self.outlier_weights = torch.from_numpy(
            np.ascontiguousarray(w_np[:, outliers])).to(dev,
                                                        self.compute_dtype)
        self.weight_int8, self.weight_scales = quantize_rowwise(
            torch.from_numpy(w_main).to(dev))

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        destination[prefix + "threshold"] = np.float32(self.threshold)

    def load(self, state_dict: dict, prefix: str) -> None:
        dev = self.weight_int8.device
        t_key = prefix + "threshold"
        if t_key in state_dict:
            loaded_t = float(np.asarray(state_dict[t_key]))
            if loaded_t != self.threshold:
                warnings.warn(
                    f"OutlierAwareLinear threshold mismatch: layer has "
                    f"threshold={self.threshold}, checkpoint has "
                    f"threshold={loaded_t}. Using checkpoint threshold.",
                    UserWarning)
                self.threshold = loaded_t
        w_key = prefix + "weight"
        if w_key in state_dict:
            self._quantize_from(full_precision(
                "OutlierAwareLinear", w_key,
                to_tensor(state_dict[w_key], dev)))
        for key, dt in (("weight_int8", torch.int8),
                        ("weight_scales", torch.float32),
                        ("outlier_indices", torch.int32),
                        ("outlier_weights", self.compute_dtype)):
            if prefix + key in state_dict:
                setattr(self, key, to_tensor(state_dict[prefix + key], dev,
                                             dt))
        b_key = prefix + "bias"
        if b_key in state_dict and self.bias is not None:
            self.bias = to_tensor(state_dict[b_key], dev, self.compute_dtype)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}, threshold={self.threshold}, "
                f"outliers={self.num_outliers}")
