"""8-bit optimizer-state codecs, bit for bit with the JAX package's.

* signed int8 blockwise (block 256) for momentum-like states;
* unsigned uint8 with sqrt range compression for ``exp_avg_sq`` (the sqrt
  keeps the small values that matter in Adam's denominator).

The arithmetic is what XLA compiles the JAX package's jitted functions to
(``tpu_bitsandbytes/optim/state8bit.py``): the quantizers divide by the
block's absmax (a true division), the dequantizers multiply by the f32
reciprocal of 127 or 255, and the signed one folds it into absmax first
(``codes * (absmax * (1/127))``). Square roots are correctly rounded on
every device (:func:`~tpu_bitsandbytes_torch.functional.sqrt_exact`).
"""

from __future__ import annotations

import warnings
from typing import Tuple

import torch

from ..functional import sqrt_exact

__all__ = [
    "quantize_state", "dequantize_state",
    "quantize_state_unsigned", "dequantize_state_unsigned",
]


def _pad_blocks(flat: torch.Tensor, block_size: int) -> torch.Tensor:
    numel = flat.numel()
    padded = -(-numel // block_size) * block_size
    if padded > numel:
        flat = torch.nn.functional.pad(flat, (0, padded - numel))
    return flat.reshape(-1, block_size)


def quantize_state(state: torch.Tensor, block_size: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed int8 blockwise codes of ``state`` (its shape) and the f32
    absmax per block of the flattened state (clamped to 1e-8)."""
    blocks = _pad_blocks(state.reshape(-1).to(torch.float32), block_size)
    absmax = blocks.abs().amax(dim=1).clamp(min=1e-8)
    q = torch.clamp(torch.round(blocks / absmax[:, None] * 127.0), -127, 127
                    ).to(torch.int8)
    return q.reshape(-1)[:state.numel()].reshape(state.shape), absmax


def dequantize_state(state_int8: torch.Tensor, absmax: torch.Tensor,
                     block_size: int = 256,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_state`."""
    blocks = _pad_blocks(state_int8.reshape(-1).to(torch.float32),
                         block_size)
    deq = blocks * (absmax * (1.0 / 127.0))[:, None]
    return deq.reshape(-1)[:state_int8.numel()].reshape(
        state_int8.shape).to(dtype)


def quantize_state_unsigned(state: torch.Tensor, block_size: int = 256,
                            warn_on_negative: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsigned uint8 codes ``round(sqrt(x / max) * 255)`` of a
    non-negative state and the f32 max per block (clamped to 1e-12).
    Negative values are clamped to 0; ``warn_on_negative`` warns how many
    there were (which reads the count back to the host)."""
    if warn_on_negative:
        neg = int((state < 0).sum())
        if neg > 0:
            warnings.warn(
                f"quantize_state_unsigned: {neg} negative values clamped to "
                f"0. This may indicate an issue with the optimizer state.",
                UserWarning, stacklevel=2)
    flat = state.reshape(-1).to(torch.float32).clamp(min=0)
    blocks = _pad_blocks(flat, block_size)
    block_max = blocks.amax(dim=1).clamp(min=1e-12)
    normalized = blocks / block_max[:, None]
    q = torch.clamp(torch.round(sqrt_exact(normalized) * 255.0), 0, 255
                    ).to(torch.uint8)
    return q.reshape(-1)[:state.numel()].reshape(state.shape), block_max


def dequantize_state_unsigned(state_uint8: torch.Tensor,
                              block_max: torch.Tensor, block_size: int = 256,
                              dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """Inverse of :func:`quantize_state_unsigned`."""
    blocks = _pad_blocks(state_uint8.reshape(-1).to(torch.float32),
                         block_size)
    s = blocks * (1.0 / 255.0)
    deq = (s * s) * block_max[:, None]
    return deq.reshape(-1)[:state_uint8.numel()].reshape(
        state_uint8.shape).to(dtype)
