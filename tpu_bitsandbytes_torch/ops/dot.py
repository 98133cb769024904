"""The f32 product of the plain paths: the JAX package's ``dot_general(...,
preferred_element_type=float32)``, shared by the int4 cache's product above
K1's M (:mod:`.int4cache`), the int8 and bf16 runtime caches
(:func:`~..models.layers.cache_matmul`), ``Linear8bitLt`` and the FP8
matmul."""

from __future__ import annotations

import torch

__all__ = ["dot_f32"]


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` in f32, the JAX package's ``dot_general(...,
    preferred_element_type=float32)`` of x with ``w`` cast to x's dtype
    (``w``'s values must be exact in it: int8 codes, or a tensor of x's
    dtype): the product is never rounded to a half-precision type. On a
    card a half-precision x takes one GEMM with an f32 output (``mm``'s
    ``out_dtype``, which has no derivative); elsewhere both operands are
    widened to f32 (exact)."""
    if x.is_cuda and x.dtype != torch.float32:
        return torch.mm(x, w.to(x.dtype).t(), out_dtype=torch.float32)
    return x.to(torch.float32) @ w.to(torch.float32).t()
