"""Plain (unquantized) Linear and Embedding modules: what model surgery
(``quantize_model``, ``replace_linear_with_*``) converts from, beside any
``torch.nn.Linear``. They are ``torch.nn.Linear``/``torch.nn.Embedding``
with the JAX package's defaults: bf16, a zero bias, x cast to the weight's
dtype, and ``padding_idx`` rows zeroed on lookup."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..functional import to_tensor

__all__ = ["Linear", "Embedding", "to_tensor"]


class Linear(torch.nn.Linear):
    """y = x @ W.T + b with W [out_features, in_features], drawn uniform in
    +-1/sqrt(in_features) from ``seed`` (the JAX package draws from a
    PRNG key: the same law, other numbers)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.bfloat16, device=None,
                 seed: int = 0):
        super().__init__(in_features, out_features, bias=bias,
                         device=device, dtype=dtype)
        bound = 1.0 / math.sqrt(in_features)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            self.weight.copy_(torch.empty(out_features, in_features).uniform_(
                -bound, bound, generator=gen))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class Embedding(torch.nn.Embedding):
    """Token lookup; ids equal to ``padding_idx`` give zeros."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, dtype=torch.bfloat16,
                 device=None, seed: int = 0):
        super().__init__(num_embeddings, embedding_dim,
                         padding_idx=padding_idx, device=device, dtype=dtype)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            self.weight.copy_(torch.randn(num_embeddings, embedding_dim,
                                          generator=gen))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return zero_padding(super().forward(input), input, self.padding_idx)


def zero_padding(out: torch.Tensor, ids: torch.Tensor,
                 padding_idx: Optional[int]) -> torch.Tensor:
    """Zero the rows of ``out`` looked up at ``padding_idx``."""
    if padding_idx is None:
        return out
    return torch.where((ids == padding_idx)[..., None],
                       torch.zeros((), dtype=out.dtype, device=out.device),
                       out)
