"""Token samplers for the decode engine: greedy, temperature, top-k, top-p.

Sampling draws from an explicit ``torch.Generator``; it will not repeat the
JAX package's random draws, only its distribution. Greedy rows are exact
argmaxes (first index on ties, as ``jnp.argmax``). Nothing here reads a
value back to the host, so a decode chunk that samples can be captured in
a CUDA graph (with the generator registered to it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0      # 0 -> greedy
    top_k: int = 0                # 0 -> disabled
    top_p: float = 1.0            # 1 -> disabled
    max_new_tokens: int = 128
    eos_token_id: Optional[int] = None
    # stop sequences (tuples of token ids), matched on the host after each
    # chunk; the stop tokens stay in the output
    stop: tuple = ()


@dataclasses.dataclass
class SamplingArrays:
    """Per-slot sampling parameters as device tensors [B]."""

    temperature: torch.Tensor     # f32; <= 0 -> greedy
    top_k: torch.Tensor           # int64; 0 -> disabled
    top_p: torch.Tensor           # f32; 1 -> disabled
    eos_id: torch.Tensor          # int32; -1 -> none

    @classmethod
    def build(cls, per_slot: Dict[int, SamplingParams], max_batch: int, *,
              device) -> "SamplingArrays":
        """per_slot: slot -> SamplingParams (missing slots are greedy)."""
        t = [0.0] * max_batch
        k = [0] * max_batch
        p = [1.0] * max_batch
        e = [-1] * max_batch
        for slot, sp in per_slot.items():
            t[slot], k[slot], p[slot] = sp.temperature, sp.top_k, sp.top_p
            e[slot] = -1 if sp.eos_token_id is None else sp.eos_token_id
        return cls(torch.tensor(t, dtype=torch.float32, device=device),
                   torch.tensor(k, dtype=torch.int64, device=device),
                   torch.tensor(p, dtype=torch.float32, device=device),
                   torch.tensor(e, dtype=torch.int32, device=device))

    def tensors(self):
        return (self.temperature, self.top_k, self.top_p, self.eos_id)

    def copy_(self, src: "SamplingArrays") -> "SamplingArrays":
        """Refill these tensors in place from ``src`` (same shapes), without
        waiting for the copies (``src`` in pinned memory when it is on the
        host and these on a card)."""
        for dst, t in zip(self.tensors(), src.tensors()):
            dst.copy_(t, non_blocking=True)
        return self


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-row temperature, top-k and top-p over logits [N, V]; filtered
    entries become -inf. Temperature is clamped at 1e-6 (greedy rows take
    the argmax instead)."""
    v = logits.shape[-1]
    scaled = logits / temperature.clamp(min=1e-6)[:, None]
    sorted_l = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, v))[:, None]
    kth = torch.gather(sorted_l, -1, (k - 1).clamp(0, v - 1))
    ninf = torch.full_like(scaled, float("-inf"))
    masked = torch.where(scaled < kth, ninf, scaled)
    sorted_m = torch.sort(masked, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_m, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p[:, None]).sum(dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_m, -1, cutoff_idx.clamp(0, v - 1))
    return torch.where(masked < cutoff, ninf, masked)


def sample_batched(logits: torch.Tensor, generator: torch.Generator,
                   s: SamplingArrays) -> torch.Tensor:
    """logits [B, V] -> int32 tokens [B] with per-row parameters.

    A row samples ``argmax(p / q)`` with ``q ~ Exp(1)`` drawn from
    ``generator``: what ``torch.multinomial(p, 1)`` computes, and the same
    numbers, without its host-side checks of ``p`` (a read back to the
    host that a CUDA graph cannot hold)."""
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    masked = filter_logits(logits, s.temperature, s.top_k, s.top_p)
    probs = torch.softmax(masked, dim=-1)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    sampled = torch.argmax(probs / q, dim=-1).to(torch.int32)
    return torch.where(s.temperature <= 0.0, greedy, sampled)
