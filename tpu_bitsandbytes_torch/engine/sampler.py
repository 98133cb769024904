"""Token samplers for the decode engine: greedy, temperature, top-k, top-p,
and HF's repetition penalty.

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
    # HF's repetition penalty over the prompt and the generated tokens: a
    # seen token's positive logit is divided by it, a negative one
    # multiplied; 1 -> disabled. It reshapes greedy argmaxes too.
    repetition_penalty: float = 1.0
    # stop sequences (tuples of token ids), matched on the host after each
    # chunk; the stop tokens stay in the output
    stop: tuple = ()
    # collect the model's log-softmax at each emitted token (before the
    # penalty and the temperature) into Request.logprobs
    logprobs: bool = False


@dataclasses.dataclass
class SamplingArrays:
    """Per-slot sampling parameters as device tensors [B]."""

    temperature: torch.Tensor     # f32; <= 0 -> greedy
    top_k: torch.Tensor           # int64; 0 -> disabled
    top_p: torch.Tensor           # f32; 1 -> disabled
    eos_id: torch.Tensor          # int32; -1 -> none
    rep_pen: torch.Tensor         # f32; read only where a seen mask is given

    @classmethod
    def build(cls, per_slot: Dict[int, SamplingParams], max_batch: int, *,
              device) -> "SamplingArrays":
        """per_slot: slot -> SamplingParams (missing slots are greedy)."""
        t = [0.0] * max_batch
        k = [0] * max_batch
        p = [1.0] * max_batch
        e = [-1] * max_batch
        r = [1.0] * max_batch
        for slot, sp in per_slot.items():
            t[slot], k[slot], p[slot] = sp.temperature, sp.top_k, sp.top_p
            e[slot] = -1 if sp.eos_token_id is None else sp.eos_token_id
            r[slot] = sp.repetition_penalty
        return cls(torch.tensor(t, dtype=torch.float32, device=device),
                   torch.tensor(k, dtype=torch.int64, device=device),
                   torch.tensor(p, dtype=torch.float32, device=device),
                   torch.tensor(e, dtype=torch.int32, device=device),
                   torch.tensor(r, dtype=torch.float32, device=device))

    def tensors(self):
        return (self.temperature, self.top_k, self.top_p, self.eos_id,
                self.rep_pen)

    def copy_(self, src: "SamplingArrays") -> "SamplingArrays":
        """Refill these tensors in place from ``src`` (same shapes), without
        waiting for the copies (``src`` in pinned memory when it is on the
        host and these on a card)."""
        for dst, t in zip(self.tensors(), src.tensors()):
            dst.copy_(t, non_blocking=True)
        return self


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor,
                             rep_pen: torch.Tensor) -> torch.Tensor:
    """HF's semantics: a seen logit that is positive is divided by its row's
    penalty, a negative one multiplied. logits f32 [B, V], seen_mask bool
    [B, V], rep_pen f32 [B]."""
    pen = rep_pen[:, None]
    adj = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen_mask, adj, logits)


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


def _draw(masked: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One token per row of filtered logits [N, V]: ``argmax(p / q)`` with
    ``q ~ Exp(1)`` drawn from ``generator``, what ``torch.multinomial(p,
    1)`` computes, and the same numbers, without its host-side checks of
    ``p`` (a read back to the host that a CUDA graph cannot hold)."""
    probs = torch.softmax(masked, dim=-1)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)


def sample_batched(logits: torch.Tensor, generator: torch.Generator,
                   s: SamplingArrays,
                   seen_mask: Optional[torch.Tensor] = None,
                   all_greedy: bool = False) -> torch.Tensor:
    """logits [B, V] -> int32 tokens [B] with per-row parameters.
    ``seen_mask`` [B, V] applies each row's repetition penalty first (to
    greedy rows too). ``all_greedy``: every row is greedy, so nothing is
    drawn from ``generator``."""
    logits = logits.to(torch.float32)
    if seen_mask is not None:
        logits = apply_repetition_penalty(logits, seen_mask, s.rep_pen)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if all_greedy:
        return greedy
    sampled = _draw(filter_logits(logits, s.temperature, s.top_k, s.top_p),
                    generator)
    return torch.where(s.temperature <= 0.0, greedy, sampled)


def sample(logits: torch.Tensor, generator: torch.Generator,
           params: SamplingParams,
           seen_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [N, V] -> int32 tokens [N], every row with ``params`` (the
    first token of one request): :func:`sample_batched` with one set of
    parameters. ``seen_mask`` [N, V] applies the repetition penalty first.
    A greedy request draws nothing from ``generator``; nothing is read back
    to the host."""
    n = logits.shape[0]
    s = SamplingArrays.build(dict.fromkeys(range(n), params), n,
                             device=logits.device)
    if params.repetition_penalty == 1.0:
        seen_mask = None
    return sample_batched(logits, generator, s, seen_mask,
                          all_greedy=params.temperature <= 0.0)
