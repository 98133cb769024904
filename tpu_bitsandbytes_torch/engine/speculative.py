"""Speculative decoding: prompt-lookup drafts and a verify step.

The JAX package's ``engine/speculative.py`` in PyTorch. Drafts come from an
n-gram lookup in the slot's own token history ("prompt lookup decoding"),
and one **verify step** scores all gamma+1 positions of every slot in one
forward (``decode_layer`` with ``[B, gamma+1]`` tokens: the matmuls run at
M = B * (gamma+1), attention over the int8 cache in torch, not K2, which
takes one query per slot). Greedy slots accept a draft by exact argmax
match, so a speculative engine emits the tokens of plain greedy decoding
(exactly in f32; in bf16 the gamma+1 queries of a verify round differently
from a one-query decode step, so argmaxes tied within about 1e-3 can
flip). Sampled slots take the distribution-preserving rejection rule.

The drafts' KV is written up front; rejected positions hold stale entries
that the per-query causal mask keeps unattended until they are overwritten,
the garbage-KV contract prefill relies on too. Nothing here reads back to
the host, so a verify step can be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..models import llama
from .kvcache import KVCache
from .sampler import SamplingArrays, _draw, filter_logits


def propose_ngram(history: List[int], gamma: int, n: int = 3) -> List[int]:
    """Prompt-lookup proposal: the most recent earlier occurrence of the
    trailing ``n``-gram, and up to ``gamma`` tokens that followed it. Empty
    when the history has no repeat to exploit."""
    if len(history) < n + 1 or gamma <= 0:
        return []
    key = history[-n:]
    for start in range(len(history) - n - 1, -1, -1):
        if history[start:start + n] == key:
            cont = history[start + n:start + n + gamma]
            if cont:
                return [int(t) for t in cont]
    return []


def accept_and_emit(logits: torch.Tensor, tokens: torch.Tensor,
                    generator: Optional[torch.Generator],
                    samp: SamplingArrays, all_greedy: bool = False):
    """Speculative acceptance with a point-mass draft.

    logits f32 [B, G1, V]: the model's raw logits after tokens[:, :j+1];
    tokens int32 [B, G1] = [last emitted, G drafts]; ``samp`` the slots'
    sampling arrays. Greedy rows (temperature <= 0) accept by exact argmax
    match. Sampled rows accept draft d at position j with probability
    p_j(d), p_j the row's temperature/top-k/top-p distribution; the
    boundary token is drawn from p_j with d removed on a rejection and from
    p_G on full acceptance: the autoregressive sampling distribution
    exactly. ``all_greedy``: every row is greedy, so nothing is drawn from
    ``generator``.

    Returns (emitted int32 [B, G1], n_acc [B]).
    """
    b, g1 = tokens.shape
    g = g1 - 1
    logits = logits.to(torch.float32)
    v = logits.shape[-1]
    dev = logits.device
    preds = torch.argmax(logits, dim=-1).to(torch.int32)     # greedy targets
    drafts = tokens[:, 1:]
    j = torch.arange(g1, device=dev)[None, :]
    if all_greedy:
        acc = preds[:, :-1] == drafts
        n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
        bonus = preds.gather(1, n_acc[:, None].long())[:, 0]
    else:
        flat = filter_logits(logits.reshape(b * g1, v),
                             samp.temperature.repeat_interleave(g1),
                             samp.top_k.repeat_interleave(g1),
                             samp.top_p.repeat_interleave(g1)
                             ).reshape(b, g1, v)
        probs = torch.softmax(flat, dim=-1)
        greedy_row = samp.temperature <= 0.0
        p_draft = probs[:, :-1].gather(-1, drafts.long()[..., None])[..., 0]
        u = torch.rand((b, g), generator=generator, device=dev)
        acc = torch.where(greedy_row[:, None], preds[:, :-1] == drafts,
                          u < p_draft)
        n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
        # boundary token: a residual draw on a rejection, a plain draw on
        # full acceptance; greedy rows take the argmax either way
        f_b = flat.gather(1, n_acc[:, None, None].long().expand(b, 1, v))[:, 0]
        d_b = drafts.gather(1, n_acc.clamp(0, g - 1)[:, None].long())[:, 0]
        reject = (n_acc < g)[:, None] & (
            torch.arange(v, device=dev)[None, :] == d_b[:, None])
        resid = torch.where(reject, torch.full_like(f_b, float("-inf")), f_b)
        greedy_b = preds.gather(1, n_acc[:, None].long())[:, 0]
        bonus = torch.where(greedy_row, greedy_b, _draw(resid, generator))
    shifted = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    emitted = torch.where(j < n_acc[:, None], shifted,
                          torch.where(j == n_acc[:, None], bonus[:, None],
                                      torch.zeros_like(shifted)))
    return emitted.to(torch.int32), n_acc


def verify_logits(params, cache: KVCache, tokens: torch.Tensor,
                  config: llama.LlamaConfig,
                  attn_span: Optional[int] = None) -> torch.Tensor:
    """The verify forward: tokens int32 [B, G1] at positions ``lengths +
    j``, their KV written into ``cache`` (positions past ``max_seq``
    dropped); the lengths are left as they were. Returns f32 logits
    [B, G1, V]."""
    g1 = tokens.shape[1]
    positions = (cache.lengths[:, None]
                 + torch.arange(g1, dtype=torch.int32,
                                device=tokens.device)[None, :])
    x, cos, sin = llama.decode_embed_and_rope(params, tokens, positions,
                                              config)
    for li, layer in enumerate(params["layers"]):
        x, cache = llama.decode_layer(layer, x, cos, sin, positions, cache,
                                      li, config, attn_span=attn_span)
    x = llama._norm(x, params["final_norm"], config)
    return llama.head_logits(params, x, config)


def verify_step(params, cache: KVCache, tokens: torch.Tensor,
                active: torch.Tensor, generator: Optional[torch.Generator],
                samp: SamplingArrays, config: llama.LlamaConfig,
                attn_span: Optional[int] = None, all_greedy: bool = False):
    """One speculative verify: tokens [B, gamma+1] = [last emitted, drafts].

    Returns (emitted [B, gamma+1], counts [B], cache), the lengths of
    active slots advanced by their counts in place. Per active slot the
    first ``counts`` entries of ``emitted`` are the accepted drafts and
    then the boundary token (counts >= 1: no accepted draft is an ordinary
    decode step); inactive slots count 0. ``attn_span`` must cover every
    active slot's length + gamma + 1.
    """
    logits = verify_logits(params, cache, tokens, config, attn_span)
    emitted, n_acc = accept_and_emit(logits, tokens, generator, samp,
                                     all_greedy=all_greedy)
    counts = torch.where(active, n_acc + 1,
                         torch.zeros_like(n_acc)).to(torch.int32)
    cache.lengths += counts
    return emitted, counts, cache
