"""A trained proxy model for quantization-accuracy gates.

No pretrained checkpoint is at hand, and a randomly initialized model is a
useless perplexity oracle: its logits are near uniform, so quantization
error barely moves its NLL. The stand-in that can be built without one:

1. a structured synthetic corpus (Zipfian unigram marginals and a local
   copy process, so there is signal to learn), :func:`make_corpus`, the
   JAX package's numpy generator value for value;
2. a tiny Llama trained on it for a few hundred full-parameter AdamW steps
   (:func:`train_proxy_lm`), whose weights have the anisotropic,
   heavy-tailed spectra that make quantization error visible;
3. teacher-forced perplexity through the full forward
   (:func:`teacher_forced_ppl`) and through the cached decode step and
   its (optionally int8) KV cache (:func:`decode_ppl`).

The gate (a relative perplexity change of at most 2% against the f32
model, the reference's |delta ppl| <= 0.1 at ppl 5.68) is asserted by the
tests and by ``chip_smoke.py``. Training and evaluation run on the device
of the parameters: :func:`train_proxy_lm` builds them on the card unless
the caller passes a CPU device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import llama

__all__ = ["make_corpus", "eval_batches", "proxy_loss", "train_proxy_lm",
           "teacher_forced_ppl", "decode_ppl"]


def make_corpus(seed: int, vocab: int, length: int, alpha: float = 1.15,
                copy_p: float = 0.35, copy_back: int = 8) -> np.ndarray:
    """int32 token stream with Zipf(alpha) marginals and local copies:
    with probability ``copy_p`` a token repeats the one ``copy_back``
    positions earlier, else it is an independent Zipf draw."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    base = rng.choice(vocab, size=length, p=probs)
    out = base.copy()
    copies = rng.random(length) < copy_p
    for i in range(copy_back, length):
        if copies[i]:
            out[i] = out[i - copy_back]
    return out.astype(np.int32)


def eval_batches(corpus: np.ndarray, batch: int, seq: int,
                 offset: int = 0) -> np.ndarray:
    """Deterministic evaluation windows [batch, seq + 1], back to back
    from ``offset``."""
    rows = []
    for i in range(batch):
        start = offset + i * (seq + 1)
        rows.append(corpus[start:start + seq + 1])
    return np.stack(rows)


def _device(params) -> torch.device:
    return params["embed"].device


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean NLL of ``targets`` under a log-softmax of ``logits`` in f32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None]).mean()


def proxy_loss(params, tokens: torch.Tensor,
               config: llama.LlamaConfig) -> torch.Tensor:
    """The mean next-token NLL of ``tokens`` [B, S + 1]: the whole row
    through the forward, the logits at 0..S-1 scored against tokens
    1..S (the JAX package's ``_loss_fn``)."""
    logits = llama.forward(params, tokens, config)
    return _nll(logits[:, :-1], tokens[:, 1:])


def train_proxy_lm(config: llama.LlamaConfig, corpus: np.ndarray,
                   steps: int = 300, batch: int = 16, seq: int = 64,
                   lr: float = 1e-3, seed: int = 0, device="cuda"):
    """Train a tiny Llama on ``corpus``; returns (params, the last step's
    perplexity).

    Parameters from ``llama.init_params`` with a generator seeded
    ``seed``; every float leaf trained by ``torch.optim.AdamW(lr,
    weight_decay=0.01)`` (betas 0.9 / 0.999, eps 1e-8: ``optax.adamw``'s
    defaults). Both decay the parameter before the step by ``lr * wd``
    times its old value and add eps outside the square root of the
    bias-corrected second moment, so one step of each agrees to the
    rounding of their operation order. Each step's ``batch`` windows of
    ``seq + 1`` tokens start at draws from a ``torch.Generator`` seeded
    ``seed + 1``; JAX's ``jax.random`` stream cannot be reproduced, so the
    trajectory is the port's own."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = llama.init_params(config, generator=gen, device=device)
    leaves = list({id(t): t for t in _float_leaves(params)}.values())
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    data = torch.as_tensor(corpus, dtype=torch.int64, device=device)
    n_windows = len(corpus) - seq - 1
    draw = torch.Generator(device=device).manual_seed(seed + 1)
    offsets = torch.arange(seq + 1, device=device)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        starts = torch.randint(0, n_windows, (batch,), generator=draw,
                               device=device)
        toks = data[starts[:, None] + offsets]
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = proxy_loss(params, toks, config)
            loss.backward()
        opt.step()
    for t in leaves:
        t.requires_grad_(False)
        t.grad = None
    return params, float(torch.exp(loss.detach()))


def _float_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _float_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _float_leaves(v)
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield tree


@torch.no_grad()
def teacher_forced_ppl(params, config: llama.LlamaConfig,
                       tokens: np.ndarray) -> float:
    """Perplexity of ``tokens`` [B, S + 1] through the full forward
    (:func:`proxy_loss`), on the parameters' device."""
    toks = torch.as_tensor(np.asarray(tokens), device=_device(params))
    return float(np.exp(float(proxy_loss(params, toks, config))))


@torch.no_grad()
def decode_ppl(params, config: llama.LlamaConfig, tokens: np.ndarray,
               quantized_kv: bool) -> float:
    """Teacher-forced perplexity through the cached decode step: each
    token of ``tokens`` [B, S + 1] goes through ``engine.decode_step`` and
    the next one is scored, so the KV cache's int8 quantization
    (``quantized_kv``) shows in the number; the cache holds S + 1
    positions in the config's dtype. The mean NLL is the mean of the S
    steps' f32 means, summed on the host, as the JAX package sums it."""
    from ..engine.engine import decode_step
    from ..engine.kvcache import KVCache
    dev = _device(params)
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32, device=dev)
    b, s1 = toks.shape
    cache = KVCache.create(config.num_layers, b, s1, config.num_kv_heads,
                           config.hd, quantized=quantized_kv,
                           dtype=config.dtype, device=dev)
    active = torch.ones((b,), dtype=torch.bool, device=dev)
    total = 0.0
    for t in range(s1 - 1):
        logits, cache = decode_step(params, cache, toks[:, t], active, config)
        total += float(_nll(logits, toks[:, t + 1]))
    return float(np.exp(total / (s1 - 1)))
