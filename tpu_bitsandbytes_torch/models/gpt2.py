"""GPT-2-class model from ``torch.nn`` modules: what ``quantize_model``
converts (the JAX package's ``models/gpt2.py``).

The blocks hold the port's :class:`~tpu_bitsandbytes_torch.nn.Linear` and
:class:`~tpu_bitsandbytes_torch.nn.Embedding`, so model surgery
(``integration.quantize_model``) replaces them as it replaces any linear.
Attention runs in f32 with a causal mask, the MLP's GeLU is the tanh
approximation (``jax.nn.gelu``'s default), and the lm_head is tied to the
token embedding when loaded from a checkpoint that ties them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..nn.linear import Embedding, Linear
from .layers import layer_norm

__all__ = ["GPT2Config", "LayerNorm", "GPT2Attention", "GPT2MLP",
           "GPT2Block", "GPT2LMHeadModel", "perplexity"]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def gpt2_124m() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def tiny() -> "GPT2Config":
        return GPT2Config(vocab_size=256, n_positions=64, n_embd=64,
                          n_layer=2, n_head=4)


class LayerNorm(torch.nn.Module):
    """:func:`~.layers.layer_norm` with a weight and a bias."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.eps = float(eps)
        self.weight = torch.nn.Parameter(
            torch.ones((dim,), dtype=dtype, device=device))
        self.bias = torch.nn.Parameter(
            torch.zeros((dim,), dtype=dtype, device=device))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class GPT2Attention(torch.nn.Module):
    def __init__(self, config: GPT2Config, seed: int = 0, device=None):
        super().__init__()
        self.n_head = config.n_head
        self.n_embd = config.n_embd
        self.c_attn = Linear(config.n_embd, 3 * config.n_embd,
                             dtype=config.dtype, device=device, seed=seed)
        self.c_proj = Linear(config.n_embd, config.n_embd,
                             dtype=config.dtype, device=device,
                             seed=seed + 1)

    def forward(self, x):
        b, s, e = x.shape
        hd = e // self.n_head
        q, k, v = (t.reshape(b, s, self.n_head, hd).to(torch.float32)
                   for t in torch.chunk(self.c_attn(x), 3, dim=-1))
        logits = torch.einsum("bshd,bthd->bhst", q, k) / np.sqrt(hd)
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        out = torch.einsum("bhst,bthd->bshd", torch.softmax(logits, dim=-1),
                           v)
        return self.c_proj(out.reshape(b, s, e).to(x.dtype))


class GPT2MLP(torch.nn.Module):
    def __init__(self, config: GPT2Config, seed: int = 0, device=None):
        super().__init__()
        self.c_fc = Linear(config.n_embd, 4 * config.n_embd,
                           dtype=config.dtype, device=device, seed=seed)
        self.c_proj = Linear(4 * config.n_embd, config.n_embd,
                             dtype=config.dtype, device=device,
                             seed=seed + 1)

    def forward(self, x):
        return self.c_proj(torch.nn.functional.gelu(self.c_fc(x),
                                                    approximate="tanh"))


class GPT2Block(torch.nn.Module):
    def __init__(self, config: GPT2Config, seed: int = 0, device=None):
        super().__init__()
        eps, dt = config.layer_norm_eps, config.dtype
        self.ln_1 = LayerNorm(config.n_embd, eps, dt, device)
        self.attn = GPT2Attention(config, seed, device)
        self.ln_2 = LayerNorm(config.n_embd, eps, dt, device)
        self.mlp = GPT2MLP(config, seed + 2, device)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPT2LMHeadModel(torch.nn.Module):
    """Decoder-only LM: wte + wpe, the blocks, ln_f and an lm_head without
    a bias. Weights are drawn from ``seed`` (the JAX package draws from a
    PRNG key: the same laws, other numbers); load a checkpoint or an HF
    state dict (``utils.hf.gpt2_params_from_state_dict``) for real ones."""

    def __init__(self, config: GPT2Config, seed: int = 0, device=None):
        super().__init__()
        self.config_vocab = config.vocab_size
        self.n_positions = config.n_positions
        dt = config.dtype
        self.wte = Embedding(config.vocab_size, config.n_embd, dtype=dt,
                             device=device, seed=seed)
        self.wpe = Embedding(config.n_positions, config.n_embd, dtype=dt,
                             device=device, seed=seed + 1)
        self.h = torch.nn.ModuleList(
            [GPT2Block(config, seed + 10 * (i + 1), device)
             for i in range(config.n_layer)])
        self.ln_f = LayerNorm(config.n_embd, config.layer_norm_eps, dt,
                              device)
        self.lm_head = Linear(config.n_embd, config.vocab_size, bias=False,
                              dtype=dt, device=device, seed=seed + 2)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.wte(input_ids) + self.wpe(pos)
        for block in self.h:
            x = block(x)
        return self.lm_head(self.ln_f(x))

    @torch.no_grad()
    def generate_greedy(self, input_ids, max_new_tokens: int = 16):
        """Greedy decoding that reruns the whole prefix each token (the
        cached decode path is the engine's)."""
        ids = input_ids
        for _ in range(max_new_tokens):
            nxt = self(ids)[:, -1].argmax(dim=-1, keepdim=True)
            ids = torch.cat([ids, nxt.to(ids.dtype)], dim=1)
        return ids


@torch.no_grad()
def perplexity(model, token_batches) -> float:
    """Mean token perplexity of a module LM over [B, S] batches."""
    total_nll, total_tok = 0.0, 0
    for ids in token_batches:
        ids = torch.as_tensor(ids)
        logp = torch.log_softmax(model(ids).to(torch.float32)[:, :-1],
                                 dim=-1)
        tgt = ids[:, 1:].long()
        total_nll += float(-logp.gather(-1, tgt[..., None]).sum())
        total_tok += tgt.numel()
    return float(math.exp(total_nll / max(total_tok, 1)))
