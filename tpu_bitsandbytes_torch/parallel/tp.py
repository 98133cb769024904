"""Tensor- and data-parallel serving steps over ``torch.distributed``.

The counterpart of the JAX package's ``shard_map`` steps, one process per
GPU: every rank holds a column shard of q/k/v, gate/up (and each expert's)
and lm_head, a row shard of o_proj and down_proj, and its kv heads of the
KV cache for its dp group's slots. The model code runs unchanged on the
local shards through its ``wrap``/``reduce_fn`` hooks
(:class:`TPContext`); the collectives on the decode path are one
``all_reduce`` over tp after o_proj and one after down_proj per layer, on
the partial in the dtype the JAX package reduces it in (the linear's
output dtype), and one ``all_gather`` of the [.., V/tp] lm_head logits; a
row-parallel int4 shard also all-reduces its A8 row scale to the maximum
(the JAX package's ``pmax``). A tied embedding keeps the replicated
product. Under a mesh the collectives always run, also over one rank, so a
captured decode chunk holds them.

The step builders return this rank's step functions; inputs and outputs
are dp-local (the rank's dp group's slots), and the engine gathers the
sampled tokens over dp (:meth:`TPContext.gather_dp`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..engine import engine as E
from ..engine import speculative as spec
from ..engine.kvcache import KVCache
from ..models import llama
from ..models.layers import QLinear4, linear_apply
from .mesh import axis_size

__all__ = ["TPContext", "make_tp_decode_step", "make_tp_decode_chunk",
           "make_tp_verify_step", "make_tp_prefill_step",
           "make_tp_prefill_chunk", "make_tp_final_logits",
           "graphs_allowed"]


def _localize(w, strip_bias: bool = False, tp_group=None):
    """A weight leaf as a shard step uses it. ``strip_bias``: a
    row-parallel linear must not add its bias per shard (the all-reduce
    would add it tp times); :meth:`TPContext.reduce_fn` adds it once after
    the reduction. ``tp_group``: an int4-cache shard of a row-parallel
    linear all-reduces its A8 row scale over it, so that its codes are the
    unsharded engine's."""
    if isinstance(w, QLinear4):
        lw = dataclasses.replace(w, bias=None if strip_bias else w.bias)
        if (tp_group is not None and w.w_cache is not None
                and w.w_cache.dtype == torch.uint8):
            lw._tp_group = tp_group
        return lw
    if isinstance(w, dict) and strip_bias:        # fp {"w", "b"} leaf
        return {"w": w["w"], "b": None}
    return w


def _row_bias(w):
    if isinstance(w, QLinear4):
        return w.bias
    if isinstance(w, dict):
        return w.get("b")
    return None


def graphs_allowed(mesh) -> bool:
    """Whether a decode chunk under ``mesh`` can be a CUDA graph: its
    collectives must be NCCL's, which a graph captures; gloo's run on the
    host."""
    return all(dist.get_backend(mesh.get_group(d)) == "nccl"
               for d in mesh.mesh_dim_names)


class TPContext:
    """This rank's place in a (dp, tp) mesh, and the hooks the model code
    takes (``n_heads``, ``n_kv``, ``wrap``, ``reduce_fn``:
    :func:`~..models.llama.decode_layer`'s)."""

    def __init__(self, mesh, config: llama.LlamaConfig):
        self.mesh = mesh
        self.tp = axis_size(mesh, "tp")
        self.dp = axis_size(mesh, "dp")
        self.tp_rank = mesh.get_local_rank("tp")
        self.dp_rank = mesh.get_local_rank("dp")
        self.tp_group = mesh.get_group("tp")
        self.dp_group = mesh.get_group("dp")
        if config.num_heads % self.tp or config.num_kv_heads % self.tp:
            raise ValueError(
                f"{config.num_heads} heads / {config.num_kv_heads} kv heads "
                f"do not divide by tp={self.tp}")
        self.n_heads = config.num_heads // self.tp
        self.n_kv = config.num_kv_heads // self.tp
        # id(leaf), row -> (leaf, its localized form): made once per leaf
        self._local = {}

    @property
    def hooks(self) -> dict:
        return dict(n_heads=self.n_heads, n_kv=self.n_kv, wrap=self.wrap,
                    reduce_fn=self.reduce_fn)

    def wrap(self, w, row: bool = False):
        key = (id(w), row)
        hit = self._local.get(key)
        if hit is None or hit[0] is not w:
            hit = (w, _localize(w, strip_bias=row,
                                tp_group=self.tp_group if row else None))
            self._local[key] = hit
        return hit[1]

    def reduce_fn(self, partial: torch.Tensor, w) -> torch.Tensor:
        """Sum a row-parallel partial over tp, then add the bias once."""
        dist.all_reduce(partial, group=self.tp_group)
        bias = _row_bias(w)
        return partial if bias is None else partial + bias.to(partial.dtype)

    def _gather(self, t: torch.Tensor, dim: int, group, n: int):
        t = t.contiguous()
        wide = t.dtype == torch.bool        # gathered as bytes
        if wide:
            t = t.to(torch.uint8)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        out = torch.cat(parts, dim=dim)
        return out.to(torch.bool) if wide else out

    def gather_tp(self, t: torch.Tensor) -> torch.Tensor:
        """[.., X/tp] shards -> [.., X], in tp rank order."""
        return self._gather(t, t.dim() - 1, self.tp_group, self.tp)

    def gather_dp(self, t: Optional[torch.Tensor], dim: int = 0
                  ) -> Optional[torch.Tensor]:
        """Each dp group's slots along ``dim`` -> every slot, in dp order."""
        if t is None:
            return None
        return self._gather(t, dim, self.dp_group, self.dp)

    def from_owner(self, t: torch.Tensor, own: bool) -> torch.Tensor:
        """The owning dp group's ``t`` on every rank: the others pass
        zeros (of its shape), and the sum over dp is the owner's value."""
        if not own:
            t = torch.zeros_like(t)
        dist.all_reduce(t, group=self.dp_group)
        return t

    def head_logits(self, params, x: torch.Tensor,
                    config: llama.LlamaConfig) -> torch.Tensor:
        """f32 logits [.., V]: the local lm_head shard's [.., V/tp],
        gathered over tp, then the epilogue; a tied embedding's replicated
        product."""
        head = params.get("lm_head")
        if head is None:
            logits = x @ params["embed"].t().to(x.dtype)
        else:
            logits = self.gather_tp(linear_apply(self.wrap(head), x))
        return llama.finish_logits(logits, config)

    def owner(self, slot: int, cache: KVCache):
        """(whether this rank's dp group owns global ``slot``, its local
        index): dp group d owns slots [d B/dp, (d+1) B/dp)."""
        per = cache.lengths.shape[0]
        return slot // per == self.dp_rank, slot % per


def make_tp_decode_step(mesh, params, config: llama.LlamaConfig,
                        cache: KVCache):
    """``fn(params, cache, tokens, active, attn_span=None, attn_start=0)``
    -> (f32 logits [B/dp, V], cache): :func:`~..engine.engine.decode_step`
    on this rank's shards; tokens and active are its dp group's slots.
    Heads, hidden and intermediate dims (and their 4-bit blocks) must
    divide by tp."""
    ctx = TPContext(mesh, config)

    def step(params, cache, tokens, active, attn_span=None, attn_start=0):
        return E.decode_step(params, cache, tokens, active, config,
                             attn_span, attn_start, tp=ctx)

    return step


def make_tp_decode_chunk(mesh, params, config: llama.LlamaConfig,
                         cache: KVCache, n_steps: int = 8):
    """``fn(params, cache, tokens, active, generator, samp, seen_mask,
    all_greedy=False, attn_span=None, attn_start=0, want_logprobs=False)``:
    :func:`~..engine.engine.decode_chunk` of ``n_steps`` on this rank's
    shards, sampling on the device; inputs and outputs are the dp group's
    slots (the engine gathers them over dp). The tp ranks of a dp group
    hold identical logits after the lm_head's gather, so with generators
    in one state they draw the same tokens."""
    ctx = TPContext(mesh, config)

    def chunk(params, cache, tokens, active, generator, samp, seen_mask,
              all_greedy=False, attn_span=None, attn_start=0,
              want_logprobs=False):
        return E.decode_chunk(params, cache, tokens, active, generator,
                              samp, config, n_steps=n_steps,
                              all_greedy=all_greedy, attn_span=attn_span,
                              seen_mask=seen_mask,
                              want_logprobs=want_logprobs,
                              attn_start=attn_start, tp=ctx)

    return chunk


def make_tp_verify_step(mesh, params, config: llama.LlamaConfig,
                        cache: KVCache):
    """``fn(params, cache, tokens [B/dp, G1], active, generator, samp,
    attn_span=None, all_greedy=False)`` -> (emitted, counts, cache):
    :func:`~..engine.speculative.verify_step` on this rank's shards, the
    lm_head gathered over tp at every position."""
    ctx = TPContext(mesh, config)

    def verify(params, cache, tokens, active, generator, samp,
               attn_span=None, all_greedy=False):
        return spec.verify_step(params, cache, tokens, active, generator,
                                samp, config, attn_span=attn_span,
                                all_greedy=all_greedy, tp=ctx)

    return verify


def tp_prefill(params, cache: KVCache, tokens: torch.Tensor, slot: int,
               true_len: int, config: llama.LlamaConfig, ctx: TPContext):
    """The mesh prefill of one request (the JAX package's
    ``_tp_prefill_impl``): tokens [1, S_pad]; the dp group that owns
    ``slot`` runs :func:`~..engine.engine.prefill_step` on its shards into
    its local slot (so one rank computes what one device does); the other
    groups skip the forward and receive its logits. Returns (f32 logits
    [V], identical on every rank, cache)."""
    own, local = ctx.owner(slot, cache)
    if own:
        logits, cache = E.prefill_step(params, cache, tokens, local,
                                       true_len, config, tp=ctx)
    else:
        logits = torch.empty((config.vocab_size,), dtype=torch.float32,
                             device=tokens.device)
    return ctx.from_owner(logits, own), cache


def make_tp_prefill_step(mesh, params, config: llama.LlamaConfig,
                         cache: KVCache):
    """``fn(params, cache, tokens [1, S_pad], slot, true_len)`` -> (f32
    logits [V], cache): :func:`tp_prefill`. ``slot`` is global."""
    ctx = TPContext(mesh, config)

    def prefill(params, cache, tokens, slot, true_len):
        return tp_prefill(params, cache, tokens, slot, true_len, config, ctx)

    return prefill


def tp_prefill_chunk(params, cache: KVCache, tokens: torch.Tensor,
                     slot: int, start: int, new_len: int,
                     config: llama.LlamaConfig, ctx: TPContext,
                     attn_span: Optional[int] = None, attn_start: int = 0):
    """One chunk of a chunked prefill under a mesh: the owning dp group
    runs :func:`~..engine.engine.prefill_chunk_step` on its shards into its
    local slot; every rank receives the chunk's hidden [1, C, H]."""
    own, local = ctx.owner(slot, cache)
    if own:
        x, cache = E.prefill_chunk_step(params, cache, tokens, local, start,
                                        new_len, config, attn_span=attn_span,
                                        attn_start=attn_start, tp=ctx)
    else:
        x = torch.empty((1, tokens.shape[1], config.hidden_size),
                        dtype=config.dtype, device=tokens.device)
    return ctx.from_owner(x, own), cache


def make_tp_prefill_chunk(mesh, params, config: llama.LlamaConfig,
                          cache: KVCache):
    """``fn(params, cache, tokens [1, C], slot, start, new_len,
    attn_span=None, attn_start=0)`` -> (hidden [1, C, H] on every rank,
    cache): :func:`tp_prefill_chunk`. Feed the final chunk's hidden to
    :func:`make_tp_final_logits`'s function."""
    ctx = TPContext(mesh, config)

    def chunk(params, cache, tokens, slot, start, new_len, attn_span=None,
              attn_start=0):
        return tp_prefill_chunk(params, cache, tokens, slot, start, new_len,
                                config, ctx, attn_span, attn_start)

    return chunk


def make_tp_final_logits(mesh, params, config: llama.LlamaConfig):
    """``fn(params, x [1, C, H], idx)`` -> f32 logits [V]: the final norm
    and the sharded lm_head at one position, gathered over tp."""
    ctx = TPContext(mesh, config)

    def final(params, x, idx):
        return E.prefill_final_logits(params, x, idx, config, tp=ctx)

    return final
