"""Sharding rules for quantized Llama-family params and the KV cache.

Megatron-style tensor parallelism over packed 4-bit storage, as in the
JAX package: a column-parallel linear shards its output rows, which for a
:class:`~..models.layers.QLinear4` is dim 0 of ``packed`` [N, K/2],
``absmax`` [N, nb] and ``absmax_q`` (each row's scales travel with its
codes) and its bias; a row-parallel linear shards the contraction, dim 1
of the same tensors, whole 4-bit blocks per shard. The per-row nested
absmax scale is sharded with the rows (column-parallel) or replicated
(row-parallel); an int8 runtime cache's row scale likewise. The KV cache
shards its kv-head axis over tp and its slot axis over dp.

Each rank holds only its own slices: :func:`shard_params` returns them, on
the rank's device, as an ordinary parameter tree whose ``QLinear4.shape``
is the shard's, so every kernel wrapper routes on the local shape.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..engine.kvcache import KVCache
from ..models import llama
from ..models.layers import QLinear4
from .mesh import P, axis_size

__all__ = ["llama_param_specs", "shard_params", "shard_local",
           "build_sharded_int4_cache", "kv_cache_spec", "spec_tree",
           "mesh_device", "interleave_fused"]

# column-parallel: shard N (dim 0); row-parallel: shard K (dim 1). The
# fused projections (quantize_params(fuse_projections=True, tp=T)) are
# column-parallel: their rows are laid out shard-interleaved.
_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
        "qkv_proj", "gateup_proj")
_ROW = ("o_proj", "down_proj")


def _linear_spec(w, col: bool):
    """The spec of a linear leaf, mirroring its structure (a QLinear4 of
    specs; None fields stay None)."""
    two_d = P("tp", None) if col else P(None, "tp")
    if isinstance(w, QLinear4):
        nested = None
        if w.absmax_state is not None:
            if w.absmax_state.blocksize != w.absmax_q.shape[1]:
                raise NotImplementedError(
                    "TP sharding needs the per-row nested absmax layout "
                    "(QLinear4.quantize); flat blockwise nested states "
                    "(quantize_4bit compress_statistics) are not shardable")
            nested = dataclasses.replace(
                w.absmax_state, absmax=P("tp") if col else P())
        if w.cache_scale is None:
            scale = None
        elif w.cache_scale.dim() == 2:
            # int4 cache scales [nb, N]: N with the rows, nb with K
            scale = P(None, "tp") if col else P("tp", None)
        else:
            # int8 cache row scale [N]: with the rows, or replicated
            scale = P("tp") if col else P()
        return dataclasses.replace(
            w, packed=None if w.packed is None else two_d,
            absmax=None if w.absmax is None else two_d,
            bias=None if w.bias is None else (P("tp") if col else P()),
            absmax_q=None if w.absmax_q is None else two_d,
            absmax_state=nested,
            w_cache=None if w.w_cache is None else two_d,
            cache_scale=scale)
    if isinstance(w, dict):                       # fp {"w", "b"} leaf
        spec = {"w": two_d}
        if w.get("b") is not None:
            spec["b"] = P("tp") if col else P()
        return spec
    return two_d


def _mlp_specs(m: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _linear_spec(v, col=(k != "down_proj")) for k, v in m.items()}


def llama_param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The spec tree of a (quantized) Llama-family parameter tree: the
    embedding, norms, MoE routers and shared-expert gate replicated; q/k/v,
    gate/up, their fusions, each expert's and the shared expert's gate/up,
    and ``lm_head`` column-parallel; o_proj and every down_proj
    row-parallel."""
    specs: Dict[str, Any] = {"embed": P(), "final_norm": P()}
    layer_specs = []
    for layer in params["layers"]:
        ls = {}
        for name, w in layer.items():
            if name == "moe":
                ms = {"router": P(),
                      "experts": [_mlp_specs(e) for e in w["experts"]]}
                if "shared_expert" in w:
                    ms["shared_expert"] = _mlp_specs(w["shared_expert"])
                    ms["shared_gate"] = P()
                ls[name] = ms
            elif name in _COL:
                ls[name] = _linear_spec(w, col=True)
            elif name in _ROW:
                ls[name] = _linear_spec(w, col=False)
            else:
                ls[name] = P()          # norms and other replicated leaves
        layer_specs.append(ls)
    specs["layers"] = layer_specs
    if "lm_head" in params:
        specs["lm_head"] = _linear_spec(params["lm_head"], col=True)
    return specs


def _take(t: Optional[torch.Tensor], spec, tp: int, rank: int, device):
    """This rank's slice of ``t`` under ``spec``, as a new contiguous
    tensor on ``device`` (the global tensor is not kept alive)."""
    if t is None:
        return None
    for dim, axis in enumerate(spec or ()):
        if axis is None:
            continue
        if axis != "tp":
            raise ValueError(f"parameters shard over tp only, not {axis!r}")
        n = t.shape[dim]
        if n % tp:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"divide by tp={tp}")
        t = t.narrow(dim, rank * (n // tp), n // tp)
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    return out.copy_(t)


def _shard_qlinear(w: QLinear4, s: QLinear4, tp: int, rank: int, device):
    col = s.packed == P("tp", None) or s.w_cache == P("tp", None)
    n, k = w.shape
    if col:
        shape = (n // tp, k)
    else:
        if w.packed is not None and (k % w.blocksize
                                     or (k // w.blocksize) % tp):
            raise ValueError(
                f"row-parallel {tuple(w.shape)}: K must be whole "
                f"{w.blocksize}-blocks per shard at tp={tp}")
        shape = (n, k // tp)
    state = w.absmax_state
    if state is not None:
        aq = w.absmax_q
        n_l = aq.shape[0] // tp if col else aq.shape[0]
        nb_l = aq.shape[1] if col else aq.shape[1] // tp
        state = dataclasses.replace(
            state, absmax=_take(state.absmax, s.absmax_state.absmax, tp,
                                rank, device),
            shape=(n_l, nb_l), blocksize=nb_l)

    def take(name):
        return _take(getattr(w, name), getattr(s, name), tp, rank, device)

    return dataclasses.replace(
        w, shape=shape, packed=take("packed"), absmax=take("absmax"),
        bias=take("bias"), absmax_q=take("absmax_q"), absmax_state=state,
        w_cache=take("w_cache"), cache_scale=take("cache_scale"))


def shard_local(params, specs, tp: int, rank: int, device):
    """The slices of ``params`` that tp rank ``rank`` of ``tp`` holds
    under ``specs``, moved to ``device``: the mesh-free core of
    :func:`shard_params`. A spec ``P()`` over a subtree (a LayerNorm's
    {"w", "b"}) replicates all of it."""
    if isinstance(params, QLinear4):
        return _shard_qlinear(params, specs, tp, rank, device)
    if isinstance(params, dict):
        if isinstance(specs, P):
            return {k: shard_local(v, specs, tp, rank, device)
                    for k, v in params.items()}
        return {k: shard_local(v, specs[k], tp, rank, device)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        if isinstance(specs, P):
            return [shard_local(v, specs, tp, rank, device) for v in params]
        return [shard_local(v, s, tp, rank, device)
                for v, s in zip(params, specs)]
    if isinstance(params, torch.Tensor):
        return _take(params, specs, tp, rank, device)
    return params


def mesh_device(mesh) -> torch.device:
    """This rank's device: its current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_params(params, mesh, specs=None):
    """This rank's slices of ``params`` (the whole tree, on any device),
    on its device (:func:`mesh_device`): dim 0 of a column-parallel
    linear's ``packed``, ``absmax``, ``absmax_q`` and bias, dim 1 of a
    row-parallel one's; replicated leaves whole. Every dp group holds the
    same slices."""
    if specs is None:
        specs = llama_param_specs(params)
    return shard_local(params, specs, axis_size(mesh, "tp"),
                       mesh.get_local_rank("tp"), mesh_device(mesh))


def build_sharded_int4_cache(params, drop_packed: bool = True):
    """The int4 runtime cache of a sharded tree (:func:`shard_params`'s),
    built shard by shard as the JAX package builds it: each rank
    dequantizes its own NF4 slices (f32) and requantizes them with
    ``quantize_int4``. Every shard of a linear has the same local dims, so
    the same K padding; the port's cache carries no N padding.
    ``drop_packed`` frees the NF4 storage afterwards (serving)."""
    return llama.build_runtime_cache(params, "int4", drop_packed=drop_packed)


def _interleave_rows_of(w, sizes, tp: int):
    """A fused leaf whose rows are ``sizes`` segments concatenated, with
    its rows (and every per-row tensor's) permuted into the order of
    ``llama._interleave_rows``; no value changes."""
    if any(n % tp for n in sizes):
        raise ValueError(f"fused segments {sizes} do not divide by tp={tp}")
    idx, off = [], 0
    offs = []
    for n in sizes:
        offs.append(off)
        off += n
    for i in range(tp):
        for o, n in zip(offs, sizes):
            t = n // tp
            idx.extend(range(o + i * t, o + (i + 1) * t))
    perm = torch.tensor(idx)

    def rows(t):
        return None if t is None else t[perm.to(t.device)].contiguous()

    if isinstance(w, QLinear4):
        st = w.absmax_state
        if st is not None:
            st = dataclasses.replace(st, absmax=rows(st.absmax))
        cs = w.cache_scale
        if cs is not None:
            cs = (cs[:, perm.to(cs.device)].contiguous() if cs.dim() == 2
                  else rows(cs))
        return dataclasses.replace(
            w, packed=rows(w.packed), absmax=rows(w.absmax),
            bias=rows(w.bias), absmax_q=rows(w.absmax_q), absmax_state=st,
            w_cache=rows(w.w_cache), cache_scale=cs)
    if isinstance(w, dict):
        return {"w": rows(w["w"]), "b": rows(w.get("b"))}
    return rows(w)


def interleave_fused(params, config: llama.LlamaConfig, tp: int):
    """A tree fused at tp = 1 (``quantize_params(fuse_projections=True)``:
    qkv_proj rows (q; k; v), gateup_proj rows (gate; up), the experts'
    too) re-laid for a tp-way mesh: the layout
    ``quantize_params(..., tp=tp)`` gives, whose column shards hold (q_i;
    k_i; v_i) and (gate_i; up_i). The same weights (every row and its
    scales moved, none changed), so a sharded engine serves the model the
    tp = 1 tree serves on one device."""
    hd = config.hd
    qkv = [config.num_heads * hd, config.num_kv_heads * hd,
           config.num_kv_heads * hd]

    def gateup(w):
        n = w.shape[0] if isinstance(w, QLinear4) else (
            w["w"] if isinstance(w, dict) else w).shape[0]
        return _interleave_rows_of(w, [n // 2, n // 2], tp)

    def mlp(m):
        return {k: gateup(v) if k == "gateup_proj" else v
                for k, v in m.items()}

    layers = []
    for layer in params["layers"]:
        out = dict(layer)
        if "qkv_proj" in layer:
            out["qkv_proj"] = _interleave_rows_of(layer["qkv_proj"], qkv, tp)
        if "gateup_proj" in layer:
            out["gateup_proj"] = gateup(layer["gateup_proj"])
        if "moe" in layer:
            moe = dict(layer["moe"])
            moe["experts"] = [mlp(e) for e in moe["experts"]]
            if "shared_expert" in moe:
                moe["shared_expert"] = mlp(moe["shared_expert"])
            out["moe"] = moe
        layers.append(out)
    return dict(params, layers=layers)


def kv_cache_spec(cache: Optional[KVCache] = None) -> KVCache:
    """The KV cache's spec: codes [L, B, H_kv, S, D] with slots over dp
    and kv heads over tp, their scales likewise, lengths over dp. Each
    rank's cache is [L, B/dp, H_kv/tp, S, D]."""
    quantized = True if cache is None else cache.quantized
    scale = P(None, "dp", "tp", None) if quantized else None
    return KVCache(k=P(None, "dp", "tp", None, None),
                   v=P(None, "dp", "tp", None, None),
                   k_scale=scale, v_scale=scale, lengths=P("dp"),
                   ring=False if cache is None else cache.ring,
                   max_positions=None if cache is None
                   else cache.max_positions)


def spec_tree(params, specs=None):
    """A tree of ``params``' structure with each tensor's spec in its
    place (None where a field is None)."""
    if specs is None:
        specs = llama_param_specs(params)

    def walk(p, s):
        if isinstance(p, QLinear4):
            return s
        if isinstance(p, dict):
            return {k: walk(v, s if isinstance(s, P) else s[k])
                    for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return [walk(v, s if isinstance(s, P) else sv)
                    for v, sv in zip(p, s if not isinstance(s, P)
                                     else [s] * len(p))]
        return None if p is None else s

    return walk(params, specs)
