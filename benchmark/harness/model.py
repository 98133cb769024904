"""The system under test for the Mistral family (Mistral, Mixtral): the
port's ``LlamaConfig``, its parameter tree and its ``DecodeEngine``, built
from a configuration file and the benchmark's weights, and the KV the
engine's cache holds, read back. Only this module and :mod:`harness.serve`
and :mod:`harness.trace` import the port (``tpu_bitsandbytes_torch``)."""

from __future__ import annotations

from typing import List, Tuple

import torch

from .weights import BLOCKSIZE


def llama_config(cfg: dict, max_seq: int):
    """The port's ``LlamaConfig`` of a configuration file."""
    from tpu_bitsandbytes_torch.models.llama import LlamaConfig
    return LlamaConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        rope_theta=float(cfg["rope_theta"]), rms_eps=cfg["rms_norm_eps"],
        max_seq_len=max(max_seq, cfg["max_position_embeddings"]),
        dtype=torch.bfloat16,
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        sliding_window=cfg.get("sliding_window"),
        hidden_act=cfg.get("hidden_act", "silu"),
        num_experts=cfg["num_local_experts"],
        experts_per_token=cfg["num_experts_per_tok"] or 2)


def program_params(tree: dict, lcfg) -> dict:
    """The port's parameter tree over the same tensors as ``tree``
    (:mod:`harness.weights`): each NF4 leaf a ``QLinear4``."""
    from tpu_bitsandbytes_torch.models.layers import QLinear4

    def q(leaf):
        n, k2 = leaf["packed"].shape
        return QLinear4(packed=leaf["packed"], absmax=leaf["absmax"],
                        shape=(n, k2 * 2), blocksize=BLOCKSIZE,
                        quant_type="nf4", dtype=lcfg.dtype)

    layers = []
    for lw in tree["layers"]:
        layer = {"input_norm": lw["input_norm"],
                 "post_attn_norm": lw["post_attn_norm"],
                 "qkv_proj": q(lw["qkv_proj"]), "o_proj": q(lw["o_proj"])}
        if "experts" in lw:
            layer["moe"] = {"router": lw["router"], "experts": [
                {n: q(e[n]) for n in ("gateup_proj", "down_proj")}
                for e in lw["experts"]]}
        else:
            layer["gateup_proj"] = q(lw["gateup_proj"])
            layer["down_proj"] = q(lw["down_proj"])
        layers.append(layer)
    return {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "layers": layers, "lm_head": q(tree["lm_head"])}


def build_engine(tree: dict, cfg: dict, engine: dict, seed: int, device):
    """A ``DecodeEngine`` over the benchmark's weights with the
    configuration's serving options and the cell's engine settings: every
    key of the cell's ``engine`` is a ``DecodeEngine`` keyword, so a cell
    file can turn on any of its options (``prefill_chunk``,
    ``speculative``, ...)."""
    from tpu_bitsandbytes_torch.engine.engine import DecodeEngine
    lcfg = llama_config(cfg, engine["max_seq"])
    serving = cfg["serving"]
    eng = DecodeEngine(
        program_params(tree, lcfg), lcfg,
        quantized_kv=serving["quantized_kv"], seed=seed % 2 ** 63,
        runtime_cache=serving["runtime_cache"], device=device,
        cuda_graphs=serving["cuda_graphs"],
        window_stage=serving["window_stage"], **engine)
    return eng


def read_kv(engine, held: List[Tuple[int, torch.Tensor]]) -> list:
    """K and V as the engine's cache holds them, dequantized by the
    cache's own ``read``: for each (slot, absolute positions) of ``held``,
    a list over layers of (k, v), each [P, H_kv, D] in the cache's dtype.
    A ring cache keeps position p at index p % ring."""
    cache = engine.cache
    ring = cache.max_seq if cache.ring else None
    span = None if ring else max(int(p.max()) + 1 for _, p in held)
    out = [[] for _ in held]
    for layer in range(cache.k.shape[0]):
        k, v = cache.read(layer, span=span)          # [B, S, H, D]
        for j, (slot, pos) in enumerate(held):
            idx = (pos % ring if ring else pos).to(k.device)
            out[j].append((k[slot, idx].clone(), v[slot, idx].clone()))
        del k, v
    return out
