"""Llama-family model: explicit parameter dicts, quantizable, engine-ready.

Parameters follow the JAX package's tree: ``{"embed", "layers": [...],
"final_norm", "lm_head"?}`` with per-layer dicts whose linear leaves are raw
tensors, ``{"w", "b"}`` dicts or :class:`QLinear4`. Only the Llama trunk is
ported (RMSNorm, SiLU-gated MLP, full causal attention, optional q/k/v
biases and tied embeddings).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..ops.flash_decode import flash_decode_attention
from .layers import (QLinear4, apply_rope, gqa_attention, gqa_attention_hm,
                     gqa_attention_kv_quant, linear_apply, rms_norm,
                     rope_table)

Params = Dict[str, Any]

_LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    attention_bias: bool = False
    rope_scaling: Optional[Tuple] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @staticmethod
    def tiny() -> "LlamaConfig":
        return LlamaConfig(vocab_size=512, hidden_size=128,
                           intermediate_size=256, num_layers=2, num_heads=4,
                           num_kv_heads=2, max_seq_len=128)

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama2_13b() -> "LlamaConfig":
        return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                           num_layers=40, num_heads=40, num_kv_heads=40)


def _norm(x, weight, config: LlamaConfig):
    return rms_norm(x, weight, config.rms_eps)


def _embed_tokens(params, tokens, config: LlamaConfig):
    return params["embed"][tokens].to(config.dtype)


def finish_logits(logits, config: LlamaConfig):
    """The lm logits epilogue: f32."""
    return logits.to(torch.float32)


def head_logits(params, x, config: LlamaConfig):
    """LM head (tied or separate): x [..., H] -> f32 logits [..., V]."""
    head = params.get("lm_head")
    if head is None:
        logits = x @ params["embed"].t().to(x.dtype)
    else:
        logits = linear_apply(head, x)
    return finish_logits(logits, config)


def init_params(config: LlamaConfig, *, generator: torch.Generator,
                device) -> Params:
    """Random ``config.dtype`` params, normal(0, 0.02) weights and unit norm
    weights, drawn from ``generator`` (which must live on ``device``)."""
    dtype = config.dtype
    h, hd = config.hidden_size, config.hd
    n_q, n_kv = config.num_heads * hd, config.num_kv_heads * hd
    shapes = {
        "q_proj": (n_q, h), "k_proj": (n_kv, h), "v_proj": (n_kv, h),
        "o_proj": (h, n_q),
        "gate_proj": (config.intermediate_size, h),
        "up_proj": (config.intermediate_size, h),
        "down_proj": (h, config.intermediate_size),
    }

    def dense(shape):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * 0.02).to(dtype)

    biased = ("q_proj", "k_proj", "v_proj") if config.attention_bias else ()
    layers = []
    for _ in range(config.num_layers):
        layer = {}
        for name in _LINEAR_NAMES:
            w = dense(shapes[name])
            layer[name] = ({"w": w, "b": dense(shapes[name][:1])}
                           if name in biased else w)
        layer["input_norm"] = torch.ones((h,), dtype=dtype, device=device)
        layer["post_attn_norm"] = torch.ones((h,), dtype=dtype,
                                             device=device)
        layers.append(layer)
    params = {"embed": dense((config.vocab_size, h)), "layers": layers,
              "final_norm": torch.ones((h,), dtype=dtype, device=device)}
    if not config.tie_embeddings:
        params["lm_head"] = dense((config.vocab_size, h))
    return params


def quantize_params(params: Params, blocksize: int = 64,
                    quant_type: str = "nf4", dtype=torch.bfloat16,
                    compress_statistics: bool = False,
                    fuse_projections: bool = False) -> Params:
    """Replace every linear projection (and lm_head) with a
    :class:`QLinear4`. ``fuse_projections`` concatenates q/k/v into
    ``qkv_proj`` and gate/up into ``gateup_proj`` (4 matmuls per layer in
    place of 7); 4-bit blocks run along K, so fusing rows changes no
    quantized value."""
    def wb(leaf):
        return (leaf["w"], leaf.get("b")) if isinstance(leaf, dict) else (
            leaf, None)

    def q(leaves):
        ws, bs = zip(*(wb(l) for l in leaves))
        bias = None
        if any(b is not None for b in bs):
            bias = torch.cat([torch.zeros(w.shape[:1], dtype=w.dtype,
                                          device=w.device) if b is None
                              else b for w, b in zip(ws, bs)])
        return QLinear4.quantize(
            torch.cat(ws).to(torch.float32), blocksize=blocksize,
            quant_type=quant_type, dtype=dtype, bias=bias,
            compress_statistics=compress_statistics)

    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        ql = {k: v for k, v in layer.items() if k not in _LINEAR_NAMES}
        if fuse_projections:
            ql["qkv_proj"] = q([layer["q_proj"], layer["k_proj"],
                                layer["v_proj"]])
            ql["o_proj"] = q([layer["o_proj"]])
            ql["gateup_proj"] = q([layer["gate_proj"], layer["up_proj"]])
            ql["down_proj"] = q([layer["down_proj"]])
        else:
            for name in _LINEAR_NAMES:
                ql[name] = q([layer[name]])
        out["layers"].append(ql)
    if "lm_head" in params:
        out["lm_head"] = q([params["lm_head"]])
    return out


def build_runtime_cache(params: Params, fmt: str = "int8",
                        drop_packed: bool = False) -> Params:
    """Attach a runtime execution cache ("int8", "int4" or "bf16"; see
    :meth:`QLinear4.with_runtime_cache`) to every :class:`QLinear4`."""
    def conv(w):
        return (w.with_runtime_cache(fmt, drop_packed=drop_packed)
                if isinstance(w, QLinear4) else w)

    out = dict(params)
    out["layers"] = [{k: conv(v) for k, v in layer.items()}
                     for layer in params["layers"]]
    if "lm_head" in params:
        out["lm_head"] = conv(params["lm_head"])
    return out


def to_device(tree, device):
    """A copy of a parameter tree (dicts, lists, :class:`QLinear4` and
    other dataclasses, :class:`~.lora.LoRALinear`) with every tensor moved
    to ``device``."""
    from .lora import LoRALinear
    if isinstance(tree, LoRALinear):
        return LoRALinear(to_device(tree.base, device),
                          tree.lora_A.detach().to(device),
                          tree.lora_B.detach().to(device), tree.scaling)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree) if f.init})
    return tree


@functools.lru_cache(maxsize=8)
def _rope(config: LlamaConfig, device: torch.device):
    return rope_table(config.hd, config.max_seq_len, config.rope_theta,
                      config.rope_scaling, device=device)


def _qkv(layer, h, config: LlamaConfig):
    b, s, _ = h.shape
    hd, nh, nkv = config.hd, config.num_heads, config.num_kv_heads
    if "qkv_proj" in layer:
        qkv = linear_apply(layer["qkv_proj"], h)
        q, k, v = torch.split(qkv, [nh * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q = linear_apply(layer["q_proj"], h)
        k = linear_apply(layer["k_proj"], h)
        v = linear_apply(layer["v_proj"], h)
    return (q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd),
            v.reshape(b, s, nkv, hd))


def _mlp(layer, h):
    if "gateup_proj" in layer:
        gate, up = torch.chunk(linear_apply(layer["gateup_proj"], h), 2,
                               dim=-1)
    else:
        gate = linear_apply(layer["gate_proj"], h)
        up = linear_apply(layer["up_proj"], h)
    return linear_apply(layer["down_proj"], torch.nn.functional.silu(gate) * up)


def _layer(layer, x, cos, sin, config: LlamaConfig):
    """One transformer layer of the causal prefill: (x, (k, v))."""
    b, s, _ = x.shape
    h = _norm(x, layer["input_norm"], config)
    q, k, v = _qkv(layer, h, config)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = gqa_attention(q, k, v)
    x = x + linear_apply(layer["o_proj"], attn.reshape(b, s, -1))
    x = x + _mlp(layer, _norm(x, layer["post_attn_norm"], config))
    return x, (k, v)


def forward(params: Params, tokens: torch.Tensor, config: LlamaConfig,
            return_kv: bool = False, remat: bool = False):
    """Causal prefill forward. tokens [B, S] int32/int64 -> f32 logits
    [B, S, V], plus the per-layer post-RoPE ``(k, v)`` [B, S, H_kv, D] when
    ``return_kv``. ``remat`` runs each layer through
    :func:`torch.utils.checkpoint.checkpoint` (non-reentrant), as the JAX
    package wraps each layer in ``jax.checkpoint``: the backward pass
    recomputes the layer's activations instead of keeping them."""
    b, s = tokens.shape
    cos_full, sin_full = _rope(config, tokens.device)
    cos, sin = cos_full[None, :s], sin_full[None, :s]
    x = _embed_tokens(params, tokens, config)
    new_kv = []
    for layer in params["layers"]:
        if remat:
            x, kv = torch.utils.checkpoint.checkpoint(
                _layer, layer, x, cos, sin, config, use_reentrant=False)
        else:
            x, kv = _layer(layer, x, cos, sin, config)
        if return_kv:
            new_kv.append(kv)
    x = _norm(x, params["final_norm"], config)
    logits = head_logits(params, x, config)
    return (logits, new_kv) if return_kv else logits


def decode_layer(layer, x, cos, sin, positions, cache, li: int,
                 config: LlamaConfig, *, attn_span: Optional[int] = None,
                 slot: Optional[int] = None):
    """One transformer layer of the cached decode step.

    x [B, 1, H] with ``positions`` [B] int32, each slot's write position;
    or x [B, S, H] with ``positions`` [B, S], S tokens per slot (the
    speculative verify step), whose queries each see the keys up to their
    own position; or, with ``slot`` (chunked prefill), one request's chunk
    x [1, C, H] at ``positions`` [1, C], written into cache slot ``slot``,
    whose queries attend to that slot's history only. The new tokens' K/V
    are written into ``cache`` (in place) before attention; positions past
    ``max_seq`` are dropped. Routes as the JAX package routes: one token
    per slot over an int8 cache in a half-precision config attends through
    kernel K2
    (:func:`~tpu_bitsandbytes_torch.ops.flash_decode.flash_decode_attention`);
    an f32 config through :func:`gqa_attention_kv_quant` (``staged=``
    inside a decode chunk), or over the dequantized cache outside one;
    several queries per slot (a verify step, a slot's chunk) through
    :func:`gqa_attention_kv_quant` in half precision; an unquantized cache
    through :func:`gqa_attention_hm`. ``attn_span`` bounds the KV read to
    the first ``attn_span`` positions. Returns (x, cache).
    """
    b, s, _ = x.shape
    pos2d = positions if positions.dim() == 2 else positions[:, None]
    h = _norm(x, layer["input_norm"], config)
    q, k, v = _qkv(layer, h, config)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    half = config.dtype in (torch.bfloat16, torch.float16)
    if slot is None:
        cache = cache.write_decode(li, k, v, positions)
        kq, ks, vq, vs = cache.read_raw(li, attn_span)
    else:
        cache = cache.write_decode(li, k, v, pos2d, slots=slot)
        kq, ks, vq, vs = cache.read_raw_slot(li, slot, attn_span)
    staged = cache.read_stage(li) if cache.stage is not None else None
    if not cache.quantized:
        attn = gqa_attention_hm(q, kq, vq, causal_offset=pos2d)
    elif half and slot is None and s == 1:
        attn = flash_decode_attention(
            q[:, 0], kq, ks, vq, vs, positions,
            staged=staged)[:, None].to(q.dtype)
    elif staged is not None:
        attn = gqa_attention_kv_quant(q, kq, ks, vq, vs, causal_offset=pos2d,
                                      staged=staged)
    elif half:
        attn = gqa_attention_kv_quant(q, kq, ks, vq, vs, causal_offset=pos2d)
    else:
        k_all = (kq.to(torch.float32) * (ks[..., None] / 127.0)).to(
            config.dtype)
        v_all = (vq.to(torch.float32) * (vs[..., None] / 127.0)).to(
            config.dtype)
        attn = gqa_attention(q, k_all.transpose(1, 2), v_all.transpose(1, 2),
                             causal_offset=pos2d)
    x = x + linear_apply(layer["o_proj"], attn.reshape(b, s, -1))
    x = x + _mlp(layer, _norm(x, layer["post_attn_norm"], config))
    return x, cache


def decode_embed_and_rope(params, tokens, positions, config: LlamaConfig):
    """Decode-step prologue: tokens/positions [B] (one token per slot) or
    [B, S] (a prefill chunk) -> x [B, S, H] and cos/sin [B, S, D/2] at the
    positions. A chunk's padding past the rope table takes the table's last
    row: its rows are garbage no valid query attends to."""
    cos_full, sin_full = _rope(config, tokens.device)
    if tokens.dim() == 1:
        tokens, positions = tokens[:, None], positions[:, None]
    else:
        positions = positions.clamp(max=cos_full.shape[0] - 1)
    pos2d = positions.long()
    return (_embed_tokens(params, tokens, config), cos_full[pos2d],
            sin_full[pos2d])


def count_params(config: LlamaConfig) -> int:
    h, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    hd = config.hd
    per_layer = (config.num_heads * hd * h + 2 * config.num_kv_heads * hd * h
                 + h * config.num_heads * hd + 3 * h * i + 2 * h)
    total = config.num_layers * per_layer + v * h + h
    if not config.tie_embeddings:
        total += v * h
    return total
