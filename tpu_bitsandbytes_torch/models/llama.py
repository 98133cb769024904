"""Llama-family model: explicit parameter dicts, quantizable, engine-ready.

Parameters follow the JAX package's tree: ``{"embed", "layers": [...],
"final_norm", "lm_head"?}`` with per-layer dicts whose linear leaves are raw
tensors, ``{"w", "b"}`` dicts or :class:`QLinear4`. The families of the JAX
package's ``LlamaConfig`` run on one trunk: Llama and Qwen2 (q/k/v biases),
Mistral (sliding windows), Mixtral and Qwen2-MoE (a sparse-MoE MLP under
``layer["moe"]``), Gemma (GeLU-tanh, ``(1 + w)`` RMSNorm, scaled
embeddings), Gemma2 (sandwich norms, logit softcaps, alternating windows),
Phi-2 (LayerNorm over ``{"w", "b"}`` norm leaves, parallel blocks, a
non-gated MLP, partial rotary, an ``lm_head`` bias) and StableLM.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..ops.flash_decode import flash_decode_attention
from .layers import (QLinear4, apply_rope, gqa_attention, gqa_attention_hm,
                     gqa_attention_kv_quant, gqa_attention_kv_window,
                     layer_norm, linear_apply, rms_norm, rope_table)

Params = Dict[str, Any]

_LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj")
_MLP_NAMES = ("gate_proj", "up_proj", "down_proj")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The JAX package's ``LlamaConfig``, field for field (see its
    comments): ``sliding_window`` (with ``sliding_window_pattern`` or the
    per-layer ``sliding_window_layers``), the Gemma knobs (``hidden_act``,
    ``rms_weight_offset``, ``scale_embeddings``), Gemma2's (``post_norms``,
    the two softcaps, ``query_pre_attn_scalar``), the MoE MLP
    (``num_experts`` > 0, top-``experts_per_token``, ``moe_*``) and
    Phi/StableLM's (``norm_type``, ``parallel_blocks``, ``gated_mlp``,
    ``rope_partial_factor``)."""
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
    sliding_window: Optional[int] = None
    rope_scaling: Optional[Tuple] = None
    hidden_act: str = "silu"
    rms_weight_offset: float = 0.0
    scale_embeddings: bool = False
    post_norms: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    sliding_window_pattern: Optional[int] = None
    sliding_window_layers: Optional[Tuple[bool, ...]] = None
    num_experts: int = 0
    experts_per_token: int = 2
    moe_intermediate_size: Optional[int] = None
    moe_norm_topk: bool = True
    moe_shared_expert_size: Optional[int] = None
    norm_type: str = "rms"
    parallel_blocks: bool = False
    gated_mlp: bool = True
    rope_partial_factor: float = 1.0

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.hd * self.rope_partial_factor)

    # ---- the JAX package's presets ---------------------------------------
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

    @staticmethod
    def llama2_70b() -> "LlamaConfig":
        return LlamaConfig(hidden_size=8192, intermediate_size=28672,
                           num_layers=80, num_heads=64, num_kv_heads=8)

    @staticmethod
    def tiny_qwen2() -> "LlamaConfig":
        return dataclasses.replace(LlamaConfig.tiny(), rope_theta=1e6,
                                   attention_bias=True, tie_embeddings=True)

    @staticmethod
    def qwen2_5_0_5b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=151936, hidden_size=896,
                           intermediate_size=4864, num_layers=24,
                           num_heads=14, num_kv_heads=2, rope_theta=1e6,
                           rms_eps=1e-6, max_seq_len=32768,
                           attention_bias=True, tie_embeddings=True)

    @staticmethod
    def tiny_gemma() -> "LlamaConfig":
        return LlamaConfig(vocab_size=512, hidden_size=128,
                           intermediate_size=256, num_layers=2, num_heads=4,
                           num_kv_heads=1, head_dim=32, max_seq_len=128,
                           rms_eps=1e-6, tie_embeddings=True,
                           hidden_act="gelu_tanh", rms_weight_offset=1.0,
                           scale_embeddings=True)

    @staticmethod
    def gemma_2b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=256000, hidden_size=2048,
                           intermediate_size=16384, num_layers=18,
                           num_heads=8, num_kv_heads=1, head_dim=256,
                           max_seq_len=8192, rms_eps=1e-6,
                           tie_embeddings=True, hidden_act="gelu_tanh",
                           rms_weight_offset=1.0, scale_embeddings=True)

    @staticmethod
    def gemma_7b() -> "LlamaConfig":
        return dataclasses.replace(LlamaConfig.gemma_2b(), hidden_size=3072,
                                   intermediate_size=24576, num_layers=28,
                                   num_heads=16, num_kv_heads=16)

    @staticmethod
    def tiny_gemma2() -> "LlamaConfig":
        return dataclasses.replace(
            LlamaConfig.tiny_gemma(), num_layers=4, num_kv_heads=2,
            post_norms=True, attn_logit_softcap=50.0,
            final_logit_softcap=30.0, query_pre_attn_scalar=32.0,
            sliding_window=16, sliding_window_pattern=2)

    @staticmethod
    def gemma2_9b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=256000, hidden_size=3584,
                           intermediate_size=14336, num_layers=42,
                           num_heads=16, num_kv_heads=8, head_dim=256,
                           max_seq_len=8192, rms_eps=1e-6,
                           tie_embeddings=True, hidden_act="gelu_tanh",
                           rms_weight_offset=1.0, scale_embeddings=True,
                           post_norms=True, attn_logit_softcap=50.0,
                           final_logit_softcap=30.0,
                           query_pre_attn_scalar=256.0, sliding_window=4096,
                           sliding_window_pattern=2)

    @staticmethod
    def tiny_mixtral() -> "LlamaConfig":
        return dataclasses.replace(LlamaConfig.tiny(), num_experts=4,
                                   experts_per_token=2)

    @staticmethod
    def mixtral_8x7b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=32000, hidden_size=4096,
                           intermediate_size=14336, num_layers=32,
                           num_heads=32, num_kv_heads=8, max_seq_len=32768,
                           rope_theta=1e6, num_experts=8,
                           experts_per_token=2)

    @staticmethod
    def tiny_qwen2_moe() -> "LlamaConfig":
        return dataclasses.replace(
            LlamaConfig.tiny(), rope_theta=1e6, attention_bias=True,
            num_experts=4, experts_per_token=2, moe_intermediate_size=96,
            moe_norm_topk=False, moe_shared_expert_size=160)

    @staticmethod
    def tiny_phi2() -> "LlamaConfig":
        return LlamaConfig(vocab_size=512, hidden_size=128,
                           intermediate_size=512, num_layers=2, num_heads=4,
                           num_kv_heads=4, max_seq_len=128,
                           norm_type="layernorm", parallel_blocks=True,
                           gated_mlp=False, hidden_act="gelu_tanh",
                           rope_partial_factor=0.5, attention_bias=True)

    @staticmethod
    def tiny_stablelm() -> "LlamaConfig":
        return dataclasses.replace(LlamaConfig.tiny(), norm_type="layernorm",
                                   rope_partial_factor=0.25)

    @staticmethod
    def tiny_mistral() -> "LlamaConfig":
        return dataclasses.replace(LlamaConfig.tiny(), sliding_window=16)

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=32000, hidden_size=4096,
                           intermediate_size=14336, num_layers=32,
                           num_heads=32, num_kv_heads=8, max_seq_len=32768,
                           sliding_window=4096)

    @staticmethod
    def qwen2_5_7b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=152064, hidden_size=3584,
                           intermediate_size=18944, num_layers=28,
                           num_heads=28, num_kv_heads=4, rope_theta=1e6,
                           rms_eps=1e-6, max_seq_len=32768,
                           attention_bias=True)


def _norm(x, leaf, config: LlamaConfig):
    """RMSNorm over a weight leaf, or LayerNorm over a ``{"w", "b"}`` leaf
    (``norm_type="layernorm"``)."""
    if config.norm_type == "layernorm":
        return layer_norm(x, leaf["w"], leaf["b"], config.rms_eps)
    return rms_norm(x, leaf, config.rms_eps, config.rms_weight_offset)


def _act(config: LlamaConfig):
    if config.hidden_act == "silu":
        return torch.nn.functional.silu
    if config.hidden_act in ("gelu_tanh", "gelu_pytorch_tanh"):
        return functools.partial(torch.nn.functional.gelu,
                                 approximate="tanh")
    if config.hidden_act == "gelu":
        return torch.nn.functional.gelu
    raise ValueError(f"unknown hidden_act: {config.hidden_act!r}")


def _no_wrap(w, row: bool = False):
    return w


def _no_reduce(partial, w):
    return partial


def _expert(exp, x, act, wrap=_no_wrap):
    """One gated MLP (an expert, or the shared expert): fused
    ``gateup_proj`` or separate gate/up, then ``down_proj`` (a
    row-parallel shard's partial under tensor parallelism: the caller
    reduces it)."""
    if "gateup_proj" in exp:
        gate, up = torch.chunk(linear_apply(wrap(exp["gateup_proj"]), x), 2,
                               dim=-1)
    else:
        gate = linear_apply(wrap(exp["gate_proj"]), x)
        up = linear_apply(wrap(exp["up_proj"]), x)
    return linear_apply(wrap(exp["down_proj"], row=True), act(gate) * up)


def moe_routing(router: torch.Tensor, x: torch.Tensor,
                config: LlamaConfig):
    """The router of :func:`_moe_mlp`: f32 logits [.., E], a softmax, the
    top-k (ties to the lower expert index, as ``jax.lax.top_k``: a stable
    sort of the negated probabilities), renormalized when
    ``moe_norm_topk``. Returns (experts [.., k] int64, weights [.., k]
    f32, probs [.., E] f32)."""
    logits = x.to(torch.float32) @ router.to(torch.float32).t()
    probs = torch.softmax(logits, dim=-1)
    k = config.experts_per_token
    top = torch.argsort(-probs, dim=-1, stable=True)[..., :k]
    topv = probs.gather(-1, top)
    if config.moe_norm_topk:            # Mixtral renormalizes; Qwen2-MoE not
        topv = topv / topv.sum(dim=-1, keepdim=True)
    return top, topv, probs


def _moe_mlp(moe, x, config: LlamaConfig, wrap=_no_wrap,
             reduce_fn=_no_reduce):
    """The sparse-MoE MLP, as the JAX package computes it: every expert
    runs on every token and is scaled by its routing weight (zero where
    not chosen) cast to x's dtype, and the experts are summed in index
    order in x's dtype; Qwen2-MoE adds its shared expert scaled by
    ``sigmoid(x @ shared_gate.T)`` (f32, cast to x's dtype). Under tensor
    parallelism (``wrap``/``reduce_fn``) the experts' row-parallel
    partials are summed first and reduced once (experts carry no bias)."""
    top, topv, probs = moe_routing(moe["router"], x, config)
    w = torch.zeros_like(probs).scatter(-1, top, topv)      # [.., E]
    act = _act(config)
    out = None
    for e, exp in enumerate(moe["experts"]):
        d = _expert(exp, x, act, wrap) * w[..., e:e + 1].to(x.dtype)
        out = d if out is None else out + d
    if "shared_expert" in moe:
        g = torch.sigmoid(x.to(torch.float32)
                          @ moe["shared_gate"].to(torch.float32).t())
        out = out + _expert(moe["shared_expert"], x, act, wrap) * g.to(
            x.dtype)
    return reduce_fn(out, None)


def _embed_tokens(params, tokens, config: LlamaConfig):
    x = params["embed"][tokens].to(config.dtype)
    if config.scale_embeddings:
        # Gemma: sqrt(H) rounded to the dtype, as a host scalar (a tensor
        # copied to the device cannot be captured in a chunk's graph); the
        # product of two values of the dtype is exact in f32, rounded once
        x = x * float(torch.tensor(config.hidden_size ** 0.5,
                                   dtype=config.dtype))
    return x


def _layer_window(config: LlamaConfig, li: int) -> Optional[int]:
    """Layer ``li``'s attention window: the explicit
    ``sliding_window_layers`` first, then Gemma2's pattern (layers with
    ``li % p == p - 1`` attend globally), else every layer windowed."""
    if config.sliding_window is None:
        return None
    if config.sliding_window_layers is not None:
        return (config.sliding_window
                if config.sliding_window_layers[li] else None)
    p = config.sliding_window_pattern
    if p is None:
        return config.sliding_window
    return None if li % p == p - 1 else config.sliding_window


def _attn_scale(config: LlamaConfig) -> Optional[float]:
    """Gemma2's ``query_pre_attn_scalar ** -0.5``; None: 1/sqrt(head_dim)."""
    if config.query_pre_attn_scalar is not None:
        return config.query_pre_attn_scalar ** -0.5
    return None


def finish_logits(logits, config: LlamaConfig):
    """The lm logits epilogue: f32, then Gemma2's final softcap."""
    logits = logits.to(torch.float32)
    cap = config.final_logit_softcap
    if cap is not None:
        logits = torch.tanh(logits / cap) * cap
    return logits


def head_logits(params, x, config: LlamaConfig):
    """LM head (tied or separate, Phi-2's with a bias): x [..., H] -> f32
    logits [..., V]."""
    head = params.get("lm_head")
    if head is None:
        logits = x @ params["embed"].t().to(x.dtype)
    else:
        logits = linear_apply(head, x)
    return finish_logits(logits, config)


def init_params(config: LlamaConfig, *, generator: torch.Generator,
                device) -> Params:
    """Random ``config.dtype`` params, normal(0, 0.02) weights, unit norm
    weights (zero LayerNorm biases), drawn from ``generator`` (which must
    live on ``device``); the JAX package's tree for every family (MoE
    experts under ``layer["moe"]``, no gate without ``gated_mlp``, no
    ``post_attn_norm`` with ``parallel_blocks``, Gemma2's ``pre_ffn_norm``
    and ``post_ffn_norm``)."""
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

    def ones():
        return torch.ones((h,), dtype=dtype, device=device)

    def norm_leaf():
        if config.norm_type == "layernorm":
            return {"w": ones(), "b": torch.zeros((h,), dtype=dtype,
                                                  device=device)}
        return ones()

    def mlp(i):
        return {"gate_proj": dense((i, h)), "up_proj": dense((i, h)),
                "down_proj": dense((h, i))}

    biased = ("q_proj", "k_proj", "v_proj") if config.attention_bias else ()
    layers = []
    for _ in range(config.num_layers):
        layer = {}
        for name in _LINEAR_NAMES:
            if name in _MLP_NAMES and (config.num_experts > 0 or (
                    not config.gated_mlp and name == "gate_proj")):
                continue
            w = dense(shapes[name])
            layer[name] = ({"w": w, "b": dense(shapes[name][:1])}
                           if name in biased else w)
        if config.num_experts > 0:
            mi = config.moe_intermediate_size or config.intermediate_size
            layer["moe"] = {
                "router": dense((config.num_experts, h)),
                "experts": [mlp(mi) for _ in range(config.num_experts)]}
            if config.moe_shared_expert_size:
                layer["moe"]["shared_expert"] = mlp(
                    config.moe_shared_expert_size)
                layer["moe"]["shared_gate"] = dense((1, h))
        layer["input_norm"] = norm_leaf()
        if not config.parallel_blocks:
            layer["post_attn_norm"] = norm_leaf()
        if config.post_norms:
            layer["pre_ffn_norm"] = ones()
            layer["post_ffn_norm"] = ones()
        layers.append(layer)
    params = {"embed": dense((config.vocab_size, h)), "layers": layers,
              "final_norm": norm_leaf()}
    if not config.tie_embeddings:
        params["lm_head"] = dense((config.vocab_size, h))
    return params


def _interleave_rows(mats, tp: int) -> torch.Tensor:
    """Concatenate [N_i, ...] tensors so that each of ``tp`` equal dim-0
    shards holds its share of every one: (q_0; k_0; v_0; q_1; k_1; v_1;
    ...), x_i being x's i-th row shard. tp = 1 is a plain concatenation."""
    for m in mats:
        if m.shape[0] % tp != 0:
            raise ValueError(f"fused projection rows {m.shape[0]} not "
                             f"divisible by tp={tp}")
    if tp == 1:
        return torch.cat(mats)
    segs = []
    for i in range(tp):
        for m in mats:
            n_t = m.shape[0] // tp
            segs.append(m[i * n_t:(i + 1) * n_t])
    return torch.cat(segs)


def quantize_params(params: Params, blocksize: int = 64,
                    quant_type: str = "nf4", dtype=torch.bfloat16,
                    compress_statistics: bool = False,
                    fuse_projections: bool = False, tp: int = 1) -> Params:
    """Replace every linear projection (the experts', and lm_head) with a
    :class:`QLinear4`; MoE routers and shared-expert gates stay in full
    precision. ``fuse_projections`` concatenates q/k/v into ``qkv_proj``
    and each gated MLP's (and expert's) gate/up into ``gateup_proj``;
    4-bit blocks run along K, so fusing rows changes no quantized value.
    ``tp``: lay the fused rows (and their biases) out for a tp-way mesh
    (:func:`_interleave_rows`), so that a column-parallel shard holds
    exactly (q_i; k_i; v_i) and (gate_i; up_i); the layout belongs to that
    tp, and tp = 1 is the single-device concatenation."""
    def wb(leaf):
        return (leaf["w"], leaf.get("b")) if isinstance(leaf, dict) else (
            leaf, None)

    def q(*leaves):
        ws, bs = zip(*(wb(l) for l in leaves))
        bias = None
        if any(b is not None for b in bs):
            bias = _interleave_rows(
                [torch.zeros(w.shape[:1], dtype=w.dtype, device=w.device)
                 if b is None else b for w, b in zip(ws, bs)],
                tp if len(ws) > 1 else 1)
        return QLinear4.quantize(
            _interleave_rows(list(ws), tp if len(ws) > 1 else 1).to(
                torch.float32), blocksize=blocksize,
            quant_type=quant_type, dtype=dtype, bias=bias,
            compress_statistics=compress_statistics)

    def q_mlp(m):
        """A gated MLP's (or expert's) linears, fused or not; a non-gated
        MLP's up/down."""
        if fuse_projections and "gate_proj" in m:
            return {"gateup_proj": q(m["gate_proj"], m["up_proj"]),
                    "down_proj": q(m["down_proj"])}
        return {n: q(m[n]) for n in _MLP_NAMES if n in m}

    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        ql = {k: v for k, v in layer.items() if k not in _LINEAR_NAMES}
        if "moe" in layer:
            moe = layer["moe"]
            ql["moe"] = {"router": moe["router"],
                         "experts": [q_mlp(e) for e in moe["experts"]]}
            if "shared_expert" in moe:
                ql["moe"]["shared_expert"] = q_mlp(moe["shared_expert"])
                ql["moe"]["shared_gate"] = moe["shared_gate"]
        else:
            ql.update(q_mlp(layer))
        if fuse_projections:
            ql["qkv_proj"] = q(layer["q_proj"], layer["k_proj"],
                               layer["v_proj"])
            ql["o_proj"] = q(layer["o_proj"])
        else:
            for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
                ql[name] = q(layer[name])
        out["layers"].append(ql)
    if "lm_head" in params:
        out["lm_head"] = q(params["lm_head"])
    return out


def build_runtime_cache(params: Params, fmt: str = "int8",
                        drop_packed: bool = False) -> Params:
    """Attach a runtime execution cache ("int8", "int4" or "bf16"; see
    :meth:`QLinear4.with_runtime_cache`) to every :class:`QLinear4` of the
    layers (experts included) and the lm_head."""
    def conv(t):
        if isinstance(t, QLinear4):
            return t.with_runtime_cache(fmt, drop_packed=drop_packed)
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v) for v in t]
        return t

    out = dict(params)
    out["layers"] = conv(params["layers"])
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
    return rope_table(config.rotary_dim, config.max_seq_len,
                      config.rope_theta, config.rope_scaling, device=device)


def _qkv(layer, h, config: LlamaConfig, n_heads: Optional[int] = None,
         n_kv: Optional[int] = None, wrap=_no_wrap):
    """q [B, S, n_heads, D], k and v [B, S, n_kv, D]: the config's head
    counts, or a tensor-parallel shard's local ones."""
    b, s, _ = h.shape
    hd = config.hd
    nh = config.num_heads if n_heads is None else n_heads
    nkv = config.num_kv_heads if n_kv is None else n_kv
    if "qkv_proj" in layer:
        qkv = linear_apply(wrap(layer["qkv_proj"]), h)
        q, k, v = torch.split(qkv, [nh * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q = linear_apply(wrap(layer["q_proj"]), h)
        k = linear_apply(wrap(layer["k_proj"]), h)
        v = linear_apply(wrap(layer["v_proj"]), h)
    return (q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd),
            v.reshape(b, s, nkv, hd))


def _mlp(layer, h, config: LlamaConfig, wrap=_no_wrap,
         reduce_fn=_no_reduce):
    if "moe" in layer:
        return _moe_mlp(layer["moe"], h, config, wrap, reduce_fn)
    if not config.gated_mlp:            # Phi-2: up -> act -> down
        d = linear_apply(wrap(layer["down_proj"], row=True),
                         _act(config)(linear_apply(wrap(layer["up_proj"]),
                                                   h)))
    else:
        d = _expert(layer, h, _act(config), wrap)
    return reduce_fn(d, layer["down_proj"])


def _block_out(layer, x, h, o, config: LlamaConfig, wrap=_no_wrap,
               reduce_fn=_no_reduce):
    """A layer after its attention: ``o`` the o_proj output (a
    row-parallel partial, which ``reduce_fn`` reduces and adds the bias
    to once), ``h`` the input norm's output. Gemma2 norms the attention
    and MLP outputs (``post_attn_norm``, ``post_ffn_norm``) and the MLP's
    input with ``pre_ffn_norm``; a parallel block (Phi-2) returns x + o +
    mlp(h)."""
    eps, off = config.rms_eps, config.rms_weight_offset
    o = reduce_fn(o, layer["o_proj"])
    if config.post_norms:
        o = rms_norm(o, layer["post_attn_norm"], eps, off)
    if not config.parallel_blocks:
        x = x + o
        h = _norm(x, layer["pre_ffn_norm" if config.post_norms
                  else "post_attn_norm"], config)
    d = _mlp(layer, h, config, wrap, reduce_fn)
    if config.post_norms:
        d = rms_norm(d, layer["post_ffn_norm"], eps, off)
    if config.parallel_blocks:
        return x + o + d
    return x + d


def _layer(layer, x, cos, sin, config: LlamaConfig, li: int,
           n_heads: Optional[int] = None, n_kv: Optional[int] = None,
           wrap=_no_wrap, reduce_fn=_no_reduce):
    """One transformer layer of the causal prefill: (x, (k, v)). The
    tensor-parallel hooks (the JAX package's ``prefill_layer``):
    ``wrap(w, row=False)`` adapts a weight leaf to this shard,
    ``reduce_fn(partial, w)`` reduces a row-parallel partial and adds its
    bias once; ``n_heads``/``n_kv`` are the shard's head counts."""
    b, s, _ = x.shape
    h = _norm(x, layer["input_norm"], config)
    q, k, v = _qkv(layer, h, config, n_heads, n_kv, wrap)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = gqa_attention(q, k, v, window=_layer_window(config, li),
                         scale=_attn_scale(config),
                         softcap=config.attn_logit_softcap)
    o = linear_apply(wrap(layer["o_proj"], row=True), attn.reshape(b, s, -1))
    return _block_out(layer, x, h, o, config, wrap, reduce_fn), (k, v)


def prefill_hidden(params: Params, tokens: torch.Tensor,
                   config: LlamaConfig, **hooks):
    """The causal prefill's layers without the final norm and the head:
    tokens [B, S] -> (x [B, S, H], the per-layer post-RoPE ``(k, v)``).
    ``hooks``: :func:`_layer`'s tensor-parallel hooks (the JAX package's
    ``prefill_layer`` loop in its mesh prefill)."""
    s = tokens.shape[1]
    cos_full, sin_full = _rope(config, tokens.device)
    cos, sin = cos_full[None, :s], sin_full[None, :s]
    x = _embed_tokens(params, tokens, config)
    new_kv = []
    for li, layer in enumerate(params["layers"]):
        x, kv = _layer(layer, x, cos, sin, config, li, **hooks)
        new_kv.append(kv)
    return x, new_kv


def forward(params: Params, tokens: torch.Tensor, config: LlamaConfig,
            return_kv: bool = False, remat: bool = False, tp=None):
    """Causal prefill forward. tokens [B, S] int32/int64 -> f32 logits
    [B, S, V], plus the per-layer post-RoPE ``(k, v)`` [B, S, H_kv, D] when
    ``return_kv``. ``remat`` runs each layer through
    :func:`torch.utils.checkpoint.checkpoint` (non-reentrant), as the JAX
    package wraps each layer in ``jax.checkpoint``: the backward pass
    recomputes the layer's activations instead of keeping them. ``tp``: a
    tensor-parallel context (``parallel.tp.TPContext``, or the training
    step's) whose hooks run the layers on this rank's shards and whose
    ``head_logits`` gathers the head's."""
    b, s = tokens.shape
    hooks = {} if tp is None else tp.hooks
    cos_full, sin_full = _rope(config, tokens.device)
    cos, sin = cos_full[None, :s], sin_full[None, :s]
    x = _embed_tokens(params, tokens, config)
    new_kv = []
    for li, layer in enumerate(params["layers"]):
        if remat:
            x, kv = torch.utils.checkpoint.checkpoint(
                _layer, layer, x, cos, sin, config, li, use_reentrant=False,
                **hooks)
        else:
            x, kv = _layer(layer, x, cos, sin, config, li, **hooks)
        if return_kv:
            new_kv.append(kv)
    x = _norm(x, params["final_norm"], config)
    logits = (head_logits(params, x, config) if tp is None
              else tp.head_logits(params, x, config))
    return (logits, new_kv) if return_kv else logits


def decode_layer(layer, x, cos, sin, positions, cache, li: int,
                 config: LlamaConfig, *, attn_span: Optional[int] = None,
                 slot: Optional[int] = None, attn_start: int = 0,
                 n_heads: Optional[int] = None, n_kv: Optional[int] = None,
                 wrap=_no_wrap, reduce_fn=_no_reduce):
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
    (:func:`~tpu_bitsandbytes_torch.ops.flash_decode.flash_decode_attention`,
    one launch computing the staged chain :func:`gqa_attention_kv_quant`,
    the JAX package's default there);
    inside a compact-window chunk (``cache.stage.cut > 0``) K2 reads the
    window's head as its main block and the tail as its staged block. An
    f32 config attends through :func:`gqa_attention_kv_window` inside a
    compact-window chunk, :func:`gqa_attention_kv_quant` (``staged=``)
    inside a two-block one, or over the dequantized cache outside one;
    several queries per slot (a verify step, a slot's chunk) through
    :func:`gqa_attention_kv_quant` in half precision; an unquantized cache
    through :func:`gqa_attention_hm`. ``attn_span`` and ``attn_start``
    bound the KV read to positions [attn_start, attn_span) (a
    fully-windowed model's lower bound). A ring cache (``cache.ring``) is
    read whole, never by K2, under the ring mask. Each layer attends with
    its window (:func:`_layer_window`), :func:`_attn_scale` and the
    attention softcap. The tensor-parallel hooks are :func:`_layer`'s:
    under them ``cache`` holds this shard's ``n_kv`` heads. Returns (x,
    cache).
    """
    b, s, _ = x.shape
    pos2d = positions if positions.dim() == 2 else positions[:, None]
    h = _norm(x, layer["input_norm"], config)
    q, k, v = _qkv(layer, h, config, n_heads, n_kv, wrap)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    half = config.dtype in (torch.bfloat16, torch.float16)
    ring = cache.max_seq if cache.ring else None
    if ring is not None:
        # the whole ring is read; the ring mask maps entries to positions
        attn_span, attn_start = None, 0
    if slot is None:
        cache = cache.write_decode(li, k, v, positions)
        kq, ks, vq, vs = cache.read_raw(li, attn_span, attn_start)
    else:
        cache = cache.write_decode(li, k, v, pos2d, slots=slot)
        kq, ks, vq, vs = cache.read_raw_slot(li, slot, attn_span, attn_start)
    st = cache.stage
    staged = cache.read_stage(li) if st is not None else None
    kw = dict(window=_layer_window(config, li), scale=_attn_scale(config),
              softcap=config.attn_logit_softcap, kpos_start=attn_start)
    if not cache.quantized:
        attn = gqa_attention_hm(q, kq, vq, causal_offset=pos2d, ring=ring,
                                **kw)
    elif half and slot is None and s == 1 and ring is None:
        if st is not None and st.cut > 0:
            # the window's head holds the span's bytes at the span's
            # positions: K2 reads it as its main block, the tail staged
            wk, wks, wv, wvs = cache.read_window(li)
            c = st.cut
            kq, ks, vq, vs = (wk[:, :, :c], wks[:, :, :c], wv[:, :, :c],
                              wvs[:, :, :c])
        attn = flash_decode_attention(
            q[:, 0], kq, ks, vq, vs, positions, staged=staged,
            **kw)[:, None].to(q.dtype)
    elif st is not None and st.cut > 0:
        kw.pop("kpos_start")
        attn = gqa_attention_kv_window(
            q, *cache.read_window(li), cut=st.cut, attn_start=attn_start,
            len0=st.len0, step=st.step, causal_offset=pos2d, **kw)
    elif staged is not None:
        attn = gqa_attention_kv_quant(q, kq, ks, vq, vs, causal_offset=pos2d,
                                      staged=staged, **kw)
    elif half:
        attn = gqa_attention_kv_quant(q, kq, ks, vq, vs, causal_offset=pos2d,
                                      ring=ring, **kw)
    else:
        k_all = (kq.to(torch.float32) * (ks[..., None] / 127.0)).to(
            config.dtype)
        v_all = (vq.to(torch.float32) * (vs[..., None] / 127.0)).to(
            config.dtype)
        attn = gqa_attention_hm(q, k_all, v_all, causal_offset=pos2d,
                                ring=ring, **kw)
    o = linear_apply(wrap(layer["o_proj"], row=True), attn.reshape(b, s, -1))
    return _block_out(layer, x, h, o, config, wrap, reduce_fn), cache


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
