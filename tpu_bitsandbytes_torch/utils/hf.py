"""HuggingFace checkpoints into the port's trees (local files, no network).

Maps a ``transformers`` config onto :class:`~..models.llama.LlamaConfig`
(Llama, Qwen2 with ``layer_types``, Mistral, Mixtral, Qwen2-MoE, Gemma,
Gemma2, Phi-3, Phi-2 and StableLM) and a state dict (torch tensors or numpy
arrays) onto the Llama parameter tree, quantized to NF4 layer by layer on
request; GPT-2's state dict onto :class:`~..models.gpt2.GPT2LMHeadModel`.
The JAX package's ``utils/hf.py``, name for name. ``transformers`` is
imported only by :func:`load_llama_from_pretrained` given a path.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..functional import to_tensor
from ..models import llama
from ..models.layers import QLinear4

__all__ = ["llama_config_from_hf", "llama_params_from_state_dict",
           "gpt2_params_from_state_dict", "load_llama_from_pretrained"]


def _t(t) -> torch.Tensor:
    """A CPU f32 tensor from a torch tensor or an array."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32)
    return to_tensor(np.asarray(t, np.float32))


def llama_config_from_hf(hf_config) -> llama.LlamaConfig:
    """A :class:`LlamaConfig` from a ``transformers`` config object or dict
    of one of the ten families, as the JAX package maps it."""
    get = (hf_config.get if isinstance(hf_config, dict)
           else lambda k, d=None: getattr(hf_config, k, d))
    model_type = get("model_type")
    attention_bias = get("attention_bias")
    if attention_bias is None:
        # Qwen2's and Phi-2's configs have no attention_bias: always biased
        attention_bias = model_type in ("qwen2", "qwen2_moe", "phi")
    # Qwen2 gates its window behind use_sliding_window; layer_types (per
    # layer, from transformers) say which layers are windowed
    sliding_window = get("sliding_window")
    sliding_window_layers = None
    if sliding_window is not None and get("use_sliding_window") is False:
        sliding_window = None
    layer_types = get("layer_types")
    if sliding_window is not None and layer_types:
        sliding_window_layers = tuple(
            t == "sliding_attention" for t in layer_types)
        if not any(sliding_window_layers):
            sliding_window = sliding_window_layers = None
    rs = get("rope_scaling")
    rope_scaling = None
    if rs:
        rs_get = (rs.get if isinstance(rs, dict)
                  else lambda k, d=None: getattr(rs, k, d))
        kind = rs_get("rope_type") or rs_get("type")
        if kind == "llama3":
            rope_scaling = ("llama3", rs_get("factor"),
                            rs_get("low_freq_factor"),
                            rs_get("high_freq_factor"),
                            rs_get("original_max_position_embeddings"))
        elif kind == "linear":
            rope_scaling = ("linear", rs_get("factor"))
        elif kind not in (None, "default"):
            raise ValueError(f"unsupported rope_scaling type: {kind!r}")
    gemma2 = model_type == "gemma2"
    gemma = model_type == "gemma" or gemma2
    hidden_act = get("hidden_activation") or get("hidden_act") or "silu"
    if hidden_act == "silu" and gemma:
        hidden_act = "gelu_pytorch_tanh"
    if gemma2 and sliding_window is None:
        sliding_window = get("sliding_window")
    phi = model_type == "phi"
    qwen2_moe = model_type == "qwen2_moe"
    num_experts = (get("num_experts") if qwen2_moe
                   else get("num_local_experts")) or 0
    return llama.LlamaConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=get("num_attention_heads"),
        num_kv_heads=get("num_key_value_heads",
                         get("num_attention_heads")),
        head_dim=get("head_dim"),
        rope_theta=get("rope_theta", 10000.0),
        rms_eps=(get("layer_norm_eps") or get("rms_norm_eps") or 1e-5),
        max_seq_len=get("max_position_embeddings", 2048),
        tie_embeddings=bool(get("tie_word_embeddings", False) or gemma),
        attention_bias=bool(attention_bias),
        sliding_window=sliding_window,
        rope_scaling=rope_scaling,
        hidden_act=("silu" if hidden_act == "silu" else
                    {"gelu_pytorch_tanh": "gelu_tanh",
                     "gelu_tanh": "gelu_tanh",
                     "gelu_new": "gelu_tanh",
                     "gelu": "gelu"}[hidden_act]),
        rms_weight_offset=1.0 if gemma else 0.0,
        scale_embeddings=gemma,
        post_norms=gemma2,
        attn_logit_softcap=get("attn_logit_softcapping") if gemma2 else None,
        final_logit_softcap=(get("final_logit_softcapping")
                             if gemma2 else None),
        query_pre_attn_scalar=(float(get("query_pre_attn_scalar"))
                               if gemma2 else None),
        sliding_window_pattern=(
            2 if (gemma2 and sliding_window_layers is None) else None),
        sliding_window_layers=sliding_window_layers,
        num_experts=num_experts,
        experts_per_token=get("num_experts_per_tok", 2) or 2,
        moe_intermediate_size=get("moe_intermediate_size"),
        moe_norm_topk=bool(get("norm_topk_prob", True)
                           if qwen2_moe else True),
        moe_shared_expert_size=(get("shared_expert_intermediate_size")
                                if qwen2_moe else None),
        norm_type="layernorm" if model_type in ("phi", "stablelm") else "rms",
        parallel_blocks=phi,
        gated_mlp=not phi,
        rope_partial_factor=float(get("partial_rotary_factor", 1.0) or 1.0),
    )


def llama_params_from_state_dict(state_dict: Dict[str, Any],
                                 config: llama.LlamaConfig,
                                 dtype=torch.bfloat16,
                                 quantize: bool = False,
                                 blocksize: int = 64,
                                 quant_type: str = "nf4",
                                 compress_statistics: bool = False,
                                 device="cpu") -> dict:
    """The port's Llama tree (on ``device``) from an HF state dict: the
    layers of every family (Phi-3's fused ``qkv_proj``/``gate_up_proj``
    split into their parts, Mixtral's ``block_sparse_moe`` and Qwen2-MoE's
    ``mlp.experts`` under ``layer["moe"]`` with f32 routers, Phi-2's
    ``dense``/``fc1``/``fc2`` and ``final_layernorm``, Gemma2's sandwich
    norms). ``quantize``: each linear becomes a :class:`QLinear4` as it is
    converted, so the full-precision copy never exceeds one weight."""
    def grab(name):
        for prefix in ("model.", ""):
            if prefix + name in state_dict:
                return _t(state_dict[prefix + name])
        raise KeyError(name)

    def has(name):
        return any(p + name in state_dict for p in ("model.", ""))

    def leaf(w, b=None):
        if quantize:
            return QLinear4.quantize(
                w.to(device), blocksize=blocksize, quant_type=quant_type,
                dtype=dtype, bias=None if b is None else b.to(device),
                compress_statistics=compress_statistics)
        w = w.to(device, dtype)
        return w if b is None else {"w": w, "b": b.to(device)}

    def lin(name):
        try:
            b = grab(name + ".bias").to(dtype)
        except KeyError:
            b = None
        return leaf(grab(name + ".weight"), b)

    def norm(name):
        w = grab(name + ".weight").to(device, dtype)
        if config.norm_type == "layernorm":
            return {"w": w, "b": grab(name + ".bias").to(device, dtype)}
        return w

    def lin_split(name, sizes, parts):
        w = grab(name + ".weight")
        return {part: leaf(wp)
                for part, wp in zip(parts, torch.split(w, sizes, dim=0))}

    def router(name):
        return grab(name).to(device)

    def experts(mp, gate, up, down):
        return [{"gate_proj": lin(mp + f"experts.{e}.{gate}"),
                 "up_proj": lin(mp + f"experts.{e}.{up}"),
                 "down_proj": lin(mp + f"experts.{e}.{down}")}
                for e in range(config.num_experts)]

    nq = config.num_heads * config.hd
    nkv = config.num_kv_heads * config.hd
    layers = []
    for li in range(config.num_layers):
        p = f"layers.{li}."
        if has(p + "self_attn.qkv_proj.weight"):       # Phi-3
            entry = lin_split(p + "self_attn.qkv_proj", [nq, nkv, nkv],
                              ["q_proj", "k_proj", "v_proj"])
        else:
            entry = {n: lin(p + "self_attn." + n)
                     for n in ("q_proj", "k_proj", "v_proj")}
        entry["o_proj"] = lin(p + ("self_attn.dense" if config.parallel_blocks
                                   else "self_attn.o_proj"))
        entry["input_norm"] = norm(p + "input_layernorm")
        if not config.parallel_blocks:
            entry["post_attn_norm"] = norm(p + "post_attention_layernorm")
        if config.num_experts > 0 and has(p + "block_sparse_moe.gate.weight"):
            mp = p + "block_sparse_moe."                # Mixtral
            entry["moe"] = {"router": router(mp + "gate.weight"),
                            "experts": experts(mp, "w1", "w3", "w2")}
        elif config.num_experts > 0 and has(
                p + "mlp.experts.0.gate_proj.weight"):  # Qwen2-MoE
            mp = p + "mlp."
            entry["moe"] = {
                "router": router(mp + "gate.weight"),
                "experts": experts(mp, "gate_proj", "up_proj", "down_proj"),
                "shared_expert": {
                    n: lin(mp + "shared_expert." + n)
                    for n in ("gate_proj", "up_proj", "down_proj")},
                "shared_gate": router(mp + "shared_expert_gate.weight")}
        elif has(p + "mlp.gate_up_proj.weight"):         # Phi-3
            i = config.intermediate_size
            entry.update(lin_split(p + "mlp.gate_up_proj", [i, i],
                                   ["gate_proj", "up_proj"]))
            entry["down_proj"] = lin(p + "mlp.down_proj")
        elif not config.gated_mlp:                      # Phi-2
            entry["up_proj"] = lin(p + "mlp.fc1")
            entry["down_proj"] = lin(p + "mlp.fc2")
        else:
            entry.update({n: lin(p + "mlp." + n)
                          for n in ("gate_proj", "up_proj", "down_proj")})
        if config.post_norms:                           # Gemma2
            entry["pre_ffn_norm"] = grab(
                p + "pre_feedforward_layernorm.weight").to(device, dtype)
            entry["post_ffn_norm"] = grab(
                p + "post_feedforward_layernorm.weight").to(device, dtype)
        layers.append(entry)
    params = {"embed": grab("embed_tokens.weight").to(device, dtype),
              "layers": layers}
    try:
        params["final_norm"] = norm("norm")
    except KeyError:
        params["final_norm"] = norm("final_layernorm")  # Phi-2
    if not config.tie_embeddings:
        try:
            params["lm_head"] = lin("lm_head")
        except KeyError:
            pass
    return params


def gpt2_params_from_state_dict(state_dict: Dict[str, Any], config,
                                dtype=torch.bfloat16, device="cpu"):
    """A :class:`~..models.gpt2.GPT2LMHeadModel` holding an HF GPT-2
    state dict; HF's Conv1D weights ([in, out]) are transposed into the
    Linear layout. The lm_head is the token embedding unless the dict has
    one."""
    import dataclasses
    from ..models.gpt2 import GPT2LMHeadModel

    def grab(name):
        for prefix in ("transformer.", ""):
            if prefix + name in state_dict:
                return _t(state_dict[prefix + name]).to(device, dtype)
        raise KeyError(name)

    model = GPT2LMHeadModel(dataclasses.replace(config, dtype=dtype),
                            device=device)
    sd = {"wte.weight": grab("wte.weight"), "wpe.weight": grab("wpe.weight"),
          "ln_f.weight": grab("ln_f.weight"), "ln_f.bias": grab("ln_f.bias")}
    for li in range(len(model.h)):
        p = f"h.{li}."
        for name in ("ln_1", "ln_2"):
            for part in ("weight", "bias"):
                sd[p + f"{name}.{part}"] = grab(p + f"{name}.{part}")
        for name in ("attn.c_attn", "attn.c_proj", "mlp.c_fc",
                     "mlp.c_proj"):
            sd[p + name + ".weight"] = grab(p + name + ".weight").t()
            sd[p + name + ".bias"] = grab(p + name + ".bias")
    sd["lm_head.weight"] = (
        _t(state_dict["lm_head.weight"]).to(device, dtype)
        if "lm_head.weight" in state_dict else sd["wte.weight"])
    with torch.no_grad():
        for k, v in sd.items():
            model.get_parameter(k).copy_(v)
    return model


def load_llama_from_pretrained(path_or_model, dtype=torch.bfloat16,
                               quantize: bool = True, blocksize: int = 64,
                               quant_type: str = "nf4",
                               compress_statistics: bool = False,
                               device="cpu"):
    """(config, params) from a local HF checkpoint directory or a
    ``transformers`` model object, quantized to NF4 by default."""
    if isinstance(path_or_model, str):
        import transformers
        model = transformers.AutoModelForCausalLM.from_pretrained(
            path_or_model, torch_dtype="float32", local_files_only=True)
    else:
        model = path_or_model
    config = llama_config_from_hf(model.config)
    params = llama_params_from_state_dict(
        model.state_dict(), config, dtype=dtype, quantize=quantize,
        blocksize=blocksize, quant_type=quant_type,
        compress_statistics=compress_statistics, device=device)
    return config, params
