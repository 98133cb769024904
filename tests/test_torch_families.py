"""PyTorch port vs JAX package: the model families.

For each of the JAX package's ``tiny_*`` family configs (Mistral, Mixtral,
Qwen2-MoE, Gemma, Gemma2, Phi-2, StableLM, and Qwen2 with
``sliding_window_layers``) the same numpy-seeded parameters (norm weights
and LayerNorm biases drawn too, so every norm convention shows) go through
both packages: the f32 forward's logits, ``quantize_params`` and
``build_runtime_cache`` byte for byte, and greedy tokens through both
engines (fused and unfused, int8 and unquantized KV, off the packed bytes
and through the int4, int8 and bf16 caches). In f32 both sides compute the
same arithmetic up to f32 sum order: logits agree within 1e-5 of max|ref|
and greedy tokens are identical. Every JAX preset crosses
``config_from_reference`` as the port's preset of the same name.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_bitsandbytes.engine import engine as JE
from tpu_bitsandbytes.engine.sampler import SamplingParams as JSP
from tpu_bitsandbytes.models import llama as JL
from tpu_bitsandbytes_torch.convert import (config_from_reference,
                                            from_reference_arrays)
from tpu_bitsandbytes_torch.engine import engine as TE
from tpu_bitsandbytes_torch.engine.sampler import SamplingParams as TSP
from tpu_bitsandbytes_torch.models import llama as TL
from tpu_bitsandbytes_torch.models.layers import QLinear4

from test_torch_engine import _prompts
from test_torch_functional import config_fields, reference_arrays, t32

LOGIT_TOL = 1e-5        # f32 logits, of max|ref|: another f32 sum order
NORMS = ("input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm",
         "final_norm")


def _qwen2_windowed():
    """Qwen2 with HF's ``layer_types``: only the second layer windowed."""
    return dataclasses.replace(JL.LlamaConfig.tiny_qwen2(),
                               sliding_window=16,
                               sliding_window_layers=(False, True))


FAMILIES = {name: getattr(JL.LlamaConfig, name) for name in (
    "tiny_mistral", "tiny_mixtral", "tiny_qwen2_moe", "tiny_gemma",
    "tiny_gemma2", "tiny_phi2", "tiny_stablelm")}
FAMILIES["tiny_qwen2_windowed"] = _qwen2_windowed


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: the test workers share
    the host's cores, and many threads per worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, dtype=jnp.float32):
    return dataclasses.replace(FAMILIES[name](), dtype=dtype)


def numpy_params(cfg, seed: int):
    """The JAX tree of ``cfg`` (its structure from ``init_params``) with
    every array drawn from a numpy seed: weights normal(0, 0.02), RMSNorm
    weights 1 + normal(0, 0.1) (normal(0, 0.1) under Gemma's ``1 + w``
    offset), LayerNorm weights likewise and biases normal(0, 0.1), routers
    normal(0, 0.5) so routing is decisive. Arrays in ``cfg.dtype``."""
    rng = np.random.default_rng(seed)
    dt = jnp.dtype(cfg.dtype)

    def draw(a, scale, mean=0.0):
        return (mean + scale * rng.standard_normal(a.shape)).astype(
            np.float32).astype(dt)

    def walk(t, key=""):
        if isinstance(t, dict):
            if key in NORMS and "w" in t:
                return {"w": draw(t["w"], 0.1, 1.0),
                        "b": draw(t["b"], 0.1)}
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, key) for v in t]
        if key in NORMS:
            return draw(t, 0.1, 0.0 if cfg.rms_weight_offset else 1.0)
        if key == "router":
            return draw(t, 0.5)
        return draw(t, 0.02)

    return walk(JL.init_params(jax.random.PRNGKey(0), cfg))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_logits_match_jax(name):
    """f32 prefill logits of 48 tokens, past every window (16)."""
    cfg = _cfg(name)
    ref_tree = numpy_params(cfg, seed=1)
    tcfg = config_from_reference(config_fields(cfg))
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 48))
    ref = np.asarray(JL.forward(_to_jax(ref_tree), jnp.asarray(tok), cfg))
    got = t32(TL.forward(from_reference_arrays(ref_tree, "cpu"),
                         torch.from_numpy(tok), tcfg))
    assert np.abs(got - ref).max() <= LOGIT_TOL * np.abs(ref).max()


def _leaves(tree, path=""):
    """(path, leaf) pairs of a tree, QLinear4s (and their JAX dicts) as
    leaves."""
    if isinstance(tree, dict) and "packed" not in tree:
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_quantize_params_match_jax(name, fuse):
    """The port's ``quantize_params`` of the same full-precision tree holds
    the JAX package's leaves at the same paths (fused and not: experts'
    gate/up, Phi-2's unfusable up/down, its lm_head bias), the packed
    codes and absmax bit for bit; routers and norms stay as they were;
    ``build_runtime_cache("int8")`` reaches every expert."""
    cfg = _cfg(name)
    tree = numpy_params(cfg, seed=2)
    jq = JL.quantize_params(_to_jax(tree), dtype=cfg.dtype,
                            fuse_projections=fuse)
    tq = TL.quantize_params(from_reference_arrays(tree, "cpu"),
                            dtype=torch.float32, fuse_projections=fuse)
    want = dict(_leaves(reference_arrays(jq)))
    got = dict(_leaves(tq))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        ref = want[path]
        if isinstance(leaf, QLinear4):
            np.testing.assert_array_equal(leaf.packed.numpy(), ref["packed"])
            np.testing.assert_array_equal(leaf.absmax.numpy(), ref["absmax"])
            assert (leaf.bias is None) == (ref["bias"] is None), path
        else:
            np.testing.assert_array_equal(t32(leaf), np.asarray(ref,
                                                                np.float32))
    cached = TL.build_runtime_cache(tq, "int8")
    assert all(leaf.w_cache is not None for _, leaf in _leaves(cached)
               if isinstance(leaf, QLinear4))


# (family, fuse_projections, quantized_kv, runtime cache): each family
# through one combination, every combination through at least one family
ENGINE_CASES = [
    ("tiny_mistral", True, True, "int4"),
    ("tiny_mixtral", False, True, "int8"),
    ("tiny_mixtral", True, True, None),
    ("tiny_qwen2_moe", True, False, "int8"),
    ("tiny_gemma", False, True, "bf16"),
    ("tiny_gemma2", True, True, "int8"),
    ("tiny_phi2", True, False, "int8"),
    ("tiny_stablelm", False, True, None),
    ("tiny_qwen2_windowed", True, False, "bf16"),
]


@pytest.mark.parametrize("name,fuse,quantized_kv,cache", ENGINE_CASES)
def test_greedy_tokens_match_jax_engine(name, fuse, quantized_kv, cache,
                                        monkeypatch):
    """Three prompts (5, 30 and 50 tokens: past the window) and 12 greedy
    tokens each through both engines, the quantized tree (with its runtime
    cache, or off the packed bytes: JAX's fused kernel in interpret mode)
    handed over through ``convert``."""
    monkeypatch.setenv("TBNB_FUSED_INTERPRET", "1")
    cfg = _cfg(name)
    jq = JL.quantize_params(_to_jax(numpy_params(cfg, seed=3)),
                            dtype=cfg.dtype, fuse_projections=fuse)
    if cache is not None:
        jq = JL.build_runtime_cache(jq, cache)
    tq = from_reference_arrays(reference_arrays(jq), "cpu")
    prompts = _prompts([5, 30, 50], cfg.vocab_size, seed=3)
    kw = dict(max_batch=4, steps_per_sync=4, quantized_kv=quantized_kv)
    ref = JE.DecodeEngine(jq, cfg, **kw).generate(
        prompts, JSP(max_new_tokens=12), pipeline_depth=1)
    got = TE.DecodeEngine(tq, config_from_reference(config_fields(cfg)),
                          device="cpu", **kw).generate(
        prompts, TSP(max_new_tokens=12))
    assert got == ref
    assert all(len(g) == 12 for g in got)


def test_moe_ties_route_to_the_lower_expert():
    """Three experts tied for the top probability: both packages route to
    the two lowest (``jax.lax.top_k``'s order, a stable sort in the port)
    and compute the same MoE output; unnormalized (Qwen2-MoE) and
    renormalized (Mixtral) weights alike."""
    for base in (JL.LlamaConfig.tiny_mixtral, JL.LlamaConfig.tiny_qwen2_moe):
        cfg = dataclasses.replace(base(), dtype=jnp.float32)
        tree = numpy_params(cfg, seed=4)
        moe = tree["layers"][0]["moe"]
        v = moe["router"][1].copy()
        moe["router"][:] = v                    # experts 1-3 tie ...
        moe["router"][0] = -v                   # ... above expert 0
        x = np.random.default_rng(4).standard_normal(
            (2, 3, cfg.hidden_size)).astype(np.float32)
        x *= np.sign(x @ v)[..., None]
        ref = np.asarray(JL._moe_mlp(_to_jax(moe), jnp.asarray(x), cfg))
        tmoe = from_reference_arrays(moe, "cpu")
        tcfg = config_from_reference(config_fields(cfg))
        top, _, probs = TL.moe_routing(tmoe["router"], torch.from_numpy(x),
                                       tcfg)
        assert torch.equal(probs[..., 1], probs[..., 2])
        assert torch.equal(probs[..., 2], probs[..., 3])
        tied = probs[..., 1] > probs[..., 0]
        assert tied.all()
        assert (top == torch.tensor([1, 2])).all()
        got = t32(TL._moe_mlp(tmoe, torch.from_numpy(x), tcfg))
        assert np.abs(got - ref).max() <= LOGIT_TOL * np.abs(ref).max()


PRESETS = sorted(n for n, v in vars(JL.LlamaConfig).items()
                 if isinstance(v, staticmethod))


@pytest.mark.parametrize("name", PRESETS)
def test_every_jax_preset_crosses(name):
    """``config_from_reference`` accepts every preset of the JAX package
    and gives the port's preset of the same name, field for field."""
    fields = config_fields(getattr(JL.LlamaConfig, name)())
    assert config_from_reference(fields) == getattr(TL.LlamaConfig, name)()
