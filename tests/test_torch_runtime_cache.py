"""PyTorch port vs JAX package: the int8 and bf16 runtime caches and
``runtime_cache="auto"``.

The same NF4 weights, from one numpy seed, go through both packages'
``QLinear4.with_runtime_cache``. The int8 codes and row scales are one
f32 division and one rounding per weight, so they must be bit-identical;
the bf16 cache is one rounding of the same f32 weight. Products: in f32
both sides sum the same f32 terms in another order (1e-5 of max|ref|); in
bf16 they round one f32 sum once, so they may differ by one bf16 ulp. The
tiny f32 model served with each cache must give the JAX engine's greedy
tokens.
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
from tpu_bitsandbytes.models.layers import QLinear4 as JQLinear4
from tpu_bitsandbytes.utils import metrics as JM
from tpu_bitsandbytes_torch.convert import (config_from_reference,
                                            from_reference_arrays)
from tpu_bitsandbytes_torch.engine import engine as TE
from tpu_bitsandbytes_torch.engine.sampler import SamplingParams as TSP
from tpu_bitsandbytes_torch.models import llama as TL
from tpu_bitsandbytes_torch.models.layers import QLinear4
from tpu_bitsandbytes_torch.ops import int4cache as K1
from tpu_bitsandbytes_torch.utils import metrics as TM

from test_torch_engine import _prompts
from test_torch_functional import (config_fields, qlinear_arrays,
                                   reference_arrays, rel_err, t32, to_np)

F32_TOL = 1e-5     # f32 products, of max|ref|: another sum order
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: the test workers share
    the host's cores, and many threads per worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


def _both(fmt, dtype="f32", n=320, k=384, seed=0, bias=False):
    jdt, tdt = DTYPES[dtype]
    w = _w(n, k, seed)
    b = (np.random.default_rng(seed + 1).standard_normal(n).astype(
        np.float32) if bias else None)
    jq = JQLinear4.quantize(jnp.asarray(w), dtype=jdt,
                            bias=None if b is None else jnp.asarray(b))
    tq = QLinear4.quantize(torch.from_numpy(w), dtype=tdt,
                           bias=None if b is None else torch.from_numpy(b))
    return jq.with_runtime_cache(fmt), tq.with_runtime_cache(fmt)


@pytest.mark.parametrize("fmt", ["int8", "bf16"])
def test_cache_codes_match_jax(fmt):
    """int8: codes and row scales bit-identical; bf16: the cache equal."""
    jq, tq = _both(fmt)
    if fmt == "int8":
        assert tq.w_cache.dtype == torch.int8
        np.testing.assert_array_equal(tq.w_cache.numpy(), to_np(jq.w_cache))
        assert tq.cache_scale.dtype == torch.float32
        np.testing.assert_array_equal(tq.cache_scale.numpy(),
                                      to_np(jq.cache_scale))
    else:
        assert tq.w_cache.dtype == torch.bfloat16 and tq.cache_scale is None
        np.testing.assert_array_equal(t32(tq.w_cache),
                                      to_np(jq.w_cache).astype(np.float32))
    assert tq.hbm_bytes() == jq.hbm_bytes()
    assert tq.packed is not None
    dropped = QLinear4.quantize(torch.from_numpy(_w(64, 128, 1))
                                ).with_runtime_cache(fmt, drop_packed=True)
    assert dropped.packed is None and dropped.absmax is None


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["int8", "bf16"])
def test_cache_call_matches_jax(fmt, dtype):
    """The cache's product, with a bias: f32 within 1e-5 of max|ref|; bf16
    within one bf16 ulp of JAX's output, element by element (both round
    the same f32 value once, summed in another order)."""
    jq, tq = _both(fmt, dtype, bias=True, seed=2)
    x = np.random.default_rng(3).standard_normal((2, 5, 384)).astype(
        np.float32)
    jdt, tdt = DTYPES[dtype]
    ref = np.asarray(jq(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    got = t32(tq(torch.from_numpy(x).to(tdt)))
    assert got.shape == ref.shape == (2, 5, 320)
    if dtype == "f32":
        assert rel_err(got, ref) <= F32_TOL
    else:
        ulp = np.abs(ref) * 2.0 ** -7 + 1e-30
        assert (np.abs(got - ref) <= ulp).all()


def test_unknown_cache_format_raises():
    q = QLinear4.quantize(torch.from_numpy(_w(64, 128, 4)))
    with pytest.raises(ValueError, match="runtime cache"):
        q.with_runtime_cache("int3")
    with pytest.raises(ValueError, match="runtime cache"):
        TM.param_footprint({"w": q}, runtime_cache="fp8")


@pytest.mark.parametrize("fmt", ["int4", "int8", "bf16"])
def test_convert_carries_each_cache(fmt):
    """A JAX QLinear4 with each cache through ``from_reference_arrays``:
    the int4 codes become nibble pairs (N padding dropped), the int8 cache
    keeps its [N, K] codes and [N] scale, the bf16 cache stays bf16 with no
    scale; each converted layer computes JAX's product (f32, 1e-5). Before
    the port had int8 and bf16 caches, ``convert`` packed any cache as int4
    nibbles and sliced a 2-D scale: these layers came out wrong."""
    jq, tq = _both(fmt, seed=5, n=200)
    conv = from_reference_arrays({"w": qlinear_arrays(jq)}, "cpu")["w"]
    assert conv.w_cache.dtype == tq.w_cache.dtype
    assert torch.equal(conv.w_cache, tq.w_cache)
    if fmt == "bf16":
        assert conv.cache_scale is None
    else:
        assert torch.equal(conv.cache_scale, tq.cache_scale)
    if fmt == "int4":
        assert to_np(jq.cache_scale).ndim == 2 and to_np(jq.w_cache).dtype \
            == np.int8    # int8 values in [-8, 7]: told apart by the scale
    x = np.random.default_rng(6).standard_normal((3, 384)).astype(np.float32)
    ref = np.asarray(jq(jnp.asarray(x)))
    assert rel_err(t32(conv(torch.from_numpy(x))), ref) <= F32_TOL


# -- the tiny model in both engines ------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX quantized params, the port's copy)."""
    cfg = dataclasses.replace(JL.LlamaConfig.tiny(), dtype=jnp.float32)
    q = JL.quantize_params(JL.init_params(jax.random.PRNGKey(7), cfg),
                           dtype=cfg.dtype, fuse_projections=True)
    return (cfg, config_from_reference(config_fields(cfg)), q,
            from_reference_arrays(reference_arrays(q), "cpu"))


CATEGORIES = ("packed", "exec_cache", "fp")


@pytest.mark.parametrize("fmt", ["int4", "int8", "bf16"])
def test_footprints_match_jax(tiny, fmt):
    """``param_footprint`` with a hypothetical cache, the engine's
    ``_footprint_est``, and the footprint of a built cache: each category
    equal to the JAX package's, byte for byte."""
    cfg, tcfg, jq, tq = tiny
    assert (TM.param_footprint(tq, runtime_cache=fmt)
            == JM.param_footprint(jq, runtime_cache=fmt))
    je = JE.DecodeEngine(jq, cfg, max_batch=2, max_seq=64)
    te = TE.DecodeEngine(tq, tcfg, max_batch=2, max_seq=64, device="cpu")
    jest, test = je._footprint_est(jq, fmt, True), te._footprint_est(
        tq, fmt, True)
    keys = CATEGORIES + ("kv", "activations_est", "total")
    assert {k: test[k] for k in keys} == {k: jest[k] for k in keys}
    built = TL.build_runtime_cache(tq, fmt)
    jbuilt = JL.build_runtime_cache(jq, fmt)
    assert (TM.param_footprint(built) == JM.param_footprint(jbuilt))


@pytest.mark.parametrize("fmt", ["int8", "bf16"])
def test_engine_greedy_tokens_match_jax(tiny, fmt):
    """The tiny f32 model served through each cache: the port's engine
    gives the JAX engine's greedy tokens (its ``step()`` loop)."""
    cfg, tcfg, jq, tq = tiny
    prompts = _prompts([6, 19, 33], cfg.vocab_size, seed=8)
    je = JE.DecodeEngine(jq, cfg, max_batch=4, steps_per_sync=4,
                         runtime_cache=fmt)
    ref = je.generate(prompts, JSP(max_new_tokens=10), pipeline_depth=1)
    te = TE.DecodeEngine(tq, tcfg, max_batch=4, steps_per_sync=4,
                         runtime_cache=fmt, device="cpu")
    w = te.params["layers"][0]["qkv_proj"]
    assert te.runtime_cache == fmt
    assert w.w_cache.dtype == {"int8": torch.int8,
                               "bf16": torch.bfloat16}[fmt]
    before = K1.int4_mm.launches, K1.int4_mm_plain.cuda_calls
    got = te.generate(prompts, TSP(max_new_tokens=10))
    assert got == ref and all(len(g) == 10 for g in got)
    assert (K1.int4_mm.launches, K1.int4_mm_plain.cuda_calls) == before


def _budget(monkeypatch, nbytes):
    """The same device budget for both engines: the port's device memory
    and a JAX chip of that much HBM."""
    monkeypatch.setattr(TE, "device_memory_bytes", lambda dev: nbytes)
    monkeypatch.setitem(JM.CHIP_SPECS, "fake",
                        {"hbm_gbps": 1, "bf16_tflops": 1, "int8_tops": 1,
                         "hbm_gib": nbytes / 2 ** 30})
    monkeypatch.setattr(JM, "detect_chip", lambda: "fake")


def _cache_only(engine, params, fmt):
    est = engine._footprint_est(params, fmt, True)
    return sum(est[k] for k in ("exec_cache", "fp", "kv", "activations_est"))


@pytest.mark.parametrize("regime,fmt,warns", [
    ("roomy", "int8", None),
    ("between", "int4", "int4 execution cache"),
    ("tiny", None, "W4A8"),
])
def test_auto_picks_as_jax(tiny, monkeypatch, regime, fmt, warns):
    """``runtime_cache="auto"`` as JAX's ``TestRuntimeCacheAuto``: int8
    where it fits 0.92 of the budget, int4 between the int8 and the int4
    totals, the packed bytes (no cache) when neither fits; the same choice
    and the same warning, word for word, as the JAX engine."""
    cfg, tcfg, jq, tq = tiny
    probe = TE.DecodeEngine(tq, tcfg, max_batch=1, max_seq=64, device="cpu")
    t8, t4 = _cache_only(probe, tq, "int8"), _cache_only(probe, tq, "int4")
    assert t4 < t8
    budget = {"roomy": 2 ** 40, "between": int((t8 + t4) / 2 / 0.92),
              "tiny": 1024}[regime]
    _budget(monkeypatch, budget)
    import warnings as w
    with w.catch_warnings(record=True) as rec:
        w.simplefilter("always")
        je = JE.DecodeEngine(jq, cfg, max_batch=1, max_seq=64,
                             runtime_cache="auto")
        te = TE.DecodeEngine(tq, tcfg, max_batch=1, max_seq=64,
                             runtime_cache="auto", device="cpu")
    msgs = [str(m.message) for m in rec if "execution cache" in
            str(m.message) or "W4A8" in str(m.message)]
    if warns is None:
        assert msgs == []
    else:
        assert len(msgs) == 2 and msgs[0] == msgs[1] and warns in msgs[0]
    assert te.runtime_cache == fmt
    leaves = [v for layer in te.params["layers"] for v in layer.values()
              if isinstance(v, QLinear4)]
    jleaves = [v for layer in je.params["layers"] for v in layer.values()
               if isinstance(v, JQLinear4)]
    want = {"int8": torch.int8, "int4": torch.uint8, None: None}[fmt]
    assert leaves and all((l.w_cache is None if want is None
                           else l.w_cache.dtype == want) for l in leaves)
    assert all((j.w_cache is None) == (want is None) for j in jleaves)
    if fmt is None:
        assert all(l.packed is not None for l in leaves)
