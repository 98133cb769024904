"""PyTorch port vs JAX package: the sharding rules and the tensor-parallel
decode step.

The JAX side runs its ``parallel`` package on JAX's 8-device CPU backend
(``tests/conftest.py``); the port runs in worlds of processes over gloo
(``tests/torch_mesh_ranks.py``, which imports no JAX), fed the same numpy
inputs. Each world is spawned once per case list and runs every case in
one go.

- The spec trees (``llama_param_specs``) equal JAX's, leaf for leaf, and
  each tp rank's slices (``shard_local``, ``shard_params``'s core) equal
  the bytes JAX's ``shard_params`` puts on the matching device, for the
  interleaved fused layout (``quantize_params(tp=2)``), the per-row nested
  absmax, biases and the int8 cache; the per-shard int4 cache equals JAX's
  per-device pieces without their N padding.
- The tp = 2 decode step's f32 logits stay within 1e-5 of max|ref| of
  JAX's ``make_tp_decode_step`` over three steps, for Llama (fused,
  interleaved, NF4, int8 KV; and through the per-shard int4 cache, its
  row-parallel A8 scale all-reduced), Qwen2 with biases (a row-parallel bias on
  o_proj and down_proj, added once), Gemma2, Mixtral and Qwen2-MoE (its
  shared expert): only the f32 sum order differs.
- The six step builders (prefill, decode chunk, verify, chunked prefill,
  final logits) on the shards agree with the port's single-device
  functions on the whole tree (f32 logits within 1e-5, tokens equal);
  ``make_pod_mesh`` and ``make_mesh``'s refusal; the KV cache's spec and
  the spec tree equal JAX's.
- A row-parallel slice's A8 codes with the all-reduced row scale equal the
  unsharded row's bit for bit (the int4 cache's K1 path), and K4's path
  keeps each slice's own scale, as JAX's ``w4a8_matmul_4bit`` does.
- The per-chip footprint arithmetic of ``tests/test_70b_plan.py``.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from tpu_bitsandbytes import functional as F
from tpu_bitsandbytes.engine.kvcache import KVCache as JKV
from tpu_bitsandbytes.models import llama as JL
from tpu_bitsandbytes.models.layers import QLinear4 as JQLinear4
from tpu_bitsandbytes.ops import w4a8 as JW
from tpu_bitsandbytes import parallel as JPAR
from tpu_bitsandbytes.parallel.sharding import (
    build_sharded_int4_cache as j_int4_shards)
from tpu_bitsandbytes.utils import metrics as JM
from tpu_bitsandbytes_torch import parallel as TPAR
from tpu_bitsandbytes_torch.convert import from_reference_arrays
from tpu_bitsandbytes_torch.functional import unpack_nibbles
from tpu_bitsandbytes_torch.models import llama as TL
from tpu_bitsandbytes_torch.models.layers import QLinear4
from tpu_bitsandbytes_torch.ops.w4a8 import quantize_a8
from tpu_bitsandbytes_torch.parallel.sharding import (_linear_spec,
                                                      shard_local)
from tpu_bitsandbytes_torch.utils import metrics as TM

from test_torch_families import _to_jax, numpy_params
from test_torch_functional import config_fields, reference_arrays, t32
from torch_mesh_ranks import start_world

LOGIT_TOL = 1e-5        # f32 logits, of max|ref|: another f32 sum order
TP = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, **kw):
    return dataclasses.replace(getattr(JL.LlamaConfig, name)(),
                               dtype=jnp.float32, **kw)


def _row_biased(tree, seed):
    """Give every o_proj and down_proj a bias ({"w", "b"} leaves)."""
    rng = np.random.default_rng(seed)
    for layer in tree["layers"]:
        for name in ("o_proj", "down_proj"):
            w = layer[name]
            layer[name] = {"w": w, "b": (0.1 * rng.standard_normal(
                w.shape[0])).astype(np.float32)}
    return tree


# the decode presets: (config, quantize kwargs or None, quantized KV)
PRESETS = {
    "llama": (_cfg("tiny"), dict(fuse_projections=True, tp=TP), True),
    # the per-shard int4 cache: K/tp = 64 pads to one 128-block per shard
    "llama_int4": (_cfg("tiny"), dict(), True),
    "qwen2_bias": (_cfg("tiny_qwen2"), dict(), False),
    "gemma2": (_cfg("tiny_gemma2"), None, False),
    "mixtral": (_cfg("tiny_mixtral"), dict(fuse_projections=True, tp=TP),
                True),
    "qwen2_moe": (_cfg("tiny_qwen2_moe"), None, False),
}


def _preset_tree(name):
    cfg, qkw, _ = PRESETS[name]
    tree = numpy_params(cfg, seed=11)
    if name == "qwen2_bias":
        tree = _row_biased(tree, seed=12)
    jtree = _to_jax(tree)
    if qkw is not None:
        jtree = JL.quantize_params(jtree, blocksize=32, dtype=jnp.float32,
                                   **qkw)
    return cfg, jtree


def _norm_spec(s):
    """A spec as a tuple without trailing Nones (JAX's P normalizes
    them away in comparisons only sometimes)."""
    t = tuple(s)
    while t and t[-1] is None:
        t = t[:-1]
    return t


def _spec_pairs(jspec, tspec, path=""):
    """(path, jax spec, port spec) for every spec leaf of both trees."""
    if isinstance(jspec, JQLinear4):
        assert isinstance(tspec, QLinear4), path
        for f in ("packed", "absmax", "bias", "absmax_q", "w_cache",
                  "cache_scale"):
            yield f"{path}.{f}", getattr(jspec, f), getattr(tspec, f)
        js, ts = jspec.absmax_state, tspec.absmax_state
        yield f"{path}.absmax_state", None if js is None else js.absmax, \
            None if ts is None else ts.absmax
    elif isinstance(jspec, dict):
        assert isinstance(tspec, dict) and jspec.keys() == tspec.keys(), path
        for k in jspec:
            yield from _spec_pairs(jspec[k], tspec[k], f"{path}/{k}")
    elif isinstance(jspec, list):
        assert len(jspec) == len(tspec), path
        for i, (a, b) in enumerate(zip(jspec, tspec)):
            yield from _spec_pairs(a, b, f"{path}/{i}")
    else:
        yield path, jspec, tspec


def _trees():
    """JAX trees covering every spec rule: unfused, fused interleaved,
    per-row nested absmax, q/k/v and row biases, the int8 cache, MoE
    experts, the shared expert, lm_head."""
    cfg = _cfg("tiny")
    p = _to_jax(numpy_params(cfg, seed=3))
    q = JL.quantize_params(p, blocksize=32, dtype=jnp.float32)
    yield "unfused", q
    yield "fused_tp2", JL.quantize_params(p, blocksize=32, dtype=jnp.float32,
                                          fuse_projections=True, tp=TP)
    yield "nested", JL.quantize_params(p, blocksize=32, dtype=jnp.float32,
                                       compress_statistics=True)
    yield "int8_cache", JL.build_runtime_cache(q, "int8")
    qcfg = _cfg("tiny_qwen2")
    qp = _to_jax(_row_biased(numpy_params(qcfg, seed=4), seed=5))
    yield "qwen2_bias", JL.quantize_params(qp, blocksize=32,
                                           dtype=jnp.float32,
                                           fuse_projections=True, tp=TP)
    yield "qwen2_bias_fp", qp
    mcfg = _cfg("tiny_qwen2_moe")
    yield "qwen2_moe_fp", _to_jax(numpy_params(mcfg, seed=6))
    xcfg = _cfg("tiny_mixtral")
    yield "mixtral", JL.quantize_params(_to_jax(numpy_params(xcfg, seed=7)),
                                        blocksize=32, dtype=jnp.float32,
                                        fuse_projections=True, tp=TP)


TREES = dict(_trees())


@pytest.mark.parametrize("name", list(TREES))
def test_param_specs_match_jax(name):
    jtree = TREES[name]
    ttree = from_reference_arrays(reference_arrays(jtree), "cpu")
    pairs = list(_spec_pairs(JPAR.llama_param_specs(jtree),
                             TPAR.llama_param_specs(ttree)))
    assert pairs
    for path, js, ts in pairs:
        if js is None or ts is None:
            assert js is None and ts is None, path
        else:
            assert _norm_spec(js) == _norm_spec(ts), (path, js, ts)


def _jax_shard(arr, dev):
    """The piece of a sharded JAX array on ``dev``, as numpy."""
    if arr is None:
        return None
    (sh,) = [s for s in arr.addressable_shards if s.device == dev]
    return np.asarray(sh.data.astype(jnp.int8)
                      if sh.data.dtype == jnp.int4 else sh.data)


def _field_pairs(jleaf, tleaf, dev, path):
    if isinstance(jleaf, JQLinear4):
        for f in ("packed", "absmax", "bias", "absmax_q", "w_cache",
                  "cache_scale"):
            yield (f"{path}.{f}", _jax_shard(getattr(jleaf, f), dev),
                   getattr(tleaf, f))
        if jleaf.absmax_state is not None:
            yield (f"{path}.absmax_state",
                   _jax_shard(jleaf.absmax_state.absmax, dev),
                   tleaf.absmax_state.absmax)
    elif isinstance(jleaf, dict):
        for k in jleaf:
            yield from _field_pairs(jleaf[k], tleaf[k], dev, f"{path}/{k}")
    elif isinstance(jleaf, list):
        for i, (a, b) in enumerate(zip(jleaf, tleaf)):
            yield from _field_pairs(a, b, dev, f"{path}/{i}")
    else:
        yield path, _jax_shard(jleaf, dev), tleaf


@pytest.mark.parametrize("name", ["fused_tp2", "nested", "int8_cache",
                                  "qwen2_bias", "qwen2_moe_fp", "mixtral"])
def test_shard_bytes_match_jax_device_shards(name):
    """Each tp rank's slices equal the bytes JAX's ``shard_params`` puts
    on the device of the same tp index (a dp = 1, tp = 2 mesh)."""
    jtree = TREES[name]
    mesh = JPAR.make_mesh(tp=TP, dp=1)
    jsh = JPAR.shard_params(jtree, mesh)
    ttree = from_reference_arrays(reference_arrays(jtree), "cpu")
    specs = TPAR.llama_param_specs(ttree)
    for r, dev in enumerate(mesh.devices[0]):
        local = shard_local(ttree, specs, TP, r, "cpu")
        n = 0
        for path, ref, got in _field_pairs(jsh, local, dev, ""):
            if ref is None:
                assert got is None, path
                continue
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=path)
            n += 1
        assert n > 10
    # the local shapes are the shard's: q_proj's rows, down_proj's K
    lay = shard_local(ttree, specs, TP, 0, "cpu")["layers"][0]
    for name_, w in lay.items():
        if isinstance(w, QLinear4):
            full = ttree["layers"][0][name_]
            n_, k_ = full.shape
            want = ((n_, k_ // TP) if name_ in ("o_proj", "down_proj")
                    else (n_ // TP, k_))
            assert w.shape == want, name_


def test_sharded_int4_cache_matches_jax():
    """``build_sharded_int4_cache``: each rank's cache (codes and scales)
    equals JAX's per-device piece with its N padding cut off; the
    row-parallel pieces share the padding of K."""
    cfg = _cfg("tiny", hidden_size=256, intermediate_size=512)
    q = JL.quantize_params(_to_jax(numpy_params(cfg, seed=8)), blocksize=64,
                           dtype=jnp.float32, fuse_projections=True, tp=TP)
    mesh = JPAR.make_mesh(tp=TP, dp=1)
    jc = j_int4_shards(JPAR.shard_params(q, mesh), mesh, drop_packed=True)
    ttree = from_reference_arrays(reference_arrays(q), "cpu")
    specs = TPAR.llama_param_specs(ttree)
    for r, dev in enumerate(mesh.devices[0]):
        local = TPAR.build_sharded_int4_cache(
            shard_local(ttree, specs, TP, r, "cpu"), drop_packed=True)
        for name in ("qkv_proj", "o_proj", "gateup_proj", "down_proj"):
            jw, tw = jc["layers"][0][name], local["layers"][0][name]
            assert tw.packed is None
            n = tw.shape[0]
            codes = _jax_shard(jw.w_cache, dev)[:n]
            got = unpack_nibbles(tw.w_cache).to(torch.int8)
            got = torch.where(got > 7, got - 16, got).numpy()
            np.testing.assert_array_equal(got, codes, err_msg=name)
            np.testing.assert_array_equal(
                tw.cache_scale.numpy(), _jax_shard(jw.cache_scale, dev)[:, :n],
                err_msg=name)
    head = local["lm_head"]
    assert head.shape == (cfg.vocab_size // TP, cfg.hidden_size)


def test_interleaved_layout_matches_jax():
    """``quantize_params(tp=2)``'s fused rows: JAX's bytes, q/k/v
    interleaved by shard, and the tp = 1 layout the plain concatenation;
    ``interleave_fused`` re-lays a tp = 1 tree into the tp = 2 tree."""
    cfg = _cfg("tiny_qwen2")
    tree = numpy_params(cfg, seed=9)
    t = from_reference_arrays(tree, "cpu")
    for tp in (1, TP):
        jq = JL.quantize_params(_to_jax(tree), blocksize=32,
                                dtype=jnp.float32, fuse_projections=True,
                                tp=tp)["layers"][0]["qkv_proj"]
        tq = TL.quantize_params(t, blocksize=32, dtype=torch.float32,
                                fuse_projections=True,
                                tp=tp)["layers"][0]["qkv_proj"]
        np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
        np.testing.assert_array_equal(tq.absmax.numpy(), np.asarray(jq.absmax))
        np.testing.assert_array_equal(tq.bias.numpy(), np.asarray(jq.bias))
    # a tree fused at tp = 1, re-laid: the tp = 2 tree's bytes, experts too
    for name in ("tiny_qwen2", "tiny_mixtral"):
        c = _cfg(name)
        tt = from_reference_arrays(numpy_params(c, seed=10), "cpu")
        tc = TL.LlamaConfig(**{f: getattr(c, f) for f in ("num_heads",
                                                          "num_kv_heads",
                                                          "hidden_size")})
        one = TL.quantize_params(tt, blocksize=32, dtype=torch.float32,
                                 fuse_projections=True)
        two = TL.quantize_params(tt, blocksize=32, dtype=torch.float32,
                                 fuse_projections=True, tp=TP)
        got = TPAR.sharding.interleave_fused(one, tc, TP)
        for (path, a), (_, b) in zip(_leaves_of(got), _leaves_of(two)):
            assert (a is None) == (b is None), path
            if a is not None:
                assert torch.equal(a, b), path
    mats = [torch.arange(4).reshape(4, 1) + 10 * i for i in range(3)]
    got = TL._interleave_rows(mats, 2)[:, 0].tolist()
    assert got == [0, 1, 10, 11, 20, 21, 2, 3, 12, 13, 22, 23]
    with pytest.raises(ValueError, match="divisible"):
        TL._interleave_rows([torch.zeros(3, 1)], 2)


def _leaves_of(tree, path=""):
    """(path, tensor or None) of every tensor field of a port tree."""
    if isinstance(tree, QLinear4):
        for f in ("packed", "absmax", "bias", "absmax_q", "w_cache",
                  "cache_scale"):
            yield f"{path}.{f}", getattr(tree, f)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_of(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_of(v, f"{path}/{i}")
    else:
        yield path, tree


# -- the tp = 2 world -------------------------------------------------------

STEPS, BATCH, MAX_SEQ = 3, 2, 32


def _jax_decode_logits(cfg, jtree, quantized_kv, toks, int4=False):
    mesh = JPAR.make_mesh(tp=TP, dp=1)
    sh = JPAR.shard_params(jtree, mesh)
    if int4:
        sh = j_int4_shards(sh, mesh)
    cache = JKV.create(cfg.num_layers, BATCH, MAX_SEQ, cfg.num_kv_heads,
                       cfg.hd, quantized=quantized_kv, dtype=cfg.dtype)
    cache = jax.device_put(cache, jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), JPAR.kv_cache_spec(cache),
        is_leaf=lambda x: isinstance(x, JP)))
    step = JPAR.make_tp_decode_step(mesh, sh, cfg, cache)
    active = jnp.ones((BATCH,), bool)
    out = []
    for t in toks:
        logits, cache = step(sh, cache, jnp.asarray(t), active)
        out.append(np.asarray(logits))
    return np.stack(out)


def _linear_case(seed, n, k, bs=64):
    rng = np.random.default_rng(seed)
    w = (0.05 * rng.standard_normal((n, k))).astype(np.float32)
    jq = JQLinear4.quantize(jnp.asarray(w), blocksize=bs, dtype=jnp.float32)
    return jq, rng.standard_normal((8, k)).astype(np.float32)


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    """One tp = 2 world running every case; JAX references computed while
    it runs."""
    cases, refs, jax_inputs = [], {}, {}
    rng = np.random.default_rng(0)
    for name, (cfg, _, qkv) in PRESETS.items():
        cfg_, jtree = _preset_tree(name)
        toks = rng.integers(1, cfg.vocab_size, (STEPS, BATCH)).astype(
            np.int32)
        int4 = name.endswith("_int4")
        jax_inputs[name] = (cfg, jtree, qkv, toks, int4)
        cases.append(dict(id=name, fn="decode_steps",
                          params=reference_arrays(jtree),
                          config=config_fields(cfg), tokens=toks,
                          max_seq=MAX_SEQ, quantized_kv=qkv, int4=int4))
    # a row whose max lies in one slice: the slices' own scales differ
    x = rng.standard_normal((4, 512)).astype(np.float32)
    x[:, 7] = 9.0
    cases.append(dict(id="a8", fn="a8_codes", x=x))
    refs["a8"] = x
    jq, xk = _linear_case(1, 128, 512)
    cases.append(dict(id="k4_row", fn="row_linear",
                      w=reference_arrays(jq), x=xk))
    refs["k4_row"] = (jq, xk)
    jq4, x4 = _linear_case(2, 128, 512)
    cases.append(dict(id="int4_row", fn="row_linear", int4=True,
                      w=reference_arrays(jq4), x=x4))
    refs["int4_row"] = (jq4, x4)
    cases.append(dict(id="mesh_api", fn="mesh_api", tp=TP, world=TP))
    # intermediate 192: no linear takes K4 on one device or on a shard, so
    # both route alike (K4 goes by the local shape: the whole 256-wide
    # down_proj takes it, its 128-wide shards do not)
    bcfg = _cfg("tiny_qwen2", intermediate_size=192)
    btree = JL.quantize_params(
        _to_jax(_row_biased(numpy_params(bcfg, seed=13), seed=14)),
        blocksize=32, dtype=jnp.float32)
    prompt = np.zeros(16, np.int32)
    prompt[:11] = rng.integers(1, bcfg.vocab_size, 11)
    chunk = np.zeros(16, np.int32)
    chunk[:10] = rng.integers(1, bcfg.vocab_size, 10)
    bcase = dict(id="builders", fn="builders",
                 params=reference_arrays(btree), config=config_fields(bcfg),
                 prompt=prompt, prompt_len=11, chunk=chunk,
                 drafts=rng.integers(1, bcfg.vocab_size, (2, 3)).astype(
                     np.int32))
    cases.append(bcase)
    refs["builders"] = bcase
    world = start_world(dict(tp=TP, dp=1, cases=cases), TP,
                        tmp_path_factory.mktemp("tp_world"))
    for name, args in jax_inputs.items():
        refs[name] = _jax_decode_logits(*args)
    return world.join(), refs


@pytest.mark.parametrize("name", list(PRESETS))
def test_tp_decode_step_matches_jax(tp_world, name):
    res, refs = tp_world
    ref = refs[name]
    for r in range(TP):
        got = res[r][name]["logits"]
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= LOGIT_TOL * np.abs(ref).max(), r
        assert res[r][name]["lengths"].tolist() == [STEPS] * BATCH
    # the tp ranks hold the same gathered logits
    np.testing.assert_array_equal(res[0][name]["logits"],
                                  res[1][name]["logits"])


def test_tp_step_builders_match_single_device(tp_world):
    """The six step builders on tp = 2 shards (Qwen2 with row biases):
    a prefill, a greedy decode chunk, a verify step, a chunked prefill and
    its final logits, against the port's single-device functions on the
    whole tree (themselves held against JAX's elsewhere): f32 logits within
    1e-5 of max|ref|, the same tokens, counts and lengths."""
    from torch_mesh_ranks import builder_run
    res, refs = tp_world
    c = refs["builders"]
    params = from_reference_arrays(c["params"], "cpu")
    from tpu_bitsandbytes_torch.convert import config_from_reference
    ref = builder_run(params, config_from_reference(c["config"]), c)
    for r in range(TP):
        got = res[r]["builders"]
        for k in ("prefill", "final"):
            assert np.abs(got[k] - ref[k]).max() <= (
                LOGIT_TOL * np.abs(ref[k]).max()), (r, k)
        for k in ("tokens", "emitted", "counts", "lengths"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_mesh_api(tp_world):
    """``make_pod_mesh`` lays (dp, tp) over the world, rank r at tp index
    r; ``make_mesh`` refuses more ranks than the world has, as JAX's
    refuses more devices."""
    res, _ = tp_world
    for r in range(TP):
        got = res[r]["mesh_api"]
        assert got["pod_shape"] == (1, TP)
        assert got["pod_names"] == ("dp", "tp")
        assert got["pod_tp_rank"] == r
        assert got["too_many"] == f"need {2 * TP} devices, have {TP}"


def test_kv_cache_spec_and_spec_tree_match_jax():
    """The KV cache's spec (slots over dp, kv heads over tp) and a tree's
    spec tree mirror JAX's."""
    for quantized in (True, False):
        jc = JKV.create(2, 4, 16, 2, 8, quantized=quantized,
                        dtype=jnp.float32)
        tc = TPAR.kv_cache_spec(TPAR.sharding.KVCache.create(
            2, 4, 16, 2, 8, quantized=quantized, dtype=torch.float32,
            device="cpu"))
        js = JPAR.kv_cache_spec(jc)
        for f in ("k", "v", "k_scale", "v_scale", "lengths"):
            a, b = getattr(js, f), getattr(tc, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert _norm_spec(a) == _norm_spec(b), f
    jtree = TREES["nested"]
    ttree = from_reference_arrays(reference_arrays(jtree), "cpu")
    jst = JPAR.spec_tree(jtree)
    tst = TPAR.spec_tree(ttree)
    for path, js, ts in _spec_pairs(jst, tst):
        if js is None or ts is None:
            assert js is None and ts is None, path
        else:
            assert _norm_spec(js) == _norm_spec(ts), path


def test_row_shard_a8_codes_match_single_device(tp_world):
    """All-reduced row scale: the slices' codes are the unsharded row's,
    bit for bit; each slice's own scale (K4's A8) differs where the row's
    max lies in the other slice."""
    res, refs = tp_world
    x = torch.from_numpy(refs["a8"])
    q, s = quantize_a8(x, x.shape[1])
    got = np.concatenate([res[r]["a8"]["codes"] for r in range(TP)], axis=1)
    np.testing.assert_array_equal(got, q.numpy())
    for r in range(TP):
        np.testing.assert_array_equal(res[r]["a8"]["s_x"], s.numpy())
    own = np.concatenate([res[r]["a8"]["own_codes"] for r in range(TP)],
                         axis=1)
    assert not np.array_equal(own, q.numpy())


def test_k4_row_shard_keeps_its_own_scale(tp_world):
    """A row-parallel NF4 shard on K4's route (k2 = 128 per shard): each
    shard quantizes its slice with its own A8 scale, as JAX's
    ``w4a8_matmul_4bit`` computes it (Pallas interpret mode) on that
    slice, and the all-reduce adds the shards' products."""
    res, refs = tp_world
    jq, x = refs["k4_row"]
    k = x.shape[1] // TP
    ref = 0
    for r in range(TP):
        assert res[r]["k4_row"]["k4"] and res[r]["k4_row"]["shape"] == (
            128, k)
        packed = jq.packed[:, r * k // 2:(r + 1) * k // 2]
        absmax = jq.absmax[:, r * k // 64:(r + 1) * k // 64]
        st = F.QuantState(absmax=absmax.reshape(-1), shape=(128, k),
                          blocksize=64, quant_type="nf4", dtype=jnp.float32)
        ref = ref + np.asarray(JW.w4a8_matmul_4bit(
            jnp.asarray(x[:, r * k:(r + 1) * k]), packed.reshape(-1), st,
            out_dtype=jnp.float32))
    for r in range(TP):
        got = res[r]["k4_row"]["out"]
        assert np.abs(got - ref).max() <= LOGIT_TOL * np.abs(ref).max()


def test_int4_row_shard_uses_the_unsharded_codes(tp_world):
    """A row-parallel int4-cache shard (K1's route): the output is the sum
    over shards of K1's plain version fed the unsharded row's A8 codes and
    scale."""
    from tpu_bitsandbytes_torch.ops.int4cache import int4_mm_plain
    res, refs = tp_world
    jq, x = refs["int4_row"]
    w = from_reference_arrays(reference_arrays(jq), "cpu")
    k = x.shape[1] // TP
    xq, s_x = quantize_a8(torch.from_numpy(x), x.shape[1])
    ref = 0
    for r in range(TP):
        lw = shard_local(w, _linear_spec(w, col=False), TP, r,
                         "cpu").with_runtime_cache("int4")
        ref = ref + int4_mm_plain(xq[:, r * k:(r + 1) * k].contiguous(),
                                  lw.w_cache, lw.cache_scale, s_x)
    for r in range(TP):
        got = res[r]["int4_row"]["out"]
        np.testing.assert_allclose(got, t32(ref), rtol=0, atol=1e-6 * float(
            ref.abs().max()))


# -- the per-chip arithmetic of tests/test_70b_plan.py ------------------------

GIB = 1024 ** 3


def _meta_tree(cfg, blocksize=64):
    """The port's NF4 tree of ``cfg`` as shapes only (meta tensors)."""
    h, hd = cfg.hidden_size, cfg.hd
    shapes = {"q_proj": (cfg.num_heads * hd, h),
              "k_proj": (cfg.num_kv_heads * hd, h),
              "v_proj": (cfg.num_kv_heads * hd, h),
              "o_proj": (h, cfg.num_heads * hd),
              "gate_proj": (cfg.intermediate_size, h),
              "up_proj": (cfg.intermediate_size, h),
              "down_proj": (h, cfg.intermediate_size)}

    def q(n, k):
        return QLinear4(
            packed=torch.empty((n, k // 2), dtype=torch.uint8, device="meta"),
            absmax=torch.empty((n, k // blocksize), dtype=torch.float32,
                               device="meta"), shape=(n, k),
            blocksize=blocksize)

    def v(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    layer = lambda: {**{k: q(*s) for k, s in shapes.items()},
                     "input_norm": v(h), "post_attn_norm": v(h)}
    return {"embed": v(cfg.vocab_size, h),
            "layers": [layer() for _ in range(cfg.num_layers)],
            "final_norm": v(h), "lm_head": q(cfg.vocab_size, h)}


@pytest.fixture(scope="module")
def plan70b():
    jcfg = JL.LlamaConfig.llama2_70b()

    def build():
        return JL.quantize_params(JL.init_params(jax.random.PRNGKey(0), jcfg,
                                                 dtype=jnp.bfloat16),
                                  blocksize=64)

    return jcfg, jax.eval_shape(build), _meta_tree(TL.LlamaConfig.llama2_70b())


@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_70b_param_footprint_matches_jax(plan70b, fmt):
    jcfg, jshapes, ttree = plan70b
    for drop in (False, True):
        assert TM.param_footprint(ttree, fmt, drop_packed=drop) == \
            JM.param_footprint(jshapes, fmt, drop_packed=drop)


@pytest.mark.parametrize("fmt,tp,batch", [("int4", 4, 8), ("int4", 8, 16),
                                          ("int8", 4, 8), ("int8", 8, 8),
                                          ("int4", 1, 1)])
def test_70b_per_chip_fit_matches_jax(plan70b, fmt, tp, batch):
    """``metrics.per_device_footprint`` is the JAX test's per-chip sum
    (cache-only serving, KV int8 over tp, max_seq 2048, 32-step chunks)
    and decides the fit the same way against a budget: the JAX test's
    own 16 GiB chip, and an 80 GB card."""
    jcfg, jshapes, ttree = plan70b
    cfg = TL.LlamaConfig.llama2_70b()
    pf = TM.param_footprint(ttree, fmt, drop_packed=True)
    kv = TM.kv_cache_bytes(cfg.num_layers, batch, 2048, cfg.num_kv_heads,
                           cfg.hd, True)
    act = TM.serving_act_bytes(cfg, batch, 2048, 32)
    jpf = JM.param_footprint(jshapes, fmt, drop_packed=True)
    jkv = JM.kv_cache_bytes(jcfg.num_layers, batch, 2048, jcfg.num_kv_heads,
                            jcfg.hd, True)
    jact = JM.serving_act_bytes(jcfg, batch, 2048, 32)
    per_chip = jpf["exec_cache"] // tp + jpf["fp"] + jkv // tp + jact
    for budget in (JM.CHIP_SPECS["v5e"]["hbm_gib"] * GIB, 80 * 10 ** 9):
        got = TM.per_device_footprint(pf, kv, act, budget, tp=tp)
        assert got["total"] == per_chip
        assert got["fits"] == (per_chip <= 0.92 * budget)


def test_70b_geometry_shards_at_tp8(plan70b):
    """The 70B layer geometry at tp = 8: 8 q heads and one kv head per
    rank, every linear's shard whole 64-blocks, every rank's slices of
    one shape."""
    _, _, ttree = plan70b
    cfg = TL.LlamaConfig.llama2_70b()
    one = dict(ttree, layers=ttree["layers"][:1])
    specs = TPAR.llama_param_specs(one)
    shapes = {r: {k: w.shape for k, w in
                  shard_local(one, specs, 8, r, "meta")["layers"][0].items()
                  if isinstance(w, QLinear4)} for r in range(8)}
    assert all(shapes[r] == shapes[0] for r in range(8))
    assert shapes[0] == {"q_proj": (1024, 8192), "k_proj": (128, 8192),
                         "v_proj": (128, 8192), "o_proj": (8192, 1024),
                         "gate_proj": (3584, 8192), "up_proj": (3584, 8192),
                         "down_proj": (8192, 3584)}
    assert cfg.num_heads // 8 == 8 and cfg.num_kv_heads // 8 == 1
