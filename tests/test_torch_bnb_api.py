"""PyTorch port vs JAX package: the rest of the functional API.

The same numpy inputs go through both packages. Codes are bit-identical
wherever JAX's are one IEEE operation per element (row-wise, col+row and
blockwise int8, FP8 E4M3/E5M2 bits including NaN and the saturation at
+-448 / +-57344, ``double_quant``, NF4/FP4 bytes); scales are the same f32
maxima and divisions, so identical too. Products in f32 sum the same terms
in another order: within 1e-6 of max|ref| where the terms are exact
(int8 sums, a sparse scatter) and 1e-5 where they are f32 products.
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpu_bitsandbytes import functional as F
import tpu_bitsandbytes as JAX_PKG
import tpu_bitsandbytes_torch as PORT
from tpu_bitsandbytes_torch import functional as T

from test_torch_functional import rel_err, t32, to_np


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy() if isinstance(
        got, torch.Tensor) else got, to_np(ref))


def test_rowwise_matches_jax():
    a = _x((2, 3, 200), 0, 3.0)
    a[0, 1] = 0.0                      # an all-zero row: the 1e-8 floor
    q, s = F.quantize_rowwise(jnp.asarray(a))
    tq, ts = T.quantize_rowwise(torch.from_numpy(a))
    _eq(tq, q)
    _eq(ts, s)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            t32(T.dequantize_rowwise(tq, ts, dtype=dt)),
            np.asarray(F.dequantize_rowwise(q, s, dtype=jdt), np.float32))


@pytest.mark.parametrize("m,k,n", [(5, 4096, 24), (1, 300, 7)])
def test_matmul_int8_exact(m, k, n):
    """Exact int32 sums at K = 4096 with full-scale codes (past f32's 2^24
    from K = 1041 on), then JAX's f32 scaling, bit for bit."""
    rng = np.random.default_rng(1)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    a[0, :] = 127
    b = rng.integers(-127, 128, (k, n), dtype=np.int8)
    b[:, 0] = 127
    sa = np.abs(_x((m,), 2)) + 0.5
    sb = np.abs(_x((n,), 3)) + 0.5
    exact = a.astype(np.int64) @ b.astype(np.int64)
    assert np.abs(exact).max() >= 2 ** 24 or k < 1041
    acc = T.int8_dot(torch.from_numpy(a), torch.from_numpy(b.T.copy()))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), exact)
    ref = F.matmul_int8(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa),
                        jnp.asarray(sb), dtype=jnp.float32)
    got = T.matmul_int8(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(sa), torch.from_numpy(sb),
                        dtype=torch.float32)
    _eq(got, ref)


def test_int_mm_padding_rule():
    """The shapes ``int8_dot`` pads to for ``torch._int_mm`` on a card:
    M > 16, K and N multiples of 8; aligned shapes are left alone."""
    assert T.int_mm_shape(1, 4096, 4096) == (17, 4096, 4096)
    assert T.int_mm_shape(8, 300, 7) == (17, 304, 8)
    assert T.int_mm_shape(64, 11008, 12288) == (64, 11008, 12288)
    assert T.int_mm_shape(17, 8, 16) == (17, 8, 16)


SPECIAL = np.array([np.nan, -np.nan, 1000.0, -1000.0, 448.0, 449.0, 1e-9,
                    0.001953125, 0.0009765625, -0.3, np.inf, -np.inf],
                   np.float32)


def test_fp8_e4m3_matches_jax():
    """E4M3 bits: the encoder on NaN (0x7F, as ml_dtypes), +-inf and
    +-1000 (saturated to +-448), subnormals; then row quantization, its
    inverse and the fused product."""
    _eq(T._encode_fp8_e4m3(torch.from_numpy(SPECIAL)),
        F._encode_fp8_e4m3(jnp.asarray(SPECIAL)))
    a = _x((24, 96), 4, 5.0)
    a[3, 7] = 1e4
    q, s = F.quantize_fp8_e4m3(jnp.asarray(a))
    tq, ts = T.quantize_fp8_e4m3(torch.from_numpy(a))
    _eq(tq, q)
    _eq(ts, s)
    np.testing.assert_array_equal(
        t32(T.dequantize_fp8_e4m3(tq, ts, dtype=torch.float32)),
        to_np(F.dequantize_fp8_e4m3(q, s, dtype=jnp.float32)))
    x = _x((3, 5, 96), 5)
    bias = _x((24,), 6)
    ref = F.matmul_fp8_e4m3(jnp.asarray(x), q, s, jnp.asarray(bias),
                            dtype=jnp.float32)
    got = T.matmul_fp8_e4m3(torch.from_numpy(x), tq, ts,
                            torch.from_numpy(bias), dtype=torch.float32)
    assert got.shape == (3, 5, 24)
    assert rel_err(t32(got), to_np(ref)) <= 1e-5
    got1 = T.matmul_fp8_e4m3(torch.from_numpy(x[0, 0]), tq, ts,
                             dtype=torch.float32)
    assert got1.shape == (24,)
    with pytest.raises(ValueError, match="2D"):
        T.quantize_fp8_e4m3(torch.zeros(2, 3, 4))


def test_fp8_e5m2_matches_jax():
    """E5M2 bits: a NaN keeps its sign over ml_dtypes' 0x7E (PyTorch's
    conversion alone gives 0x7F), +-inf and +-1e6 saturate to +-57344."""
    a = _x((8, 40), 7, 100.0)
    a[1, 3] = np.nan
    a[2, :4] = [1e6, -1e6, np.inf, -np.inf]
    q, s = F.quantize_fp8_e5m2(jnp.asarray(a))
    tq, ts = T.quantize_fp8_e5m2(torch.from_numpy(a))
    _eq(tq, q)
    _eq(ts, s)
    assert set(tq.numpy()[1]) == {0x7E}
    deq = T.dequantize_fp8_e5m2(tq, ts, dtype=torch.float32)
    np.testing.assert_array_equal(
        t32(deq), to_np(F.dequantize_fp8_e5m2(q, s, dtype=jnp.float32)))


def test_double_quant_matches_jax():
    a = _x((33, 70), 8, 2.0)
    ref = F.double_quant(jnp.asarray(a))
    got = T.double_quant(torch.from_numpy(a))
    assert got[4] is None and ref[4] is None
    for g, r in zip(got[:4], ref[:4]):
        _eq(g, r)


def test_dequant_absmax_matches_jax():
    """Double-quantized absmax by a nested state, and by per-256 scales for
    a 1-D and a 2-D input."""
    am = np.abs(_x((600,), 9)) + 0.1
    q, st = F.quantize_blockwise(jnp.asarray(am), blocksize=256)
    tq, tst = T.quantize_blockwise(torch.from_numpy(am), blocksize=256)
    _eq(tq, q)
    np.testing.assert_array_equal(t32(T.dequant_absmax(tq, tst)),
                                  to_np(F.dequant_absmax(q, st)))
    codes = np.random.default_rng(10).integers(-127, 128, (3, 600),
                                               dtype=np.int8)
    sc = np.abs(_x((3, 3), 11))
    for c, s in ((codes[0], sc[0]), (codes, sc)):
        np.testing.assert_array_equal(
            t32(T.dequant_absmax(torch.from_numpy(c), torch.from_numpy(s))),
            to_np(F.dequant_absmax(jnp.asarray(c), jnp.asarray(s))))


def test_colrow_matches_jax():
    w = _x((48, 80), 12, 3.0)
    q, r, c = F.quantize_colrow(jnp.asarray(w))
    tq, tr, tc = T.quantize_colrow(torch.from_numpy(w))
    for g, ref in ((tq, q), (tr, r), (tc, c)):
        _eq(g, ref)
    np.testing.assert_array_equal(
        t32(T.dequantize_colrow(tq, tr, tc, dtype=torch.float32)),
        to_np(F.dequantize_colrow(q, r, c, dtype=jnp.float32)))
    x, b = _x((6, 80), 13), _x((48,), 14)
    ref = F.matmul_colrow(jnp.asarray(x), q, r, c, jnp.asarray(b),
                          dtype=jnp.float32)
    got = T.matmul_colrow(torch.from_numpy(x), tq, tr, tc,
                          torch.from_numpy(b), dtype=torch.float32)
    assert rel_err(t32(got), to_np(ref)) <= 1e-5


def test_sparse_coo_matches_jax():
    """COO from dense (with a threshold), the scatter product in f32
    (1e-6: several entries add into one row in another order), int8
    values against one global scale (codes identical) and their product."""
    a = _x((20, 30), 15)
    a[np.abs(a) < 1.0] = 0.0
    dense = _x((30, 12), 16)
    for thr in (0.0, 1.5):
        ref = F.sparse_coo_from_dense(a, threshold=thr)
        got = T.sparse_coo_from_dense(torch.from_numpy(a), threshold=thr)
        for g, r in zip(got[:3], ref[:3]):
            _eq(g, r)
        assert got[3:] == ref[3:] == (20, 30)
    r, c, v, rows, cols = T.sparse_coo_from_dense(torch.from_numpy(a))
    jr, jc, jv, _, _ = F.sparse_coo_from_dense(a)
    ref = F.spmm_coo(jr, jc, jv, jnp.asarray(dense), rows, cols)
    got = T.spmm_coo(r, c, v, torch.from_numpy(dense), rows, cols)
    assert rel_err(t32(got), to_np(ref)) <= 1e-6
    ref_q = F.quantize_sparse_coo(jr, jc, jv)
    got_q = T.quantize_sparse_coo(r, c, v)
    _eq(got_q[2], ref_q[2])
    _eq(got_q[3], ref_q[3])
    ref = F.spmm_coo_int8(jr, jc, ref_q[2], ref_q[3], jnp.asarray(dense),
                          rows, cols, dtype=jnp.float32)
    got = T.spmm_coo_int8(r, c, got_q[2], got_q[3], torch.from_numpy(dense),
                          rows, cols, dtype=torch.float32)
    assert rel_err(t32(got), to_np(ref)) <= 1e-6


@pytest.mark.parametrize("qt", ["nf4", "fp4"])
def test_4bit_aliases_match_jax(qt):
    """quantize_/dequantize_/matmul_ nf4 and fp4, the codebook maps, and
    the QuantState dict of each package loading into the other's."""
    w = _x((40, 128), 17)
    jq = getattr(F, f"quantize_{qt}")
    tq = getattr(T, f"quantize_{qt}")
    p, st = jq(jnp.asarray(w), compress_statistics=True)
    tp, tst = tq(torch.from_numpy(w), compress_statistics=True)
    _eq(tp, p)
    deq = getattr(T, f"dequantize_{qt}")(tp, tst)
    np.testing.assert_array_equal(
        t32(deq), np.asarray(getattr(F, f"dequantize_{qt}")(p, st),
                             np.float32))
    x = _x((3, 128), 18)
    ref = getattr(F, f"matmul_{qt}")(jnp.asarray(x), p, st)
    got = getattr(T, f"matmul_{qt}")(torch.from_numpy(x), tp, tst)
    assert rel_err(t32(got), to_np(ref)) <= 1e-5
    book = {"nf4": (T.create_normal_map(), F.create_normal_map()),
            "fp4": (T.create_fp4_map(), F.create_fp4_map())}[qt]
    _eq(*book)
    # the JAX state's dict, as numpy, loads into the port and dequantizes
    # alike; the port's dict has the JAX keys and types
    jd = st.as_dict()
    jd = dict(jd, absmax=to_np(jd["absmax"]),
              state2=dict(jd["state2"], absmax=to_np(jd["state2"]["absmax"])))
    from_jax = T.QuantState.from_dict(jd)
    np.testing.assert_array_equal(t32(T.dequantize_4bit(tp, from_jax)),
                                  t32(deq))
    td = tst.as_dict()
    assert td.keys() == st.as_dict().keys()
    assert {k: td[k] for k in ("shape", "blocksize", "quant_type", "dtype")} \
        == {k: jd[k] for k in ("shape", "blocksize", "quant_type", "dtype")}
    assert T.QuantState.from_dict(td).state2.quant_type == "int8"


def test_package_exports_match_jax():
    """The port exports the JAX package's ``__all__`` (and has
    ``has_cuda_kernels`` beside it); importing it builds nothing,
    initializes no CUDA and imports neither jax nor transformers."""
    assert set(PORT.__all__) == set(JAX_PKG.__all__)
    assert callable(PORT.has_cuda_kernels)
    for name in PORT.__all__:
        assert hasattr(PORT, name), name
    assert PORT.is_available()
    assert PORT.has_native_kernels() == (
        torch.cuda.is_available()
        and torch.cuda.get_device_capability(0) == (9, 0))
    import subprocess
    import sys
    code = ("import sys, torch, tpu_bitsandbytes_torch; "
            "print(torch.cuda.is_initialized(), 'jax' in sys.modules, "
            "'transformers' in sys.modules, "
            "any(tpu_bitsandbytes_torch.has_cuda_kernels().values()))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["False"] * 4


# -- the bitsandbytes keywords (ROADMAP A6) -------------------------------

A6_FUNCTIONS = ["quantize_4bit", "quantize_nf4", "quantize_fp4",
                "dequantize_4bit", "dequantize_nf4", "dequantize_fp4",
                "quantize_blockwise", "dequantize_blockwise", "QuantState"]


def _default(v):
    """A default of either package, comparable: dtypes by name."""
    if v is jnp.uint8 or v is jnp.bfloat16:
        return np.dtype(v).name
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    return v


@pytest.mark.parametrize("name", A6_FUNCTIONS)
def test_a6_signatures_match_jax(name):
    """Parameter names, order, kinds and defaults equal JAX's under
    ``inspect.signature`` (the dtype defaults, jnp.uint8 / torch.uint8 and
    jnp.bfloat16 / torch.bfloat16, by name; annotations differ by
    package)."""
    import inspect

    def params(fn):
        return [(p.name, p.kind, _default(p.default))
                for p in inspect.signature(fn).parameters.values()]
    assert params(getattr(T, name)) == params(getattr(F, name))


@pytest.mark.parametrize("shape", [(40, 200), (1000,)])
def test_quantize_4bit_with_given_absmax(shape):
    """``absmax=`` replaces the statistics (here 1.5x the computed ones, so
    codes shift toward zero), with and without double quantization; the
    codes, absmax and nested state equal JAX's."""
    w = _x(shape, 30)
    _, st = F.quantize_4bit(jnp.asarray(w))
    am = np.asarray(st.absmax) * np.float32(1.5)
    for compress in (False, True):
        p, jst = F.quantize_4bit(jnp.asarray(w), absmax=jnp.asarray(am),
                                 compress_statistics=compress)
        tp, tst = T.quantize_4bit(torch.from_numpy(w),
                                  absmax=torch.from_numpy(am),
                                  compress_statistics=compress)
        _eq(tp, p)
        _eq(tst.absmax, jst.absmax)
        if compress:
            _eq(tst.state2.absmax, jst.state2.absmax)
        np.testing.assert_array_equal(
            t32(T.dequantize_4bit(tp, tst)),
            np.asarray(F.dequantize_4bit(p, jst), np.float32))


@pytest.mark.parametrize("qt", ["nf4", "fp4"])
def test_quantize_4bit_out_and_storage(qt):
    """``out=`` receives the packed bytes (and is returned); the aliases
    take ``quant_storage=`` and view the bytes as that dtype, as JAX's
    ``view``: int8 and float16 bytes equal JAX's."""
    w = _x((24, 128), 31)
    p, _ = getattr(F, f"quantize_{qt}")(jnp.asarray(w))
    out = torch.empty(p.shape[0], dtype=torch.uint8)
    got, _ = getattr(T, f"quantize_{qt}")(torch.from_numpy(w), out=out)
    assert got is out
    _eq(out, p)
    for tdt, jdt in ((torch.int8, jnp.int8), (torch.float16, jnp.float16)):
        jp, _ = getattr(F, f"quantize_{qt}")(jnp.asarray(w),
                                             quant_storage=jdt)
        tp, _ = getattr(T, f"quantize_{qt}")(torch.from_numpy(w),
                                             quant_storage=tdt)
        assert tp.dtype == tdt and tp.shape == jp.shape
        np.testing.assert_array_equal(
            tp.view(torch.uint8).numpy(),
            np.asarray(jp).view(np.uint8))


@pytest.mark.parametrize("qt", ["nf4", "fp4"])
def test_dequantize_4bit_without_a_state(qt):
    """``absmax``/``blocksize``/``quant_type`` in place of a QuantState:
    flat codes, two values per byte, bf16, equal to JAX's (the
    ``quant_type=`` of ``dequantize_4bit`` and the aliases); ``out=``
    receives them; neither a state nor absmax raises."""
    w = _x((3000,), 32)
    p, st = F.quantize_4bit(jnp.asarray(w), blocksize=128, quant_type=qt)
    tp = torch.from_numpy(np.asarray(p))
    am = torch.from_numpy(np.asarray(st.absmax))
    ref = np.asarray(F.dequantize_4bit(p, absmax=st.absmax, blocksize=128,
                                       quant_type=qt), np.float32)
    got = T.dequantize_4bit(tp, absmax=am, blocksize=128, quant_type=qt)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    np.testing.assert_array_equal(t32(got), ref)
    alias = getattr(T, f"dequantize_{qt}")(tp, absmax=am, blocksize=128)
    np.testing.assert_array_equal(t32(alias), np.asarray(
        getattr(F, f"dequantize_{qt}")(p, absmax=st.absmax, blocksize=128),
        np.float32))
    out = torch.empty(ref.shape, dtype=torch.bfloat16)
    assert T.dequantize_4bit(tp, absmax=am, out=out, blocksize=128,
                             quant_type=qt) is out
    np.testing.assert_array_equal(t32(out), ref)
    with pytest.raises(ValueError, match="quant_state or absmax"):
        T.dequantize_4bit(tp)


def test_blockwise_nested_and_keywords():
    """``nested=True`` double-quantizes the absmax in blocks of 256 (codes,
    the int8 absmax and its state equal JAX's, and so does the
    dequantized tensor through the nested state); ``out=`` receives the
    codes; ``code=``/``absmax=`` are unused, as in JAX; without a state,
    ``absmax=``/``blocksize=`` dequantize in A's shape to bf16."""
    a = _x((3, 70000), 33, 2.0)
    q, st = F.quantize_blockwise(jnp.asarray(a), blocksize=512, nested=True)
    out = torch.empty(a.shape, dtype=torch.int8)
    tq, tst = T.quantize_blockwise(torch.from_numpy(a), code=None,
                                   absmax=torch.ones(1), out=out,
                                   blocksize=512, nested=True)
    assert tq is out
    _eq(tq, q)
    _eq(tst.absmax, st.absmax)
    assert tst.absmax.dtype == torch.int8 and tst.state2.blocksize == 256
    _eq(tst.state2.absmax, st.state2.absmax)
    np.testing.assert_array_equal(
        t32(T.dequantize_blockwise(tq, tst)),
        np.asarray(F.dequantize_blockwise(q, st), np.float32))
    q2, st2 = F.quantize_blockwise(jnp.asarray(a), blocksize=512)
    tq2, tst2 = T.quantize_blockwise(torch.from_numpy(a), blocksize=512)
    ref = np.asarray(F.dequantize_blockwise(q2, absmax=st2.absmax,
                                            blocksize=512), np.float32)
    got = T.dequantize_blockwise(tq2, absmax=tst2.absmax, blocksize=512,
                                 nested=True)
    assert got.dtype == torch.bfloat16 and got.shape == a.shape
    np.testing.assert_array_equal(t32(got), ref)
    with pytest.raises(ValueError, match="quant_state or absmax"):
        T.dequantize_blockwise(tq2)


def test_quant_state_code_and_offset():
    """``QuantState.code`` is the codebook of an nf4/fp4 state (JAX's host
    copy's values; None for int8) and ``offset`` None, in JAX's field
    order; a checkpoint carries an offset both ways."""
    import dataclasses
    from tpu_bitsandbytes_torch.utils import checkpoint as C
    assert [f.name for f in dataclasses.fields(T.QuantState)] == [
        f.name for f in dataclasses.fields(F.QuantState)]
    for qt in ("nf4", "fp4"):
        w = _x((8, 64), 34)
        _, jst = F.quantize_4bit(jnp.asarray(w), quant_type=qt)
        _, tst = T.quantize_4bit(torch.from_numpy(w), quant_type=qt)
        _eq(tst.code, jst.code)
        assert tst.offset is None and jst.offset is None
    _, bst = T.quantize_blockwise(torch.ones(10))
    assert bst.code is None and F.quantize_blockwise(
        jnp.ones(10))[1].code is None
    st = T.QuantState(absmax=torch.ones(4), shape=(4, 64),
                      offset=torch.tensor(0.5))
    arrays = {}
    tree = C._decode(C._encode(st, arrays, "s"), arrays)
    assert float(tree.offset) == 0.5


# -- utils/metrics leftovers ----------------------------------------------

def test_metrics_leftovers_match_jax():
    """``matmul4bit_bytes`` equals JAX's (pure arithmetic);
    ``matmul4bit_roofline_us`` divides those bytes by a bandwidth the
    caller gives (no TPU table in the port); ``detect_chip`` names the
    device ("cpu" here); ``Timer`` times a block and ``Timer.time_fn``
    a function; ``trace`` marks a region for ``torch.profiler`` and with
    ``log_dir`` writes a profile there."""
    import tempfile
    from tpu_bitsandbytes.utils import metrics as JM
    from tpu_bitsandbytes_torch.utils import metrics as TMx
    for args in ((4096, 4096), (11008, 4096, 8), (4096, 11008, 256, 128)):
        assert TMx.matmul4bit_bytes(*args) == JM.matmul4bit_bytes(*args)
    assert TMx.matmul4bit_roofline_us(4096, 4096, 1, bw_bytes_per_s=2e12) \
        == JM.matmul4bit_bytes(4096, 4096, 1) / 2e12 * 1e6
    assert TMx.detect_chip() == "cpu"
    with TMx.Timer() as t:
        sum(range(1000))
    assert t.elapsed > 0
    assert TMx.Timer.time_fn(lambda x: x + 1, torch.ones(4), iters=3,
                             warmup=1) > 0
    with tempfile.TemporaryDirectory() as d:
        with TMx.trace("region", log_dir=d):
            torch.ones(8) @ torch.ones(8)
        assert any(f.endswith(".json") for f in os.listdir(d))
    with TMx.trace("region"):
        pass
