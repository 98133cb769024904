"""PyTorch port vs JAX package: the int4 runtime cache and its matmul (K1).

JAX's ``int4_matmul`` runs its Pallas kernel in interpret mode on the CPU,
as tests/test_int4_cache.py runs it; the port runs K1's plain version.

Tolerances: int4 codes are bit-identical and scales agree to f32 rounding
(<= 1e-6). In f32 the block dots are exact integers in both packages and
only the f32 sum order differs: <= 1e-5 of max|ref|. In bf16 the outputs
are those f32 sums rounded once: <= 1 bf16 ulp elementwise.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpu_bitsandbytes.models.layers import QLinear4 as JQLinear4
from tpu_bitsandbytes.ops import int4cache as J
from tpu_bitsandbytes_torch.convert import from_reference_arrays
from tpu_bitsandbytes_torch.functional import matmul_4bit
from tpu_bitsandbytes_torch.models.layers import QLinear4
from tpu_bitsandbytes_torch.ops import int4cache as T

from test_torch_functional import qlinear_arrays, rel_err, t32, to_np
from test_torch_w4a8 import MAGIC, MAGIC_F, _byte_perm, _mma_m16n8k32


def _w(n, k, seed):
    return (np.random.default_rng(seed).standard_normal((n, k)) * 0.05
            ).astype(np.float32)


def _both(w):
    jq, js = J.quantize_int4(jnp.asarray(w))
    tq, ts = T.quantize_int4(torch.from_numpy(w))
    return jq, js, tq, ts


@pytest.mark.parametrize("n,k", [(128, 256), (100, 200), (2100, 128)])
def test_quantize_int4_matches(n, k):
    """(2100, 128): N >= JAX's tile, so JAX pads N; compare the real rows."""
    jq, js, tq, ts = _both(_w(n, k, seed=n + k))
    np.testing.assert_array_equal(T.unpack_int4(tq).numpy(), to_np(jq)[:n])
    assert rel_err(ts.numpy(), np.asarray(js)[:, :n]) <= 1e-6
    assert rel_err(t32(T.dequant_int4(tq, ts)),
                   np.asarray(J.dequant_int4(jq, js))[:n]) <= 1e-6


def _ulp_bf16(ref):
    mag = np.maximum(np.abs(ref), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("m", [1, 8, 13, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_matmul_matches(m, dtype):
    """M <= 64 runs the A8 kernel path in both packages, M = 80 the
    dequant path; K = 200 exercises the K padding."""
    n, k = 256, 200
    jq, js, tq, ts = _both(_w(n, k, seed=1))
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    ref = np.asarray(J.int4_matmul(jnp.asarray(x, jd), jq, js,
                                   out_dtype=jd), np.float32)
    got = t32(T.int4_matmul(torch.from_numpy(x).to(td), tq, ts,
                            out_dtype=td))
    assert got.shape == ref.shape == (m, n)
    if dtype == "float32":
        assert rel_err(got, ref) <= 1e-5
    else:
        assert (np.abs(got - ref) <= _ulp_bf16(ref)).all()


def test_small_m_dequant_branch():
    """N = 100 is below JAX's tile and not a multiple of 128: JAX takes the
    dequant branch even at M = 4, with no A8 quantization, and so must the
    port (the A8 path would differ by ~1%)."""
    n, k, m = 100, 256, 4
    assert not T.takes_kernel(m, n, k, T.INT4_BLOCK)
    jq, js, tq, ts = _both(_w(n, k, seed=2))
    x = np.random.default_rng(3).standard_normal((m, k)).astype(np.float32)
    ref = np.asarray(J.int4_matmul(jnp.asarray(x), jq, js,
                                   out_dtype=jnp.float32))
    got = t32(T.int4_matmul(torch.from_numpy(x), tq, ts,
                            out_dtype=torch.float32))
    assert rel_err(got, ref) <= 1e-5
    xq_like = ref - np.asarray(x) @ np.asarray(J.dequant_int4(jq, js)).T
    assert np.abs(xq_like).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("m,n,k", [
    (8, 12288, 4096), (8, 4096, 4096), (8, 22016, 4096), (8, 4096, 11008),
    (8, 32000, 4096), (64, 22016, 4096), (65, 4096, 4096), (1, 100, 256),
    (1, 1000, 256), (1, 2047, 640), (8, 2053, 4096), (3, 384, 384),
    (4, 256, 192)])
def test_branch_choice_matches_jax(m, n, k):
    """The port's branch rule against JAX's own: the N padding of its
    quantize_int4 followed by the tile search of int4_matmul."""
    kp = J._round_up(k, J.INT4_BLOCK)
    t = J._preferred_tile(kp)
    n_pad = J._round_up(n, t) if n >= t else n
    jax_kernel = (m <= J._MAX_M and kp % 128 == 0
                  and J._select_n_tile(n_pad, kp) is not None)
    assert T.takes_kernel(m, n, kp, J.INT4_BLOCK) == jax_kernel


def test_qlinear_runtime_cache_matches():
    """NF4 -> int4 requantization in QLinear4.with_runtime_cache: the same
    NF4 bytes give the same int4 codes in both packages, and a converted
    JAX QLinear4 (N padding stripped) computes what JAX computes."""
    w = _w(320, 384, seed=4)
    jq = JQLinear4.quantize(jnp.asarray(w), dtype=jnp.float32
                            ).with_runtime_cache("int4")
    tq = QLinear4.quantize(torch.from_numpy(w), dtype=torch.float32
                           ).with_runtime_cache("int4")
    np.testing.assert_array_equal(
        T.unpack_int4(tq.w_cache).numpy(), to_np(jq.w_cache)[:320])
    conv = from_reference_arrays(qlinear_arrays(jq), "cpu")
    np.testing.assert_array_equal(conv.w_cache.numpy(), tq.w_cache.numpy())
    x = np.random.default_rng(5).standard_normal((2, 3, 384)).astype(
        np.float32)
    ref = np.asarray(jq(jnp.asarray(x)))
    assert rel_err(t32(conv(torch.from_numpy(x))), ref) <= 1e-5
    assert rel_err(t32(tq(torch.from_numpy(x))), ref) <= 1e-5


def test_no_cache_raises():
    """Without a runtime cache a QLinear4 runs off its packed bytes (here
    K = 128 is off the K4 rule, so ``matmul_4bit``); what raises is a
    cache format that neither package has (the JAX package's ValueError)."""
    q = QLinear4.quantize(torch.from_numpy(_w(128, 128, seed=6)),
                          dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, 128)).astype(np.float32))
    ref = matmul_4bit(x, q.packed.reshape(-1), q.quant_state())
    assert torch.equal(q(x), ref)
    with pytest.raises(ValueError, match="int3"):
        q.with_runtime_cache("int3")


def test_cpu_calls_take_the_plain_version():
    jq, js, tq, ts = _both(_w(128, 256, seed=7))
    before = T.int4_mm.launches, T.int4_mm_plain.cuda_calls
    T.int4_matmul(torch.ones((2, 256)), tq, ts)
    assert (T.int4_mm.launches, T.int4_mm_plain.cuda_calls) == before


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_large_m_route_follows_its_inputs(dtype, grad):
    """Above K1's M, only a bf16 x on a card that records no gradient takes
    the bf16 decode and the tensor-core GEMM. On the CPU, in f32, and for an
    x that records a gradient, the product is the widened one: x and the
    cache dequantized to x's dtype, both in f32, one f32 matmul (which
    differentiates in x); the decode kernel never runs."""
    n, k, m = 256, 200, 80
    _, _, tq, ts = _both(_w(n, k, seed=13))
    td = getattr(torch, dtype)
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (m, k)).astype(np.float32)).to(td).requires_grad_(grad)
    assert not T.takes_kernel(m, n, 256, T.INT4_BLOCK)
    before = T.dequant_int4_bf16.launches, T.int4_mm.launches
    got = T.int4_matmul(x, tq, ts, out_dtype=torch.float32)
    xp = torch.nn.functional.pad(x.detach(), (0, 256 - k)).to(torch.float32)
    want = xp @ T.dequant_int4(tq, ts, dtype=td).to(torch.float32).t()
    assert torch.equal(got.detach(), want)
    assert (T.dequant_int4_bf16.launches, T.int4_mm.launches) == before
    assert (got.grad_fn is not None) == grad
    if grad:
        g = torch.ones_like(got)
        got.backward(g)
        d_x = g @ T.dequant_int4(tq, ts, dtype=td).to(torch.float32)
        assert torch.equal(x.grad, d_x[:, :k].to(td))


@pytest.mark.parametrize("n,k,bs", [(200, 200, 128), (96, 512, 32),
                                    (64, 1024, 256), (24, 100, 8)])
def test_dequant_kernel_layout_gives_dequant_int4(n, k, bs):
    """``csrc/int4_dequant.cu`` mirrored in numpy: word w = n * (K_pad/8) + c
    (four bytes of codes, loaded and stored by one lane) takes the scale of
    block c // (bs / 8) of row n; each byte
    gives one 32-bit word of two bf16 values (the low nibble's, sign-fixed
    as (v ^ 8) - 8, in the low half), f32 products rounded to nearest even,
    and the four words one 16-byte store at out[n, 8 c:8 c + 8]. Bit for
    bit the CPU's ``dequant_int4(..., dtype=bfloat16)``, which
    ``dequant_int4_bf16`` returns on the CPU."""
    rng = np.random.default_rng(n + k + bs)
    tq, ts = T.quantize_int4(torch.from_numpy(_w(n, k, seed=bs)), bs)
    tq = torch.from_numpy(rng.integers(0, 256, tuple(tq.shape),
                                       dtype=np.uint8))
    codes, scales = tq.numpy(), ts.numpy()
    kp = codes.shape[1] * 2
    per_row = kp // 8
    w = np.arange(n * per_row)
    row, c = w // per_row, w % per_row
    s = scales[c // (bs // 8), row]                         # [words]
    b = codes.reshape(-1, 4).astype(np.int32)               # [words, 4]
    lo = ((b & 0xF) ^ 8) - 8
    hi = (((b >> 4) & 0xF) ^ 8) - 8
    prod = np.stack([lo, hi], -1).astype(np.float32) * s[:, None, None]
    bits = torch.from_numpy(prod).to(torch.bfloat16).view(torch.int16)
    pairs = (bits[..., 0].to(torch.int32) & 0xFFFF) | (
        bits[..., 1].to(torch.int32) << 16)                 # [words, 4]
    out = pairs.numpy().astype("<i4")
    want = T.dequant_int4(tq, ts, dtype=torch.bfloat16)
    assert np.array_equal(out.reshape(n, kp // 2).view("<u2"),
                          want.view(torch.int16).numpy().view("<u2"))
    assert torch.equal(T.dequant_int4_bf16(tq, ts), want)


# The tensor-core K1 (csrc/int4_matmul.cu on csrc/a8_tc.cuh), mirrored in
# numpy. Its decode sign-extends the low and the high nibbles of a packed
# word apart and interleaves them with two byte permutes, so that it gives
# codes 0-3 of the word in one int8x4 word and 4-7 in the other, the order
# K4's table decode gives: the fragment map is K4's (test_torch_w4a8.py).

def _sext_nibbles(v):
    return v | ((v & np.uint32(0x08080808)) * np.uint32(0x1E))


def _int4_decode8(v):
    """The kernel's Int4::decode8 on uint32 words v."""
    ev = _sext_nibbles(v & np.uint32(0x0F0F0F0F))
    od = _sext_nibbles((v >> np.uint32(4)) & np.uint32(0x0F0F0F0F))
    return (_byte_perm(ev, od, np.full_like(v, 0x5140)),
            _byte_perm(ev, od, np.full_like(v, 0x7362)))


def test_kernel_decode_gives_unpack_int4():
    """Every byte value in every byte position of a word, and random words:
    the decode's eight int8 values are ``unpack_int4``'s codes of the word's
    four bytes, in element order."""
    rng = np.random.default_rng(12)
    b = np.arange(256, dtype=np.uint32)
    words = np.concatenate([b << np.uint32(8 * i) for i in range(4)]
                           + [rng.integers(0, 2 ** 32, 4096, dtype=np.uint32)])
    lo, hi = _int4_decode8(words)
    got = np.stack([lo, hi], axis=1).astype("<u4").view(np.int8)
    packed = torch.from_numpy(words.astype("<u4").view(np.uint8).reshape(-1, 4))
    np.testing.assert_array_equal(got.reshape(-1, 8),
                                  T.unpack_int4(packed).numpy())


def _int4_fragments(packed_step, x_step):
    """A and B registers of all 32 lanes for one k32 step of K1: packed_step
    uint8 [16 rows, 16 bytes], x_step int8 [8 rows, 32]."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    word = packed_step.view("<u4")                # [16 rows, 4 words]
    lo_g, hi_g = _int4_decode8(word[g, t])
    lo_g8, hi_g8 = _int4_decode8(word[g + 8, t])
    regs = np.stack([lo_g, lo_g8, hi_g, hi_g8], axis=1).astype("<u4")
    a = regs.view(np.int8).reshape(32, 4, 4)
    b = x_step.reshape(8, 4, 8)[g, t].reshape(32, 2, 4)
    return a, b


@pytest.mark.parametrize("bs", [32, 64, 128, 256])
def test_kernel_fragment_map_gives_the_block_sums(bs):
    """One tile of K1 (16 weight rows, one 256-code chunk, 8 activation
    rows) through the kernel's decode, fragment fill and MMA, emulated: the
    permuted int32 block sums equal the plain dots of x with unpack_int4's
    codes, read exactly as floats from the MAGIC-seeded chains; scaled by
    the K-major scale[b, n] block by block and by s_x last they give
    int4_mm_plain."""
    rng = np.random.default_rng(bs)
    n, m, kp = 16, 8, 256
    packed = rng.integers(0, 256, (n, kp // 2), dtype=np.uint8)
    xq = rng.integers(-127, 128, (m, kp), dtype=np.int8)
    scales = rng.uniform(1e-3, 1e-2, (kp // bs, n)).astype(np.float32)
    s_x = rng.uniform(1e-3, 5e-2, (m,)).astype(np.float32)
    w_i8 = T.unpack_int4(torch.from_numpy(packed)).numpy().astype(np.int64)
    acc = np.zeros((n, m), np.float32)
    for blk in range(kp // bs):
        chain = np.full((n, m), MAGIC, np.int64)
        for step in range(blk * bs // 32, (blk + 1) * bs // 32):
            a, b = _int4_fragments(packed[:, step * 16:(step + 1) * 16],
                                   xq[:, step * 32:(step + 1) * 32])
            chain += _mma_m16n8k32(a, b)
        cols = slice(blk * bs, (blk + 1) * bs)
        direct = w_i8[:, cols] @ xq[:, cols].astype(np.int64).T
        assert np.array_equal(chain - MAGIC, direct)
        as_float = chain.astype(np.uint32).view(np.float32) - MAGIC_F
        assert np.array_equal(as_float, direct.astype(np.float32))
        acc += as_float * scales[blk][:, None]
    got = (acc * s_x[None, :]).T
    ref = T.int4_mm_plain(torch.from_numpy(xq), torch.from_numpy(packed),
                          torch.from_numpy(scales), torch.from_numpy(s_x))
    assert rel_err(got, t32(ref)) <= 1e-6
