"""PyTorch port vs JAX package: the packed-NF4 x A8 matmul (kernel K4).

The same numpy weights and activations go through JAX's
``w4a8_matmul_4bit`` (its Pallas kernel in interpret mode on the CPU) and
the port's wrapper (the kernel's plain version on CPU tensors).
Tolerance 1e-5 of max|ref|: the int8 codes and the int32 block dots are
exact in both, so only the f32 order of the block sums can differ.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpu_bitsandbytes import functional as F
from tpu_bitsandbytes.models.layers import QLinear4 as JQLinear4
from tpu_bitsandbytes.ops import w4a8 as JW
from tpu_bitsandbytes_torch import functional as TF
from tpu_bitsandbytes_torch.convert import from_reference_arrays, torch_dtype
from tpu_bitsandbytes_torch.ops import w4a8 as TW

from test_torch_functional import qlinear_arrays, rel_err, t32

TOL = 1e-5


def port_state(js) -> TF.QuantState:
    """A JAX QuantState (and its nested state) as the port's."""
    st2 = None
    if js.state2 is not None:
        st2 = port_state(js.state2)
    return TF.QuantState(
        absmax=torch.from_numpy(np.asarray(js.absmax).copy()),
        shape=js.shape, blocksize=js.blocksize, quant_type=js.quant_type,
        dtype=torch_dtype(jnp.dtype(js.dtype).name), state2=st2)


def _case(m, n, k, blocksize, seed, double_quant=False, dtype=jnp.float32,
          quant_type="nf4"):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed, js = F.quantize_4bit(jnp.asarray(w), blocksize=blocksize,
                                 compress_statistics=double_quant,
                                 quant_type=quant_type)
    js.dtype = jnp.dtype(dtype)
    return (x, packed, js, torch.from_numpy(np.asarray(packed).copy()),
            port_state(js))


def test_int8_codebook_matches_jax():
    assert TW.NF4_I8 == tuple(int(v) for v in JW.NF4_I8_NP)
    assert TW.NF4_I8[0] == -127 and TW.NF4_I8[-1] == 127


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("blocksize,k", [(64, 512), (128, 768), (64, 500)])
def test_w4a8_matches_jax(m, blocksize, k):
    x, jpk, js, tpk, ts = _case(m, 256, k, blocksize, seed=m + k)
    ref = JW.w4a8_matmul_4bit(jnp.asarray(x), jpk, js,
                              out_dtype=jnp.float32)
    got = TW.w4a8_matmul_4bit(torch.from_numpy(x), tpk, ts,
                              out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, 256)
    assert rel_err(t32(got), np.asarray(ref)) <= TOL


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_w4a8_double_quant_bias_out_dtype(out_dtype):
    """Double-quantized absmax (dequantized outside the kernel), a bias,
    and the output cast. bf16 output: both packages round the same f32
    values to bf16, so the 1e-5 holds there too up to one bf16 ulp where an
    f32 difference crosses a rounding boundary (2**-8 of max|ref|)."""
    x, jpk, js, tpk, ts = _case(8, 384, 512, 64, seed=3, double_quant=True)
    bias = np.random.default_rng(4).standard_normal(384).astype(np.float32)
    jd, td = jnp.dtype(out_dtype), torch_dtype(out_dtype)
    ref = JW.w4a8_matmul_4bit(jnp.asarray(x), jpk, js,
                              bias=jnp.asarray(bias), out_dtype=jd)
    got = TW.w4a8_matmul_4bit(torch.from_numpy(x), tpk, ts,
                              bias=torch.from_numpy(bias), out_dtype=td)
    assert got.dtype == td
    tol = TOL if out_dtype == "float32" else 2 ** -8
    assert rel_err(t32(got), np.asarray(ref, np.float32)) <= tol


def test_takes_w4a8_equals_jax_rule():
    """The K4 rule equals ``_select_tiles_w4a8(...) is not None`` (plus
    NF4, which JAX checks first) over a grid of shapes."""
    checked = 0
    for qt in ("nf4", "fp4"):
        for m in (1, 8, 64, 65):
            for n in (128, 256, 384, 1000, 4096, 32000):
                for k in (128, 200, 4096, 5120, 13824, 16384, 20000):
                    for bs in (2, 4, 64, 128, 256):
                        kp = F._pad_k(k, bs)
                        jax_takes = (qt == "nf4" and JW._select_tiles_w4a8(
                            m, n, kp // 2, bs // 2) is not None)
                        assert TW.takes_w4a8(m, n, kp, bs, qt) == jax_takes, (
                            qt, m, n, k, bs)
                        checked += jax_takes
    assert checked > 50


@pytest.mark.parametrize("blocksize", [4, 6, 8, 12, 48, 64, 4096])
def test_w4a8_blocksizes_are_the_kernels(blocksize):
    """``takes_w4a8`` admits every even blocksize of 4 or more, as JAX
    does, and K4 takes multiples of 4: both packages build 4-bit states
    with power-of-two blocksizes only, so the two never disagree."""
    k_pad = 2 * math.lcm(blocksize // 2, 128)
    assert TW.takes_w4a8(8, 128, k_pad, blocksize, "nf4")
    w = np.zeros((128, k_pad), np.float32)
    if blocksize & (blocksize - 1):
        with pytest.raises(ValueError, match="power of 2"):
            F.quantize_4bit(jnp.asarray(w), blocksize=blocksize)
        with pytest.raises(ValueError, match="power of 2"):
            TF.quantize_4bit(torch.from_numpy(w), blocksize=blocksize)
    else:
        assert blocksize % 4 == 0


def test_w4a8_raises_off_the_rule():
    x, _, _, tpk, ts = _case(65, 256, 512, 64, seed=5)
    with pytest.raises(NotImplementedError):
        TW.w4a8_matmul_4bit(torch.from_numpy(x), tpk, ts)


@pytest.mark.parametrize("m,double_quant", [(8, False), (8, True),
                                            (100, False), (300, True)])
def test_qlinear4_without_cache_matches_jax(monkeypatch, m, double_quant):
    """QLinear4 off its packed bytes, handed over through
    ``from_reference_arrays`` with the keys that are None left out: M <= 64
    takes K4, M = 100 K5 and M = 300 the dequant product, in both packages
    (JAX with its kernels in interpret mode)."""
    monkeypatch.setenv("TBNB_W4A8_INTERPRET", "1")
    monkeypatch.setenv("TBNB_FUSED_INTERPRET", "1")
    rng = np.random.default_rng(m)
    w = (rng.standard_normal((256, 500)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, 500)).astype(np.float32)
    jq = JQLinear4.quantize(jnp.asarray(w), dtype=jnp.float32,
                            compress_statistics=double_quant)
    arrays = {k: v for k, v in qlinear_arrays(jq).items() if v is not None}
    assert "w_cache" not in arrays
    tq = from_reference_arrays(arrays, "cpu")
    assert tq.w_cache is None and (tq.absmax_q is not None) == double_quant
    calls = []
    monkeypatch.setattr(TW, "w4a8_mm", lambda *a: calls.append(1) or
                        TW.w4a8_mm_plain(*a))
    ref = np.asarray(jq(jnp.asarray(x)))
    got = t32(tq(torch.from_numpy(x)))
    assert bool(calls) == (m <= 64)
    assert rel_err(got, ref) <= TOL


def _byte_perm(x, y, s):
    """CUDA's __byte_perm on numpy uint32 arrays: result byte i is byte
    ((s >> 4i) & 7) of the eight bytes of (x, y)."""
    src = (x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32)))
    out = np.zeros_like(x, dtype=np.uint64)
    for i in range(4):
        sel = (s >> np.uint32(4 * i)) & np.uint32(7)
        byte = (src >> (sel.astype(np.uint64) * np.uint64(8))) & np.uint64(255)
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32)


def test_kernel_decode_words_give_the_codebook():
    """The table words the wrapper hands K4, run through the kernel's
    decode (two table lookups, then a pick by bit 3 of each code), turn
    every 16-bit group of four codes into their NF4_I8 values."""
    t0, t1, t2, t3 = (np.uint32(w) for w in TW._table_words())
    v = np.arange(1 << 16, dtype=np.uint32)
    sel = v & np.uint32(0x7777)
    lo = _byte_perm(np.full_like(v, t0), np.full_like(v, t1), sel)
    hi = _byte_perm(np.full_like(v, t2), np.full_like(v, t3), sel)
    got = _byte_perm(lo, hi, np.uint32(0x3210) | ((v >> np.uint32(1))
                                                  & np.uint32(0x4444)))
    got = got.view(np.int8).reshape(-1, 4)
    codes = (v[:, None] >> (np.arange(4, dtype=np.uint32) * 4)) & 15
    np.testing.assert_array_equal(got, np.asarray(TW.NF4_I8)[codes])


# The tensor-core K4 (csrc/w4a8_matmul.cu), mirrored in numpy: one warp,
# mma.sync m16n8k32 with the weights as A (16 rows) and the activations as
# B (8 rows). PTX's fragment layout, for lane (g, t) = (lane >> 2, lane & 3):
# A register r holds row g + 8 * (r & 1), logical k 4t + i + 16 * (r >> 1)
# in byte i; B register j holds column (activation row) g, logical k
# 4t + i + 16 * j. The kernel fills them from the k32 step's 32-code window
# so that logical k 4t + i + 16h is the physical code 8t + 4h + i: A from
# the packed word at bytes 4t..4t+3 of the row (decode8: low half into a0/a1,
# high half into a2/a3), B from x[row][8t .. 8t + 7].
MAGIC = 0x4B400000          # a block's int32 MMA chain starts here
MAGIC_F = np.float32(12582912.0)


def _decode8(v, words):
    """The kernel's decode8 on uint32 words v: (codes 0-3, codes 4-7) as
    int8x4 words, byte i for code i."""
    t0, t1, t2, t3 = (np.full_like(v, w) for w in words)
    sel = v & np.uint32(0x77777777)
    pick = np.uint32(0x32103210) | ((v >> np.uint32(1))
                                    & np.uint32(0x44444444))

    def half(s, p):
        return _byte_perm(_byte_perm(t0, t1, s), _byte_perm(t2, t3, s), p)

    return half(sel, pick), half(sel >> np.uint32(16), pick >> np.uint32(16))


def _fragments(packed_step, x_step, words):
    """A and B registers of all 32 lanes for one k32 step: packed_step
    uint8 [16 rows, 16 bytes], x_step int8 [8 rows, 32]. Returns int8
    arrays A [32 lanes, 4 regs, 4 bytes] and B [32, 2, 4]."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    word = packed_step.view("<u4")                # [16 rows, 4 words]
    lo_g, hi_g = _decode8(word[g, t], words)
    lo_g8, hi_g8 = _decode8(word[g + 8, t], words)
    regs = np.stack([lo_g, lo_g8, hi_g, hi_g8], axis=1).astype("<u4")
    a = regs.view(np.int8).reshape(32, 4, 4)
    b = x_step.reshape(8, 4, 8)[g, t].reshape(32, 2, 4)
    return a, b


def _mma_m16n8k32(a, b):
    """D [16, 8] = A B over PTX's logical fragment layout."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    a_full = np.zeros((16, 32), np.int64)
    b_full = np.zeros((32, 8), np.int64)
    for r in range(4):
        for i in range(4):
            a_full[g + 8 * (r & 1), 4 * t + i + 16 * (r >> 1)] = a[:, r, i]
    for j in range(2):
        for i in range(4):
            b_full[4 * t + i + 16 * j, g] = b[:, j, i]
    return a_full @ b_full


def test_kernel_fragment_map_covers_the_window_once():
    """Over one k32 step, the 32 lanes' A registers hold every (weight row,
    code) of the 16 x 32 window once, each decoded from its own packed byte
    and nibble, and their B registers every (activation row, k) once."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    seen_a, seen_b = np.zeros((16, 32), int), np.zeros((8, 32), int)
    for r in range(4):
        row = g + 8 * (r & 1)
        for i in range(4):
            k = 8 * t + 4 * (r >> 1) + i                # physical code
            # packed byte 4t + 2 * (r >> 1) + i // 2 of the row, nibble i % 2
            byte = 4 * t + 2 * (r >> 1) + i // 2
            assert np.array_equal(byte, k // 2) and i % 2 == k[0] % 2
            np.add.at(seen_a, (row, k), 1)
    for j in range(2):
        for i in range(4):
            np.add.at(seen_b, (g, 8 * t + 4 * j + i), 1)
    assert (seen_a == 1).all() and (seen_b == 1).all()


def test_kernel_fragment_map_gives_the_block_sums():
    """One full tile of the tensor-core K4 (16 weight rows, one 256-code
    chunk, 8 activation rows, blocksize 64) through the kernel's decode,
    fragment fill and MMA, emulated: the int32 block sums equal the direct
    dot of x with the codebook values, read exactly as floats from the
    MAGIC-seeded chains; scaled block by block they give w4a8_mm_plain."""
    rng = np.random.default_rng(11)
    n, m, kp, bs = 16, 8, 256, 64
    packed = rng.integers(0, 256, (n, kp // 2), dtype=np.uint8)
    xq = rng.integers(-127, 128, (m, kp), dtype=np.int8)
    absmax = rng.uniform(5e-3, 3.5e-2, (n, kp // bs)).astype(np.float32)
    s_x = rng.uniform(1e-3, 5e-2, (m,)).astype(np.float32)
    words = [np.uint32(w) for w in TW._table_words()]
    codes = np.stack([packed & 15, packed >> 4], axis=-1).reshape(n, kp)
    w_i8 = np.asarray(TW.NF4_I8, np.int64)[codes]
    acc = np.zeros((n, m), np.float32)
    for blk in range(kp // bs):
        chain = np.full((n, m), MAGIC, np.int64)
        for step in range(blk * bs // 32, (blk + 1) * bs // 32):
            a, b = _fragments(packed[:, step * 16:(step + 1) * 16],
                              xq[:, step * 32:(step + 1) * 32], words)
            chain += _mma_m16n8k32(a, b)
        direct = w_i8[:, blk * bs:(blk + 1) * bs] @ xq[:, blk * bs:(
            blk + 1) * bs].astype(np.int64).T
        assert np.array_equal(chain - MAGIC, direct)
        as_float = chain.astype(np.uint32).view(np.float32) - MAGIC_F
        assert np.array_equal(as_float, direct.astype(np.float32))
        acc += as_float * (absmax[:, blk:blk + 1]
                           * np.float32(1.0 / 127.0))
    got = (acc * s_x[None, :]).T
    ref = TW.w4a8_mm_plain(torch.from_numpy(xq), torch.from_numpy(packed),
                           torch.from_numpy(absmax), torch.from_numpy(s_x))
    assert rel_err(got, t32(ref)) <= 1e-6
