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
