"""PyTorch port vs JAX package: the fused 4-bit matmul (kernel K5).

The port's ``matmul_4bit`` (the kernel's plain version on CPU tensors)
against JAX's ``fused_matmul_4bit`` (its Pallas kernel in interpret mode on
the CPU), on the same numpy inputs. Tolerances, as shares of max|ref|:
f32 mode 1e-5 (exact products in both, only the f32 sum order differs);
bf16 mode 1e-2 (the same bf16 weights and x, but the f32 result is rounded
to bf16, whose ulp at max|ref| is 3.9e-3).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpu_bitsandbytes import functional as F
from tpu_bitsandbytes.ops import matmul4bit as JM
from tpu_bitsandbytes_torch import functional as TF
from tpu_bitsandbytes_torch.ops import matmul4bit as TM

from test_torch_functional import rel_err, t32
from test_torch_w4a8 import _case

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("m,n,k,double_quant", [
    (65, 256, 512, False), (128, 200, 500, True), (256, 131, 384, False)])
def test_fused_matmul_matches_jax(dtype, quant_type, m, n, k, double_quant):
    """M over the K4 limit up to the K5 crossover, odd N (JAX pads N to a
    lane multiple), K padded to the block."""
    jd = jnp.dtype(dtype)
    x, jpk, js, tpk, ts = _case(m, n, k, 64, seed=m + n, dtype=jd,
                                double_quant=double_quant,
                                quant_type=quant_type)
    ref = JM.fused_matmul_4bit(jnp.asarray(x), jpk, js, mxu_dtype=jd)
    got = TF.matmul_4bit(torch.from_numpy(x), tpk, ts,
                         compute_dtype=ts.dtype)
    assert got.dtype == ts.dtype and got.shape == (m, n)
    assert rel_err(t32(got), np.asarray(ref, np.float32)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_m257_takes_the_dequant_product_in_both(monkeypatch, dtype):
    """M = 257 passes the crossover: neither package calls its fused
    matmul, and both multiply the dequantized weight."""
    monkeypatch.setenv("TBNB_FUSED_INTERPRET", "1")
    jd = jnp.dtype(dtype)
    x, jpk, js, tpk, ts = _case(257, 256, 512, 64, seed=7, dtype=jd)
    jcalls, tcalls = [], []
    monkeypatch.setattr(JM, "fused_matmul_4bit",
                        lambda *a, **k: jcalls.append(1))
    monkeypatch.setattr(TM, "matmul4bit_mm",
                        lambda *a, **k: tcalls.append(1))
    ref = F.matmul_4bit(jnp.asarray(x), jpk, js, compute_dtype=jd)
    got = TF.matmul_4bit(torch.from_numpy(x), tpk, ts, compute_dtype=ts.dtype)
    assert not jcalls and not tcalls
    assert rel_err(t32(got), np.asarray(ref, np.float32)) <= TOL[dtype]


@pytest.mark.parametrize("shape", [(320,), (2, 30, 320)])
def test_matmul_4bit_reshapes_match_jax(monkeypatch, shape):
    """1-D and 3-D inputs flatten to rows and come back in their shape
    (M = 1 and M = 60, both fused), with a bias."""
    monkeypatch.setenv("TBNB_FUSED_INTERPRET", "1")
    x, jpk, js, tpk, ts = _case(1, 256, 320, 64, seed=11)
    x = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    bias = np.linspace(-1, 1, 256, dtype=np.float32)
    ref = F.matmul_4bit(jnp.asarray(x), jpk, js, bias=jnp.asarray(bias))
    got = TF.matmul_4bit(torch.from_numpy(x), tpk, ts,
                         bias=torch.from_numpy(bias))
    assert got.shape == shape[:-1] + (256,)
    assert rel_err(t32(got), np.asarray(ref)) <= TOL["float32"]


def test_fused_raises_off_the_rule():
    """The JAX package's kernel takes only 2-D states with an even
    blocksize."""
    w = torch.randn(64, 64)
    packed, st = TF.quantize_4bit(w.reshape(-1), blocksize=64)
    with pytest.raises(NotImplementedError):
        TM.fused_matmul_4bit(torch.randn(2, 64), packed, st)
    packed, st = TF.quantize_4bit(w, blocksize=1)
    with pytest.raises(NotImplementedError):
        TM.fused_matmul_4bit(torch.randn(2, 64), packed, st)


def _wgmma_emulation(x, packed, absmax, book, splits):
    """The wgmma kernel's arithmetic, thread by thread, in torch: each CTA
    (128 weight rows, all M tokens) walks its split's 64-code stages; in
    each k16 slice consumer thread (warpgroup, warp, lane g t) decodes bytes
    t and t+4 of its rows r0 and r0 + 8 into four bf16x2 registers (a[0] row
    r0 k 2t..2t+1, a[1] row r0+8 k 2t..2t+1, a[2]/a[3] the same at k + 8),
    with the block scale its fetch counters give; the register A tile times
    x's slice is summed over the slices, the splits' partials in split
    order. TMA's zero fill past M, N and K_pad is mirrored. Asserts that
    every code of a tile is decoded exactly once and that the counters give
    each slice its block. Returns out f32 [M, N] (summed in f64)."""
    m, kp = x.shape
    n, nb = absmax.shape
    bs16 = kp // nb // 16
    nt = 64 if m <= 64 else 128 if m <= 128 else 256
    n_st = -(-kp // 64)
    tiles = -(-n // 128)
    xs = torch.zeros((nt, n_st * 64), dtype=torch.float64)
    xs[:m, :kp] = x.double()
    codes = torch.zeros((tiles * 128, n_st * 32), dtype=torch.uint8)
    codes[:n, :kp // 2] = packed
    ct = torch.arange(256)
    g, t = (ct % 32) // 4, ct % 4
    r0 = (ct // 128) * 64 + ((ct // 32) % 4) * 16 + g
    cps = -(-n_st // splits)
    out = torch.zeros((tiles * 128, nt), dtype=torch.float64)
    for tile in range(tiles):
        rows = (tile * 128 + r0, tile * 128 + r0 + 8)
        scales = [absmax[r.clamp(max=n - 1)] for r in rows]     # [256, nb]
        for lo in range(0, n_st, cps):
            hi = min(lo + cps, n_st)
            blk, pos = lo * 4 // bs16, lo * 4 % bs16
            part = torch.zeros((128, nt), dtype=torch.float64)
            seen = torch.zeros((128, (hi - lo) * 64), dtype=torch.int32)
            for j in range(lo * 4, hi * 4):                     # k16 slices
                b = min(blk, nb - 1)
                assert b == min(j // bs16, nb - 1)
                pos += 1
                if pos == bs16:
                    pos, blk = 0, blk + 1
                a = torch.zeros((128, 16), dtype=torch.float64)
                for rr in (0, 1):
                    sc = scales[rr][:, b]
                    rl = r0 + 8 * rr
                    for half in (0, 1):     # byte t, then byte t + 4
                        byte = codes[rows[rr], j * 8 + 4 * half + t].long()
                        kk = 2 * t + 8 * half
                        for e, code in enumerate((byte & 15, byte >> 4)):
                            v = (book[code] * sc).to(torch.bfloat16)
                            a[rl, kk + e] = v.double()
                            seen[rl, (j - lo * 4) * 16 + kk + e] += 1
                part += a @ xs[:, j * 16:(j + 1) * 16].T
            assert bool((seen == 1).all())
            out[tile * 128:(tile + 1) * 128] += part
    return out[:n, :m].T.float()


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("m,n,kp,bs,splits", [
    (65, 200, 224, 32, 2), (1, 128, 320, 64, 1), (256, 131, 512, 16, 3)])
def test_wgmma_emulation_matches_plain(quant_type, m, n, kp, bs, splits):
    """The kernel's fragment map, decode and split sums give
    ``matmul4bit_plain`` within 1e-6 of max|ref| (the same bf16 operands;
    only the order of the f32 sums differs): N past a 128-row tile, K_pad
    half a stage past a whole one (224), blocks of 16 to 64 codes."""
    rng = np.random.default_rng(m + n + kp)
    x = torch.from_numpy(rng.standard_normal((m, kp)).astype(np.float32)
                         ).to(torch.bfloat16)
    packed = torch.from_numpy(rng.integers(0, 256, (n, kp // 2),
                                           dtype=np.uint8))
    absmax = torch.from_numpy(rng.uniform(5e-3, 3.5e-2, (n, kp // bs))
                              .astype(np.float32))
    book = TF.codebook(quant_type, "cpu")
    assert TM.takes_wgmma(m, n, kp, bs)
    got = _wgmma_emulation(x, packed, absmax, book, splits)
    ref = TM.matmul4bit_plain(x, packed, absmax, book, "bf16")
    assert rel_err(got.numpy(), ref.numpy()) <= 1e-6


def test_takes_wgmma_grid():
    """Every Llama-2 7B/13B matmul (fused and unfused projections, the
    head) at the K5 buckets' M takes the wgmma kernel in bf16; K_pad off 32,
    blocks below 16 and M past 256 keep the 64 x 64-tile kernel, f32 its
    own."""
    for hidden, inter in ((4096, 11008), (5120, 13824)):
        shapes = [(3 * hidden, hidden), (hidden, hidden),
                  (2 * inter, hidden), (inter, hidden), (hidden, inter),
                  (32000, hidden)]
        for m in (65, 128, 256):
            for n, k in shapes:
                kp = TF._pad_k(k, 64)
                assert TM.takes_wgmma(m, n, kp, 64)
                assert TM.kernel_of(m, n, kp, 64, "bf16") == "wgmma"
                assert TM.kernel_of(m, n, kp, 64, "f32") == "f32"
    assert not TM.takes_wgmma(128, 256, 200, 8)
    assert TM.kernel_of(128, 256, 200, 8, "bf16") == "bf16"
    for bs in (2, 4):
        assert not TM.takes_wgmma(128, 4096, 4096, bs)
    assert not TM.takes_wgmma(257, 4096, 4096, 64)
    assert not TM.takes_wgmma(0, 4096, 4096, 64)
