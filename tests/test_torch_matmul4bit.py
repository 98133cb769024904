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
