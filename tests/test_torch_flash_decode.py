"""PyTorch port vs JAX package: flash-decode attention over int8 KV (K2).

The port's plain version of K2 against JAX's ``flash_decode_attention`` in
Pallas interpret mode. Both quantize q and p to int8 with the same f32
formulas and do exact integer dots, so they differ by f32 sum order, or by
one p code where an exp rounds differently: <= 1e-3 of max|ref|.

Against the port's float staged chain ``gqa_attention_kv_quant`` (which
keeps q and p in float) the q/p quantization itself shows: <= 2%, the
tolerance tests/test_flash_decode.py holds the JAX kernel to.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpu_bitsandbytes.ops.flash_decode import flash_decode_attention as jfd
from tpu_bitsandbytes_torch.models.layers import gqa_attention_kv_quant
from tpu_bitsandbytes_torch.ops import flash_decode as T

from test_torch_functional import rel_err, t32

TOL_JAX = 1e-3
TOL_FLOAT = 0.02


def make(seed, b, h, h_kv, d, t, c):
    rng = np.random.default_rng(seed)
    arrs = {
        "q": (rng.standard_normal((b, h, d)) * 0.3).astype(np.float32),
        "k": rng.integers(-127, 128, (b, h_kv, t, d)).astype(np.int8),
        "v": rng.integers(-127, 128, (b, h_kv, t, d)).astype(np.int8),
        "ks": rng.uniform(0.5, 2.0, (b, h_kv, t)).astype(np.float32),
        "vs": rng.uniform(0.5, 2.0, (b, h_kv, t)).astype(np.float32),
        "stk": rng.integers(-127, 128, (b, h_kv, c, d)).astype(np.int8),
        "stv": rng.integers(-127, 128, (b, h_kv, c, d)).astype(np.int8),
        "stks": rng.uniform(0.5, 2.0, (b, h_kv, c)).astype(np.float32),
        "stvs": rng.uniform(0.5, 2.0, (b, h_kv, c)).astype(np.float32),
        "off": rng.integers(t // 2, t, (b,)).astype(np.int32),
    }
    return arrs


def run_both(a, step, **kw):
    """(port plain, JAX interpret) outputs as f32 numpy; step None means
    the unstaged call."""
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    j_st = None if step is None else (j["stk"], j["stks"], j["stv"],
                                      j["stvs"], jnp.int32(step))
    t_st = None if step is None else (t["stk"], t["stks"], t["stv"],
                                      t["stvs"], step)
    scale = 1.0 / np.sqrt(a["q"].shape[-1])
    ref = jfd(j["q"].astype(jnp.bfloat16), j["k"], j["ks"], j["v"], j["vs"],
              j["off"], staged=j_st, scale=scale, interpret=True, **kw)
    got = T.flash_decode_attention(
        t["q"].to(torch.bfloat16), t["k"], t["ks"], t["v"], t["vs"],
        t["off"], staged=t_st, scale=scale, **kw)
    return t32(got), np.asarray(ref, np.float32), t, t_st, scale


@pytest.mark.parametrize("step", [None, 0, 15])
@pytest.mark.parametrize("h,h_kv", [(4, 4), (8, 4)])
def test_matches_jax_kernel(step, h, h_kv):
    a = make(1, 3, h, h_kv, 64, 96, 16)
    got, ref, t, t_st, scale = run_both(a, step)
    assert got.shape == ref.shape == (3, h, 64)
    assert rel_err(got, ref) <= TOL_JAX
    # the float staged chain of the f32 decode path
    flt = gqa_attention_kv_quant(
        t["q"].to(torch.bfloat16)[:, None], t["k"], t["ks"], t["v"], t["vs"],
        causal_offset=t["off"][:, None], scale=scale, staged=t_st)[:, 0]
    assert rel_err(got, t32(flt)) <= TOL_FLOAT


def test_kpos_start():
    """A span read that starts at kpos_start: absolute key positions."""
    a = make(2, 2, 8, 4, 64, 256, 8)
    a["off"] = a["off"] + 128
    for name in ("k", "v", "ks", "vs"):
        a[name] = np.ascontiguousarray(a[name][:, :, 128:])
    got, ref, *_ = run_both(a, 3, kpos_start=128)
    assert rel_err(got, ref) <= TOL_JAX


def test_fresh_zero_length_slot():
    """off = 0, unstaged: only key 0 is in range; with kpos_start beyond it
    every key is masked, p is uniform over all keys (the dummy staged
    block included) and the output stays finite."""
    a = make(3, 2, 4, 4, 32, 64, 8)
    a["off"] = np.zeros((2,), np.int32)
    got, ref, *_ = run_both(a, None)
    assert rel_err(got, ref) <= TOL_JAX
    got, ref, *_ = run_both(a, None, kpos_start=8)
    assert np.isfinite(got).all()
    assert rel_err(got, ref) <= TOL_JAX


def test_window_and_softcap():
    a = make(4, 2, 8, 4, 64, 128, 16)
    got, ref, *_ = run_both(a, 5, window=24, softcap=30.0)
    assert rel_err(got, ref) <= TOL_JAX


def test_strided_span_view():
    """The kernel's operands are span views of the cache; the plain
    version must read them through their strides too."""
    a = make(5, 2, 4, 2, 32, 128, 8)
    full = {k: torch.from_numpy(a[k]) for k in ("k", "v", "ks", "vs")}
    view = {k: x[:, :, :96] for k, x in full.items()}
    q = torch.from_numpy(a["q"])
    off = torch.from_numpy(np.array([50, 90], np.int32))
    got = T.flash_decode_attention(q, view["k"], view["ks"], view["v"],
                                   view["vs"], off)
    ref = T.flash_decode_attention(
        q, *(view[k].contiguous() for k in ("k", "ks", "v", "vs")), off)
    np.testing.assert_array_equal(t32(got), t32(ref))
