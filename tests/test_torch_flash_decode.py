"""PyTorch port vs JAX package: flash-decode attention over int8 KV (K2).

K2 computes the JAX package's default decode attention, the staged chain
``gqa_attention_kv_quant``: f32 logits, one softmax over the main span and
the staged block, the v-scale-folded probabilities rounded to q's dtype for
the PV product. In f32 the port's plain version of K2 and JAX's chain do
the same arithmetic up to f32 sum order: <= 1e-5 of max|ref|. With bf16 q
it holds to the port's own chain (held to JAX's bf16 rounding by
``test_torch_requests.py``), which returns bf16: K2's f32 output rounded
to bf16 is within one bf16 ulp of its largest output, 2^-7 of max|ref|
(f32 sums in another order).

Against JAX's Pallas flash-decode kernel, which quantizes q and p to int8,
that quantization shows: <= 2%, the tolerance tests/test_flash_decode.py
holds the JAX kernel to against the chain.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpu_bitsandbytes.models.layers import gqa_attention_kv_quant as jchain
from tpu_bitsandbytes.ops.flash_decode import flash_decode_attention as jfd
from tpu_bitsandbytes_torch.models.layers import gqa_attention_kv_quant
from tpu_bitsandbytes_torch.ops import flash_decode as T

from test_torch_functional import rel_err, t32

TOL_CHAIN = 1e-5
TOL_BF16_OUT = 2.0 ** -7
TOL_PALLAS = 0.02


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
    """(port plain, JAX chain) outputs as f32 numpy, both from f32 q; step
    None means the unstaged call, which K2 runs over a fully masked dummy
    staged block (the JAX chain is given the same block)."""
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    b, h_kv, _, d = a["k"].shape
    t_st = None if step is None else (t["stk"], t["stks"], t["stv"],
                                      t["stvs"], step)
    dummy = T._dummy_stage(b, h_kv, d, torch.device("cpu"))
    j_st = tuple(jnp.asarray(x.numpy()) for x in (t_st or dummy)[:4]) + (
        -1 if step is None else step,)
    scale = 1.0 / np.sqrt(d)
    ref = jchain(j["q"][:, None], j["k"], j["ks"], j["v"], j["vs"],
                 causal_offset=j["off"][:, None], staged=j_st, scale=scale,
                 **kw)[:, 0]
    got = T.flash_decode_attention(
        t["q"], t["k"], t["ks"], t["v"], t["vs"], t["off"], staged=t_st,
        scale=scale, **kw)
    return t32(got), np.asarray(ref, np.float32), t, t_st, scale


@pytest.mark.parametrize("step", [None, 0, 15])
@pytest.mark.parametrize("h,h_kv", [(4, 4), (8, 4)])
def test_matches_jax_kernel(step, h, h_kv):
    a = make(1, 3, h, h_kv, 64, 96, 16)
    got, ref, t, t_st, scale = run_both(a, step)
    assert got.shape == ref.shape == (3, h, 64)
    assert rel_err(got, ref) <= TOL_CHAIN
    # bf16 q: the port's chain of the half-precision decode path, and JAX's
    # Pallas kernel (interpret mode)
    q16 = t["q"].to(torch.bfloat16)
    got16 = T.flash_decode_attention(q16, t["k"], t["ks"], t["v"], t["vs"],
                                     t["off"], staged=t_st, scale=scale)
    flt = gqa_attention_kv_quant(
        q16[:, None], t["k"], t["ks"], t["v"], t["vs"],
        causal_offset=t["off"][:, None], scale=scale, staged=t_st)[:, 0]
    assert rel_err(t32(got16.to(torch.bfloat16)), t32(flt)) <= TOL_BF16_OUT
    j = {k: jnp.asarray(v) for k, v in a.items()}
    j_st = None if step is None else (j["stk"], j["stks"], j["stv"],
                                      j["stvs"], jnp.int32(step))
    pallas = jfd(j["q"].astype(jnp.bfloat16), j["k"], j["ks"], j["v"],
                 j["vs"], j["off"], staged=j_st, scale=scale, interpret=True)
    assert rel_err(t32(got16), np.asarray(pallas, np.float32)) <= TOL_PALLAS


def test_kpos_start():
    """A span read that starts at kpos_start: absolute key positions."""
    a = make(2, 2, 8, 4, 64, 256, 8)
    a["off"] = a["off"] + 128
    for name in ("k", "v", "ks", "vs"):
        a[name] = np.ascontiguousarray(a[name][:, :, 128:])
    got, ref, *_ = run_both(a, 3, kpos_start=128)
    assert rel_err(got, ref) <= TOL_CHAIN


def test_fresh_zero_length_slot():
    """off = 0, unstaged: only key 0 is in range; with kpos_start beyond it
    every key is masked, p is uniform over all keys (the dummy staged
    block included) and the output stays finite."""
    a = make(3, 2, 4, 4, 32, 64, 8)
    a["off"] = np.zeros((2,), np.int32)
    got, ref, *_ = run_both(a, None)
    assert rel_err(got, ref) <= TOL_CHAIN
    got, ref, *_ = run_both(a, None, kpos_start=8)
    assert np.isfinite(got).all()
    assert rel_err(got, ref) <= TOL_CHAIN


def test_window_and_softcap():
    a = make(4, 2, 8, 4, 64, 128, 16)
    got, ref, *_ = run_both(a, 5, window=24, softcap=30.0)
    assert rel_err(got, ref) <= TOL_CHAIN


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


def split_emulation(q, k, ks, v, vs, off, staged, step, *, scale, window,
                    kpos_start, softcap, s):
    """K2's decomposition (csrc/flash_decode.cu), emulated with torch on the
    CPU. Per slot: the main keys the masks keep, [t_lo, t_hi) from off,
    step, window and kpos_start (the whole span when every key of the slot,
    staged ones included, is masked); then those keys and the staged block,
    in that order, split into ``s`` contiguous shares. Each share gives its
    logits' max; their max m is the slot's. Each share gives its sum of p;
    l sums the shares' in rank order. Each share rounds its pv to q's dtype
    (p divided by l first in an unstaged call, ``step`` -1) and forms f32
    PV partials, added in rank order, then divided by l where p was not.
    Returns f32 [B, H, D]."""
    st_k, st_ks, st_v, st_vs = staged
    b, h, d = q.shape
    h_kv, t = k.shape[1], k.shape[2]
    c = st_k.shape[2]
    rep = h // h_kv
    qf = q.to(torch.float32).reshape(b, h_kv, rep, d)
    out = torch.empty((b, h_kv, rep, d), dtype=torch.float32)
    for bi in range(b):
        o = int(off[bi])
        t_hi = min(t, max(0, o - step - kpos_start))
        t_lo = min(t, max(0, o - window + 1 - kpos_start)) if window else 0
        j_lo = max(0, step - window + 1) if window else 0
        j_hi = min(c, step + 1)
        if t_hi <= t_lo and j_hi <= j_lo:
            t_lo, t_hi = 0, t
        t_hi = max(t_hi, t_lo)
        nmain = t_hi - t_lo
        keys = torch.cat([k[bi, :, t_lo:t_hi], st_k[bi]], 1).float()
        vals = torch.cat([v[bi, :, t_lo:t_hi], st_v[bi]], 1).float()
        kscale = torch.cat([ks[bi, :, t_lo:t_hi], st_ks[bi]], 1)
        vscale = torch.cat([vs[bi, :, t_lo:t_hi], st_vs[bi]], 1)
        kpos = kpos_start + torch.arange(t_lo, t_hi)
        jst = torch.arange(c)
        keep_m = kpos <= o - step - 1
        keep_s = jst <= step
        if window:
            keep_m &= kpos > o - window
            keep_s &= jst > step - window
        keep = torch.cat([keep_m, keep_s])
        n = nmain + c
        per = -(-n // s)
        shares = [(min(n, r * per), min(n, r * per + per)) for r in range(s)]
        shares = [sh for sh in shares if sh[1] > sh[0]]   # an empty share adds nothing

        def logits(i0, i1):
            x = torch.einsum("hrd,htd->hrt", qf[bi], keys[:, i0:i1])
            x = x * (kscale[:, None, i0:i1] * (scale / 127.0))
            if softcap is not None:
                x = torch.tanh(x / softcap) * softcap
            return torch.where(keep[i0:i1], x, torch.full_like(x, -1e30))

        lgs = [logits(i0, i1) for i0, i1 in shares]
        m = torch.full((h_kv, rep, 1), -float("inf"))
        for x in lgs:
            m = torch.maximum(m, x.amax(-1, keepdim=True))
        ps = [torch.exp(x - m) for x in lgs]
        l = torch.zeros((h_kv, rep, 1))
        for p in ps:
            l = l + p.sum(-1, keepdim=True)
        acc = torch.zeros((h_kv, rep, d))
        for (i0, i1), p in zip(shares, ps):
            pv = (p / l if step < 0 else p) * T._div127(vscale[:, None, i0:i1])
            if q.dtype != torch.float32:
                pv = pv.to(q.dtype).float()
            acc = acc + torch.einsum("hrt,htd->hrd", pv, vals[:, i0:i1])
        out[bi] = acc if step < 0 else acc / l
    return out.reshape(b, h, d)


# (step or None for the unstaged call, options, offsets or None) over
# make(9, 3, 8, 4, 32, 70, 8): T = 70 is not a multiple of 3 or 8
SPLIT_CASES = {
    # slot 0 reads from kpos_start = 16 at off = 5: every key masked, p = 1
    # over the whole span (the dummy block too), beside two live slots
    "all_masked_slot": (None, {"kpos_start": 16}, [5, 50, 80]),
    "staged": (15, {}, None),
    "window_softcap": (5, {"window": 24, "softcap": 30.0}, None),
    "kpos_start": (3, {"kpos_start": 32}, [40, 70, 95]),
    "unstaged_window": (None, {"window": 20}, None),
}
_JAX_SPLIT = {}


@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_emulation_matches(case, s):
    """K2's cluster split gives flash_decode_plain's and JAX's chain's
    numbers for S = 1, 3 and 8 CTAs (f32 q: f32 sums in another order)."""
    step, kw, offs = SPLIT_CASES[case]
    a = make(9, 3, 8, 4, 32, 70, 8)
    if offs is not None:
        a["off"] = np.asarray(offs, np.int32)
    if case not in _JAX_SPLIT:
        _JAX_SPLIT[case] = run_both(a, step, **kw)
    got_plain, ref, t, t_st, scale = _JAX_SPLIT[case]
    if t_st is None:
        t_st = T._dummy_stage(3, 4, 32, torch.device("cpu"))
    opts = dict(scale=scale, window=kw.get("window"),
                kpos_start=kw.get("kpos_start", 0), softcap=kw.get("softcap"))
    emu = split_emulation(t["q"], t["k"], t["ks"], t["v"], t["vs"],
                          t["off"], t_st[:4], t_st[4], s=s, **opts)
    assert np.isfinite(t32(emu)).all()
    assert rel_err(t32(emu), got_plain) <= TOL_CHAIN
    assert rel_err(t32(emu), ref) <= TOL_CHAIN
