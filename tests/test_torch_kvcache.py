"""PyTorch port vs JAX package: the int8 KV cache and its chunk stage.

The same K/V go into both caches; codes must be identical and scales
(absmaxes) equal, since both quantize with the same f32 formulas.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpu_bitsandbytes.engine.kvcache import KVCache as JKV
from tpu_bitsandbytes_torch.engine.kvcache import KVCache as TKV

L, B, S, H, D, C = 2, 3, 32, 2, 16, 8


def _assert_same(j, t):
    np.testing.assert_array_equal(t.k.numpy(), np.asarray(j.k))
    np.testing.assert_array_equal(t.v.numpy(), np.asarray(j.v))
    np.testing.assert_array_equal(t.k_scale.numpy(), np.asarray(j.k_scale))
    np.testing.assert_array_equal(t.v_scale.numpy(), np.asarray(j.v_scale))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))


def _prefilled(rng, lengths):
    j = JKV.create(L, B, S, H, D, dtype=jnp.float32)
    t = TKV.create(L, B, S, H, D, device="cpu")
    for slot, n in enumerate(lengths):
        for li in range(L):
            k = rng.standard_normal((n, H, D)).astype(np.float32)
            v = rng.standard_normal((n, H, D)).astype(np.float32)
            j = j.write_prefill(li, slot, jnp.asarray(k), jnp.asarray(v))
            t = t.write_prefill(li, slot, torch.from_numpy(k),
                                torch.from_numpy(v))
    lens = np.asarray(lengths, np.int32)
    j = dataclasses.replace(j, lengths=jnp.asarray(lens))
    t.lengths = torch.from_numpy(lens.copy())
    return j, t


def test_stage_and_flush_match():
    """A chunk of C steps. Slot 0 goes inactive after 3 steps (its later
    staged entries are garbage that must not land), slot 1 runs the whole
    chunk, and slot 2 starts within C of max_seq (29 > S - C) and stops at
    S - 1: the case where a C-wide slab write would shift onto history."""
    rng = np.random.default_rng(0)
    j, t = _prefilled(rng, [5, 20, 29])
    j = j.begin_stage(C, window=False)
    t = t.begin_stage(C, window=False)
    for step in range(C):
        active = np.array([step < 3, True, step < 2])
        for li in range(L):
            k = rng.standard_normal((B, 1, H, D)).astype(np.float32)
            v = rng.standard_normal((B, 1, H, D)).astype(np.float32)
            j = j.write_decode(li, jnp.asarray(k), jnp.asarray(v), j.lengths)
            t = t.write_decode(li, torch.from_numpy(k), torch.from_numpy(v),
                               t.lengths)
            jst, tst = j.read_stage(li), t.read_stage(li)
            for a, b in zip(jst[:4], tst[:4]):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            assert int(jst[4]) == tst[4] == step
        j = dataclasses.replace(
            j, lengths=j.lengths + jnp.asarray(active, jnp.int32))
        t.lengths += torch.from_numpy(active).to(torch.int32)
        j, t = j.advance_stage(), t.advance_stage()
    j, t = j.flush_stage(), t.flush_stage()
    assert j.stage is None and t.stage is None
    np.testing.assert_array_equal(t.lengths.numpy(), [8, 28, 31])
    _assert_same(j, t)


def _chunk(j, t, rng, c, active_at):
    """One staged chunk of ``c`` decode steps through both caches, slot b
    active at step i where ``active_at(i)[b]``; returns both, unflushed."""
    j = j.begin_stage(c, window=False)
    t = t.begin_stage(c, window=False)
    for step in range(c):
        active = np.asarray(active_at(step))
        for li in range(L):
            k = rng.standard_normal((B, 1, H, D)).astype(np.float32)
            v = rng.standard_normal((B, 1, H, D)).astype(np.float32)
            j = j.write_decode(li, jnp.asarray(k), jnp.asarray(v), j.lengths)
            t = t.write_decode(li, torch.from_numpy(k), torch.from_numpy(v),
                               t.lengths)
        j = dataclasses.replace(
            j, lengths=j.lengths + jnp.asarray(active, jnp.int32))
        t.lengths += torch.from_numpy(active).to(torch.int32)
        j, t = j.advance_stage(), t.advance_stage()
    return j, t


def _host_loop_flush(t):
    """The flush as a host loop over slots (the port's first version):
    each slot's ``lengths - len0`` staged entries to ``len0 + j``."""
    out = [x.clone() for x in (t.k, t.v, t.k_scale, t.v_scale)]
    st = t.stage
    for bi, (start, n) in enumerate(zip(st.len0.tolist(),
                                        (t.lengths - st.len0).tolist())):
        for buf, staged in zip(out, (st.k, st.v, st.k_scale, st.v_scale)):
            buf[:, bi, :, start:start + n] = staged[:, bi, :, :n]
    return out


@pytest.mark.parametrize("c", [1, C])
def test_device_flush_matches_host_loop_and_jax(c):
    """Two chunks of C steps on one cache (the second reuses the stage and
    finds the first chunk's entries in it). Slot 0 goes inactive after
    step 3 of the first chunk, slot 1 runs throughout, slot 2 starts
    within C of max_seq and stops at S - 1 mid-chunk. The on-device
    flush gives exactly the host loop's codes and scales and the JAX
    package's; no valid entry reaches the clamped position S - 1."""
    rng = np.random.default_rng(c)
    j, t = _prefilled(rng, [5, 10, S - 1 - min(c, 5)])
    for chunk in range(2):
        j, t = _chunk(j, t, rng, c, lambda i: [
            chunk == 0 and i < 3, True, int(t.lengths[2]) < S - 1])
        len0, valid = t.stage.len0, t.lengths - t.stage.len0
        assert int((len0 + valid).max()) <= S - 1    # last valid at S - 2
        if chunk == 0 and c > 1:
            assert int(len0[2]) + c - 1 > S - 1      # clamped duplicates
        ref = _host_loop_flush(t)
        j, t = j.flush_stage(), t.flush_stage()
        assert t.stage is None
        for got, want in zip((t.k, t.v, t.k_scale, t.v_scale), ref):
            assert torch.equal(got, want)
        _assert_same(j, t)
    assert t.lengths.tolist() == [5 + min(c, 3), 10 + 2 * c, S - 1]


def test_begin_stage_reuses_its_buffers():
    """Each chunk length's stage is allocated once: a later chunk gets the
    same buffers, its step reset to 0 and ``len0`` copied in place."""
    rng = np.random.default_rng(3)
    _, t = _prefilled(rng, [4, 9, 1])
    t.begin_stage(C, window=False)
    ptrs = [x.data_ptr() for x in (t.stage.k, t.stage.v, t.stage.k_scale,
                                   t.stage.v_scale, t.stage.len0)]
    for _ in range(2):
        t.advance_stage()
    t.lengths += 2
    t.flush_stage()
    t.begin_stage(C, window=False)
    assert t.stage.step == 0
    assert [x.data_ptr() for x in (t.stage.k, t.stage.v, t.stage.k_scale,
                                   t.stage.v_scale, t.stage.len0)] == ptrs
    assert t.stage.len0.tolist() == [6, 11, 3]
    assert t.begin_stage(1, window=False).stage is not t.stages[C]
    assert set(t.stages) == {C, 1}


def test_write_decode_scatter_and_read_raw():
    """Unstaged writes scatter at per-slot positions; a batched prefill
    sends rows to arbitrary slots."""
    rng = np.random.default_rng(1)
    j, t = _prefilled(rng, [4, 9, 1])
    k = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    v = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    j = j.write_decode(1, jnp.asarray(k), jnp.asarray(v), j.lengths)
    t = t.write_decode(1, torch.from_numpy(k), torch.from_numpy(v),
                       t.lengths)
    k2 = rng.standard_normal((2, 5, H, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5)[None], (2, 5)).astype(np.int32)
    slots = np.array([2, 0], np.int32)
    j = j.write_decode(0, jnp.asarray(k2), jnp.asarray(k2),
                       jnp.asarray(pos), slots=jnp.asarray(slots))
    t = t.write_decode(0, torch.from_numpy(k2), torch.from_numpy(k2),
                       torch.from_numpy(pos), slots=torch.from_numpy(slots))
    _assert_same(j, t)
    for a, b in zip(j.read_raw(1, 16), t.read_raw(1, 16)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_stage_longer_than_cache_is_a_no_op():
    t = TKV.create(L, B, S, H, D, device="cpu")
    assert t.begin_stage(S + 1).stage is None
    assert t.begin_stage(S + 1, window=False).stage is None
    assert JKV.create(L, B, S, H, D).begin_stage(S + 1,
                                                window=False).stage is None
