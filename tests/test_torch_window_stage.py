"""PyTorch port vs JAX package: the compact-window KV stage.

``KVCache.begin_stage(window=True)`` copies the cache's span ``[start,
span)`` in front of the chunk's staged tokens, and decode attention reads
that window as one block (``gqa_attention_kv_window``; a half-precision
config keeps kernel K2 over the window's head and tail). The JAX package's
``TestWindowStage`` (``tests/test_engine.py``) holds the window against the
two-block stage; here the same numpy inputs also go through the JAX
package: the KV cache's codes and scales must be identical, f32 attention
within 1e-6 of max|ref| (another f32 sum order), and greedy tokens of a
tiny f32 model identical to JAX's and to the port's two-block stage. Also:
the engine's gate, ``KVCache.read``/``reset_slot``/``set_length``, and one
tp = 2 world over gloo running ``make_tp_decode_chunk(window_stage=True)``.
"""

import copy
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_bitsandbytes.engine import engine as JE
from tpu_bitsandbytes.engine.kvcache import KVCache as JKV
from tpu_bitsandbytes.engine.sampler import SamplingArrays as JSA
from tpu_bitsandbytes.models import layers as JLa
from tpu_bitsandbytes.models import llama as JL
from tpu_bitsandbytes_torch.convert import (config_from_reference,
                                            from_reference_arrays)
from tpu_bitsandbytes_torch.engine import engine as TE
from tpu_bitsandbytes_torch.engine.kvcache import KVCache as TKV
from tpu_bitsandbytes_torch.engine.sampler import SamplingArrays as TSA
from tpu_bitsandbytes_torch.engine.sampler import SamplingParams as TSP
from tpu_bitsandbytes_torch.models import layers as TLa
from tpu_bitsandbytes_torch.models import llama as TL

from test_torch_engine import _prompts
from test_torch_functional import config_fields, reference_arrays, rel_err
from torch_mesh_ranks import start_world

ATTN_TOL = 1e-6     # f32 attention, of max|ref|: another f32 sum order
L, B, S, H, D, C = 2, 3, 16, 2, 8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX params, port params): the tiny
    Mistral config (every layer windowed at 16) in f32 with the int4
    cache."""
    cfg = dataclasses.replace(JL.LlamaConfig.tiny_mistral(),
                              dtype=jnp.float32)
    q = JL.quantize_params(JL.init_params(jax.random.PRNGKey(6), cfg),
                           dtype=cfg.dtype, fuse_projections=True)
    jp = JL.build_runtime_cache(q, "int4")
    return (cfg, config_from_reference(config_fields(cfg)), jp,
            from_reference_arrays(reference_arrays(jp), "cpu"))


# -- the cache ---------------------------------------------------------------

def _filled(lengths, seed=0):
    """Both packages' int8 caches after the same decode writes at
    positions [0, max(lengths)), with ``lengths`` set."""
    rng = np.random.default_rng(seed)
    j = JKV.create(L, B, S, H, D, dtype=jnp.float32)
    t = TKV.create(L, B, S, H, D, dtype=torch.float32, device="cpu")
    for p in range(max(lengths)):
        for li in range(L):
            k, v = (rng.standard_normal((B, 1, H, D)).astype(np.float32)
                    for _ in range(2))
            j = j.write_decode(li, jnp.asarray(k), jnp.asarray(v),
                               jnp.full((B,), p, jnp.int32))
            t.write_decode(li, torch.from_numpy(k), torch.from_numpy(v),
                           torch.full((B,), p, dtype=torch.int32))
    lens = np.asarray(lengths, np.int32)
    t.lengths.copy_(torch.from_numpy(lens))
    return dataclasses.replace(j, lengths=jnp.asarray(lens)), t


def _chunk_writes(cache, window, span=None, start=0, seed=7, torch_side=True):
    """C staged decode steps into ``cache`` (either package's), every slot
    active; the stage left open."""
    rng = np.random.default_rng(seed)
    c = cache.begin_stage(C, span=span, start=start, window=window)
    assert (c.stage.cut > 0) == window
    for _ in range(C):
        for li in range(L):
            k, v = (rng.standard_normal((B, 1, H, D)).astype(np.float32)
                    for _ in range(2))
            if torch_side:
                c.write_decode(li, torch.from_numpy(k), torch.from_numpy(v),
                               c.lengths)
            else:
                c = c.write_decode(li, jnp.asarray(k), jnp.asarray(v),
                                   c.lengths)
        if torch_side:
            c.lengths += 1
        else:
            c = dataclasses.replace(c, lengths=c.lengths + 1)
        c = c.advance_stage()
    return c


def _equal(t_tensors, j_arrays):
    for a, b in zip(t_tensors, j_arrays):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _planes(c):
    return c.k, c.v, c.k_scale, c.v_scale


@pytest.mark.parametrize("lengths,span,start", [
    ((5, 9, 12), None, 0),      # mid-decode, the whole cache
    ((12, 9, 11), None, 0),     # slot 0 at S - C: the clamped overlay
    ((5, 9, 12), 16, 0),        # an explicit span of S
    ((9, 10, 12), 16, 4),       # a fully-windowed chunk's attn_start
])
def test_flush_matches_plain_stage(lengths, span, start):
    """The window stage flushes from its tail: the cache equals the
    two-block stage's flush and JAX's window flush, code for code."""
    j0, _ = _filled(lengths)
    got = {}
    for window in (True, False):
        _, t = _filled(lengths)
        got[window] = _chunk_writes(t, window, span, start).flush_stage()
    jw = _chunk_writes(j0, True, span, start, torch_side=False).flush_stage()
    assert got[True].stage is None
    for a, b in zip(_planes(got[True]), _planes(got[False])):
        assert torch.equal(a, b)
    _equal(_planes(got[True]), _planes(jw))
    _equal([got[True].lengths], [jw.lengths])


def test_read_stage_tail_matches_plain_stage():
    """``read_stage`` of a window stage is its tail: the two-block stage's
    entries, and JAX's window ``read_stage``; ``read_window`` is JAX's."""
    j0, _ = _filled((5, 9, 12))
    _, tw = _filled((5, 9, 12))
    _, tp = _filled((5, 9, 12))
    tw = _chunk_writes(tw, True, span=13)
    tp = _chunk_writes(tp, False, span=13)
    jw = _chunk_writes(j0, True, span=13, torch_side=False)
    for li in range(L):
        for a, b in zip(tw.read_stage(li)[:4], tp.read_stage(li)[:4]):
            assert torch.equal(a, b)
        _equal(tw.read_stage(li)[:4], jw.read_stage(li)[:4])
        _equal(tw.read_window(li), jw.read_window(li))
    assert tw.stage.step == int(jw.stage.step) == C


def test_window_prefix_is_the_span_copy():
    """Entries [0, cut) of the window are the span [start, span) of the
    main cache, cut = span - start; the window's buffers are allocated
    once per chunk length at max_seq + C and viewed per span."""
    j0, t = _filled((9, 10, 12))
    t = _chunk_writes(t, True, span=12, start=4)
    st = t.stage
    assert st.cut == 8 and st.size == C and st.k.shape[3] == 8 + C
    assert torch.equal(st.k[:, :, :, :8], t.k[:, :, :, 4:12])
    assert torch.equal(st.v_scale[:, :, :, :8], t.v_scale[:, :, :, 4:12])
    jst = _chunk_writes(j0, True, span=12, start=4, torch_side=False).stage
    assert jst.cut == st.cut
    _equal(_planes(st), _planes(jst))
    full = t.windows[C][0]
    assert full.shape[3] == S + C and st.k.data_ptr() == full.data_ptr()
    t.flush_stage()
    t.begin_stage(C, span=16)
    assert t.stage.k.data_ptr() == full.data_ptr() and t.stage.cut == 16
    assert t.window_bytes() == 2 * L * B * H * (S + C) * (D + 4)


def test_stage_is_a_no_op_where_jax_has_none():
    """No stage on a ring cache, an unquantized cache or a chunk longer
    than the cache, window or not."""
    caches = [TKV.create(L, B, S, H, D, device="cpu", ring_size=8),
              TKV.create(L, B, S, H, D, quantized=False, device="cpu")]
    for c in caches:
        assert c.begin_stage(C).stage is None
    assert TKV.create(L, B, S, H, D, device="cpu").begin_stage(
        S + 1, span=S).stage is None


# -- read, reset_slot, set_length --------------------------------------------

@pytest.mark.parametrize("quantized", [True, False])
def test_read_reset_and_set_length_match_jax(quantized):
    """``read`` (the dequantized, token-major span [start, span)),
    ``reset_slot`` and ``set_length`` give JAX's arrays."""
    rng = np.random.default_rng(4)
    j = JKV.create(L, B, S, H, D, quantized=quantized, dtype=jnp.float32)
    t = TKV.create(L, B, S, H, D, quantized=quantized, dtype=torch.float32,
                   device="cpu")
    for slot, n in enumerate((6, 11, 3)):
        for li in range(L):
            k, v = (rng.standard_normal((n, H, D)).astype(np.float32)
                    for _ in range(2))
            j = j.write_prefill(li, slot, jnp.asarray(k), jnp.asarray(v))
            t.write_prefill(li, slot, torch.from_numpy(k),
                            torch.from_numpy(v))
    for li, span, start in ((0, None, 0), (1, 12, 0), (1, 12, 5)):
        _equal(t.read(li, span, start), j.read(li, span, start))
    assert t.read(1, 12, 5)[0].shape == (B, 7, H, D)
    j = j.set_length(1, 9).set_length(2, 4).reset_slot(0)
    assert t.set_length(1, 9).set_length(2, 4).reset_slot(0) is t
    _equal([t.lengths], [j.lengths])


def test_read_dequantizes_to_the_cache_dtype():
    j = JKV.create(L, B, S, H, D)
    t = TKV.create(L, B, S, H, D, device="cpu")
    x = np.random.default_rng(5).standard_normal((7, H, D)).astype(
        np.float32)
    j = j.write_prefill(0, 1, jnp.asarray(x), jnp.asarray(x))
    t.write_prefill(0, 1, torch.from_numpy(x), torch.from_numpy(x))
    got, ref = t.read(0, 8)[0], j.read(0, 8)[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


# -- attention ---------------------------------------------------------------

@pytest.mark.parametrize("window,softcap,attn_start", [
    (None, None, 0), (6, None, 0), (None, 30.0, 0), (6, 30.0, 3)])
def test_kv_window_attention_matches_jax(window, softcap, attn_start):
    """f32 ``gqa_attention_kv_window`` over random codes: slots at
    different chunk-start lengths, a step into the chunk, a layer window,
    a softcap and a fully-windowed chunk's ``attn_start``."""
    rng = np.random.default_rng(11)
    b, h, h_kv, d, cut, c, step = 3, 4, 2, 16, 12, 4, 2
    w = cut + c
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, (b, h_kv, w, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.5, 3.0, (b, h_kv, w)).astype(np.float32)
              for _ in range(2))
    len0 = np.array([5, 9, 13], np.int32) + attn_start
    off = (len0 + step)[:, None]
    kw = dict(cut=cut, attn_start=attn_start, step=step, window=window,
              softcap=softcap, scale=0.3)
    ref = JLa.gqa_attention_kv_window(
        *map(jnp.asarray, (q, kq, ks, vq, vs)), len0=jnp.asarray(len0),
        causal_offset=jnp.asarray(off), **kw)
    got = TLa.gqa_attention_kv_window(
        *map(torch.from_numpy, (q, kq, ks, vq, vs)),
        len0=torch.from_numpy(len0), causal_offset=torch.from_numpy(off),
        **kw)
    assert rel_err(got.numpy(), np.asarray(ref)) <= ATTN_TOL


def test_bf16_k2_route_is_bit_identical_across_modes():
    """A bf16 config's decode step keeps K2 (its plain version on the CPU)
    in a window chunk, fed the window's head and tail: the logits are bit
    for bit those of the two-block stage's K2 over the span view."""
    tcfg = TL.LlamaConfig.tiny()
    tp = TL.build_runtime_cache(TL.quantize_params(
        TL.init_params(tcfg, generator=torch.Generator().manual_seed(3),
                       device="cpu"), fuse_projections=True), "int4")
    prompts = _prompts([7, 20], tcfg.vocab_size, seed=3)
    out = {}
    for window in (True, False):
        cache = TKV.create(tcfg.num_layers, 2, 64, tcfg.num_kv_heads,
                           tcfg.hd, device="cpu")
        toks = []
        for slot, pr in enumerate(prompts):
            padded = torch.zeros((1, 32), dtype=torch.int32)
            padded[0, :len(pr)] = torch.tensor(pr)
            lg, cache = TE.prefill_step(tp, cache, padded, slot, len(pr),
                                        tcfg)
            toks.append(lg.argmax())
        cache.begin_stage(3, span=32, window=window)
        assert cache.stage.cut == (32 if window else 0)
        t_in, steps = torch.stack(toks).to(torch.int32), []
        for _ in range(3):
            lg, cache = TE.decode_step(tp, cache, t_in,
                                       torch.ones(2, dtype=torch.bool),
                                       tcfg, attn_span=32)
            steps.append(lg)
            t_in = lg.argmax(-1).to(torch.int32)
        cache.flush_stage()
        out[window] = (torch.stack(steps), cache.k.clone())
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])


# -- the decode chunk --------------------------------------------------------

def _prefilled_caches(tiny, prompts, max_seq=64, pad=32):
    """Both packages' int8 caches with ``prompts`` prefilled slot by slot,
    and the first greedy tokens (JAX's)."""
    cfg, tcfg, jp, tp = tiny
    b = len(prompts)
    jc = JKV.create(cfg.num_layers, b, max_seq, cfg.num_kv_heads, cfg.hd,
                    dtype=jnp.float32)
    tc = TKV.create(cfg.num_layers, b, max_seq, cfg.num_kv_heads, cfg.hd,
                    dtype=torch.float32, device="cpu")
    first = []
    for slot, pr in enumerate(prompts):
        padded = np.zeros((1, pad), np.int32)
        padded[0, :len(pr)] = pr
        jl, jc = JE.prefill_step(jp, jc, jnp.asarray(padded),
                                 jnp.int32(slot), jnp.int32(len(pr)), cfg)
        _, tc = TE.prefill_step(tp, tc, torch.from_numpy(padded), slot,
                                len(pr), tcfg)
        first.append(int(np.argmax(np.asarray(jl))))
    return jc, tc, np.asarray(first, np.int32)


@pytest.mark.parametrize("attn_start", [0, 16])
def test_decode_chunk_tokens_match_jax_and_two_block(tiny, attn_start):
    """``decode_chunk(window_stage=True)`` (the default, as JAX's): greedy
    tokens identical to JAX's window chunk and to the port's two-block
    chunk over the same state, from position 0 and from a fully-windowed
    chunk's ``attn_start`` (the window then holds [16, span)); the slot
    at ``max_seq - 1`` goes inactive mid-chunk; the flushed caches' codes
    and lengths are JAX's."""
    cfg, tcfg, jp, tp = tiny
    prompts = _prompts([36, 40, 58], cfg.vocab_size, seed=15)
    n, b = 6, 3
    active = np.ones((b,), bool)
    jc, tc0, first = _prefilled_caches(tiny, prompts, pad=64)
    jout = JE.decode_chunk(jp, jc, jnp.asarray(first), jnp.asarray(active),
                           jax.random.PRNGKey(0), JSA.build({}, b), cfg,
                           n_steps=n, all_greedy=True, attn_span=64,
                           attn_start=attn_start)
    got = {}
    for window in (True, False):
        tc = copy.deepcopy(tc0)
        kw = {} if window else dict(window_stage=False)
        toks, act, tc, *_ = TE.decode_chunk(
            tp, tc, torch.from_numpy(first), torch.from_numpy(active), None,
            TSA.build({}, b, device="cpu"), tcfg, n_steps=n,
            all_greedy=True, attn_span=64, attn_start=attn_start, **kw)
        got[window] = (toks.numpy(), act.numpy(), tc)
    assert not got[True][1][-1, 2]      # slot 2 stopped at max_seq - 1
    np.testing.assert_array_equal(got[True][0], np.asarray(jout[0]))
    np.testing.assert_array_equal(got[True][0], got[False][0])
    np.testing.assert_array_equal(got[True][1], np.asarray(jout[1]))
    _equal([got[True][2].k, got[True][2].lengths], [jout[2].k,
                                                     jout[2].lengths])
    assert torch.equal(got[True][2].v, got[False][2].v)


# -- the engine --------------------------------------------------------------

def test_engine_window_stage_serves_the_two_block_tokens(tiny):
    """``DecodeEngine(window_stage=True)`` takes the mode and serves the
    default (two-block) engine's greedy tokens, with slot turnover;
    ``footprint()`` counts the window buffers once a chunk has allocated
    them: the KV cache's bytes times (max_seq + C) / max_seq."""
    cfg, tcfg, _, tp = tiny
    kw = dict(max_batch=2, max_seq=64, steps_per_sync=4, device="cpu")
    prompts = _prompts([4, 9, 6], cfg.vocab_size, seed=16)
    te = TE.DecodeEngine(tp, tcfg, window_stage=True, **kw)
    plain = TE.DecodeEngine(tp, tcfg, **kw)
    assert te.window_stage and not plain.window_stage
    kv0 = te.footprint()["kv"]
    sp = TSP(max_new_tokens=10)
    assert te.generate(prompts, sp) == plain.generate(prompts, sp)
    win = te.cache.window_bytes()
    assert win == kv0 * (64 + 4) // 64
    assert te.footprint()["kv"] == kv0 + win


def test_engine_gate_turns_the_mode_off(tiny, monkeypatch):
    """The JAX engine's gate: off on an unquantized cache, on a ring, and
    where the window buffers would not fit 0.92 of the device's memory."""
    cfg, tcfg, _, tp = tiny
    kw = dict(max_batch=2, max_seq=64, steps_per_sync=4, device="cpu",
              window_stage=True)
    assert TE.DecodeEngine(tp, tcfg, **kw).window_stage
    assert not TE.DecodeEngine(tp, tcfg, quantized_kv=False,
                               **kw).window_stage
    ring = TE.DecodeEngine(tp, tcfg, ring_kv=True, **dict(kw, max_seq=256))
    assert ring.cache.ring and not ring.window_stage
    est = TE.DecodeEngine(tp, tcfg, **kw).footprint()
    win = est["kv"] * (64 + 4) / 64
    for budget, on in ((int((est["total"] + win) / 0.92) + 64, True),
                       (int((est["total"] + win) / 0.92) - 64, False)):
        monkeypatch.setattr(TE, "device_memory_bytes", lambda dev: budget)
        assert TE.DecodeEngine(tp, tcfg, **kw).window_stage is on


# -- tensor parallelism ------------------------------------------------------

def test_tp_decode_chunk_window_stage(tmp_path):
    """One tp = 2 world over gloo: ``make_tp_decode_chunk`` with
    ``window_stage=True`` (and False) from an int8 cache prefilled through
    ``make_tp_prefill_step``, off the packed bytes (intermediate 192: no
    linear takes K4, which JAX's CPU path skips). In f32 the shards change
    only the sum order, so each rank's greedy tokens equal JAX's window
    chunk's on one device."""
    cfg = dataclasses.replace(JL.LlamaConfig.tiny(), dtype=jnp.float32,
                              intermediate_size=192)
    jp = JL.quantize_params(JL.init_params(jax.random.PRNGKey(17), cfg),
                            blocksize=32, dtype=cfg.dtype)
    tiny = (cfg, config_from_reference(config_fields(cfg)), jp,
            from_reference_arrays(reference_arrays(jp), "cpu"))
    prompts = _prompts([6, 14], cfg.vocab_size, seed=17)
    job = dict(tp=2, dp=1, cases=[dict(
        id="w", fn="window_chunk", params=reference_arrays(jp),
        config=config_fields(cfg), prompts=prompts, max_seq=64, pad=16,
        steps=5, span=64, start=0)])
    world = start_world(job, 2, tmp_path, timeout=120)
    jc, _, first = _prefilled_caches(tiny, prompts, pad=16)
    jout = JE.decode_chunk(jp, jc, jnp.asarray(first),
                           jnp.ones((2,), bool), jax.random.PRNGKey(0),
                           JSA.build({}, 2), cfg, n_steps=5, all_greedy=True,
                           attn_span=64)
    for r in world.join():
        for window in (True, False):
            np.testing.assert_array_equal(r["w"][window]["tokens"],
                                          np.asarray(jout[0]))
            np.testing.assert_array_equal(r["w"][window]["lengths"],
                                          np.asarray(jout[2].lengths))
