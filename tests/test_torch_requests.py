"""PyTorch port vs JAX package: the request API of the decode engine.

Chunked prefill (int8 and bf16 KV caches), the repetition penalty, logprobs,
cancel and streaming, on the tiny config in f32 with the int4 cache, the
same model and prompts in both engines (JAX's ``step()`` loop, no
pipelining). In f32 both sides compute the same arithmetic up to f32 sum
order, so greedy tokens are identical and logprobs agree within 1e-5; the
unquantized cache keeps K/V in the config's dtype.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_bitsandbytes.engine import engine as JE
from tpu_bitsandbytes.engine.kvcache import KVCache as JKV
from tpu_bitsandbytes.engine.sampler import SamplingParams as JSP
from tpu_bitsandbytes.models import layers as JLayers
from tpu_bitsandbytes.models import llama as JL
from tpu_bitsandbytes_torch.convert import config_from_reference
from tpu_bitsandbytes_torch.engine import engine as TE
from tpu_bitsandbytes_torch.engine import sampler as TS
from tpu_bitsandbytes_torch.engine.kvcache import KVCache as TKV
from tpu_bitsandbytes_torch.engine.sampler import SamplingParams as TSP
from tpu_bitsandbytes_torch.models import layers as TLayers

from test_torch_engine import _model, _prompts
from test_torch_functional import config_fields, t32

LP_TOL = 1e-5      # logprobs, absolute: f32 logits in another sum order


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX params, port params): tiny, f32."""
    cfg = dataclasses.replace(JL.LlamaConfig.tiny(), dtype=jnp.float32)
    jp, tp = _model(cfg, seed=5)
    return cfg, config_from_reference(config_fields(cfg)), jp, tp


def _engines(tiny, **kw):
    """The JAX engine and the port's (on the CPU), built alike."""
    cfg, tcfg, jp, tp = tiny
    return (JE.DecodeEngine(jp, cfg, **kw),
            TE.DecodeEngine(tp, tcfg, device="cpu", **kw))


def _sps(spec):
    """(JAX, port) SamplingParams lists from keyword dicts."""
    return [JSP(**d) for d in spec], [TSP(**d) for d in spec]


def _run(engine):
    while engine.step():
        pass
    return {r.uid: r for r in engine.finished}


@pytest.mark.parametrize("quantized", [True, False])
def test_chunked_tokens_match_jax(tiny, quantized):
    """``prefill_chunk=16``: prompts of 50 and 33 tokens go in chunk by
    chunk beside a 7-token one that decodes meanwhile (a chunk of another
    slot's decode writes garbage at the prefilling slot's frontier); greedy
    tokens equal JAX's, on an int8 and on an unquantized cache."""
    cfg = tiny[0]
    prompts = _prompts([50, 7, 33], cfg.vocab_size, seed=1)
    je, te = _engines(tiny, max_batch=2, max_seq=128, prefill_chunk=16,
                      quantized_kv=quantized, steps_per_sync=4)
    ref = je.generate(prompts, JSP(max_new_tokens=6), pipeline_depth=1)
    got = te.generate(prompts, TSP(max_new_tokens=6))
    assert got == ref
    assert all(len(g) == 6 for g in got)


def test_chunked_equals_unchunked_with_bf16_kv(tiny):
    """With an unquantized cache a chunked prefill attends to the same
    keys as one forward over the prompt: the same greedy tokens (the JAX
    package's ``test_chunked_matches_unchunked``)."""
    cfg, tcfg, _, tp = tiny
    prompts = _prompts([50, 7, 33], cfg.vocab_size, seed=2)
    sp = TSP(max_new_tokens=6)
    outs = [TE.DecodeEngine(tp, tcfg, max_batch=2, max_seq=128,
                            quantized_kv=False, prefill_chunk=chunk,
                            device="cpu").generate(prompts, sp)
            for chunk in (None, 16)]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("quantized", [True, False])
def test_prefill_chunk_step_matches_jax(tiny, quantized):
    """Three 16-token chunks of a 40-token prompt through
    ``prefill_chunk_step``, then ``prefill_final_logits``: hidden states and
    logits within 1e-5 of max|ref| (f32, another sum order), and the caches
    alike (int8 codes equal where no f32 absmax rounds differently)."""
    cfg, tcfg, jp, tp = tiny
    prompt = _prompts([40], cfg.vocab_size, seed=3)[0]
    jc = JKV.create(cfg.num_layers, 2, 128, cfg.num_kv_heads, cfg.hd,
                    quantized=quantized, dtype=cfg.dtype)
    tc = TKV.create(cfg.num_layers, 2, 128, cfg.num_kv_heads, cfg.hd,
                    quantized=quantized, dtype=tcfg.dtype, device="cpu")
    for start in (0, 16, 32):
        toks = np.zeros((1, 16), np.int32)
        chunk = prompt[start:start + 16]
        toks[0, :len(chunk)] = chunk
        end = start + len(chunk)
        span = JE._chunk_span_bucket(start + 16, 128)
        jx, jc = JE.prefill_chunk_step(
            jp, jc, jnp.asarray(toks), jnp.int32(1), jnp.int32(start),
            jnp.int32(end), cfg, attn_span=span)
        tx, tc = TE.prefill_chunk_step(tp, tc, torch.from_numpy(toks), 1,
                                       start, end, tcfg, attn_span=span)
        ref = np.asarray(jx)
        assert np.abs(t32(tx) - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    assert tc.lengths.tolist() == [0, 40]
    jl = np.asarray(JE.prefill_final_logits(jp, jx, jnp.int32(39 - 32), cfg))
    tl = t32(TE.prefill_final_logits(tp, tx, 39 - 32, tcfg))
    assert tl.shape == (cfg.vocab_size,)
    assert np.abs(tl - jl).max() <= 1e-5 * np.abs(jl).max()
    kv = np.asarray(jc.k[:, 1, :, :40], np.float32)
    assert np.abs(t32(tc.k[:, 1, :, :40]) - kv).max() <= 1e-5 * max(
        np.abs(kv).max(), 1)


def test_prefill_and_decode_interleave_as_jax(tiny, monkeypatch):
    """While a 60-token prompt goes in as 4 chunks of 16, the request
    already running keeps decoding: both engines dispatch prefill chunks
    ("p") and decode chunks ("d") in the same order, with decode chunks
    between prefill chunks ("pd" and "dp"), and emit the same tokens."""
    cfg = tiny[0]
    calls = {"jax": [], "port": []}

    def spy(mod, side):
        for name, tag in (("prefill_chunk_step", "p"), ("decode_chunk", "d")):
            orig = getattr(mod, name)

            def wrapped(*a, _orig=orig, _tag=tag, **k):
                calls[side].append(_tag)
                return _orig(*a, **k)

            monkeypatch.setattr(mod, name, wrapped)

    spy(JE, "jax")
    spy(TE, "port")
    short, long_ = _prompts([5, 60], cfg.vocab_size, seed=4)
    outs = []
    for eng in _engines(tiny, max_batch=2, max_seq=128, prefill_chunk=16,
                        steps_per_sync=2, quantized_kv=False):
        sp = JSP if isinstance(eng, JE.DecodeEngine) else TSP
        eng.add_request(short, sp(max_new_tokens=30))
        eng.step()
        eng.add_request(long_, sp(max_new_tokens=3))
        outs.append({u: r.generated for u, r in _run(eng).items()})
    assert outs[1] == outs[0]
    joined = "".join(calls["port"])
    assert joined == "".join(calls["jax"])
    assert joined.count("p") == 4 and "pd" in joined and "dp" in joined


def test_penalty_across_chunks_and_group_admission_matches_jax(tiny):
    """The repetition penalty in group admission (three prompts of one
    length bucket, two penalized, over their prompts), at the first token
    of a chunked prefill, and in decode across 4-step chunk boundaries
    (the seen mask rebuilt on the host per chunk and updated on the device
    within one): greedy tokens equal JAX's, and the penalty changes them."""
    cfg, tcfg, _, tp = tiny
    prompts = _prompts([9, 12, 14, 40], cfg.vocab_size, seed=6)
    # prompts that repeat tokens, so the penalty has something to act on
    prompts = [p + p[:4] for p in prompts]
    spec = [dict(max_new_tokens=10, repetition_penalty=1.3),
            dict(max_new_tokens=10),
            dict(max_new_tokens=10, repetition_penalty=2.0),
            dict(max_new_tokens=10, repetition_penalty=1.3)]
    jsp, tsp = _sps(spec)
    je, te = _engines(tiny, max_batch=4, max_seq=128, prefill_chunk=32,
                      steps_per_sync=4)
    ref = je.generate(prompts, jsp, pipeline_depth=1)
    got = te.generate(prompts, tsp)
    assert got == ref
    plain = TE.DecodeEngine(tp, tcfg, max_batch=4, max_seq=128,
                            prefill_chunk=32, steps_per_sync=4,
                            device="cpu").generate(
        prompts, TSP(max_new_tokens=10))
    assert [got[i] != plain[i] for i in range(4)] == [True, False, True, True]


@pytest.mark.parametrize("quantized", [True, False])
def test_logprobs_match_jax(tiny, quantized):
    """Logprobs of every emitted token, the first (from prefill) included,
    within 1e-5 of JAX's (f32 logits in another sum order), beside a
    request that asks for none; one request with logprobs and a penalty
    (logprobs come from the raw logits) goes in by chunks."""
    cfg = tiny[0]
    prompts = _prompts([11, 6, 30], cfg.vocab_size, seed=7)
    spec = [dict(max_new_tokens=7, logprobs=True),
            dict(max_new_tokens=7),
            dict(max_new_tokens=7, logprobs=True, repetition_penalty=1.5)]
    jsp, tsp = _sps(spec)
    je, te = _engines(tiny, max_batch=3, max_seq=64, prefill_chunk=16,
                      steps_per_sync=4, quantized_kv=quantized)
    for eng, sps in ((je, jsp), (te, tsp)):
        for p, sp in zip(prompts, sps):
            eng.add_request(p, sp)
    ref, got = _run(je), _run(te)
    for uid in (1, 2, 3):
        assert got[uid].generated == ref[uid].generated
        assert len(got[uid].logprobs) == len(ref[uid].logprobs)
        np.testing.assert_allclose(got[uid].logprobs, ref[uid].logprobs,
                                   rtol=0, atol=LP_TOL)
    assert len(got[1].logprobs) == len(got[3].logprobs) == 7
    assert got[2].logprobs == []
    assert all(lp <= 0 for lp in got[1].logprobs + got[3].logprobs)


@pytest.mark.parametrize("which", ["waiting", "active", "prefilling"])
def test_cancel_matches_jax(tiny, which):
    """Cancel a waiting request, a decoding one or one half way through its
    chunked prefill, after the first engine step: it finishes cancelled
    with what it emitted so far, and every other request's tokens equal
    JAX's (the cancelled slot is reused by the waiting request)."""
    cfg = tiny[0]
    prompts = _prompts([6, 45, 9, 12], cfg.vocab_size, seed=8)
    target = {"active": 1, "prefilling": 2, "waiting": 4}[which]
    outs = []
    for eng in _engines(tiny, max_batch=3, max_seq=128, prefill_chunk=16,
                        steps_per_sync=4):
        sp = JSP if isinstance(eng, JE.DecodeEngine) else TSP
        for p in prompts:
            eng.add_request(p, sp(max_new_tokens=8))
        eng.step()
        state = {r.uid: "prefilling" if r.prefilling else "active"
                 for r in eng.active.values()}
        state.update({r.uid: "waiting" for r in eng.waiting})
        assert state[target] == which
        assert eng.cancel(target) and not eng.cancel(target)
        outs.append(_run(eng))
    ref, got = outs
    assert got[target].cancelled and len(got[target].generated) < 8
    assert {u: r.generated for u, r in got.items()} == {
        u: r.generated for u, r in ref.items()}


def test_generate_stream_events_match_jax(tiny):
    """``generate_stream``'s (uid, token, done) events equal JAX's, in
    order: two requests that decode and one that goes in by chunks; the
    last event of each uid has done=True and they add up to
    :meth:`generate`'s tokens."""
    cfg = tiny[0]
    prompts = _prompts([5, 40, 9], cfg.vocab_size, seed=9)
    spec = [dict(max_new_tokens=5), dict(max_new_tokens=6),
            dict(max_new_tokens=4, logprobs=True)]
    jsp, tsp = _sps(spec)
    je, te = _engines(tiny, max_batch=2, max_seq=128, prefill_chunk=16,
                      steps_per_sync=4)
    ref = list(je.generate_stream(prompts, jsp))
    got = list(te.generate_stream(prompts, tsp))
    assert got == ref
    for uid in (1, 2, 3):
        mine = [(t, d) for u, t, d in got if u == uid]
        assert [d for _, d in mine] == [False] * (len(mine) - 1) + [True]
        assert [t for t, _ in mine] == next(
            r.generated for r in te.finished if r.uid == uid)


@pytest.mark.parametrize("quantized", [True, False])
def test_chunk_padding_past_max_seq_is_dropped(tiny, quantized):
    """max_seq 120, prefill_chunk 16: a 119-token prompt's final chunk
    (positions 112-127) pads 8 positions past the cache. The JAX package's
    scatter drops them; so does the port (torch would raise), and the
    tokens equal JAX's, beside a request decoding meanwhile."""
    cfg = tiny[0]
    prompts = _prompts([119, 5], cfg.vocab_size, seed=10)
    je, te = _engines(tiny, max_batch=2, max_seq=120, prefill_chunk=16,
                      steps_per_sync=4, quantized_kv=quantized)
    ref = je.generate(prompts, JSP(max_new_tokens=12), pipeline_depth=1)
    got = te.generate(prompts, TSP(max_new_tokens=12))
    assert got == ref
    assert len(got[0]) == 1 and len(got[1]) == 12    # out of room at 119


@pytest.mark.parametrize("quantized", [True, False])
def test_write_decode_drops_positions_past_the_cache(quantized):
    """A [2, 8]-token write whose positions run past max_seq (row 0 from
    28, row 1 from 31) into slots 2 and 0 of a 32-position cache: what
    lands equals the JAX package's cache, which drops them."""
    rng = np.random.default_rng(11)
    L_, B_, S_, H_, D_ = 2, 3, 32, 2, 16
    j = JKV.create(L_, B_, S_, H_, D_, quantized=quantized,
                   dtype=jnp.float32)
    t = TKV.create(L_, B_, S_, H_, D_, quantized=quantized,
                   dtype=torch.float32, device="cpu")
    pos = np.stack([28 + np.arange(8), 31 + np.arange(8)]).astype(np.int32)
    slots = np.array([2, 0], np.int32)
    for li in range(L_):
        k = rng.standard_normal((2, 8, H_, D_)).astype(np.float32)
        v = rng.standard_normal((2, 8, H_, D_)).astype(np.float32)
        j = j.write_decode(li, jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(pos), slots=jnp.asarray(slots))
        t = t.write_decode(li, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(pos),
                           slots=torch.from_numpy(slots))
    for name in ("k", "v", "k_scale", "v_scale"):
        jv, tv = getattr(j, name), getattr(t, name)
        if jv is None:
            assert tv is None
            continue
        np.testing.assert_array_equal(t32(tv), np.asarray(jv, np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_unquantized_cache_matches_jax(dtype):
    """``KVCache.create(quantized=False)``: K/V in the given dtype with no
    scales and no stage; prefill and decode writes, ``read_raw`` and
    ``read_raw_slot`` equal the JAX package's, and ``bytes_per_token``
    follows the dtype (JAX's, which counts 2 bytes, for bf16)."""
    rng = np.random.default_rng(12)
    L_, B_, S_, H_, D_ = 2, 3, 32, 2, 16
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = JKV.create(L_, B_, S_, H_, D_, quantized=False, dtype=jdt)
    t = TKV.create(L_, B_, S_, H_, D_, quantized=False, dtype=tdt,
                   device="cpu")
    assert not t.quantized and t.k.dtype == tdt and t.k_scale is None
    for li in range(L_):
        k = rng.standard_normal((20, H_, D_)).astype(np.float32)
        v = rng.standard_normal((20, H_, D_)).astype(np.float32)
        j = j.write_prefill(li, 1, jnp.asarray(k), jnp.asarray(v))
        t = t.write_prefill(li, 1, torch.from_numpy(k), torch.from_numpy(v))
    j = j.begin_stage(4, window=False)
    t = t.begin_stage(4, window=False)
    assert j.stage is None and t.stage is None
    lens = np.array([3, 20, 9], np.int32)
    for li in range(L_):
        k = rng.standard_normal((B_, 1, H_, D_)).astype(np.float32)
        v = rng.standard_normal((B_, 1, H_, D_)).astype(np.float32)
        j = j.write_decode(li, jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(lens))
        t = t.write_decode(li, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(lens))
    for li in range(L_):
        for got, ref in zip(t.read_raw(li, 24), j.read_raw(li, 24)):
            assert (got is None) == (ref is None)
            if got is not None:
                np.testing.assert_array_equal(t32(got),
                                              np.asarray(ref, np.float32))
        for got, ref in zip(t.read_raw_slot(li, 1, 24),
                            j.read_raw_slot(li, jnp.int32(1), 24)):
            if got is not None:
                assert got.shape == (1, H_, 24, D_)
                np.testing.assert_array_equal(t32(got),
                                              np.asarray(ref, np.float32))
    want = L_ * 2 * H_ * D_ * t.k.element_size()
    assert t.bytes_per_token() == want
    if dtype == "bfloat16":
        assert t.bytes_per_token() == j.bytes_per_token()
    q = TKV.create(L_, B_, S_, H_, D_, device="cpu")
    assert q.bytes_per_token() == JKV.create(L_, B_, S_, H_,
                                             D_).bytes_per_token()


def test_read_raw_slot_matches_jax():
    """``read_raw_slot`` of an int8 cache: one slot's codes and scales, as
    views, equal to the JAX package's."""
    rng = np.random.default_rng(13)
    j = JKV.create(1, 3, 32, 2, 16, dtype=jnp.float32)
    t = TKV.create(1, 3, 32, 2, 16, device="cpu")
    k = rng.standard_normal((20, 2, 16)).astype(np.float32)
    j = j.write_prefill(0, 2, jnp.asarray(k), jnp.asarray(-k))
    t = t.write_prefill(0, 2, torch.from_numpy(k), torch.from_numpy(-k))
    for got, ref in zip(t.read_raw_slot(0, 2, 24),
                        j.read_raw_slot(0, jnp.int32(2), 24)):
        assert got._is_view()
        np.testing.assert_array_equal(t32(got), np.asarray(ref, np.float32))


def test_chunk_span_bucket_matches_jax():
    """``_chunk_span_bucket`` equals the JAX package's over needs up to 32k
    and several max_seq: multiples of 128 up to 2048, then powers of two."""
    for max_seq in (120, 2048, 3000, 4096, 32768):
        for need in list(range(1, 4200, 7)) + list(range(4200, 32769, 331)):
            assert (TE._chunk_span_bucket(need, max_seq)
                    == JE._chunk_span_bucket(need, max_seq)), (need, max_seq)


def test_prefill_chunk_below_16_raises(tiny):
    cfg, tcfg, _, tp = tiny
    with pytest.raises(ValueError):
        TE.DecodeEngine(tp, tcfg, prefill_chunk=8, device="cpu")


def test_repetition_penalty_is_hfs():
    """``apply_repetition_penalty`` equals the JAX package's and
    transformers' ``RepetitionPenaltyLogitsProcessor``."""
    transformers = pytest.importorskip("transformers")
    from tpu_bitsandbytes.engine.sampler import apply_repetition_penalty
    rng = np.random.default_rng(14)
    logits = rng.standard_normal((2, 50)).astype(np.float32)
    hist = [list(rng.integers(0, 50, 8)), list(rng.integers(0, 50, 5))]
    mask = np.zeros((2, 50), bool)
    for b in range(2):
        mask[b, hist[b]] = True
    pen = np.full((2,), 1.7, np.float32)
    got = TS.apply_repetition_penalty(torch.from_numpy(logits),
                                      torch.from_numpy(mask),
                                      torch.from_numpy(pen)).numpy()
    proc = transformers.RepetitionPenaltyLogitsProcessor(penalty=1.7)
    hf = np.stack([proc(torch.tensor([hist[b]]),
                        torch.tensor(logits[b:b + 1])).numpy()[0]
                   for b in range(2)])
    np.testing.assert_allclose(got, hf, atol=1e-6)
    np.testing.assert_array_equal(got, np.asarray(apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(mask), jnp.asarray(pen))))


def test_seen_mask_device_update_equals_host_rebuild(tiny):
    """Within a chunk the seen mask is updated on the device as tokens are
    emitted; after the chunk it equals the host's rebuild from the
    requests' prompts and outputs, for every slot still decoding."""
    cfg, tcfg, _, tp = tiny
    te = TE.DecodeEngine(tp, tcfg, max_batch=3, max_seq=64,
                         steps_per_sync=4, device="cpu")
    prompts = _prompts([5, 8, 11], cfg.vocab_size, seed=15)
    for p, pen in zip(prompts, (1.2, 1.0, 1.5)):
        te.add_request(p, TSP(max_new_tokens=20, repetition_penalty=pen))
    for _ in range(3):
        te.step()
        host = te._seen_mask()
        for slot in te.active:
            assert torch.equal(te._seen[slot], torch.from_numpy(host[slot]))
    assert len(te.active) == 3


def test_sample_first_token_with_penalty():
    """``sampler.sample`` (a request's first token): greedy with the
    penalty over its mask is the argmax of the penalized logits; a
    temperature row draws from the generator, within its top-k."""
    rng = np.random.default_rng(16)
    logits = torch.from_numpy(rng.standard_normal((1, 40)).astype(
        np.float32) * 3)
    mask = torch.zeros((1, 40), dtype=torch.bool)
    mask[0, logits[0].argmax()] = True
    gen = torch.Generator().manual_seed(0)
    got = TS.sample(logits, gen, TSP(repetition_penalty=1e6), mask)
    want = TS.apply_repetition_penalty(logits, mask,
                                       torch.tensor([1e6])).argmax(-1)
    assert got.dtype == torch.int32 and int(got[0]) == int(want[0])
    assert int(got[0]) != int(logits[0].argmax())
    state = gen.get_state()
    assert int(TS.sample(logits, gen, TSP())[0]) == int(logits[0].argmax())
    assert torch.equal(gen.get_state(), state)     # greedy draws nothing
    top3 = set(logits[0].topk(3).indices.tolist())
    draws = {int(TS.sample(logits, gen, TSP(temperature=5.0, top_k=3))[0])
             for _ in range(30)}
    assert draws <= top3 and len(draws) > 1


@pytest.mark.parametrize("staged", [False, True])
def test_bf16_int8_kv_attention_rounds_as_jax(monkeypatch, staged):
    """bf16 q over int8 codes (``gqa_attention_kv_quant``): C = 16 queries
    of one slot, as a prefill chunk attends, and one staged decode query;
    the JAX package's bf16 path (taken off the CPU, where it computes in
    f32, by reporting a TPU backend) rounds the v-scale-folded
    probabilities to bf16 before the PV product, and so does the port.
    Both outputs are bf16: f32 sums in another order flip an output's
    rounding only where it sits within that difference of a rounding
    boundary, so at most 1 bf16 ulp of max|ref| anywhere and 2% of the
    outputs apart; leaving p in f32 moves about 40% of them."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    rng = np.random.default_rng(17)
    b, h, hkv, d, t, c = (1, 8, 2, 64, 96, 16) if not staged else (
        1, 8, 2, 64, 96, 8)
    s = 1 if staged else c
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kq = rng.integers(-127, 128, (b, hkv, t, d), dtype=np.int8)
    vq = rng.integers(-127, 128, (b, hkv, t, d), dtype=np.int8)
    ks = (rng.random((b, hkv, t)) * 2 + 0.5).astype(np.float32)
    vs = (rng.random((b, hkv, t)) * 2 + 0.5).astype(np.float32)
    off = (70 + np.arange(s))[None].repeat(b, 0).astype(np.int32)
    jargs = [jnp.asarray(q, jnp.bfloat16), jnp.asarray(kq), jnp.asarray(ks),
             jnp.asarray(vq), jnp.asarray(vs)]
    targs = [torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(kq),
             torch.from_numpy(ks), torch.from_numpy(vq), torch.from_numpy(vs)]
    jkw, tkw = {}, {}
    if staged:
        st = [rng.integers(-127, 128, (b, hkv, c, d), dtype=np.int8),
              (rng.random((b, hkv, c)) + 0.5).astype(np.float32),
              rng.integers(-127, 128, (b, hkv, c, d), dtype=np.int8),
              (rng.random((b, hkv, c)) + 0.5).astype(np.float32)]
        jkw["staged"] = tuple(jnp.asarray(a) for a in st) + (jnp.int32(5),)
        tkw["staged"] = tuple(torch.from_numpy(a) for a in st) + (5,)
    ref = np.asarray(JLayers.gqa_attention_kv_quant(
        *jargs, causal_offset=jnp.asarray(off), **jkw), np.float32)
    got = t32(TLayers.gqa_attention_kv_quant(
        *targs, causal_offset=torch.from_numpy(off), **tkw))
    ulp = 2.0 ** -8 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= ulp
    assert np.mean(got != ref) <= 0.02
