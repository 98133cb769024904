"""PyTorch port vs JAX package: speculative decoding.

Prompt-lookup drafts, the verify step (``decode_layer`` with gamma + 1
tokens per slot) and the speculative engine, on the tiny config in f32
with the int4 cache. The invariant is the JAX package's: a speculative
engine emits exactly the tokens of plain greedy decoding. In f32 a verify
step's queries and a decode step's compute the same arithmetic up to f32
sum order, so that holds exactly here (at bf16 near-tied argmaxes can
flip); and the port's verify step emits JAX's tokens and counts.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_bitsandbytes.engine import engine as JE
from tpu_bitsandbytes.engine import speculative as JS
from tpu_bitsandbytes.engine.kvcache import KVCache as JKV
from tpu_bitsandbytes.engine.sampler import SamplingArrays as JSA
from tpu_bitsandbytes.engine.sampler import SamplingParams as JSP
from tpu_bitsandbytes.models import llama as JL
from tpu_bitsandbytes_torch.convert import config_from_reference
from tpu_bitsandbytes_torch.engine import engine as TE
from tpu_bitsandbytes_torch.engine import speculative as TS
from tpu_bitsandbytes_torch.engine.kvcache import KVCache as TKV
from tpu_bitsandbytes_torch.engine.sampler import SamplingArrays as TSA
from tpu_bitsandbytes_torch.engine.sampler import SamplingParams as TSP

from test_torch_engine import _model, _prompts
from test_torch_functional import config_fields


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: the test workers share
    the host's cores, and many threads per worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX params, port params): tiny, f32,
    int4 cache."""
    cfg = dataclasses.replace(JL.LlamaConfig.tiny(), dtype=jnp.float32)
    jp, tp = _model(cfg, seed=3)
    return cfg, config_from_reference(config_fields(cfg)), jp, tp


@pytest.mark.parametrize("hist,gamma,n,want", [
    ([5, 6, 7, 8, 9, 1, 2, 5, 6, 7], 3, 3, [8, 9, 1]),  # finds the repeat
    ([1, 2, 3, 1, 2, 4, 1, 2], 1, 2, [4]),              # latest match wins
    ([1, 2, 3, 4, 5], 3, 3, []),                        # no match
    ([1, 2], 3, 3, []),                                 # short history
])
def test_propose_ngram(hist, gamma, n, want):
    assert TS.propose_ngram(hist, gamma, n=n) == want
    assert JS.propose_ngram(hist, gamma, n=n) == want


def _caches(tiny, b, quantized, prefix, max_seq=32):
    """The JAX and port caches after decode steps over ``prefix`` [B, T]
    (both sides fed the same tokens): (JAX cache, port cache)."""
    cfg, tcfg, jp, tp = tiny
    jc = JKV.create(cfg.num_layers, b, max_seq, cfg.num_kv_heads, cfg.hd,
                    quantized=quantized, dtype=cfg.dtype)
    tc = TKV.create(cfg.num_layers, b, max_seq, cfg.num_kv_heads, cfg.hd,
                    quantized=quantized, dtype=tcfg.dtype, device="cpu")
    active = np.ones((b,), bool)
    for i in range(prefix.shape[1]):
        _, jc = JE.decode_step(jp, jc, jnp.asarray(prefix[:, i], jnp.int32),
                               jnp.asarray(active), cfg)
        _, tc = TE.decode_step(tp, tc, torch.from_numpy(
            prefix[:, i].astype(np.int32)), torch.from_numpy(active), tcfg)
    return jc, tc


def _verify(tiny, jc, tc, toks, active, all_greedy=False):
    """JAX's and the port's verify step on the same tokens, greedy rows:
    ((emitted, counts, lengths) of JAX, of the port) as numpy."""
    cfg, tcfg, jp, tp = tiny
    b = toks.shape[0]
    je, jn, jc = JS.verify_step(jp, jc, jnp.asarray(toks.astype(np.int32)),
                                jnp.asarray(active), jax.random.PRNGKey(0),
                                JSA.build({}, b), cfg)
    te, tn, tc = TS.verify_step(tp, tc, torch.from_numpy(toks.astype(np.int32)),
                                torch.from_numpy(active),
                                torch.Generator().manual_seed(0),
                                TSA.build({}, b, device="cpu"), tcfg,
                                all_greedy=all_greedy)
    return ((np.asarray(je), np.asarray(jn), np.asarray(jc.lengths)),
            (te.numpy(), tn.numpy(), tc.lengths.numpy()))


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("all_greedy", [False, True])
def test_verify_step_matches_sequential_greedy_and_jax(tiny, quantized,
                                                       all_greedy):
    """Drafts equal to what step-by-step greedy decoding emits are all
    accepted, and the emitted tokens are those of the sequential decode;
    emitted tokens, counts and lengths equal JAX's verify step's (greedy
    rows through the general acceptance rule, and the all-greedy one)."""
    cfg = tiny[0]
    b, ctx, g = 2, 6, 3
    prefix = np.random.default_rng(0).integers(1, cfg.vocab_size, (b, ctx))
    _, tc = _caches(tiny, b, quantized, prefix[:, :-1])
    toks = torch.from_numpy(prefix[:, -1].astype(np.int32))
    active = torch.ones((b,), dtype=torch.bool)
    oracle = []
    for _ in range(g + 1):
        logits, tc = TE.decode_step(tiny[3], tc, toks, active, tiny[1])
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        oracle.append(toks.numpy())
    oracle = np.stack(oracle, 1)                                # [B, g+1]
    jc, tc = _caches(tiny, b, quantized, prefix[:, :-1])
    vt = np.concatenate([prefix[:, -1:], oracle[:, :g]], axis=1)
    ref, got = _verify(tiny, jc, tc, vt, np.ones((b,), bool), all_greedy)
    np.testing.assert_array_equal(got[0], oracle)
    np.testing.assert_array_equal(got[1], g + 1)
    np.testing.assert_array_equal(got[2], ctx + g)
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(t, r)


def test_verify_rejects_wrong_drafts_and_inactive_slots_stay(tiny):
    """Wrong drafts: only the boundary token (greedy's next) is emitted and
    the length grows by one; an inactive slot counts 0 and keeps its
    length; all as JAX's verify step."""
    cfg, tcfg, _, tp = tiny
    b, g = 3, 3
    prefix = np.random.default_rng(1).integers(1, cfg.vocab_size, (b, 1))
    tc = _caches(tiny, b, True, prefix)[1]
    logits, _ = TE.decode_step(tp, tc, torch.tensor([7, 8, 9],
                                                    dtype=torch.int32),
                               torch.zeros((b,), dtype=torch.bool), tcfg)
    nxt = torch.argmax(logits, dim=-1).numpy()
    wrong = (nxt[:, None] + 1 + np.zeros((b, g), np.int64)) % cfg.vocab_size
    vt = np.concatenate([np.array([[7], [8], [9]]), wrong], axis=1)
    active = np.array([True, True, False])
    jc, tc = _caches(tiny, b, True, prefix)
    ref, got = _verify(tiny, jc, tc, vt, active)
    np.testing.assert_array_equal(got[1], [1, 1, 0])
    np.testing.assert_array_equal(got[0][:2, 0], nxt[:2])
    np.testing.assert_array_equal(got[2], [2, 2, 1])
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(t, r)


def test_verify_drafts_past_max_seq_are_dropped(tiny):
    """A verify step of a slot near the end of the cache: its drafts past
    ``max_seq`` are dropped (as JAX's scatter drops them), the rest of the
    cache is untouched, and position 0's logits equal a decode step's."""
    cfg, tcfg, _, tp = tiny
    b, s = 1, 8
    prefix = np.random.default_rng(2).integers(1, cfg.vocab_size, (b, 6))
    tc = _caches(tiny, b, True, prefix, max_seq=s)[1]
    before = [t.clone() for t in (tc.k, tc.v, tc.k_scale, tc.v_scale)]
    vt = torch.tensor([[5, 6, 7, 8]], dtype=torch.int32)
    logits = TS.verify_logits(tp, tc, vt, tcfg)
    for t0, t in zip(before, (tc.k, tc.v, tc.k_scale, tc.v_scale)):
        assert torch.equal(t[:, :, :, :6], t0[:, :, :, :6])
    assert tc.lengths.tolist() == [6]
    step, _ = TE.decode_step(tp, _caches(tiny, b, True, prefix,
                                         max_seq=s)[1],
                             vt[:, 0], torch.ones((1,), dtype=torch.bool),
                             tcfg)
    assert (logits[:, 0] - step).abs().max() <= 1e-5 * step.abs().max()


class TestSpeculativeEngine:
    def _prompts(self, cfg, repetitive):
        rng = np.random.default_rng(4)
        if repetitive:
            pat = rng.integers(1, cfg.vocab_size, 4).tolist()
            return [pat * 4 for _ in range(3)]
        return [rng.integers(1, cfg.vocab_size, 12).tolist()
                for _ in range(3)]

    @pytest.mark.parametrize("quantized", [True, False])
    @pytest.mark.parametrize("repetitive", [True, False])
    def test_matches_plain_greedy_and_jax(self, tiny, repetitive, quantized):
        """The speculative engine's greedy tokens equal the plain engine's
        and the JAX speculative engine's, on an int8 and an unquantized
        cache; its ``stats`` shows ``spec_stats``, the same counts as
        JAX's."""
        cfg, tcfg, jp, tp = tiny
        prompts = self._prompts(cfg, repetitive)
        kw = dict(max_batch=2, max_seq=128, quantized_kv=quantized)
        plain = TE.DecodeEngine(tp, tcfg, device="cpu", **kw).generate(
            prompts, TSP(max_new_tokens=10))
        je = JE.DecodeEngine(jp, cfg, speculative="ngram", spec_gamma=3, **kw)
        ref = je.generate(prompts, JSP(max_new_tokens=10))
        te = TE.DecodeEngine(tp, tcfg, speculative="ngram", spec_gamma=3,
                             device="cpu", **kw)
        got = te.generate(prompts, TSP(max_new_tokens=10))
        assert got == ref == plain
        assert te.spec_stats == je.spec_stats
        assert te.spec_stats["verify_steps"] > 0
        assert te.stats["speculative"] == te.spec_stats
        if repetitive:
            assert te.spec_stats["accepted"] > 0

    def test_sampled_slots_ride_the_verify_step(self, tiny):
        cfg, tcfg, _, tp = tiny
        eng = TE.DecodeEngine(tp, tcfg, max_batch=2, max_seq=128,
                              speculative="ngram", device="cpu")
        outs = eng.generate(_prompts([6, 6], cfg.vocab_size, seed=5),
                            TSP(max_new_tokens=4, temperature=0.9))
        assert all(len(o) == 4 for o in outs)
        assert eng.spec_stats["verify_steps"] > 0

    def test_penalty_requests_fall_back(self, tiny):
        """A repetition penalty (no seen mask in the verify step) takes the
        decode chunk, as in JAX; so do logprobs."""
        cfg, tcfg, _, tp = tiny
        for sp in (TSP(max_new_tokens=4, repetition_penalty=1.3),
                   TSP(max_new_tokens=4, logprobs=True)):
            eng = TE.DecodeEngine(tp, tcfg, max_batch=1, max_seq=128,
                                  speculative="ngram", device="cpu")
            outs = eng.generate(_prompts([6], cfg.vocab_size, seed=6), sp)
            assert len(outs[0]) == 4
            assert eng.spec_stats["verify_steps"] == 0

    def test_eos_mid_acceptance_stops(self, tiny):
        """An EOS inside an accepted run of drafts ends the request there,
        as the plain engine and JAX's speculative engine end it."""
        cfg, tcfg, jp, tp = tiny
        pat = np.random.default_rng(7).integers(1, cfg.vocab_size, 4).tolist()
        prompts = [pat * 4]
        kw = dict(max_batch=1, max_seq=128, quantized_kv=False)
        ref = TE.DecodeEngine(tp, tcfg, device="cpu", **kw).generate(
            prompts, TSP(max_new_tokens=10))[0]
        eos = int(ref[2])
        want = TE.DecodeEngine(tp, tcfg, device="cpu", **kw).generate(
            prompts, TSP(max_new_tokens=10, eos_token_id=eos))
        got = TE.DecodeEngine(tp, tcfg, speculative="ngram", spec_gamma=3,
                              device="cpu", **kw).generate(
            prompts, TSP(max_new_tokens=10, eos_token_id=eos))
        jax_got = JE.DecodeEngine(jp, cfg, speculative="ngram", spec_gamma=3,
                                  **kw).generate(
            prompts, JSP(max_new_tokens=10, eos_token_id=eos))
        assert got == want == jax_got
        assert got[0][-1] == eos and len(got[0]) <= 3


class TestAcceptanceDistribution:
    """``accept_and_emit`` is speculative sampling with a point-mass
    proposal: the first emitted token's marginal equals the row's sampling
    distribution, whatever the draft (the speculative sampling theorem).
    20,000 rows in one call; a 4-sigma binomial deviation at p = 0.25 is
    about 0.012."""

    N = 20000

    def _first_token_marginal(self, logits, draft, g):
        v = logits.shape[-1]
        n = self.N
        samp = TSA(torch.ones(n), torch.zeros(n, dtype=torch.int64),
                   torch.ones(n), torch.full((n,), -1, dtype=torch.int32),
                   torch.ones(n))
        tokens = torch.tensor([[0] + [draft] * g], dtype=torch.int32)
        emitted, _ = TS.accept_and_emit(
            logits.expand(n, -1, -1), tokens.expand(n, -1),
            torch.Generator().manual_seed(0), samp)
        return np.bincount(emitted[:, 0].numpy(), minlength=v) / n

    @pytest.mark.parametrize("likely,seed,scale,g", [(True, 3, 1.0, 3),
                                                     (False, 4, 2.0, 2)])
    def test_first_token_marginal_matches_target(self, likely, seed, scale,
                                                 g):
        """The most likely draft (mostly accepted) and the least likely
        one (mostly rejected, the residual draw must restore the target)."""
        v = 8
        logits = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (1, g + 1, v)).astype(np.float32) * scale)
        target = torch.softmax(logits[0, 0], dim=-1).numpy()
        draft = int(np.argmax(target) if likely else np.argmin(target))
        emp = self._first_token_marginal(logits, draft, g)
        np.testing.assert_allclose(emp, target, atol=0.015)

    def test_greedy_rows_stay_exact(self):
        """Greedy rows in a sampling batch accept by exact match; a row
        with a wrong first draft emits the argmax at position 0."""
        v, g = 8, 3
        logits = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (2, g + 1, v)).astype(np.float32))
        preds = torch.argmax(logits, dim=-1).numpy()
        toks = np.zeros((2, g + 1), np.int32)
        toks[0, 1:] = preds[0, :g]
        toks[1, 1:] = (preds[1, :g] + 1) % v
        samp = TSA.build({}, 2, device="cpu")
        for all_greedy in (False, True):
            emitted, n_acc = TS.accept_and_emit(
                logits, torch.from_numpy(toks),
                torch.Generator().manual_seed(0), samp, all_greedy=all_greedy)
            assert n_acc.tolist() == [g, 0]
            np.testing.assert_array_equal(emitted[0].numpy(), preds[0])
            assert int(emitted[1, 0]) == preds[1, 0]
