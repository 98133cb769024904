"""PyTorch port vs JAX package: sliding windows in the engine.

The counterparts of the JAX package's ``TestWindowedKVRead`` and
``TestRingKV``, each held against the JAX engine: a fully-windowed model
(Mistral-class) reads the KV cache from its window's 1024-bucket on, a
model with global layers reads it whole, and ``ring_kv=True`` keeps a
rolling cache of the window plus the positions in flight, with the same
greedy tokens as the full cache, past the ring's size, under speculation
and across a snapshot; and chunked prefill on a windowed model. The
models are tiny, f32 and full precision, from a numpy seed.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpu_bitsandbytes.engine import engine as JE
from tpu_bitsandbytes.engine.sampler import SamplingParams as JSP
from tpu_bitsandbytes.models import llama as JL
from tpu_bitsandbytes_torch.convert import (config_from_reference,
                                            from_reference_arrays)
from tpu_bitsandbytes_torch.engine import engine as TE
from tpu_bitsandbytes_torch.engine.sampler import SamplingParams as TSP

from test_torch_engine import _prompts
from test_torch_families import _to_jax, numpy_params
from test_torch_functional import config_fields


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: the test workers share
    the host's cores, and many threads per worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mistral(max_seq, window, seed):
    """(JAX config, port config, JAX params, port params): tiny Mistral in
    f32 with ``window``."""
    cfg = dataclasses.replace(JL.LlamaConfig.tiny_mistral(),
                              sliding_window=window, max_seq_len=max_seq,
                              dtype=jnp.float32)
    tree = numpy_params(cfg, seed)
    return (cfg, config_from_reference(config_fields(cfg)), _to_jax(tree),
            from_reference_arrays(tree, "cpu"))


def _both(model, prompts, sp, **kw):
    """Greedy tokens of the JAX engine (its step loop) and the port's."""
    cfg, tcfg, jp, tp = model
    ref = JE.DecodeEngine(jp, cfg, **kw).generate(
        prompts, JSP(**sp), pipeline_depth=1)
    te = TE.DecodeEngine(tp, tcfg, device="cpu", **kw)
    return te.generate(prompts, TSP(**sp)), ref, te


@pytest.fixture(scope="module")
def long_window():
    return _mistral(2048, 16, seed=21)


def test_windowed_start_matches_full_read(long_window, monkeypatch):
    """A 1,100-token prompt: the port's decode chunks read from a start of
    at least 1024, and its tokens are the JAX engine's (which reads from
    its own windowed start) and the port's own with the full read."""
    prompt = _prompts([1100], 512, seed=21)
    sp = dict(max_new_tokens=8)
    kw = dict(max_batch=1, max_seq=2048, quantized_kv=False)
    starts = []
    orig = TE.DecodeEngine._attn_window

    def spy(self, extra_steps=0):
        st, span = orig(self, extra_steps)
        starts.append(st)
        return st, span

    monkeypatch.setattr(TE.DecodeEngine, "_attn_window", spy)
    got, ref, _ = _both(long_window, prompt, sp, **kw)
    assert max(starts) >= 1024
    assert got == ref
    monkeypatch.setattr(TE.DecodeEngine, "_attn_window",
                        lambda self, extra_steps=0:
                        (0, self._attn_span(extra_steps)))
    full = TE.DecodeEngine(long_window[3], long_window[1], device="cpu",
                           **kw).generate(prompt, TSP(**sp))
    assert full == ref


def test_mixed_window_models_keep_full_read():
    """Gemma2's alternating windows: the read starts at 0, as in JAX."""
    cfg = dataclasses.replace(JL.LlamaConfig.tiny_gemma2(),
                              dtype=jnp.float32)
    tp = from_reference_arrays(numpy_params(cfg, 22), "cpu")
    e = TE.DecodeEngine(tp, config_from_reference(config_fields(cfg)),
                        max_batch=1, max_seq=64, quantized_kv=False,
                        device="cpu")
    e.add_request(_prompts([40], cfg.vocab_size, seed=22)[0],
                  TSP(max_new_tokens=2))
    e._admit()
    assert not e._fully_windowed
    assert e._attn_window() == (0, e._attn_span())


@pytest.fixture(scope="module")
def ring_model():
    return _mistral(512, 32, seed=31)


@pytest.mark.parametrize("quantized_kv", [False, True])
def test_ring_matches_full_cache(ring_model, quantized_kv):
    """A 150-token prompt (past the 128-entry ring) and 12 tokens: the
    port's ring engine gives the JAX ring engine's tokens and its own full
    cache's."""
    prompt = _prompts([150], 512, seed=31)
    sp = dict(max_new_tokens=12)
    kw = dict(max_batch=2, max_seq=512, quantized_kv=quantized_kv)
    got, ref, te = _both(ring_model, prompt, sp, ring_kv=True, **kw)
    assert te.cache.ring and te.cache.max_seq < 512
    assert got == ref
    full = TE.DecodeEngine(ring_model[3], ring_model[1], device="cpu",
                           **kw).generate(prompt, TSP(**sp))
    assert full == ref


def test_ring_memory_is_window_sized(ring_model):
    """The ring is ceil128(window + slack) = 128 entries against 512, and
    ``footprint()`` counts its bytes, as the JAX engine sizes it."""
    _, tcfg, jp, tp = ring_model
    kw = dict(max_batch=2, max_seq=512, quantized_kv=True)
    e = TE.DecodeEngine(tp, tcfg, ring_kv=True, device="cpu", **kw)
    full = TE.DecodeEngine(tp, tcfg, device="cpu", **kw)
    assert e.cache.k.numel() * 4 <= full.cache.k.numel()
    je = JE.DecodeEngine(jp, ring_model[0], ring_kv=True, **kw)
    assert e.ring_size == je.ring_size == 128
    assert tuple(e.cache.k.shape) == tuple(je.cache.k.shape)
    assert e.footprint()["kv"] * 4 == full.footprint()["kv"]


def test_ring_generation_past_ring_size(ring_model):
    """120 new tokens after 20 prompt tokens: the ring's entries recycle,
    and the tokens stay the JAX engine's."""
    prompt = _prompts([20], 512, seed=32)
    got, ref, _ = _both(ring_model, prompt, dict(max_new_tokens=120),
                        max_batch=1, max_seq=512, quantized_kv=False,
                        ring_kv=True)
    assert got == ref and len(got[0]) == 120


def test_ring_speculative_and_snapshot(ring_model, tmp_path):
    """Speculation over a ring (the verify step reads it under the ring
    mask) gives plain greedy's tokens; a snapshot after one step keeps the
    ring flag, refuses a plain engine, and the restored engine finishes
    with the uninterrupted tokens."""
    cfg, tcfg, jp, tp = ring_model
    rng = np.random.default_rng(33)
    rep = (list(map(int, rng.integers(0, cfg.vocab_size, 7))) * 6)[:40]
    sp = dict(max_new_tokens=10)
    kw = dict(max_batch=1, max_seq=512, quantized_kv=False)
    ref = JE.DecodeEngine(jp, cfg, **kw).generate([rep], JSP(**sp),
                                                  pipeline_depth=1)
    spec = TE.DecodeEngine(tp, tcfg, ring_kv=True, speculative="ngram",
                           device="cpu", **kw)
    assert spec.generate([rep], TSP(**sp)) == ref
    assert spec.spec_stats["accepted"] > 0
    e = TE.DecodeEngine(tp, tcfg, ring_kv=True, device="cpu", **kw)
    e.add_request(rep, TSP(**sp))
    e.step()
    path = str(tmp_path / "ring.npz")
    e.save_state(path)
    with pytest.raises(ValueError, match="cache mode"):
        TE.DecodeEngine(tp, tcfg, device="cpu", **kw).load_state(path)
    e2 = TE.DecodeEngine(tp, tcfg, ring_kv=True, device="cpu", **kw)
    e2.load_state(path)
    assert e2.cache.ring
    while e2.step():
        pass
    assert e2.finished[0].generated == ref[0]


def test_ring_rejects_unsuitable_configs(ring_model):
    """No window, or a ring no shorter than ``max_seq``: refused, as in
    JAX."""
    cfg = dataclasses.replace(JL.LlamaConfig.tiny(), dtype=jnp.float32)
    tp = from_reference_arrays(numpy_params(cfg, 34), "cpu")
    tcfg = config_from_reference(config_fields(cfg))
    with pytest.raises(ValueError, match="fully-sliding-window"):
        TE.DecodeEngine(tp, tcfg, max_batch=1, max_seq=64, ring_kv=True,
                        device="cpu")
    with pytest.raises(ValueError, match="inert"):
        TE.DecodeEngine(ring_model[3], ring_model[1], max_batch=1,
                        max_seq=128, ring_kv=True, device="cpu")


@pytest.mark.parametrize("ring", [False, True])
def test_chunked_prefill_on_windowed_model(long_window, ring):
    """A 1,400-token prompt in 256-token chunks on the windowed model: the
    last chunks read from a windowed start (1024) on the plain cache, the
    whole ring on a ring cache; tokens equal the JAX engine's."""
    prompt = _prompts([1400, 40], 512, seed=35)
    kw = dict(max_batch=2, max_seq=2048, quantized_kv=True,
              prefill_chunk=256, ring_kv=ring)
    got, ref, te = _both(long_window, prompt, dict(max_new_tokens=8), **kw)
    assert got == ref
    if not ring:
        assert te._win_start(1280) == 1024
