"""The decode engine's tracer (``DecodeEngine.tracer``) on the CPU.

The spans of the serving loops (``run_pipelined`` and the ``step`` loop)
nest as the engine documents them and cover the loops' bodies; the
counters match the spans and hand counts (a group's padded tokens, the KV
in use at a dispatch); every request's times are ordered; and tracing
changes no token, keeps nothing while off and records nothing per token.
A tiny f32 model with the int4 cache, built from a seed (no JAX).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_bitsandbytes_torch.engine import engine as TE
from tpu_bitsandbytes_torch.engine.sampler import SamplingParams as TSP
from tpu_bitsandbytes_torch.models import llama
from tpu_bitsandbytes_torch.utils.metrics import Tracer

TOP = {"engine.admission", "engine.dispatch", "engine.collect",
       "engine.drain"}
CHILDREN = {
    "engine.admission": {"engine.prefill_group", "engine.prefill_one",
                         "engine.prefill_chunk", "engine.first_tokens"},
    "engine.dispatch": {"engine.stage", "graph.replay", "graph.capture"},
    "engine.collect": {"engine.collect_wait"},
    "engine.drain": {"engine.collect"},
}
REASONS = {"idle", "slot_free", "prefill", "budget"}


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
    """(config, int4-cached params): LlamaConfig.tiny_mistral() in f32 (a
    window of 16 for the ring), 256 positions."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny_mistral(),
                              dtype=torch.float32, max_seq_len=256)
    gen = torch.Generator().manual_seed(3)
    params = llama.quantize_params(
        llama.init_params(cfg, generator=gen, device="cpu"),
        dtype=torch.float32, fuse_projections=True)
    return cfg, llama.build_runtime_cache(params, "int4")


def _prompts(lengths, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


def _engine(tiny, **kw):
    cfg, params = tiny
    kw = {"max_batch": 3, "max_seq": 256, "steps_per_sync": 4, **kw}
    return TE.DecodeEngine(params, cfg, device="cpu", **kw)


LOOP = ("_admit", "_advance_prefill", "_host_inputs", "_attn_window",
        "_seen_mask", "run_chunk", "_dispatch", "_to_host", "_collect_host",
        "_collect_chunk", "_burst_end", "_budget_in_flight", "_kv_in_use")


def _inside_spans(eng):
    """Wrap the methods the serving loops call so that each call records
    whether a span was open around it."""
    outside = []
    for name in LOOP:
        fn = getattr(eng, name)

        def run(*a, _fn=fn, _name=name, **kw):
            if not eng.tracer._open:
                outside.append(_name)
            return _fn(*a, **kw)
        setattr(eng, name, run)
    return outside


def _check_tree(tr, loop_depth):
    """Every span closed inside its parent, under the parent the engine
    documents; returns {name: [spans]}."""
    by = {}
    for i, sp in enumerate(tr.spans):
        by.setdefault(sp.name, []).append(sp)
        assert sp.start_ns <= sp.end_ns
        if sp.parent < 0:
            assert sp.name in TOP, sp.name
            continue
        parent = tr.spans[sp.parent]
        assert sp.parent < i
        assert sp.name in CHILDREN[parent.name], (parent.name, sp.name)
        assert parent.start_ns <= sp.start_ns <= sp.end_ns <= parent.end_ns
    if loop_depth == 1:
        assert "engine.drain" not in by
    return by


CASES = {
    "plain": ({}, [20, 25, 30, 50, 9, 70], 10),
    "chunked": ({"prefill_chunk": 32}, [20, 25, 90, 9, 70], 10),
    "ring": ({"ring_kv": True}, [20, 150, 30, 9], 10),
    # a speculative engine runs the step loop at either depth
    "ngram": ({"speculative": "ngram"}, [20, 25, 30, 9], 10),
}


@pytest.mark.parametrize("depth", [2, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_and_cover_the_loop(tiny, case, depth):
    """Under ``run_pipelined`` (depth 2) and the ``step`` loop (depth 1),
    with a chunked prefill, a ring cache and speculative verify steps
    (always the step loop): every span sits under
    the parent the engine documents, every method the loop calls runs
    inside a span, ``engine.chunks`` is the number of dispatch spans,
    the collections' tokens are ``engine.decode_tokens`` (and
    ``stats["tokens"]``), and every request is admitted once."""
    kw, lengths, n_out = CASES[case]
    eng = _engine(tiny, **kw)
    if case == "ring":
        assert eng.cache.ring
    outside = _inside_spans(eng)
    eng.tracer.start()
    eng.generate(_prompts(lengths, tiny[0].vocab_size),
                 TSP(max_new_tokens=n_out), pipeline_depth=depth)
    eng.tracer.stop()
    assert outside == []
    tr = eng.tracer
    loop = 1 if case == "ngram" else depth
    by = _check_tree(tr, loop)
    counts = tr.counts
    assert counts["engine.chunks"] == len(by["engine.dispatch"])
    tokens = sum(s.attrs["tokens"] for s in by["engine.collect"]
                 if "tokens" in s.attrs)
    assert counts["engine.decode_tokens"] == tokens == eng.stats["tokens"]
    assert tokens + len(lengths) == len(lengths) * n_out
    for sp in by["engine.dispatch"]:
        assert sp.attrs["graph"] == "eager"
        assert len(sp.attrs["key"]) == (4 if case == "ngram" else 6)
        assert 0 < sp.attrs["kv_used"] <= sp.attrs["kv_reserved"]
        assert sp.attrs["kv_reserved"] == 3 * eng.cache.max_seq
    uids = [u for s in by["engine.admission"] for u in s.attrs.get("uids", ())]
    assert sorted(uids) == list(range(1, len(lengths) + 1))
    assert all(s.device_ms is None for s in tr.spans)    # no CUDA events
    if loop == 2:
        assert {s.attrs["reason"] for s in by["engine.drain"]} <= REASONS
        assert "engine.collect_wait" not in by      # no events on the CPU
    if case == "chunked":
        # the 90-token prompt (the third request) in 32-token chunks
        pre = [s for s in by["engine.prefill_chunk"] if s.attrs["uid"] == 3]
        assert [(s.attrs["start"], s.attrs["end"]) for s in pre] == [
            (0, 32), (32, 64), (64, 90)]
    if case == "ngram":
        assert eng.spec_stats["verify_steps"] == len(by["engine.dispatch"])
    if case == "ring":
        # 150 tokens bucket to 256, past the 128-entry ring: alone
        one = [s for s in by["engine.prefill_one"] if s.attrs["tokens"] == 150]
        assert one and one[0].attrs["s_pad"] == 256
    pre_tok = sum(s.attrs["tokens"] for n in ("engine.prefill_group",
                                              "engine.prefill_one")
                  for s in by.get(n, ()))
    pre_tok += sum(s.attrs["end"] - s.attrs["start"]
                   for s in by.get("engine.prefill_chunk", ()))
    assert counts["prefill.tokens"] == pre_tok == sum(lengths)


def test_group_padding_counted_by_hand(tiny):
    """A group of 3 prompts of 20, 25 and 30 tokens pads to 4 rows (a copy
    of row 0) of the 32 bucket: 128 padded tokens for 75 true ones."""
    eng = _engine(tiny)
    eng.tracer.start()
    eng.generate(_prompts([20, 25, 30], tiny[0].vocab_size),
                 TSP(max_new_tokens=2))
    eng.tracer.stop()
    grp = [s for s in eng.tracer.spans if s.name == "engine.prefill_group"]
    assert len(grp) == 1
    assert {k: grp[0].attrs[k] for k in ("rows", "r_pad", "s_pad",
                                          "tokens")} == {
        "rows": 3, "r_pad": 4, "s_pad": 32, "tokens": 75}
    assert eng.tracer.counts["prefill.padded_tokens"] == 4 * 32
    assert eng.tracer.counts["prefill.tokens"] == 75


@pytest.mark.parametrize("depth", [2, 1])
def test_kv_used_by_hand(tiny, depth):
    """Prompts of 10 and 20 tokens, 4-step chunks: the second dispatch
    holds each prompt, its first token's step and the 4 steps of the first
    chunk (in flight, pipelined; collected, in the step loop): (10 + 4) +
    (20 + 4) = 38 positions of 2 x 256. And at every dispatch the KV in use
    is what the device's slot lengths say (the CPU runs each chunk before
    the next is staged)."""
    eng = _engine(tiny, max_batch=2)
    seen = []
    dispatch = eng._dispatch

    def run(**kw):
        lens = eng.cache.lengths.tolist()
        seen.append(sum(min(lens[s], eng.cache.max_seq) for s in eng.active))
        return dispatch(**kw)
    eng._dispatch = run
    eng.tracer.start()
    eng.generate(_prompts([10, 20], tiny[0].vocab_size),
                 TSP(max_new_tokens=9), pipeline_depth=depth)
    eng.tracer.stop()
    used = [s.attrs["kv_used"] for s in eng.tracer.spans
            if s.name == "engine.dispatch"]
    assert used[:2] == [30, 38]
    assert [s.attrs["kv_reserved"] for s in eng.tracer.spans
            if s.name == "engine.dispatch"][0] == 2 * 256
    assert used == seen


def test_kv_used_capped_at_the_ring(tiny):
    """A ring cache of 128 entries: a 150-token prompt holds 128."""
    eng = _engine(tiny, max_batch=1, ring_kv=True)
    eng.tracer.start()
    eng.generate(_prompts([150], tiny[0].vocab_size), TSP(max_new_tokens=6),
                 pipeline_depth=1)
    eng.tracer.stop()
    used = [s.attrs["kv_used"] for s in eng.tracer.spans
            if s.name == "engine.dispatch"]
    assert used and all(u == 128 for u in used)


def test_request_times_ordered(tiny):
    """Every request: submitted, admitted, first token, in that order on
    the tracer's clock, and its first token collected at the admission
    that gave it its slot; a cancelled waiting request has no admission
    and no first token."""
    eng = _engine(tiny, max_batch=2)
    prompts = _prompts([12, 30, 7, 44, 19], tiny[0].vocab_size)
    uids = [eng.add_request(p, TSP(max_new_tokens=6)) for p in prompts]
    eng.cancel(uids[-1])
    eng.tracer.start()
    eng.run_pipelined()
    eng.tracer.stop()
    adm = [s for s in eng.tracer.spans if s.name == "engine.admission"]
    reqs = {r.uid: r for r in eng.finished}
    for u in uids[:-1]:
        r = reqs[u]
        assert r.t_submit <= r.t_admit <= r.t_first
        at = [s for s in adm if u in s.attrs.get("uids", ())]
        assert len(at) == 1
        assert at[0].start_ns <= r.t_admit <= r.t_first <= at[0].end_ns
    gone = reqs[uids[-1]]
    assert gone.t_admit is None and gone.t_first is None


def test_tracing_changes_no_token_and_keeps_nothing_off(tiny):
    """The same requests with the tracer on and off give the same tokens
    and counters; off, no span is kept; on, the spans are bounded by the
    chunks and admissions (none per token)."""
    prompts = _prompts([20, 25, 30, 50, 9, 70, 33], tiny[0].vocab_size)
    sp = TSP(max_new_tokens=24)
    off, on = _engine(tiny, steps_per_sync=8), _engine(tiny, steps_per_sync=8)
    on.tracer.start()
    got = on.generate(prompts, sp)
    on.tracer.stop()
    assert off.generate(prompts, sp) == got
    assert off.tracer.spans == [] and dict(off.tracer.counts) == dict(
        on.tracer.counts)
    n_chunks = on.tracer.counts["engine.chunks"]
    n_adm = sum(1 for s in on.tracer.spans if s.name == "engine.admission")
    # per chunk: its dispatch, staging, collection; per admission: its
    # span, a prefill per group or prompt, the first tokens' read, a drain
    assert len(on.tracer.spans) <= 3 * n_chunks + (3 + len(prompts)) * n_adm
    assert on.tracer.counts["engine.decode_tokens"] > len(on.tracer.spans)


def test_tracer_spans_nest_and_continue():
    """The tracer alone: parents by index, a note continues the innermost
    open span of its name (from inside a child too) and is dropped where
    none is open, ``start`` drops an earlier recording, and a span or a
    note while off keeps nothing."""
    tr = Tracer()
    with tr.span("a") as a:
        assert a is None
        tr.note("a", x=0)
    assert tr.spans == []
    tr.start()
    with tr.span("a", x=1) as a:
        tr.note("a", y=2)
        with tr.span("b") as b:
            tr.note("a", z=3)
            tr.note("c", w=4)
    with tr.span("c"):
        pass
    tr.note("a", v=5)
    tr.count("n")
    tr.count("n", 3)
    tr.stop()
    assert [(s.name, s.parent) for s in tr.spans] == [("a", -1), ("b", 0),
                                                      ("c", -1)]
    assert a.attrs == {"x": 1, "y": 2, "z": 3} and b.attrs == {}
    assert tr.spans[2].attrs == {} and b.end_ns <= a.end_ns
    assert tr.counts["n"] == 4 and tr.counts["missing"] == 0
    tr.start()
    assert tr.spans == [] and tr.counts["n"] == 4
