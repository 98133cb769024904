"""The program's own trace as the traced run reads it
(``harness/engine_trace.py``): the four readers on hand-built runs, the
idle gaps named by the innermost program span before the harness's phase,
the instrument's extension with and without an engine tracer, the
cross-checks against the harness's readings and the clock's residuals."""

import types

import pytest

from harness import engine_trace as ET
from harness import spec
from harness import trace
from harness.record import Run
from harness.accounting import Window
from tpu_bitsandbytes_torch.utils.metrics import Span, Tracer


MS = 1_000_000


def np_p90(values):
    import numpy as np
    return float(np.percentile(values, 90))


def _reader(name):
    return spec.load_reader(spec.BENCH / "metrics" / f"{name}.py")


def _marks(spans=(), counts_open=None, counts_close=None, requests=(),
           firsts=()):
    tr = Tracer()
    tr.spans = list(spans)
    m = ET.Marks(tr, open_ns=100 * MS, close_ns=1100 * MS,
                 open_counts=counts_open or {},
                 close_counts=counts_close or {},
                 requests=list(requests), firsts=list(firsts), checked=True)
    return m


def _run(marks):
    return Run(cell="t", cfg={}, engine={"steps_per_sync": 4,
                                         "max_batch": 2},
               window=Window(0.0, 1.0), reqs=[], setup_s=0.0, capture_s=0.0,
               memory_peak=0, device_kind="cpu",
               inst=types.SimpleNamespace(program=marks))


def test_queue_wait_p90_over_the_window_admissions():
    """(submitted, admitted) in ms: admissions at 50 (before the window),
    1,100 (at the close) and never are left out; the waits 0, 10, ..., 90
    ms of the ten admitted inside give a p90 of 81 ms."""
    reqs = [(50 * MS - 5, 50 * MS), (1000 * MS, 1100 * MS), (200 * MS, None)]
    reqs += [(200 * MS, (200 + 10 * i) * MS) for i in range(10)]
    got = _reader("queue_wait_p90_ms")(_run(_marks(requests=reqs)))
    assert got == pytest.approx(81.0)
    # the harness's profiler starting at 250-1,250 ms: each wait loses
    # what it holds of that (those admitted at 260-290 ms keep 50 ms)
    m = _marks(requests=reqs)
    m.pauses = [(250 * MS, 1250 * MS)]
    assert _reader("queue_wait_p90_ms")(_run(m)) == pytest.approx(
        np_p90([0, 10, 20, 30, 40, 50, 50, 50, 50, 50]))


def test_admit_to_first_p90_over_the_window_admissions():
    """(admitted, first token) in ms: admissions at 50 (before the
    window) and 1,100 (at the close), and a request with no first token
    yet, are left out; the ten admitted at 200 ms with their first tokens
    100, 200, ..., 1,000 ms later give a p90 of 910 ms, and 500 where the
    profiler paused at 700-1,200 ms."""
    firsts = [(50 * MS, 60 * MS), (1100 * MS, 1200 * MS), (300 * MS, None)]
    firsts += [(200 * MS, (300 + 100 * i) * MS) for i in range(10)]
    got = _reader("admit_to_first_p90_ms")(_run(_marks(firsts=firsts)))
    assert got == pytest.approx(910.0)
    m = _marks(firsts=firsts)
    m.pauses = [(700 * MS, 1200 * MS)]
    assert _reader("admit_to_first_p90_ms")(_run(m)) == pytest.approx(
        np_p90([100, 200, 300, 400, 500, 500, 500, 500, 500, 500]))
    assert _reader("admit_to_first_p90_ms")(_run(_marks())) is None


def test_admission_stall_share_clips_to_the_window():
    """Admissions at 50-150 ms (50 inside), 400-600 (200) and 1,050-1,300
    (50) of a 1,000 ms window: 30%; a prefill span inside an admission
    and a dispatch are not counted again."""
    spans = [Span("engine.admission", 50 * MS, end_ns=150 * MS),
             Span("engine.admission", 400 * MS, end_ns=600 * MS),
             Span("engine.prefill_group", 410 * MS, parent=1,
                  end_ns=590 * MS),
             Span("engine.dispatch", 600 * MS, end_ns=900 * MS),
             Span("engine.admission", 1050 * MS, end_ns=1300 * MS)]
    assert _reader("admission_stall_share")(_run(_marks(spans))) == \
        pytest.approx(30.0)
    # the profiler paused 100 ms inside the second admission: 200 of 900
    m = _marks(spans)
    m.pauses = [(450 * MS, 550 * MS)]
    assert _reader("admission_stall_share")(_run(m)) == pytest.approx(
        100 * 200 / 900)
    assert _reader("admission_stall_share")(_run(_marks())) is None


def test_prefill_useful_share_from_the_counters():
    """75 true tokens of 128 padded in the window (counters at the open
    and the close): 58.59375%."""
    m = _marks(counts_open={"prefill.tokens": 500,
                            "prefill.padded_tokens": 900},
               counts_close={"prefill.tokens": 575,
                             "prefill.padded_tokens": 1028})
    assert _reader("prefill_useful_share")(_run(m)) == pytest.approx(
        100 * 75 / 128)
    assert _reader("prefill_useful_share")(_run(_marks())) is None


def test_kv_in_use_share_over_the_window_dispatches():
    """The loop's dispatches inside the window at 30 and 50 of 100
    positions: 40%; one before the window, one opened inside another
    span and one without the loop's KV count are not read."""
    kv = {"kv_reserved": 100}
    spans = [Span("engine.dispatch", 90 * MS, attrs={**kv, "kv_used": 90}),
             Span("engine.dispatch", 200 * MS, attrs={**kv, "kv_used": 30}),
             Span("engine.dispatch", 300 * MS, attrs={**kv, "kv_used": 50}),
             Span("engine.dispatch", 400 * MS, parent=2,
                  attrs={**kv, "kv_used": 99}),
             Span("engine.dispatch", 500 * MS, attrs={"key": None})]
    for s in spans:
        s.end_ns = s.start_ns + MS
    assert _reader("kv_in_use_share")(_run(_marks(spans))) == \
        pytest.approx(40.0)


def test_readers_find_nothing_without_the_program():
    """A run whose program has no tracer (or an untraced run) reads None
    in every new metric, and raises nothing."""
    for inst in (None, types.SimpleNamespace(program=None)):
        run = _run(None)
        run.inst = inst
        for name in ("queue_wait_p90_ms", "admission_stall_share",
                     "prefill_useful_share", "kv_in_use_share",
                     "admit_to_first_p90_ms"):
            assert _reader(name)(run) is None


def test_idle_gaps_named_by_the_innermost_span_first():
    """Gaps (profiler clock) named by the deepest program span over their
    middle: ``engine.first_tokens`` inside ``engine.admission``; where no
    program span covers the middle, the harness's phase (host clock =
    profiler clock - 10), else "host other"."""
    spans = [Span("engine.admission", 100, end_ns=300),
             Span("engine.first_tokens", 200, parent=0, end_ns=300),
             Span("engine.dispatch", 300, end_ns=400),
             Span("graph.replay", 350, parent=2, end_ns=400)]
    host = [("host prefill", 500, 600)]
    idle = [(190, 230), (360, 380), (505, 555), (700, 705), (110, 130)]
    got = ET.named_gaps(idle, spans, host, 10)
    assert got == [["host prefill", 50e-9], ["engine.first_tokens", 40e-9],
                   ["graph.replay", 20e-9], ["engine.admission", 20e-9],
                   ["host other", 5e-9]]
    assert ET.named_gaps(idle, [], host, 10, n=1) == [["host prefill",
                                                        50e-9]]


class _Engine:
    """The six methods the instrument wraps, on the CPU."""

    def __init__(self, tracer):
        import torch
        self.device = torch.device("cpu")
        if tracer is not None:
            self.tracer = tracer
        self.finished, self.active, self.waiting = [], {}, []

    def _dispatch(self, **kw):
        return None

    _collect_chunk = _admit_group = _admit_one = _dispatch
    _host_inputs = _collect_host = _dispatch


def _loop(engine):
    return types.SimpleNamespace(engine=engine, hooks=[], keep_chunks=False,
                                 t_open=None, t_close=None)


def test_instrument_starts_the_tracer_and_marks_the_window():
    """With an engine tracer: started when the instrument is built, the
    window's ends marked at the admission points with the counters and
    the requests' times; without one, nothing changes."""
    ET.install()
    bare = trace.Instrument(_loop(_Engine(None)), 0.0, 1.0)
    assert bare.program is None
    tr = Tracer()
    eng = _Engine(tr)
    loop = _loop(eng)
    inst = trace.Instrument(loop, 0.0, 1.0)
    assert tr.on and inst.program.tracer is tr
    point = loop.hooks[-1]
    point(loop, 0.0)                        # not steady yet
    assert inst.program.open_ns is None
    loop.t_open = 1.0
    tr.count("prefill.tokens", 7)
    point(loop, 1.0)
    assert inst.program.open_counts == {"prefill.tokens": 7}
    tr.count("prefill.tokens", 5)
    eng.finished = [types.SimpleNamespace(t_submit=1, t_admit=2, t_first=4)]
    loop.t_close = 2.0
    point(loop, 2.0)
    m = inst.program
    assert m.open_ns <= m.close_ns and m.delta("prefill.tokens") == 5
    assert m.requests == [(1, 2)] and m.firsts == [(2, 4)]


def test_cross_checks_and_clock_residuals():
    """The counters against the harness's window (chunk tokens, prefill
    tokens), the dispatch spans' device ms against the chunk events, and
    the clock: the marker's record 5 us after its launch, a burst's first
    dispatch whose first record (its staging copy) follows its start by 20
    us and its staging's by 15 us on an idle device, and whose replay's
    first kernel follows the replay's start by 29.97 ms, with the host
    28.97 ms in that replay's call against 2 ms in the next dispatch's."""
    spans = [Span("engine.admission", 100 * MS, end_ns=200 * MS),
             Span("engine.dispatch", 200 * MS, end_ns=300 * MS,
                  device_ms=10.0),
             Span("engine.dispatch", 300 * MS, end_ns=400 * MS,
                  device_ms=12.0),
             Span("engine.stage", 200 * MS + 5000, parent=1,
                  end_ns=200 * MS + 9000),
             Span("graph.replay", 200 * MS + 30000, parent=1,
                  end_ns=229 * MS),
             Span("graph.replay", 301 * MS, parent=2, end_ns=303 * MS)]
    m = _marks(spans, counts_open={"engine.chunks": 3,
                                   "engine.decode_tokens": 10,
                                   "prefill.tokens": 0},
               counts_close={"engine.chunks": 5, "engine.decode_tokens": 22,
                             "prefill.tokens": 40})
    m.marker_ns = 99 * MS
    req = types.SimpleNamespace(chunks=[None] + [0] * 8 + [1] * 4,
                                prompt=[1] * 3)
    span = trace.Span(t_start=0.0, t_stop=1.0, records=[
        ("marker", 99 * MS + 5000, 1000),
        ("prefill", 150 * MS, MS), ("Memcpy HtoD", 200 * MS + 20000, 100),
        ("kernel", 230 * MS, 100)])
    inst = types.SimpleNamespace(
        program=m, span=span,
        chunks=[{"id": 0, "window": True}, {"id": 1, "window": True}],
        prefills=[{"lens": [30, 10], "window": True},
                  {"lens": [9], "window": False}],
        decode_ms=lambda ids: 22.0 * len(ids) / 2)
    run = _run(m)
    run.inst, run.reqs = inst, [req]
    lines = ET.cross_checks(run, m)
    assert "slot_occupancy harness 75.0 program 75.0" in lines[0]
    assert lines[0].endswith("equal")
    assert "+0.000%" in lines[1]
    assert lines[2] == "prefill tokens harness 40 program 40; equal"
    res = ET.clock_residuals(span.records, spans, m.marker_ns, 0, 10**12)
    assert res == {"marker_ns": 5000, "dispatch_ns": [20000],
                   "stage_ns": [15000], "replay_ns": [29_970_000],
                   "replay_host_ns": [28_970_000],
                   "replay_host_other_ns": [2 * MS], "busy_at_launch": 0}
