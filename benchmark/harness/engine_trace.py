"""The program's own trace in the traced run: ``DecodeEngine.tracer``'s
spans and counters over the window, on the tracer's clock (Unix-epoch
nanoseconds, the clock of ``torch.profiler``'s device records).

:mod:`harness.trace` records the traced run from outside the program.
:func:`install`, which each reader of the program's metrics calls when it
is loaded, extends its :class:`~harness.trace.Instrument` so that a traced
run also (every cell lists such a metric, so every traced run does):

- starts the engine's tracer as soon as the instrument is built, after the
  warm-up and before the loop's first admission, so that the window's
  first admission is recorded whole;
- marks the window's open and close on the tracer's clock, with the
  counters there and every request's submission, admission and first
  token times, by a hook at the loop's admission points;
- notes the profiler marker's launch on the tracer's clock, and the
  intervals in which the harness starts and stops its profiler: they lie
  inside admission points (seconds each, before the engine admits), so
  the readers take them out of the window, the admissions and the waits;
- names the breakdown's idle gaps by the innermost program span that
  covers each gap's middle, on the shared clock with no offset; where none
  does, by the harness's host phase, else "host other".

An engine without a tracer (a commit from before it) is left as it was: the
readers find nothing and the breakdown keeps the harness's names. The first
:func:`of` of a run logs the cross-checks against the harness's own
readings and the clock's residuals to standard error.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

from . import trace

TOP_DISPATCH = "engine.dispatch"
CLOCK_LIMIT_NS = 200_000        # a launch's first device record, at most


@dataclasses.dataclass
class Marks:
    """The program's record of one traced run."""
    tracer: object
    open_ns: Optional[int] = None
    close_ns: Optional[int] = None
    open_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    close_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # (t_submit, t_admit) of every request the engine held at the close
    requests: List[Tuple[Optional[int], Optional[int]]] = dataclasses.field(
        default_factory=list)
    # (t_admit, t_first) of the same requests
    firsts: List[Tuple[Optional[int], Optional[int]]] = dataclasses.field(
        default_factory=list)
    marker_ns: Optional[int] = None     # the profiler marker's launch
    # the harness's profiler starting or stopping: (start, end)
    pauses: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    checked: bool = False

    def paused_ns(self, a: int, b: int) -> int:
        """Nanoseconds of [a, b) in which the harness's profiler started
        or stopped."""
        return sum(max(0, min(b, e) - max(a, s)) for s, e in self.pauses)

    @property
    def window_ns(self) -> int:
        """The window's length less the profiler's pauses in it."""
        return (self.close_ns - self.open_ns
                - self.paused_ns(self.open_ns, self.close_ns))

    def wait_ns(self, a: int, b: int) -> int:
        """The time from ``a`` to ``b`` (a request's submission to its
        admission, its admission to its first token) less the profiler's
        pauses."""
        return b - a - self.paused_ns(a, b)

    def holds(self, t: int) -> bool:
        return self.open_ns <= t < self.close_ns

    def delta(self, counter: str) -> int:
        """The counter's advance over the window."""
        return (self.close_counts.get(counter, 0)
                - self.open_counts.get(counter, 0))

    def spans(self, name: str, top: bool = False) -> list:
        """The spans of ``name`` that start inside the window (``top``:
        those at the top of the tree, opened by the serving loop)."""
        return [s for s in self.tracer.spans if s.name == name
                and self.holds(s.start_ns) and (not top or s.parent < 0)]

    def inside_ns(self, name: str) -> int:
        """Nanoseconds of the window inside the spans of ``name`` at the
        top of the tree (which never overlap), each clipped to it, less the
        profiler's pauses."""
        out = 0
        for s in self.tracer.spans:
            if s.name == name and s.parent < 0:
                a, b = max(s.start_ns, self.open_ns), min(s.end_ns,
                                                          self.close_ns)
                if b > a:
                    out += b - a - self.paused_ns(a, b)
        return out


def of(run) -> Optional[Marks]:
    """The program's record of ``run`` once its window has closed, with the
    tracer stopped (its spans' device times resolved); None where the
    program has no tracer or the run was not traced."""
    m = getattr(run.inst, "program", None) if run.inst is not None else None
    if m is None or m.close_ns is None:
        return None
    if m.tracer.on:
        m.tracer.stop()
    if not m.checked:
        m.checked = True
        for line in cross_checks(run, m):
            print(f"engine trace: {line}", file=sys.stderr, flush=True)
    return m


# -- the instrument's extension ---------------------------------------------

def _at_point(marks: Marks, loop) -> None:
    tr = marks.tracer
    if marks.open_ns is None and loop.t_open is not None:
        marks.open_ns = tr.now()
        marks.open_counts = dict(tr.counts)
    elif (marks.close_ns is None and marks.open_ns is not None
          and loop.t_close is not None):
        marks.close_ns = tr.now()
        marks.close_counts = dict(tr.counts)
        eng = loop.engine
        reqs = (list(eng.finished) + list(eng.active.values())
                + list(eng.waiting))
        marks.requests = [(r.t_submit, r.t_admit) for r in reqs]
        marks.firsts = [(r.t_admit, r.t_first) for r in reqs]


def install() -> None:
    """Extend :class:`~harness.trace.Instrument` (once) as the module's
    docstring says."""
    inst = trace.Instrument
    if getattr(inst, "program_trace", False):
        return
    init, start, stop = inst.__init__, inst.start, inst.stop
    breakdown = inst.breakdown

    def paused(fn):
        def run(self):
            m = self.program
            t0 = None if m is None else m.tracer.now()
            fn(self)
            if m is not None:
                m.pauses.append((t0, m.tracer.now()))
        return run

    def __init__(self, loop, *a, **kw):
        init(self, loop, *a, **kw)
        tracer = getattr(self.engine, "tracer", None)
        self.program = None if tracer is None else Marks(tracer)
        if self.program is not None:
            tracer.start()
            loop.hooks.append(lambda lp, now: _at_point(self.program, lp))

    def start_profile(self):
        paused(start)(self)
        if self.program is not None:
            # the marker was launched right after span.start_ns was read
            # (time.perf_counter_ns); the two clocks read back to back
            self.program.marker_ns = self.span.start_ns + (
                self.program.tracer.now() - time.perf_counter_ns())

    def named_breakdown(self):
        out = breakdown(self)
        m = self.program
        if m is None or not m.tracer.spans:
            return out
        if m.tracer.on:
            m.tracer.stop()
        sp = self.span
        lo = sp.start_ns + sp.offset_ns
        out["idle_gaps"] = named_gaps(
            trace.gaps(sp.records, lo, lo + int(sp.seconds * 1e9)),
            m.tracer.spans, self.host, sp.offset_ns)
        named = sum(s for name, s in out["idle_gaps"]
                    if not name.startswith("host"))
        total = sum(s for _, s in out["idle_gaps"])
        if total:
            print(f"engine trace: {100 * named / total:.2f}% of the 10 "
                  "longest idle gaps' time named by program spans",
                  file=sys.stderr, flush=True)
        return out

    inst.__init__ = __init__
    inst.start = start_profile
    inst.stop = paused(stop)
    inst.breakdown = named_breakdown
    inst.program_trace = True


# -- naming and checks -----------------------------------------------------

def innermost(spans: list, t: int) -> Optional[str]:
    """The name of the deepest span that holds ``t``, or None."""
    best, depth = None, -1
    for i, s in enumerate(spans):
        if s.start_ns <= t < s.end_ns:
            d, p = 0, s.parent
            while p >= 0:
                d, p = d + 1, spans[p].parent
            if d > depth:
                best, depth = s.name, d
    return best


def named_gaps(idle: List[Tuple[int, int]], spans: list,
               host: List[Tuple[str, int, int]], offset_ns: int,
               n: int = 10) -> List[list]:
    """The ``n`` longest idle gaps (profiler clock), each named by the
    innermost program span that covers its middle on the same clock; where
    none does, by the harness's host phase (``trace.named_gaps``, host
    clock = profiler clock minus ``offset_ns``), else "host other"."""
    out = []
    for s, e in sorted(idle, key=lambda g: g[0] - g[1])[:n]:
        name = innermost(spans, (s + e) // 2)
        if name is None:
            name = trace.named_gaps([(s, e)], host, offset_ns)[0][0]
        out.append([name, (e - s) / 1e9])
    return out


def _first_dispatches(spans: list) -> list:
    """The dispatch spans that open a burst: the top-level dispatch right
    after an admission, launched on a device the admission's first tokens
    waited for."""
    top = [s for s in spans if s.parent < 0]
    return [b for a, b in zip(top, top[1:])
            if a.name == "engine.admission" and b.name == TOP_DISPATCH]


def clock_residuals(records: list, spans: list, marker_ns: Optional[int],
                    lo: int, hi: int) -> dict:
    """How the profiler's device records sit against the program's spans
    on the shared clock, over the profiled sub-span [lo, hi): the marker's
    first record after its launch, and for every burst's first dispatch
    the first device record after the span's start (its staging copy or
    its replay), with the device's last work before it (which must have
    ended, since the host had waited for the prefill); the first device
    record after its staging's start and the first kernel after its
    replay's start (the graph's launch on the host lies between); and the
    host's time in its replay call (``graph.replay``'s span, which holds
    the launch) against that of every other dispatch's replay. ns."""
    out = {"marker_ns": None, "dispatch_ns": [], "stage_ns": [],
           "replay_ns": [], "replay_host_ns": [], "replay_host_other_ns": [],
           "busy_at_launch": 0}
    recs = sorted((s, s + d) for _, s, d in records)
    kernels = sorted((s, s + d) for n, s, d in records
                     if not n.startswith(("Memcpy", "Memset")))
    if marker_ns is not None and recs:
        out["marker_ns"] = recs[0][0] - marker_ns
    first = _first_dispatches(spans)
    opening = {id(sp) for sp in first}
    for sp in spans:
        if (sp.name == "graph.replay" and sp.parent >= 0
                and id(spans[sp.parent]) not in opening
                and lo <= sp.start_ns < hi):
            out["replay_host_other_ns"].append(sp.end_ns - sp.start_ns)
    for sp in first:
        t = sp.start_ns
        if not lo <= t < hi:
            continue
        before = [e for s, e in recs if s < t]
        after = [s for s, _ in recs if s >= t]
        if before and max(before) > t:
            out["busy_at_launch"] += 1
        if after:
            out["dispatch_ns"].append(after[0] - t)
        for name, key, pool in (("engine.stage", "stage_ns", recs),
                                 ("graph.replay", "replay_ns", kernels)):
            kid = [x for x in spans if x.name == name
                   and sp.start_ns <= x.start_ns < sp.end_ns]
            after_kid = [s for s, _ in pool if kid and s >= kid[0].start_ns]
            if after_kid:
                out[key].append(after_kid[0] - kid[0].start_ns)
            if kid and name == "graph.replay":
                out["replay_host_ns"].append(kid[0].end_ns - kid[0].start_ns)
    return out


def shape(m: Marks) -> List[str]:
    """The window's admission cycles as the spans show them: queue waits,
    admissions (the profiler's pauses apart), the chunks of each burst and
    why each burst ended."""
    waits = sorted(m.wait_ns(s, a) / 1e6 for s, a in m.requests
                   if s is not None and a is not None and m.holds(a))
    q = [waits[min(len(waits) - 1, int(f * len(waits)))]
         for f in (0.1, 0.5, 0.9, 1.0)] if waits else []
    adm = m.spans("engine.admission", top=True)
    bursts, n = [], 0
    for x in m.tracer.spans:
        if x.parent < 0 and m.holds(x.start_ns):
            if x.name == "engine.dispatch":
                n += 1
            elif x.name == "engine.admission" and n:
                bursts, n = bursts + [n], 0
    reasons = collections.Counter(x.attrs.get("reason") for x in
                                  m.spans("engine.drain", top=True))
    return [
        f"queue wait ms over {len(waits)} requests: p10, p50, p90, max {q}",
        "admissions ms "
        f"{[round((x.end_ns - x.start_ns) / 1e6) for x in adm]} (the "
        "profiler's pauses ms "
        f"{[round((e - s) / 1e6) for s, e in m.pauses]}), admitted "
        f"{[len(x.attrs.get('uids', ())) for x in adm]}",
        f"chunks per burst {bursts}; bursts ended by {dict(reasons)}"]


def cross_checks(run, m: Marks) -> List[str]:
    """The program's counters and spans against the harness's own readings
    over the window, and the shared clock's residuals."""
    lines = []
    inst = run.inst
    steps = run.engine["steps_per_sync"]
    chunks = run.chunk_ids("window")
    if chunks:
        harness_tokens = sum(1 for _ in run.decode_tokens(chunks))
        occ = 100.0 * harness_tokens / (len(chunks) * steps
                                        * run.engine["max_batch"])
        n_chunks = m.delta("engine.chunks")
        tokens = m.delta("engine.decode_tokens")
        mine = 100.0 * tokens / (n_chunks * steps * run.engine["max_batch"])
        lines.append(f"slot_occupancy harness {occ!r} program {mine!r} "
                     f"(chunks {len(chunks)} / {n_chunks}, decode tokens "
                     f"{harness_tokens} / {tokens}); "
                     f"{'equal' if occ == mine else 'DIFFERENT'}")
        dev = [s.device_ms for s in m.spans(TOP_DISPATCH, top=True)]
        if dev and all(d is not None for d in dev):
            ref = inst.decode_ms(sorted(chunks))
            lines.append(
                f"dispatch spans' device ms {sum(dev)!r} against the "
                f"harness's chunk events {ref!r} ({len(dev)} / "
                f"{len(chunks)} chunks): {100 * (sum(dev) / ref - 1):+.3f}%")
    true = sum(sum(p["lens"]) for p in run.prefills("window"))
    mine = m.delta("prefill.tokens")
    lines.append(f"prefill tokens harness {true} program {mine}; "
                 f"{'equal' if true == mine else 'DIFFERENT'}")
    lines += shape(m)
    sp = run.span
    if sp.records:
        lo = min(s for _, s, _ in sp.records)
        hi = lo + int(sp.seconds * 1e9)
        res = clock_residuals(sp.records, m.tracer.spans, m.marker_ns, lo, hi)
        d, o = res["dispatch_ns"], res["replay_host_other_ns"]
        lines.append(
            f"clock: marker's first record {res['marker_ns']} ns after its "
            f"launch; burst-first dispatches {len(d)}, first record after "
            f"the span's start median {statistics.median(d) if d else None} "
            f"ns, max {max(d) if d else None} ns, min {min(d) if d else None}"
            f" ns ({sum(1 for x in d if not 0 <= x <= CLOCK_LIMIT_NS)} "
            f"outside [0, {CLOCK_LIMIT_NS}]), after its staging's start "
            f"{res['stage_ns']} ns, first kernel after its replay's start "
            f"{res['replay_ns']} ns, the host in that replay's call "
            f"{res['replay_host_ns']} ns (other dispatches' replays: median "
            f"{statistics.median(o) if o else None} ns, max "
            f"{max(o) if o else None} ns); device busy at "
            f"{res['busy_at_launch']} such launches")
    return lines
