"""The traced run: spans, counts and a device trace of a fixed sub-span.

Everything here is recorded from the benchmark's own files, around the
engine's calls into each layer (no span inside the program):

- each decode chunk's dispatch (``DecodeEngine._dispatch``): its number,
  whether it ran inside the window and the profiled sub-span, and CUDA
  events on the caller's stream around the replay;
- the chunk whose tokens are being collected (``_collect_chunk``, which
  collects chunks in dispatch order), so every token knows its chunk;
- each admission prefill (``_admit_group``, ``_admit_one``): its rows,
  padded length and true prompt lengths, on the host's clock between two
  synchronizations;
- host phases (admission and prefill, dispatch, the wait and collection of
  a chunk, the first tokens' read) while the profiler runs, to name what
  the host did during the device's idle gaps;
- the launch counters of ``tpu_bitsandbytes_torch.ops._build.COUNTERS``
  (which a graph replay advances) at the sub-span's two ends;
- ``torch.profiler`` (CUDA activity only) over a fixed sub-span of the
  window: from the first admission point ``start_s`` or more after the
  window opens to the first admission point ``seconds`` or more after
  that, so it holds whole cycles of admission prefill and decode chunks;
  both ends synchronize, so every device record in it belongs to work
  launched inside it. The records are read raw (the smoke script's ``device_ops``
  way; building the profiler's event tree took 8-23 s per chunk there).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import torch

Record = Tuple[str, int, int]           # (name, start ns, duration ns)


def counters() -> Dict[str, int]:
    """Each kernel wrapper's count, as ``<function>.<attribute>``."""
    from tpu_bitsandbytes_torch.ops import _build
    return {f"{f.__name__}.{a}": getattr(f, a) for f, a in _build.COUNTERS}


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals, sorted and disjoint."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(records: List[Record]) -> int:
    """Nanoseconds in which some device record ran."""
    return sum(e - s for s, e in merge([(s, s + d) for _, s, d in records]))


def gaps(records: List[Record], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle intervals of [lo, hi) between the records' union."""
    out, t = [], lo
    for s, e in merge([(s, s + d) for _, s, d in records]):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def top_ops(records: List[Record], n: int = 10) -> List[list]:
    """The ``n`` device operations (by name) that took most time:
    [[name, seconds], ...]."""
    tot: Dict[str, int] = {}
    for name, _, d in records:
        tot[name] = tot.get(name, 0) + d
    return [[name[:160], ns / 1e9] for name, ns in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def named_gaps(idle: List[Tuple[int, int]], host: List[Tuple[str, int, int]],
               offset_ns: int, n: int = 10) -> List[list]:
    """The ``n`` longest idle gaps, each named by the host phase that
    covered its middle (device time minus ``offset_ns`` is host time):
    [[phase, seconds], ...]."""
    out = []
    for s, e in sorted(idle, key=lambda g: g[0] - g[1])[:n]:
        mid = (s + e) // 2 - offset_ns
        name = next((p for p, a, b in host if a <= mid < b), "host other")
        out.append([name, (e - s) / 1e9])
    return out


@dataclasses.dataclass
class Span:
    t_start: float = 0.0
    t_stop: float = 0.0
    start_ns: int = 0
    counters_before: Dict[str, int] = dataclasses.field(default_factory=dict)
    counters_after: Dict[str, int] = dataclasses.field(default_factory=dict)
    records: List[Record] = dataclasses.field(default_factory=list)
    offset_ns: int = 0          # device clock minus host clock

    @property
    def seconds(self) -> float:
        return self.t_stop - self.t_start

    def launches(self, counter: str) -> int:
        return (self.counters_after.get(counter, 0)
                - self.counters_before.get(counter, 0))


class Instrument:
    """The traced run's wrappers over one engine and its :class:`Loop`."""

    def __init__(self, loop, start_s: float, seconds: float):
        self.loop, self.engine = loop, loop.engine
        self.start_s, self.span_s = start_s, seconds
        self.chunks: List[dict] = []
        self.prefills: List[dict] = []
        self.host: List[Tuple[str, int, int]] = []
        self.span = Span()
        self.state = "before"          # "before", "on", "done"
        self._prof = None
        self._collected = 0
        eng = self.engine
        self._marker = torch.zeros((1,), device=eng.device)
        for name in ("_dispatch", "_collect_chunk", "_admit_group",
                     "_admit_one", "_host_inputs", "_collect_host"):
            setattr(eng, name, getattr(self, name[1:])(getattr(eng, name)))
        loop.keep_chunks = True
        loop.hooks.append(lambda lp, now: self.at_point(now))

    # -- the sub-span ------------------------------------------------------
    def in_window(self) -> bool:
        return self.loop.t_open is not None and self.loop.t_close is None

    def at_point(self, now: float) -> None:
        t_open = self.loop.t_open
        if (self.state == "before" and t_open is not None
                and now >= t_open + self.start_s):
            self.start()
        elif self.state == "on" and now >= self.span.t_start + self.span_s:
            self.stop()

    def start(self) -> None:
        torch.cuda.synchronize()
        self.span.counters_before = counters()
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.start()
        self.span.t_start = time.perf_counter()
        self.span.start_ns = time.perf_counter_ns()
        self._marker.add_(1.0)          # the sub-span's first device record
        self.state = "on"

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.span.t_stop = time.perf_counter()
        self.span.counters_after = counters()
        self._prof.stop()
        self.state = "done"

    def read_trace(self) -> None:
        """The sub-span's raw device records, after the run."""
        from torch.autograd import DeviceType
        if self._prof is None:
            return
        if self.state == "on":
            self.stop()
        recs = [(e.name(), e.start_ns(), e.duration_ns())
                for e in self._prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA
                and not e.is_user_annotation()]
        recs.sort(key=lambda r: r[1])
        self.span.records = recs
        if recs:
            self.span.offset_ns = recs[0][1] - self.span.start_ns
        self._prof = None

    # -- wrappers ----------------------------------------------------------
    def _phase(self, name: str, fn):
        def run(*a, **kw):
            if self.state != "on":
                return fn(*a, **kw)
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **kw)
            finally:
                self.host.append((name, t0, time.perf_counter_ns()))
        return run

    def dispatch(self, fn):
        def run(**kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(**kw)
            e1.record()
            self.chunks.append({"id": len(self.chunks),
                                "window": self.in_window(),
                                "span": self.state == "on",
                                "events": (e0, e1)})
            return out
        return self._phase("host dispatch", run)

    def collect_chunk(self, fn):
        def run(*a, **kw):
            self.loop.cur_chunk = self._collected
            self._collected += 1
            try:
                return fn(*a, **kw)
            finally:
                self.loop.cur_chunk = None
        return run

    def _prefill(self, fn, rows_of):
        def run(*a, **kw):
            from tpu_bitsandbytes_torch.engine.engine import _bucket
            reqs = rows_of(*a)
            torch.cuda.synchronize()
            before = counters()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = counters()
            lens = [len(r.prompt) for r in reqs]
            self.prefills.append({
                "lens": lens, "ms": ms, "window": self.in_window(),
                "launches": {k: after[k] - before[k] for k in after
                             if after[k] != before[k]},
                "span": self.state == "on",
                "s_pad": _bucket(max(lens), self.engine.max_seq),
                "r_pad": 1 << (len(lens) - 1).bit_length()})
            return out
        return self._phase("host prefill", run)

    def admit_group(self, fn):
        return self._prefill(fn, lambda s_pad, grp: [r for _, r in grp])

    def admit_one(self, fn):
        return self._prefill(fn, lambda slot, req: [req])

    def host_inputs(self, fn):
        return self._phase("host first tokens", fn)

    def collect_host(self, fn):
        return self._phase("host wait and collect", fn)

    # -- after the run -------------------------------------------------------
    def decode_ms(self, chunk_ids) -> float:
        """Device ms of the given chunks, by their CUDA events."""
        return sum(self.chunks[i]["events"][0].elapsed_time(
            self.chunks[i]["events"][1]) for i in chunk_ids)

    def breakdown(self) -> dict:
        sp = self.span
        lo = sp.start_ns + sp.offset_ns
        hi = lo + int(sp.seconds * 1e9)
        return {"device_ops": top_ops(sp.records),
                "idle_gaps": named_gaps(gaps(sp.records, lo, hi), self.host,
                                        sp.offset_ns)}

