"""The serving engine's tracer (spans and counters), the device-memory
footprint of a served model (the JAX package's ``utils/metrics.py``,
budgeted against the device's own memory), the bytes of a 4-bit matmul
and its least time at a given bandwidth, a wall-clock timer and profiler
regions. The JAX package's table of TPU datasheet numbers has no
counterpart: the caller passes the card's bandwidth."""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import torch


# -- the serving engine's tracer ---------------------------------------------

def now_ns() -> int:
    """The tracer's clock: nanoseconds since the Unix epoch, the clock on
    which ``torch.profiler`` reports its records (it converts CUPTI's device
    times to it), so a span and the kernels it launched line up with no
    offset to estimate."""
    return time.time_ns()


@dataclasses.dataclass
class Span:
    """One interval of the engine's work on the tracer's clock. ``parent``
    is the index of the enclosing span in :attr:`Tracer.spans` (-1 at the
    top); ``device_ms`` is the device time of the work launched inside it,
    for a span opened with ``device=True`` on a CUDA device, resolved by
    :meth:`Tracer.stop`."""

    name: str
    start_ns: int
    parent: int = -1
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    end_ns: int = 0
    device_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)


_OFF = contextlib.nullcontext()


class Tracer:
    """Spans and counters of a serving engine (``DecodeEngine.tracer``).

    Counters (:attr:`counts`, by name) are host integers and always on;
    the engine advances them once per admission, group, chunk or
    collection, never once per token. Spans are kept in memory between
    :meth:`start` and :meth:`stop` only; while the tracer is off,
    :meth:`span` checks one attribute and keeps nothing."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.on = False
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = collections.Counter()
        self._open: List[int] = []         # indices of the open spans

    now = staticmethod(now_ns)

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] += n

    def start(self) -> None:
        """Keep spans from here on (those of an earlier recording go)."""
        self.spans, self._open, self.on = [], [], True

    def stop(self) -> None:
        """Stop keeping spans, and resolve the device time of those that
        recorded CUDA events: one synchronization."""
        if self.on and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.on = False
        for sp in self.spans:
            if sp.events is not None and sp.end_ns:
                sp.device_ms = sp.events[0].elapsed_time(sp.events[1])
                sp.events = None

    def span(self, name: str, device: bool = False, **attrs):
        """A context manager over a block of the engine's work, yielding its
        :class:`Span` (None while the tracer is off). ``device``: also time
        the work the block launches, by a pair of CUDA events on the current
        stream."""
        if not self.on:
            return _OFF
        return self._record(name, device, attrs)

    def note(self, name: str, **attrs) -> None:
        """Add ``attrs`` to the innermost open span of ``name`` (nothing
        while the tracer is off, or where no such span is open): how a
        method tells the span its caller opened what it did."""
        if not self.on:
            return
        for i in reversed(self._open):
            if self.spans[i].name == name:
                self.spans[i].attrs.update(attrs)
                return

    @contextlib.contextmanager
    def _record(self, name: str, device: bool, attrs: dict):
        events = None
        if device and self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        # read after the events are made and recorded, so that the span
        # starts with its block's work, not the tracer's
        sp = Span(name, self.now(), self._open[-1] if self._open else -1,
                  attrs, events=events)
        self._open.append(len(self.spans))
        self.spans.append(sp)
        try:
            yield sp
        finally:
            if events is not None:
                events[1].record()
            sp.end_ns = self.now()
            if self._open and self.spans[self._open[-1]] is sp:
                self._open.pop()


# -- device-memory budget accounting (the JAX package's utils/metrics.py) --

def device_memory_bytes(device) -> int:
    """The memory a footprint is budgeted against: a CUDA device's total
    memory, or the host's RAM for a CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def param_footprint(params, runtime_cache: Optional[str] = None,
                    drop_packed: bool = False) -> Dict[str, int]:
    """Bytes by category of a (quantized) parameter tree.

    ``runtime_cache`` ("int8", "int4" or "bf16"): count a hypothetical
    execution cache for :class:`QLinear4` leaves that carry none yet, as
    the JAX package counts it (1, 0.5 or 2 bytes per weight, plus 4 bytes
    per row, or per (row, 128-block) for int4); the engine decides
    ``drop_packed`` and "auto" its format from this before it builds the
    cache (building it and then dropping the codes would hold both at
    once). ``drop_packed``: count no packed bytes for a leaf with a (real
    or hypothetical) cache, as if the codes were freed.

    Returns {"packed": NF4 codes + absmax, "exec_cache": the runtime cache,
    "fp": everything else}.
    """
    if runtime_cache not in (None, "int8", "int4", "bf16"):
        raise ValueError(f"unknown runtime cache format: {runtime_cache!r}")
    from ..models.layers import QLinear4
    from ..ops.int4cache import INT4_BLOCK
    out = {"packed": 0, "exec_cache": 0, "fp": 0}

    def visit(w):
        if isinstance(w, QLinear4):
            pk = (_nbytes(w.packed) + _nbytes(w.absmax)
                  + _nbytes(w.absmax_q))
            if w.absmax_state is not None:
                pk += _nbytes(w.absmax_state.absmax)
            ex = _nbytes(w.w_cache) + _nbytes(w.cache_scale)
            if ex == 0 and runtime_cache is not None:
                n, k = w.shape
                per = {"int8": 1, "bf16": 2, "int4": 0.5}[runtime_cache]
                sc = (k // INT4_BLOCK) * 4 if runtime_cache == "int4" else 4
                ex = int(n * k * per) + n * sc
            if drop_packed and ex:
                pk = 0
            out["packed"] += pk
            out["exec_cache"] += ex
            out["fp"] += _nbytes(w.bias)
        elif isinstance(w, dict):
            for v in w.values():
                visit(v)
        elif isinstance(w, (list, tuple)):
            for v in w:
                visit(v)
        elif isinstance(w, torch.Tensor):
            out["fp"] += _nbytes(w)

    visit(params)
    return out


def per_device_footprint(pf: Dict[str, int], kv_bytes: int,
                         act_bytes: int, budget: int, tp: int = 1,
                         dp: int = 1) -> Dict[str, Any]:
    """One device's share of a (dp, tp)-sharded serving deployment, the
    JAX package's per-chip table: ``pf`` (:func:`param_footprint` of the
    whole tree) with the weights split over tp (the fp leaves whole on
    every device), ``kv_bytes`` (the whole KV cache) split over tp * dp,
    the activation estimate; their ``total``, the ``budget`` and ``fits``
    (total within 0.92 of it)."""
    out = {"packed": pf["packed"] // tp, "exec_cache": pf["exec_cache"] // tp,
           "fp": pf["fp"], "kv": kv_bytes // (tp * dp),
           "activations_est": act_bytes}
    out["total"] = sum(out.values())
    out["budget"] = budget
    out["fits"] = out["total"] <= 0.92 * budget
    return out


def kv_cache_bytes(num_layers: int, batch: int, s_axis: int, kv_heads: int,
                   head_dim: int, quantized: bool = True,
                   dtype_bytes: int = 2) -> int:
    """Bytes of a KV cache allocation (codes and scales when quantized)."""
    per = 2 * num_layers * batch * kv_heads * s_axis
    if quantized:
        return per * head_dim + per * 4
    return per * head_dim * dtype_bytes


def serving_act_bytes(config, max_batch: int, prefill_bucket: int,
                      steps_per_sync: int = 8) -> int:
    """The JAX package's rough bound on serving's transient memory: a
    prefill at ``prefill_bucket`` keeps a few S x max(4H, 2I) planes live,
    decode keeps B x (H + V) hidden and logits plus the chunk's KV stage.
    An estimate, not a measurement."""
    h, i, v = (config.hidden_size, config.intermediate_size,
               config.vocab_size)
    act = 2  # bf16 planes
    prefill = prefill_bucket * max(4 * h, 2 * i) * act * 2
    stage = (2 * config.num_layers * max_batch * config.num_kv_heads
             * steps_per_sync * (config.hd + 4))
    decode = max_batch * (h * act + v * 4) + stage
    return int(max(prefill, decode))


def format_footprint(fp: Dict[str, Any]) -> str:
    """A footprint table (``DecodeEngine.footprint()``) as text."""
    gib = 1024 ** 3
    lines = ["Device memory footprint:"]
    for key in ("packed", "exec_cache", "fp", "kv", "activations_est"):
        if key in fp:
            lines.append(f"  {key:<16} {fp[key] / gib:8.3f} GiB")
    lines.append(f"  {'total':<16} {fp['total'] / gib:8.3f} GiB"
                 f" / {fp['budget'] / gib:.1f} GiB"
                 f" ({'fits' if fp['fits'] else 'OVER BUDGET'})")
    return "\n".join(lines)


# -- roofline, timing and profiler regions ---------------------------------

def detect_chip() -> str:
    """The current CUDA device's name (``torch.cuda.get_device_name``), or
    "cpu" without one."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return "cpu"


def matmul4bit_bytes(n: int, k: int, m: int = 1, blocksize: int = 64,
                     absmax_bytes: int = 4, act_bytes: int = 2) -> int:
    """Device-memory bytes of one fused 4-bit matmul: the packed codes,
    the absmax, x [M, K] and y [M, N]."""
    return int(n * k / 2 + n * (k / blocksize) * absmax_bytes
               + m * k * act_bytes + m * n * act_bytes)


def matmul4bit_roofline_us(n: int, k: int, m: int = 1, blocksize: int = 64,
                           *, bw_bytes_per_s: float) -> float:
    """The least time of that matmul at ``bw_bytes_per_s`` (the caller's
    measured or published bandwidth; no default), in microseconds."""
    return matmul4bit_bytes(n, k, m, blocksize) / bw_bytes_per_s * 1e6


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(name: str, log_dir: Optional[str] = None):
    """A named region in ``torch.profiler`` traces
    (``record_function``); with ``log_dir``, also profiles the region (the
    CPU, and CUDA when a card is present) and writes its Chrome trace to
    ``log_dir/<name>.json``."""
    if log_dir is None:
        with torch.profiler.record_function(name):
            yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(name):
            yield
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


class Timer:
    """Wall-clock seconds of a ``with`` block (``elapsed``); the CUDA
    device is synchronized on exit, so queued kernels count."""

    def __enter__(self):
        _sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.elapsed = time.perf_counter() - self.t0
        return False

    @staticmethod
    def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
        """Mean seconds of ``fn(*args)`` over ``iters`` calls after
        ``warmup`` calls, synchronized before and after."""
        for _ in range(warmup):
            fn(*args)
        _sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _sync()
        return (time.perf_counter() - t0) / iters
