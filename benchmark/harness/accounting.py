"""Requests as the clients see them, and the window's end-to-end numbers.

Every time is the host's clock (``time.perf_counter``) at the moment the
client sees the event: a request's submission, and each token's callback
(``on_token``) when the engine collects it. The window is ``[open,
close)``; both ends are admission points of the engine (see
:mod:`harness.serve`), so it holds whole admission cycles.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Req:
    client: int
    round: int
    prompt: List[int]
    n_out: int
    t_submit: float
    uid: int = 0
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    # the decode chunk each token came from (None: the prefill's first
    # token); kept in traced runs only
    chunks: List[Optional[int]] = dataclasses.field(default_factory=list)
    t_done: Optional[float] = None
    cancelled: bool = False
    greedy: bool = True          # sampled greedily (the check reads these)


@dataclasses.dataclass
class Window:
    open: float
    close: float

    @property
    def seconds(self) -> float:
        return self.close - self.open

    def holds(self, t: float) -> bool:
        return self.open <= t < self.close


def p95(values: List[float]) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def output_tokens_per_s(reqs: List[Req], win: Window) -> float:
    """Every token collected inside the window, over its seconds."""
    n = sum(1 for r in reqs for t in r.times if win.holds(t))
    return n / win.seconds


def ttft_ms(reqs: List[Req], win: Window) -> List[float]:
    """Submission to first token of every request submitted inside the
    window; one with no first token by the close counts its wait to the
    close."""
    out = []
    for r in reqs:
        if not win.holds(r.t_submit):
            continue
        first = r.times[0] if r.times and r.times[0] < win.close else win.close
        out.append((first - r.t_submit) * 1e3)
    return out


def tpot_ms(reqs: List[Req], win: Window) -> List[float]:
    """(last token - first token) / (tokens - 1) of every request that
    finished inside the window."""
    return [(r.times[-1] - r.times[0]) / (len(r.times) - 1) * 1e3
            for r in reqs
            if r.t_done is not None and win.holds(r.t_done)
            and len(r.times) > 1]


def attempted(reqs: List[Req], win: Window) -> List[Req]:
    """The requests submitted inside the window."""
    return [r for r in reqs if win.holds(r.t_submit)]


def failed(reqs: List[Req], win: Window) -> List[Req]:
    """Requests submitted inside the window that finished without
    delivering exactly their output length. Those still in flight at the
    close are cut by the window (the harness cancels them), not failed."""
    return [r for r in attempted(reqs, win)
            if r.t_done is not None and len(r.tokens) != r.n_out]
