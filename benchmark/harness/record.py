"""What one run saw, as the metric readers (``benchmark/metrics``) read it.

A reader is ``read(run) -> number or None``; None means it found nothing
to read, and the harness leaves the metric out of the result line.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Set, Tuple

from .accounting import Req, Window


@dataclasses.dataclass
class Run:
    cell: str
    cfg: dict                    # the configuration file, normalized
    engine: dict                 # the cell's engine settings
    window: Window
    reqs: List[Req]
    setup_s: float
    capture_s: float             # graph capture seconds during set-up
    memory_peak: int             # torch.cuda.max_memory_allocated()
    device_kind: str
    inst: Optional[object] = None    # harness.trace.Instrument (traced)

    # -- the traced run's bookkeeping ---------------------------------------
    def chunk_ids(self, where: str) -> Set[int]:
        """Decode chunks dispatched inside ``where`` ("window" or
        "span")."""
        return {c["id"] for c in self.inst.chunks if c[where]}

    def prefills(self, where: str) -> List[dict]:
        return [p for p in self.inst.prefills if p[where]]

    def decode_tokens(self, chunks: Set[int]) -> Iterator[Tuple[Req, int]]:
        """(request, i) of every token i >= 1 (a decode step's output: its
        input token i - 1 sat at position ``len(prompt) + i - 1``) that a
        chunk of ``chunks`` produced."""
        for r in self.reqs:
            for i, c in enumerate(r.chunks):
                if c is not None and c in chunks:
                    yield r, i

    def keys(self, r: Req, i: int) -> int:
        """Keys token i's decode step attends to: every position up to its
        input's, inside the configuration's sliding window."""
        n = len(r.prompt) + i
        w = self.cfg.get("sliding_window")
        return n if w is None else min(n, w)

    @property
    def span(self):
        return self.inst.span

    def decode_launches(self, counter: str) -> int:
        """Launches of ``counter`` in the profiled sub-span outside its
        prefills."""
        pre = sum(p["launches"].get(counter, 0) for p in self.prefills("span"))
        return self.span.launches(counter) - pre
