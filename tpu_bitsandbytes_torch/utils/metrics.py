"""Rolling per-step engine metrics."""

from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class StepMetrics:
    step: int
    tokens: int
    wall_s: float
    tokens_per_s: float


class MetricsLogger:
    """Tokens and wall time of the last ``window`` engine steps."""

    def __init__(self, window: int = 100):
        self.window = window
        self.history: List[StepMetrics] = []
        self._step = 0

    def record(self, tokens: int, wall_s: float) -> StepMetrics:
        self._step += 1
        m = StepMetrics(self._step, tokens, wall_s,
                        tokens / wall_s if wall_s > 0 else 0.0)
        self.history.append(m)
        if len(self.history) > self.window:
            self.history.pop(0)
        return m

    def summary(self) -> Dict[str, float]:
        if not self.history:
            return {}
        toks = sum(m.tokens for m in self.history)
        secs = sum(m.wall_s for m in self.history)
        return {
            "steps": len(self.history),
            "tokens": toks,
            "tokens_per_s": toks / secs if secs else 0.0,
            "mean_step_ms": secs / len(self.history) * 1e3,
        }
