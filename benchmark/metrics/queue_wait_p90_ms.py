"""90th percentile, over the requests the engine admitted inside the
window, of their wait in the queue: the admission's time less the
submission's (``Request.t_admit - t_submit``, the engine tracer's
clock), less the traced run's profiler start or stop inside it. p90: a
chat window admits 90-150 requests, 9-15 beyond it."""

import numpy as np

from harness import engine_trace

engine_trace.install()     # the traced run starts the engine's tracer


def read(run):
    m = engine_trace.of(run)
    if m is None:
        return None
    waits = [m.wait_ns(s, a) / 1e6 for s, a in m.requests
             if s is not None and a is not None and m.holds(a)]
    return float(np.percentile(waits, 90)) if waits else None
