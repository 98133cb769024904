"""90th percentile, over the requests the engine admitted inside the
window, of the time from their admission to their first token
(``Request.t_first - t_admit``, the engine tracer's clock): the
admission's prefills and the first tokens' read, the part of TTFT after
the queue (``queue_wait_p90_ms``), less the traced run's profiler start
or stop inside it."""

import numpy as np

from harness import engine_trace

engine_trace.install()     # the traced run starts the engine's tracer


def read(run):
    m = engine_trace.of(run)
    if m is None:
        return None
    firsts = [m.wait_ns(a, f) / 1e6 for a, f in m.firsts
              if a is not None and f is not None and m.holds(a)]
    return float(np.percentile(firsts, 90)) if firsts else None
