"""Share of the window in which the engine was admitting
(``engine.admission`` spans: from the top of the serving loop, after the
drain, to the burst's first dispatch, so the prefills and the first
tokens' read), each clipped to the window, in %. No decode chunk runs
then. The traced run's profiler start and stop, which the harness makes
inside admission points, are taken out of both."""

from harness import engine_trace

engine_trace.install()     # the traced run starts the engine's tracer


def read(run):
    m = engine_trace.of(run)
    if m is None or not m.spans("engine.admission", top=True):
        return None
    return 100.0 * m.inside_ns("engine.admission") / m.window_ns
