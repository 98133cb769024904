"""True prompt tokens over the tokens the window's prefills computed
(the counters ``prefill.tokens`` and ``prefill.padded_tokens``: prompts
padded to their bucket, groups to a power of two of rows), in %."""

from harness import engine_trace

engine_trace.install()     # the traced run starts the engine's tracer


def read(run):
    m = engine_trace.of(run)
    if m is None or not m.delta("prefill.padded_tokens"):
        return None
    return (100.0 * m.delta("prefill.tokens")
            / m.delta("prefill.padded_tokens"))
