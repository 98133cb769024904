"""Mean, over the window's decode-chunk dispatches, of the KV positions
the slots hold (``kv_used``, from the engine's own bookkeeping) over
those the cache reserves (``kv_reserved``: slots times its S axis), in
%."""

from harness import engine_trace

engine_trace.install()     # the traced run starts the engine's tracer


def read(run):
    m = engine_trace.of(run)
    if m is None:
        return None
    shares = [s.attrs["kv_used"] / s.attrs["kv_reserved"]
              for s in m.spans(engine_trace.TOP_DISPATCH, top=True)
              if "kv_used" in s.attrs]
    return 100.0 * sum(shares) / len(shares) if shares else None
