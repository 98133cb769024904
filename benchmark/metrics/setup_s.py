"""Process start to the end of warm-up: imports, weights drawn on the
card, the engine and its runtime cache and KV cache, the kernels' build
and load, one prefill per prompt bucket and every reachable graph's
capture (host clock)."""


def read(run):
    return run.setup_s
