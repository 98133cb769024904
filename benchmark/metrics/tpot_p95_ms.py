"""95th percentile, over every request that finished inside the window,
of (last token - first token) / (tokens - 1)."""

from harness import accounting


def read(run):
    v = accounting.tpot_ms(run.reqs, run.window)
    return accounting.p95(v) if v else None
