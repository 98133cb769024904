"""95th percentile, over every request submitted inside the window, of
submission to the first token's callback; a request with no first token
by the close counts its wait to the close."""

from harness import accounting


def read(run):
    v = accounting.ttft_ms(run.reqs, run.window)
    return accounting.p95(v) if v else None
