"""Every output token the clients saw inside the window, over the
window's seconds (host clock)."""

from harness import accounting


def read(run):
    return accounting.output_tokens_per_s(run.reqs, run.window)
