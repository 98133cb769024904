"""1 - (the union of the device's records over the profiled sub-span's
length), in %."""

from harness.trace import busy_ns


def read(run):
    sp = run.span
    if sp.seconds <= 0 or not sp.records:
        return None
    return 100.0 * (1.0 - busy_ns(sp.records) / 1e9 / sp.seconds)
