"""K2's share of its roofline over the profiled sub-span, in %: the
least time of its launches' useful work (``roofline/k2.py``) over their
device time in the profiler's records."""

from roofline import k2


def read(run):
    return k2.share(run)
