"""K1's share of its roofline over the profiled sub-span, in %: the
least time of its launches' useful work (``roofline/k1.py``) over their
device time in the profiler's records."""

from roofline import k1


def read(run):
    return k1.share(run)
