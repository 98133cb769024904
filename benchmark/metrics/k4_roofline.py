"""K4's share of its roofline over the profiled sub-span, in %: the
least time of its launches' useful work (``roofline/k4.py``) over their
device time in the profiler's records."""

from roofline import k4


def read(run):
    return k4.share(run)
