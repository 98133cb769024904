"""K3's share of its roofline over the profiled sub-span, in %: the
least time of its launches' useful work (``roofline/k3.py``) over their
device time in the profiler's records."""

from roofline import k3


def read(run):
    return k3.share(run)
