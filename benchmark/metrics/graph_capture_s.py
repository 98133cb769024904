"""Seconds set-up spent capturing decode-chunk graphs
(``DecodeEngine.graph_stats()["capture_s"]``; each key's eager first
chunk excluded)."""


def read(run):
    return run.capture_s
