"""The trace's arithmetic: the union of device records, the idle gaps of
the sub-span named by the host phase that covered them, and the top
operations by time."""

from harness.trace import busy_ns, gaps, merge, named_gaps, top_ops

RECS = [("k1", 100, 50), ("k2", 120, 60), ("k1", 300, 100), ("copy", 500, 0)]


def test_union_and_gaps():
    assert merge([(100, 150), (120, 180), (300, 400)]) == [(100, 180),
                                                          (300, 400)]
    assert busy_ns(RECS) == 80 + 100
    assert gaps(RECS, 50, 600) == [(50, 100), (180, 300), (400, 500),
                                   (500, 600)]


def test_named_gaps_and_top_ops():
    host = [("host prefill", 150, 290), ("host dispatch", 380, 450)]
    # device clock = host clock + 10
    named = named_gaps([(180, 300), (400, 420), (50, 60)], host, 10, n=2)
    assert named == [["host prefill", 120e-9], ["host dispatch", 20e-9]]
    assert named_gaps([(50, 60)], host, 10) == [["host other", 10e-9]]
    assert top_ops(RECS, 2) == [["k1", 150e-9], ["k2", 60e-9]]
