"""The closed-loop generator, found by the mix's kind: the same seed gives
the same requests, every seed gets the same set of lengths in each round,
and ids stay in the vocabulary."""

import pytest

from harness import traffic

MIX = {"kind": "closed_loop", "clients": 64,
       "prompt_tokens": [128, 1024], "output_tokens": [64, 320],
       "sampling": [{"temperature": 0.0}]}
BIG = 2 ** 31 + 12345


def ClosedLoop(mix, seed, vocab):
    return traffic.load(mix, seed, vocab)


def grid(lo, hi, n):
    return [lo + int((i + 0.5) * (hi - lo + 1) / n) for i in range(n)]


def test_same_seed_same_requests():
    a, b = ClosedLoop(MIX, BIG, 32000), ClosedLoop(MIX, BIG, 32000)
    for c, r in [(0, 0), (63, 0), (5, 7), (17, 40)]:
        assert a.request(c, r) == b.request(c, r)


def test_seeds_share_the_work_and_draw_the_ids():
    a, b = ClosedLoop(MIX, 1, 32000), ClosedLoop(MIX, BIG, 32000)
    for r in range(4):
        la = [a.lengths(c, r) for c in range(64)]
        assert la == [b.lengths(c, r) for c in range(64)]
        assert sorted(p for p, _ in la) == sorted(grid(128, 1024, 64))
        assert sorted(o for _, o in la) == sorted(grid(64, 320, 64))
    assert a.request(3, 1)[0] != b.request(3, 1)[0]
    assert [a.lengths(c, 0) for c in range(64)] != [
        a.lengths(c, 1) for c in range(64)]


def test_lengths_and_ids_in_range():
    t = ClosedLoop(MIX, 7, 32000)
    g = grid(128, 1024, 64)
    assert min(g) >= 128 and max(g) <= 1024 and len(set(g)) == 64
    for c in range(64):
        prompt, n_out, _ = t.request(c, 3)
        assert 128 <= len(prompt) <= 1024 and 64 <= n_out <= 320
        assert 0 <= min(prompt) and max(prompt) < 32000
    assert t.longest() == 1344


def test_clients_differ():
    t = ClosedLoop(MIX, 7, 32000)
    assert t.request(0, 0)[0][:16] != t.request(1, 0)[0][:16]


def test_kind_is_found_by_name():
    assert type(ClosedLoop(MIX, 1, 100)).__module__ == "bench_kind_closed_loop"
    with pytest.raises(ValueError, match="unknown traffic kind"):
        traffic.load({**MIX, "kind": "open_loop_poisson"}, 1, 100)


def test_sampling_comes_from_the_mix():
    sampled = {"temperature": 0.7, "top_p": 0.9}
    t = ClosedLoop({**MIX, "sampling": [{"temperature": 0.0}, sampled]},
                   1, 100)
    assert [t.request(c, 2)[2] for c in range(4)] == [
        {"temperature": 0.0}, sampled, {"temperature": 0.0}, sampled]
