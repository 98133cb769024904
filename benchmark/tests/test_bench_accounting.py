"""The window's end-to-end numbers: the rate counts every token inside
the window over its seconds, the first-token tail counts every request
submitted inside it (one with no first token by the close at its wait to
the close), and the per-token tail every request that finished in it."""

import pytest

from harness.accounting import (Req, Window, attempted, failed,
                                output_tokens_per_s, p95, tpot_ms, ttft_ms)


def req(t_submit, times, n_out=None, done=True):
    r = Req(client=0, round=0, prompt=[1, 2], n_out=n_out or len(times),
            t_submit=t_submit, times=list(times), tokens=[0] * len(times))
    r.t_done = times[-1] if done and times else None
    return r


WIN = Window(10.0, 20.0)


def test_rate_is_every_token_over_the_window():
    reqs = [req(9.0, [9.5, 10.0, 12.0, 19.99, 20.0, 21.0]),
            req(15.0, [16.0, 17.0], n_out=5, done=False)]
    # 10.0, 12.0, 19.99 and 16.0, 17.0 lie in [10, 20)
    assert output_tokens_per_s(reqs, WIN) == pytest.approx(5 / 10.0)


def test_ttft_counts_unfinished_at_the_close():
    reqs = [req(9.0, [9.5, 11.0]),            # submitted before: out
            req(11.0, [11.25, 12.0]),         # 250 ms
            req(18.0, [], n_out=4, done=False),   # no token: 2,000 ms
            req(19.0, [20.5, 21.0]),          # first token after the close
            req(20.0, [20.1])]                # submitted at the close: out
    assert ttft_ms(reqs, WIN) == pytest.approx([250.0, 2000.0, 1000.0])
    assert len(attempted(reqs, WIN)) == 3
    # in flight at the close is cut, not failed; finished short is failed
    assert failed(reqs, WIN) == []
    short = req(12.0, [12.5, 13.0], n_out=3)
    assert failed(reqs + [short], WIN) == [short]


def test_tpot_over_requests_finished_inside():
    reqs = [req(5.0, [6.0, 8.0, 10.0, 12.0]),     # done at 12: (12-6)/3
            req(11.0, [11.5, 19.0, 22.0]),        # done after the close
            req(12.0, [13.0])]                    # one token: no gaps
    assert tpot_ms(reqs, WIN) == pytest.approx([2000.0])


def test_p95_is_linear_between_order_statistics():
    assert p95(list(range(101))) == pytest.approx(95.0)
    assert p95([1.0, 2.0]) == pytest.approx(1.95)
