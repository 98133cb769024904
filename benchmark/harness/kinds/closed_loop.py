"""The closed loop: ``clients`` clients each keep one request in flight and
send the next as soon as the previous one's last token is collected.

A mix file of this kind reads::

    {"kind": "closed_loop", "clients": 64,
     "prompt_tokens": [128, 1024], "output_tokens": [64, 320],
     "sampling": [{"temperature": 0.0}]}

``sampling`` is a list of the port's ``SamplingParams`` keywords, dealt to
the clients in turn (client c's requests take entry c mod its length;
``max_new_tokens`` is the request's output length), so a sampled mix can
carry greedy clients for the check. With no EOS and no stop sequence
``output_tokens`` fixes the work. Every seed gets the
same work: in round r (each client's r-th request) the clients take their
prompt and output lengths from the stratified grids
``lo + floor((i + 0.5) (hi - lo + 1) / n)``, i < n = clients, of the two
inclusive ranges, so lengths are uniform over each range. Which client
gets which length is one fixed permutation a round, the same for every
seed: in a closed loop the order decides which requests finish and are
admitted together, and a seed-drawn order moved the first cell's
throughput by 8% between seeds where two runs of one seed agreed to
0.1%. The run's seed draws the token ids, uniform over the vocabulary,
per client and round (and the weights); no prefix is shared. The window
may open once every client's first request has finished (steady state).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_ORDER, _LENGTHS, _TOKENS = 0, 0x1E57, 0x70C5


def grid(lo: int, hi: int, n: int) -> List[int]:
    """n stratified draws of the uniform distribution on [lo, hi]."""
    return [lo + int((i + 0.5) * (hi - lo + 1) / n) for i in range(n)]


class Traffic:
    """Requests of a closed-loop mix for one ``seed``."""

    def __init__(self, params: dict, seed: int, vocab: int):
        self.clients = int(params["clients"])
        self.prompt_range = tuple(params["prompt_tokens"])
        self.output_range = tuple(params["output_tokens"])
        self.sampling = [dict(s) for s in params["sampling"]]
        self.seed = seed % 2 ** 64
        self.vocab = vocab
        self._rounds = {}
        self._first_done = 0

    def _round(self, r: int) -> List[Tuple[int, int]]:
        """(prompt, output) lengths of every client in round r."""
        if r not in self._rounds:
            n = self.clients
            rng = np.random.default_rng([_ORDER, _LENGTHS, r])
            who = rng.permutation(n)
            prompts = np.asarray(grid(*self.prompt_range, n))[
                rng.permutation(n)]
            outs = np.asarray(grid(*self.output_range, n))[
                rng.permutation(n)]
            out = [None] * n
            for j in range(n):
                out[who[j]] = (int(prompts[j]), int(outs[j]))
            self._rounds[r] = out
        return self._rounds[r]

    def lengths(self, client: int, r: int) -> Tuple[int, int]:
        """(prompt tokens, output tokens) of client ``client``'s r-th
        request."""
        return self._round(r)[client]

    def request(self, client: int, r: int) -> Tuple[List[int], int, dict]:
        """(prompt token ids, output tokens, sampling keywords) of that
        request."""
        n_prompt, n_out = self.lengths(client, r)
        rng = np.random.default_rng([self.seed, _TOKENS, client, r])
        return (rng.integers(0, self.vocab, n_prompt).tolist(), n_out,
                self.sampling[client % len(self.sampling)])

    def longest(self) -> int:
        """The most positions one request can hold."""
        return self.prompt_range[1] + self.output_range[1]

    # -- driving the loop (harness.serve.Loop) ------------------------------
    def start(self, loop) -> None:
        for c in range(self.clients):
            loop.submit(c)

    def done(self, loop, rec) -> None:
        """``rec`` delivered its last token: its client sends the next."""
        if rec.round == 0:
            self._first_done += 1
        if loop.t_close is None:
            loop.submit(rec.client)

    def steady(self) -> bool:
        """Whether the window may open: every first request finished."""
        return self._first_done == self.clients
