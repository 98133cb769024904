"""Warm-up and the closed loop, driven through the port's public path:
``DecodeEngine.add_request(on_token=...)`` and
``DecodeEngine.run_pipelined(DEPTH)``, the path ``generate`` takes.

The loop lives in the token callbacks: when a request's last token is
collected, the traffic's kind decides what comes next (a closed loop's
client submits its next request). The window opens at the first
admission point once the traffic is steady (a closed loop: every
client's first request has finished), and closes at the first admission point at least
``seconds`` later; an admission point is each call of the engine's
``_admit``, which ``run_pipelined`` makes after every drain. So the
window holds whole cycles of drain, admission and decode chunks, and a
rate over it does not depend on where inside a cycle a fixed time would
have cut. At the close the clients stop and the requests still in flight
are cancelled, so a run pays nothing after its window but the check.
Before they are, the loop notes which request's KV each slot holds (the
check reads it back).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch

from .accounting import Req, Window

DEPTH = 2       # chunks in flight (``run_pipelined``'s depth, as generate's)
# the cell settings the exact warm-up below covers; any other engine
# keyword (``prefill_chunk``, ``speculative``, ...) is warmed by the
# engine's own ``DecodeEngine.warmup``
BASE_ENGINE = {"max_batch", "max_seq", "steps_per_sync", "ring_kv"}


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU,
    where the tests drive the loop)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reachable_keys(engine, traffic) -> List[tuple]:
    """Every (attn_start, attn_span) a decode chunk of this traffic can
    ask for: the engine's span buckets from one fresh request of the
    shortest prompt (its first token in, nothing in flight) up to the
    longest request's last position with ``DEPTH - 1`` chunks in flight;
    a ring cache reads the whole ring, one key."""
    from tpu_bitsandbytes_torch.engine.engine import _span_bucket
    if engine.cache.ring:
        return [(0, None)]
    n = engine.steps_per_sync
    lo = traffic.prompt_range[0] + 1 + n
    hi = traffic.longest() - 1 + DEPTH * n
    spans = sorted({_span_bucket(need, engine.max_seq)
                    for need in range(lo, hi + 1)})
    short_lo = traffic.prompt_range[0] + 1
    starts = sorted({engine._win_start(s)
                     for s in range(short_lo, traffic.longest())})
    return [(a, s) for a in starts for s in spans if a + n < s]


def prompt_buckets(engine, traffic) -> List[int]:
    """The padded prompt lengths (the engine's buckets) the traffic's
    prompt range reaches."""
    from tpu_bitsandbytes_torch.engine.engine import _bucket
    lo, hi = traffic.prompt_range
    return sorted({_bucket(n, engine.max_seq) for n in range(lo, hi + 1)})


def greedy(sampling: dict) -> bool:
    return float(sampling.get("temperature", 0.0)) <= 0


def features(sampling: List[dict]) -> tuple:
    """The decode-graph variants (``DecodeEngine.warmup``'s ``features``)
    a mix's sampling keywords turn on."""
    out = []
    if not all(greedy(s) for s in sampling):
        out.append("sampled")
    if any(s.get("logprobs") for s in sampling):
        out.append("logprobs")
    if any(float(s.get("repetition_penalty", 1.0)) != 1.0
           for s in sampling):
        out.append("penalty")
    return tuple(out)


def warm_up(engine, traffic, settings: dict) -> dict:
    """Everything the cell's traffic can reach, before the first request:
    the kernels' build and load, one prefill per prompt bucket, and the
    decode-chunk graph of every reachable key, each run once from empty
    slots as ``DecodeEngine.warmup`` runs its own keys (which would also
    capture a span-128 key this traffic never reaches). Where the cell's
    engine settings (beyond :data:`BASE_ENGINE`) or the mix's sampling
    turn on more shapes or graph variants, ``DecodeEngine.warmup`` over
    the prompt buckets warms them as the program plans them, in place of
    the plain prefills."""
    import numpy as np
    from tpu_bitsandbytes_torch.engine.engine import prefill_step
    from tpu_bitsandbytes_torch.ops import _build
    feats = features(traffic.sampling)
    buckets = prompt_buckets(engine, traffic)
    if set(settings) - BASE_ENGINE or feats:
        engine.warmup(prompt_lengths=buckets, features=feats)
    else:
        if engine.device.type == "cuda":
            _build.load_all()
        for s_pad in buckets:
            toks = torch.zeros((1, s_pad), dtype=torch.int32,
                               device=engine.device)
            prefill_step(engine.params, engine.cache, toks, 0, 1,
                         engine.config)
    zeros = np.zeros((engine.max_batch,), np.int32)
    ones = np.ones((engine.max_batch,), bool)
    keys = reachable_keys(engine, traffic)
    for a_start, span in keys:
        engine.cache.lengths.fill_(a_start)
        engine.run_chunk(zeros, ones, all_greedy=True, attn_span=span,
                         attn_start=a_start)
    engine.cache.lengths.zero_()
    sync(engine.device)
    return {"prefill_buckets": buckets, "keys": keys}


class Loop:
    """The traffic's clients over ``engine``.

    ``hooks``: called as ``hooks(loop, now)`` at every admission point,
    before the admission (the traced run starts and stops its profiler
    there)."""

    def __init__(self, engine, traffic, seconds: float):
        from tpu_bitsandbytes_torch.engine.sampler import SamplingParams
        self.engine, self.traffic = engine, traffic
        self.seconds = seconds
        self.keep_chunks = False        # the traced run's per-token chunks
        self._params = SamplingParams
        self.reqs: List[Req] = []
        self.by_uid = {}
        self.rounds = [0] * traffic.clients
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self.cur_chunk: Optional[int] = None
        self.hooks: List[Callable] = []
        self.keys_before = None
        self.keys_after = None
        self.holders = {}               # uid -> slot, at the close
        self._admit = engine._admit
        engine._admit = self._admit_point

    # -- clients ----------------------------------------------------------
    def submit(self, client: int) -> None:
        r = self.rounds[client]
        self.rounds[client] += 1
        prompt, n_out, samp = self.traffic.request(client, r)
        rec = Req(client, r, prompt, n_out, t_submit=time.perf_counter(),
                  greedy=greedy(samp))
        rec.uid = self.engine.add_request(
            prompt, self._params(**samp, max_new_tokens=n_out),
            on_token=self.on_token)
        self.by_uid[rec.uid] = rec
        self.reqs.append(rec)

    def on_token(self, uid: int, token: int, done: bool) -> None:
        rec = self.by_uid[uid]
        now = time.perf_counter()
        rec.times.append(now)
        rec.tokens.append(token)
        if self.keep_chunks:
            rec.chunks.append(self.cur_chunk)
        if done:
            rec.t_done = now
            self.traffic.done(self, rec)

    # -- the engine's admission points ------------------------------------
    def _admit_point(self):
        now = time.perf_counter()
        if self.t_open is None:
            if self.traffic.steady():
                self.t_open = now
                self.keys_before = len(self.engine.graph_keys())
        elif self.t_close is None and now >= self.t_open + self.seconds:
            self.t_close = now
            self.keys_after = len(self.engine.graph_keys())
            self.holders = self._holders()
            self._cancel_all()
        for hook in self.hooks:
            hook(self, now)
        return self._admit()

    def _holders(self) -> dict:
        """uid -> slot of the request whose KV each slot holds: the last
        one admitted to it (active, or finished and not yet replaced). At
        an admission point nothing is in flight, so its positions up to
        its last emitted token's are as the server wrote them."""
        last = {}
        for req in self.engine.finished:
            if req.slot is not None and req.uid in self.by_uid:
                last[req.slot] = req.uid
        for slot, req in self.engine.active.items():
            last[slot] = req.uid
        return {uid: slot for slot, uid in last.items()}

    def _cancel_all(self) -> None:
        for rec in self.reqs:
            if rec.t_done is None and not rec.cancelled:
                rec.cancelled = True
                self.engine.cancel(rec.uid)

    def run(self) -> Window:
        self.traffic.start(self)
        self.engine.run_pipelined(DEPTH)
        sync(self.engine.device)
        if self.t_close is None:
            raise RuntimeError("the window never closed: the traffic ran "
                               "out before --seconds had passed")
        return Window(self.t_open, self.t_close)

    def detach(self) -> None:
        """Give the engine back its own admission and drop it, so that
        nothing of the server outlives the loop."""
        self.engine._admit = self._admit
        self.engine = self._admit = None

    def captured_in_window(self) -> int:
        """Graphs captured between the window's open and close."""
        return (self.keys_after or 0) - (self.keys_before or 0)
