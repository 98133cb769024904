"""Single-device decode engine: chunked decode steps + continuous batching.

The eager PyTorch counterpart of the JAX package's engine. A decode chunk
advances every slot ``n_steps`` tokens with sampling and EOS handling on
the device, so the host reads tokens back once per chunk; within a chunk
new K/V go to the cache's stage and are flushed at its end. A host-side
scheduler admits queued requests into free slots between chunks, grouping
same-length-bucket prompts into one batched prefill.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models import llama
from ..utils.metrics import MetricsLogger
from .kvcache import KVCache
from .sampler import SamplingArrays, SamplingParams, sample_batched


def decode_step(params, cache: KVCache, tokens: torch.Tensor,
                active: torch.Tensor, config: llama.LlamaConfig,
                attn_span: Optional[int] = None):
    """Advance every slot one token: tokens int32 [B], active bool [B].
    Returns (f32 logits [B, V], cache) with the lengths of active slots
    advanced in place. ``attn_span`` must cover every active slot's
    length + 1."""
    positions = cache.lengths.clone()
    x, cos, sin = llama.decode_embed_and_rope(params, tokens, positions,
                                              config)
    for li, layer in enumerate(params["layers"]):
        x, cache = llama.decode_layer(layer, x, cos, sin, positions, cache,
                                      li, config, attn_span=attn_span)
    x = llama._norm(x, params["final_norm"], config)
    logits = llama.head_logits(params, x[:, 0], config)
    cache.lengths += active.to(torch.int32)
    cache.advance_stage()
    return logits, cache


def decode_chunk(params, cache: KVCache, tokens: torch.Tensor,
                 active: torch.Tensor, generator: torch.Generator,
                 samp: SamplingArrays, config: llama.LlamaConfig,
                 n_steps: int = 8, all_greedy: bool = False,
                 attn_span: Optional[int] = None):
    """Advance every slot up to ``n_steps`` tokens without reading anything
    back to the host; a slot that emits its EOS, or reaches ``max_seq - 1``,
    goes inactive on the device and its later emissions carry
    ``active=False``. Staged like the JAX package's
    ``decode_chunk(window_stage=False)``.

    Returns (tokens_seq int32 [n_steps, B], active_seq bool [n_steps, B],
    cache, last tokens [B], active [B]).
    """
    max_seq = cache.max_seq
    cache.begin_stage(n_steps)
    toks_seq, act_seq = [], []
    for _ in range(n_steps):
        logits, cache = decode_step(params, cache, tokens, active, config,
                                    attn_span)
        if all_greedy:
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            toks = sample_batched(logits, generator, samp)
        toks = torch.where(active, toks, tokens)
        toks_seq.append(toks)
        act_seq.append(active)
        hit_eos = active & (toks == samp.eos_id)
        active = active & ~hit_eos & (cache.lengths < max_seq - 1)
        tokens = toks
    cache.flush_stage()
    return (torch.stack(toks_seq), torch.stack(act_seq), cache, tokens,
            active)


def prefill_step(params, cache: KVCache, tokens: torch.Tensor, slot: int,
                 true_len: int, config: llama.LlamaConfig):
    """Prefill one request of (padded) shape [1, S_pad] into ``slot``.
    Positions past ``true_len`` write garbage KV that decode overwrites
    before attending to it. Returns (f32 last-token logits [V], cache)."""
    logits, new_kv = llama.forward(params, tokens, config, return_kv=True)
    for li, (k, v) in enumerate(new_kv):
        cache.write_prefill(li, slot, k[0], v[0])
    cache.lengths[slot] = true_len
    return logits[0, true_len - 1].to(torch.float32), cache


def prefill_batch(params, cache: KVCache, tokens: torch.Tensor,
                  slots: torch.Tensor, true_lens: torch.Tensor,
                  generator: torch.Generator, samp: SamplingArrays,
                  config: llama.LlamaConfig):
    """Prefill R same-bucket requests in one forward: tokens [R, S_pad],
    target ``slots`` [R], ``true_lens`` [R]. Duplicate slots must be
    identical rows. Returns (first tokens [R] sampled with ``samp``,
    cache)."""
    logits, new_kv = llama.forward(params, tokens, config, return_kv=True)
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :].expand(
        tokens.shape)
    for li, (k, v) in enumerate(new_kv):
        cache.write_decode(li, k, v, pos, slots=slots)
    cache.lengths[slots.long()] = true_lens.to(torch.int32)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    last = logits[rows, true_lens.long() - 1]
    return sample_batched(last, generator, samp), cache


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    params: SamplingParams
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    # first token from prefill: a device scalar until _host_inputs reads it
    pending_first: Optional[Any] = None


def _bucket(n: int, max_seq: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return min(b, max_seq)


def _span_bucket(need: int, max_seq: int) -> int:
    """``need`` rounded up to a multiple of 128, clamped to
    [128, max_seq]."""
    return min(max_seq, max(128, -(-need // 128) * 128))


class DecodeEngine:
    """Slot-based continuous-batching decode engine over a Llama model."""

    def __init__(self, params, config: llama.LlamaConfig, *,
                 max_batch: int = 8, max_seq: Optional[int] = None,
                 seed: int = 0, steps_per_sync: int = 8,
                 runtime_cache: Optional[str] = None,
                 device="cuda"):
        """``params`` must live on ``device``. ``steps_per_sync``: decode
        steps per host read-back (one decode chunk). ``runtime_cache``:
        "int4" attaches the int4 execution cache to every NF4 weight (which
        kernel K1 streams); None serves the params as they are."""
        self.config = config
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq or config.max_seq_len
        self.steps_per_sync = max(1, int(steps_per_sync))
        if runtime_cache is not None:
            params = llama.build_runtime_cache(params, runtime_cache)
        self.params = params
        self.cache = KVCache.create(config.num_layers, max_batch,
                                    self.max_seq, config.num_kv_heads,
                                    config.hd, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._uid = 0
        self.waiting: List[Request] = []
        self.active: Dict[int, Request] = {}   # slot -> request
        self.finished: List[Request] = []
        self.metrics = MetricsLogger()

    # -- request management ---------------------------------------------
    def add_request(self, prompt_tokens,
                    sampling: Optional[SamplingParams] = None) -> int:
        self._uid += 1
        self.waiting.append(Request(self._uid, [int(t) for t in prompt_tokens],
                                    sampling or SamplingParams()))
        return self._uid

    def _free_slots(self) -> List[int]:
        return [s for s in range(self.max_batch) if s not in self.active]

    def _samp(self, per_slot, n: int) -> SamplingArrays:
        return SamplingArrays.build(per_slot, n, device=self.device)

    # -- admission --------------------------------------------------------
    def _admit(self):
        free = self._free_slots()
        groups: Dict[int, list] = {}
        while free and self.waiting:
            slot = free.pop(0)
            req = self.waiting.pop(0)
            req.slot = slot
            if len(req.prompt) >= self.max_seq:
                # keep the latest context that still leaves room to decode
                req.prompt = req.prompt[-(self.max_seq - 1):]
            groups.setdefault(_bucket(len(req.prompt), self.max_seq),
                              []).append((slot, req))
        for s_pad, grp in sorted(groups.items()):
            if len(grp) == 1:
                self._admit_one(*grp[0])
            else:
                self._admit_group(s_pad, grp)

    def _admit_one(self, slot: int, req: Request):
        s = len(req.prompt)
        toks = torch.zeros((1, _bucket(s, self.max_seq)), dtype=torch.int32)
        toks[0, :s] = torch.tensor(req.prompt, dtype=torch.int32)
        last_logits, self.cache = prefill_step(
            self.params, self.cache, toks.to(self.device), slot, s,
            self.config)
        req.pending_first = sample_batched(
            last_logits[None, :], self.generator,
            self._samp({0: req.params}, 1))[0]
        self.active[slot] = req

    def _admit_group(self, s_pad: int, grp: list):
        """Prefill a same-bucket group in one forward. R pads to a power of
        two with copies of row 0, whose colliding KV writes are identical."""
        r = len(grp)
        r_pad = 1
        while r_pad < r:
            r_pad *= 2
        rows = [grp[i if i < r else 0] for i in range(r_pad)]
        toks = np.zeros((r_pad, s_pad), np.int32)
        for i, (_, req) in enumerate(rows):
            toks[i, :len(req.prompt)] = req.prompt
        dev = self.device
        slots = torch.tensor([slot for slot, _ in rows], dtype=torch.int32,
                             device=dev)
        lens = torch.tensor([len(req.prompt) for _, req in rows],
                            dtype=torch.int32, device=dev)
        samp = self._samp({i: req.params for i, (_, req) in enumerate(rows)},
                          r_pad)
        firsts, self.cache = prefill_batch(
            self.params, self.cache, torch.from_numpy(toks).to(dev), slots,
            lens, self.generator, samp, self.config)
        for i, (slot, req) in enumerate(grp):
            req.pending_first = firsts[i]
            self.active[slot] = req

    # -- decode -------------------------------------------------------------
    def _attn_span(self) -> int:
        """Span bucket covering every active slot's position plus the
        chunk."""
        longest = max((len(r.prompt) + len(r.generated)
                       for r in self.active.values()), default=0)
        return _span_bucket(longest + self.steps_per_sync, self.max_seq)

    def _host_inputs(self):
        """This chunk's (tokens [B], active [B]) from host bookkeeping,
        consuming the first tokens that prefill produced."""
        tokens = np.zeros((self.max_batch,), np.int32)
        active = np.zeros((self.max_batch,), bool)
        for slot, req in list(self.active.items()):
            if req.pending_first is not None:
                first = int(req.pending_first)
                req.pending_first = None
                self._collect(slot, req, first)
                if req.done:
                    continue
            tokens[slot] = req.generated[-1]
            active[slot] = True
        return tokens, active

    def _collect_chunk(self, toks_seq, act_seq) -> int:
        toks_seq = toks_seq.cpu().numpy()
        act_seq = act_seq.cpu().numpy()
        emitted = 0
        for i in range(toks_seq.shape[0]):
            for slot in list(self.active.keys()):
                req = self.active.get(slot)
                if req is None or not act_seq[i, slot]:
                    continue
                self._collect(slot, req, int(toks_seq[i, slot]))
                emitted += 1
        return emitted

    def _collect(self, slot: int, req: Request, token: int):
        req.generated.append(token)
        sp = req.params
        gen = req.generated
        out_of_room = len(req.prompt) + len(gen) >= self.max_seq - 1
        hit_stop = any(len(gen) >= len(st) and tuple(gen[-len(st):]) ==
                       tuple(st) for st in sp.stop)
        if ((sp.eos_token_id is not None and token == sp.eos_token_id)
                or len(gen) >= sp.max_new_tokens or out_of_room or hit_stop):
            req.done = True
            self.finished.append(req)
            del self.active[slot]

    def step(self) -> bool:
        """One engine iteration: admit, then one decode chunk. Returns False
        when no work remains."""
        self._admit()
        if not self.active:
            return bool(self.waiting)
        tokens, active = self._host_inputs()
        if not active.any():
            return bool(self.waiting or self.active)
        t0 = time.perf_counter()
        all_greedy = all(r.params.temperature <= 0
                         for r in self.active.values())
        samp = self._samp({s: r.params for s, r in self.active.items()},
                          self.max_batch)
        toks_seq, act_seq, self.cache, _, _ = decode_chunk(
            self.params, self.cache, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(active).to(self.device), self.generator, samp,
            self.config, n_steps=self.steps_per_sync, all_greedy=all_greedy,
            attn_span=self._attn_span())
        emitted = self._collect_chunk(toks_seq, act_seq)
        self.metrics.record(emitted, time.perf_counter() - t0)
        return bool(self.waiting or self.active)

    def generate(self, prompts: List[List[int]],
                 sampling=None) -> List[List[int]]:
        """Run every prompt to completion through :meth:`step`.
        ``sampling``: one SamplingParams for all prompts, or one each."""
        if sampling is None or isinstance(sampling, SamplingParams):
            sampling = [sampling] * len(prompts)
        if len(sampling) != len(prompts):
            raise ValueError(f"{len(sampling)} sampling params for "
                             f"{len(prompts)} prompts")
        uids = [self.add_request(p, sp) for p, sp in zip(prompts, sampling)]
        while self.step():
            pass
        by_uid = {r.uid: r.generated for r in self.finished}
        return [by_uid[u] for u in uids]

    @property
    def stats(self) -> dict:
        return {"active": len(self.active), "waiting": len(self.waiting),
                "finished": len(self.finished),
                "kv_bytes_per_token": self.cache.bytes_per_token(),
                **self.metrics.summary()}
