"""Single-device decode engine: chunked decode steps + continuous batching.

The PyTorch counterpart of the JAX package's engine. A decode chunk
advances every slot ``n_steps`` tokens with sampling and EOS handling on
the device, so the host reads tokens back once per chunk; within a chunk
new K/V go to the cache's stage and are flushed at its end. On a CUDA
device each chunk is one CUDA graph replay (:class:`ChunkGraphs`, the
counterpart of the JAX package's jitted ``lax.scan``), so the host pays
the launches of a chunk once per set of static arguments, not once per
token. A host-side scheduler admits queued requests into free slots
between chunks, grouping same-length-bucket prompts into one batched
prefill.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Counter, Dict, List, Optional

import numpy as np
import torch

from ..models import llama
from ..ops import _build
from ..utils import graph_census
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
    ``decode_chunk(window_stage=False)``. The whole chunk (stage reset,
    steps, sampling, flush) can be captured in one CUDA graph; the Python
    loop unrolls into it as JAX's scan runs its body ``n_steps`` times.

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


class ChunkGraphs:
    """CUDA graphs of the decode chunk, one per static key, in one memory
    pool: the counterpart of the JAX package's ``decode_chunk``, which jit
    compiles at first use for each set of static arguments.

    A key's first chunk runs eagerly on the capture stream, which builds
    what must exist before a capture (the rope table, K2's cluster plan, the
    split-K scratch of that stream, the persistent stage), and is then
    captured; later chunks of the key replay the graph on the same stream,
    ordered after the caller's stream and it after them, so the graph's
    launches share that stream's split-K scratch in order with its eager
    ones. A capture or replay error raises. The counters of
    ``ops._build.COUNTERS`` (the kernels' launches, the plain versions'
    calls on CUDA tensors) tick when their functions run, which for a
    graph is once, at capture: the capture's ticks are undone, and each
    replay adds them, so they count what runs on the device. Each graph
    is kept beside its instantiation, so :meth:`kernel_names` can read
    the kernels a replay launches from the graph itself.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.capture_s = 0.0
        # key -> (graph, its static outputs, [(counter, launches)])
        self._graphs: Dict[Any, tuple] = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key, fn: Callable[[], Any],
            generator: Optional[torch.Generator] = None):
        """``fn()`` as the graph of ``key``: replayed, or at the key's first
        use run eagerly and captured. ``generator``: the one ``fn`` draws
        from, registered with the graph so that every replay draws fresh
        numbers from its current state. Returns ``fn``'s outputs (a graph's
        are overwritten by its next replay)."""
        entry = self._graphs.get(key)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        if entry is not None:
            graph, out, ticks = entry
            with torch.cuda.stream(self.stream):
                graph.replay()
            current.wait_stream(self.stream)
            for (f, a), n in ticks:
                setattr(f, a, getattr(f, a) + n)
            return out
        with torch.cuda.stream(self.stream):
            out = fn()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if generator is not None:
            graph.register_generator_state(generator)
        counters = list(_build.COUNTERS)
        before = [getattr(f, a) for f, a in counters]
        # capture_begin/end, not torch.cuda.graph: that one empties the
        # allocator's cache first, which the next prefill then pays for
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                static = fn()
            finally:
                graph.capture_end()
            graph.instantiate()
        current.wait_stream(self.stream)
        ticks = []
        for (f, a), n0 in zip(counters, before):
            if getattr(f, a) != n0:
                ticks.append(((f, a), getattr(f, a) - n0))
                setattr(f, a, n0)
        self._graphs[key] = (graph, static, ticks)
        self.capture_s += time.perf_counter() - t0
        return out

    def kernel_names(self, key) -> Counter[str]:
        """The kernels one replay of ``key``'s graph launches: their
        demangled names, each with its number of launches."""
        return graph_census.kernel_names(self._graphs[key][0].raw_cuda_graph())

    def pool_bytes(self) -> int:
        """Device bytes the graphs' memory pool holds."""
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))


class DecodeEngine:
    """Slot-based continuous-batching decode engine over a Llama model."""

    def __init__(self, params, config: llama.LlamaConfig, *,
                 max_batch: int = 8, max_seq: Optional[int] = None,
                 seed: int = 0, steps_per_sync: int = 8,
                 runtime_cache: Optional[str] = None,
                 device="cuda", cuda_graphs: bool = True):
        """``params`` must live on ``device``. ``steps_per_sync``: decode
        steps per host read-back (one decode chunk). ``runtime_cache``:
        "int4" attaches the int4 execution cache to every NF4 weight (which
        kernel K1 streams); None serves the params as they are.
        ``cuda_graphs``: on a CUDA device, run each decode chunk as a CUDA
        graph replay (:class:`ChunkGraphs`, one graph per span bucket,
        chunk length and all-greedy flag, captured at first use); False
        runs the same chunk eagerly there. CPU devices run it eagerly."""
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
        # the chunk's static inputs: tokens and active staged through
        # (pinned, on CUDA) host buffers, and the sampling arrays, refilled
        # only when the active set's parameters change
        pin = self.device.type == "cuda"
        b = max_batch
        self._tokens_host = torch.zeros((b,), dtype=torch.int32,
                                        pin_memory=pin)
        self._active_host = torch.zeros((b,), dtype=torch.bool,
                                        pin_memory=pin)
        self._tokens = torch.zeros((b,), dtype=torch.int32,
                                   device=self.device)
        self._active = torch.zeros((b,), dtype=torch.bool, device=self.device)
        self._samp_static = SamplingArrays.build({}, b, device=self.device)
        self._samp_key = None
        self._graphs = (ChunkGraphs(self.device)
                        if cuda_graphs and pin else None)
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

    def _samp_arrays(self) -> SamplingArrays:
        """The active set's sampling arrays for a decode chunk: device
        tensors that live as long as the engine (a captured chunk reads
        them), refilled in place only when the active set's (slot,
        SamplingParams) change, as the JAX package's ``_samp_arrays``
        rebuilds them."""
        key = [(s, r.params) for s, r in sorted(self.active.items())]
        if key != self._samp_key:
            src = SamplingArrays.build(dict(key), self.max_batch,
                                       device="cpu")
            if self.device.type == "cuda":
                src = SamplingArrays(*(t.pin_memory() for t in src.tensors()))
            self._samp_static.copy_(src)
            self._samp_key = key
        return self._samp_static

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

    def run_chunk(self, tokens: np.ndarray, active: np.ndarray, *,
                  all_greedy: bool, attn_span: int):
        """One decode chunk of ``steps_per_sync`` steps from host
        ``tokens`` int32 [B] and ``active`` bool [B], staged into the static
        device inputs without a host sync. On CUDA (unless the engine was
        built with ``cuda_graphs=False``) the chunk replays the graph of
        ``(attn_span, steps_per_sync, all_greedy)``, captured at the key's
        first use. Returns the device (tokens_seq, active_seq) [steps, B];
        read them before the next chunk, which may overwrite them."""
        n = self.steps_per_sync
        self._tokens_host.numpy()[:] = tokens
        self._active_host.numpy()[:] = active
        self._tokens.copy_(self._tokens_host, non_blocking=True)
        self._active.copy_(self._active_host, non_blocking=True)
        samp = self._samp_arrays()

        def chunk():
            toks_seq, act_seq, _, _, _ = decode_chunk(
                self.params, self.cache, self._tokens, self._active,
                self.generator, samp, self.config, n_steps=n,
                all_greedy=all_greedy, attn_span=attn_span)
            return toks_seq, act_seq

        if self._graphs is None:
            return chunk()
        return self._graphs.run((attn_span, n, all_greedy), chunk,
                                None if all_greedy else self.generator)

    def graph_stats(self) -> dict:
        """Graphs captured, seconds spent capturing them (their eager
        first chunks excluded) and the bytes of their memory pool."""
        g = self._graphs
        if g is None:
            return {"graphs": 0, "capture_s": 0.0, "pool_bytes": 0}
        return {"graphs": len(g), "capture_s": g.capture_s,
                "pool_bytes": g.pool_bytes()}

    def graph_kernel_names(self, attn_span: int,
                           all_greedy: bool = True) -> Counter[str]:
        """The kernels one replay of the chunk graph of ``attn_span`` and
        ``all_greedy`` launches, by demangled name, read from the graph."""
        return self._graphs.kernel_names(
            (attn_span, self.steps_per_sync, all_greedy))

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
        toks_seq, act_seq = self.run_chunk(tokens, active,
                                           all_greedy=all_greedy,
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
