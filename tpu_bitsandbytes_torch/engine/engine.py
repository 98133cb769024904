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
prefill; with ``prefill_chunk`` a long prompt is written into its slot one
chunk per engine step, between decode chunks (chunked prefill). Requests
may ask for a repetition penalty and for logprobs, may be cancelled, and
may stream their tokens (``on_token``, :meth:`DecodeEngine.generate_stream`).

The engine's lifecycle: :meth:`DecodeEngine.footprint` budgets the device's
memory (``drop_packed="auto"`` frees the NF4 codes where they would not fit
beside the runtime cache), :meth:`DecodeEngine.warmup` captures the graphs
serving will meet before the first request, :meth:`DecodeEngine.save_state`
and :meth:`DecodeEngine.load_state` snapshot and restart the engine
token-identically, :meth:`DecodeEngine.run_pipelined` keeps two chunks in
flight so the host's read-back hides under the device's work, and
``speculative="ngram"`` scores prompt-lookup drafts in one verify step.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
import warnings
from typing import Any, Callable, Counter, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models import llama
from ..ops import _build
from ..utils import graph_census
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.metrics import (Tracer, device_memory_bytes, kv_cache_bytes,
                             param_footprint, per_device_footprint,
                             serving_act_bytes)
from . import speculative as spec
from .kvcache import KVCache
from .sampler import SamplingArrays, SamplingParams, sample, sample_batched


def _hooks(tp) -> dict:
    """The model code's tensor-parallel hooks of ``tp`` (a
    :class:`~..parallel.tp.TPContext`), or none."""
    return {} if tp is None else tp.hooks


def _head(params, x, config: llama.LlamaConfig, tp=None):
    if tp is None:
        return llama.head_logits(params, x, config)
    return tp.head_logits(params, x, config)


def decode_step(params, cache: KVCache, tokens: torch.Tensor,
                active: torch.Tensor, config: llama.LlamaConfig,
                attn_span: Optional[int] = None, attn_start: int = 0,
                tp=None):
    """Advance every slot one token: tokens int32 [B], active bool [B].
    Returns (f32 logits [B, V], cache) with the lengths of active slots
    advanced in place. ``attn_span`` must cover every active slot's
    length + 1; ``attn_start`` (a fully-windowed model's lower bound) must
    lie at or below every active slot's length minus the window. ``tp``:
    a :class:`~..parallel.tp.TPContext`, to run on this rank's shards (B
    its dp group's slots)."""
    positions = cache.lengths.clone()
    x, cos, sin = llama.decode_embed_and_rope(params, tokens, positions,
                                              config)
    for li, layer in enumerate(params["layers"]):
        x, cache = llama.decode_layer(layer, x, cos, sin, positions, cache,
                                      li, config, attn_span=attn_span,
                                      attn_start=attn_start, **_hooks(tp))
    x = llama._norm(x, params["final_norm"], config)
    logits = _head(params, x[:, 0], config, tp)
    cache.lengths += active.to(torch.int32)
    cache.advance_stage()
    return logits, cache


def decode_chunk(params, cache: KVCache, tokens: torch.Tensor,
                 active: torch.Tensor, generator: torch.Generator,
                 samp: SamplingArrays, config: llama.LlamaConfig,
                 n_steps: int = 8, all_greedy: bool = False,
                 attn_span: Optional[int] = None,
                 seen_mask: Optional[torch.Tensor] = None,
                 want_logprobs: bool = False, attn_start: int = 0,
                 tp=None, window_stage: bool = True):
    """Advance every slot up to ``n_steps`` tokens without reading anything
    back to the host; a slot that emits its EOS, or reaches ``max_seq - 1``,
    goes inactive on the device and its later emissions carry
    ``active=False``. The whole chunk (stage reset, steps, sampling, flush)
    can be captured in one CUDA graph; the Python loop unrolls into it as
    JAX's scan runs its body ``n_steps`` times.

    ``window_stage`` (the JAX package's default, True): an int8 cache
    stages the chunk in a compact window, a copy of the span
    ``[attn_start, attn_span)`` followed by the staged tokens
    (``KVCache.begin_stage(window=True)``); False stages the tokens alone,
    attended beside the span as a second block.

    ``seen_mask`` bool [B, V]: each slot's seen tokens, which turns on the
    repetition penalty (``samp.rep_pen``; greedy rows too); it is updated in
    place as tokens are emitted. ``want_logprobs``: also return the model's
    log-softmax at each emitted token, from the raw logits (before the
    penalty and the temperature). ``tp``: as :func:`decode_step`'s.

    Returns (tokens_seq int32 [n_steps, B], active_seq bool [n_steps, B],
    cache, last tokens [B], active [B], logprobs_seq f32 [n_steps, B] or
    None, seen_mask).
    """
    max_seq = cache.max_positions or cache.max_seq   # the absolute bound
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    cache.begin_stage(n_steps, span=attn_span, start=attn_start,
                      window=window_stage)
    toks_seq, act_seq, lp_seq = [], [], []
    for _ in range(n_steps):
        logits, cache = decode_step(params, cache, tokens, active, config,
                                    attn_span, attn_start, tp)
        toks = sample_batched(logits, generator, samp, seen_mask,
                              all_greedy=all_greedy)
        toks = torch.where(active, toks, tokens)
        if want_logprobs:
            lp_seq.append(torch.log_softmax(logits, dim=-1).gather(
                1, toks.long()[:, None])[:, 0])
        if seen_mask is not None:
            t = toks.long()
            seen_mask.index_put_((rows, t), seen_mask[rows, t] | active)
        toks_seq.append(toks)
        act_seq.append(active)
        hit_eos = active & (toks == samp.eos_id)
        active = active & ~hit_eos & (cache.lengths < max_seq - 1)
        tokens = toks
    cache.flush_stage()
    return (torch.stack(toks_seq), torch.stack(act_seq), cache, tokens,
            active, torch.stack(lp_seq) if want_logprobs else None,
            seen_mask)


def _forward(params, tokens, config: llama.LlamaConfig, tp=None):
    """The prefill forward: (f32 logits [B, S, V], per-layer (k, v));
    under ``tp`` on this rank's shards, the head's shards gathered."""
    if tp is None:
        return llama.forward(params, tokens, config, return_kv=True)
    x, new_kv = llama.prefill_hidden(params, tokens, config, **tp.hooks)
    x = llama._norm(x, params["final_norm"], config)
    return tp.head_logits(params, x, config), new_kv


def prefill_step(params, cache: KVCache, tokens: torch.Tensor, slot: int,
                 true_len: int, config: llama.LlamaConfig, tp=None):
    """Prefill one request of (padded) shape [1, S_pad] into ``slot``.
    Positions past ``true_len`` write garbage KV that decode overwrites
    before attending to it (a ring cache drops them). Returns (f32
    last-token logits [V], cache). ``tp``: as :func:`decode_step`'s."""
    logits, new_kv = _forward(params, tokens, config, tp)
    for li, (k, v) in enumerate(new_kv):
        cache.write_prefill(li, slot, k[0], v[0], valid_len=true_len)
    cache.lengths[slot] = true_len
    return logits[0, true_len - 1].to(torch.float32), cache


def prefill_batch(params, cache: KVCache, tokens: torch.Tensor,
                  slots: torch.Tensor, true_lens: torch.Tensor,
                  generator: torch.Generator, samp: SamplingArrays,
                  config: llama.LlamaConfig,
                  seen_mask: Optional[torch.Tensor] = None, tp=None):
    """Prefill R same-bucket requests in one forward: tokens [R, S_pad],
    target ``slots`` [R], ``true_lens`` [R]. Duplicate slots must be
    identical rows. ``seen_mask`` [R, V]: each row's prompt tokens, for its
    repetition penalty. Returns (first tokens [R] sampled with ``samp``,
    cache). ``tp``: as :func:`decode_step`'s."""
    logits, new_kv = _forward(params, tokens, config, tp)
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :].expand(
        tokens.shape)
    for li, (k, v) in enumerate(new_kv):
        cache.write_decode(li, k, v, pos, slots=slots)
    cache.lengths[slots.long()] = true_lens.to(torch.int32)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    last = logits[rows, true_lens.long() - 1]
    return sample_batched(last, generator, samp, seen_mask=seen_mask), cache


def prefill_chunk_step(params, cache: KVCache, tokens: torch.Tensor,
                       slot: int, start: int, new_len: int,
                       config: llama.LlamaConfig,
                       attn_span: Optional[int] = None,
                       attn_start: int = 0, tp=None):
    """One chunk of a chunked prefill: tokens [1, C] written into ``slot``
    at positions [start, start + C) (those past ``max_seq`` dropped), the
    chunk's queries attending to the slot's own history (``decode_layer``
    in slot mode). A final chunk's padding writes garbage KV past the
    prompt, which decode overwrites before attending to it.

    ``new_len``: the slot's length after this chunk. Setting it after every
    chunk is load-bearing: decode chunks running for other slots write a
    garbage token into every slot at ``lengths[slot]`` (the int8 stage's
    flush drops it; an unquantized cache takes it), so the length must
    track the prefill frontier, where the next chunk, or the slot's first
    decode step, writes real KV before anything attends to it.

    Returns (hidden [1, C, H], cache); the final chunk's hidden goes to
    :func:`prefill_final_logits`. ``tp``: as :func:`decode_step`'s (the
    slot local to this rank's dp group)."""
    c = tokens.shape[1]
    positions = start + torch.arange(c, dtype=torch.int32,
                                     device=tokens.device)[None, :]
    x, cos, sin = llama.decode_embed_and_rope(params, tokens, positions,
                                              config)
    for li, layer in enumerate(params["layers"]):
        x, cache = llama.decode_layer(layer, x, cos, sin, positions, cache,
                                      li, config, attn_span=attn_span,
                                      slot=slot, attn_start=attn_start,
                                      **_hooks(tp))
    cache.lengths[slot] = new_len
    return x, cache


def prefill_final_logits(params, x: torch.Tensor, idx: int,
                         config: llama.LlamaConfig, tp=None) -> torch.Tensor:
    """f32 logits [V] of the prompt's last token: x [1, C, H] from the final
    prefill chunk, ``idx`` its index in the chunk. The lm_head runs once per
    admission, at M = 1 (its shard, gathered, under ``tp``)."""
    xl = llama._norm(x[:, idx], params["final_norm"], config)
    return _head(params, xl, config, tp)[0]


def _token_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """The model's log-softmax of ``tok`` (a device scalar) under raw
    logits [V], as a device scalar."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return lp.gather(0, tok.long().reshape(1))[0]


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
    # called as on_token(uid, token, done) for every emission, on the host,
    # when the chunk that emitted it is collected
    on_token: Optional[Callable[[int, int, bool], Any]] = None
    cancelled: bool = False
    # chunked prefill: the prompt tokens already in the slot's KV; a
    # prefilling request holds its slot but decodes only once its final
    # chunk has sampled its first token
    prefilling: bool = False
    prefill_pos: int = 0
    # the model's logprob of each emitted token (with params.logprobs)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    # the first token's logprob: a device scalar until _host_inputs reads it
    pending_first_lp: Optional[Any] = None
    # on the engine tracer's clock (ns): queued, given a slot, first token
    # collected
    t_submit: Optional[int] = None
    t_admit: Optional[int] = None
    t_first: Optional[int] = None


def _dp_seed(seed: int, dp_rank: int) -> int:
    """dp group ``dp_rank``'s decode-chunk seed under a mesh: a stream of
    its own, apart from the first tokens' (``seed``)."""
    return (seed * 1000003 + 1 + dp_rank) % (2 ** 63)


def rank_path(path: str) -> str:
    """This rank's snapshot file under a mesh: ``a/b.npz`` ->
    ``a/b.rank{r}.npz``, r the rank in the default process group."""
    root, ext = os.path.splitext(path)
    return f"{root}.rank{dist.get_rank()}{ext}"


def _bucket(n: int, max_seq: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return min(b, max_seq)


def _span_bucket(need: int, max_seq: int) -> int:
    """``need`` rounded up to a multiple of 128, clamped to
    [128, max_seq]."""
    return min(max_seq, max(128, -(-need // 128) * 128))


def _chunk_span_bucket(need: int, max_seq: int) -> int:
    """A prefill chunk's span bucket: multiples of 128 up to 2048, then
    powers of two (clamped to ``max_seq``), as in the JAX package, whose
    chunks compile once per bucket."""
    b = _span_bucket(need, max_seq)
    if b <= 2048:
        return b
    p = 4096
    while p < b:
        p *= 2
    return min(p, max_seq)


class ChunkGraphs:
    """CUDA graphs of the decode chunk (and of the speculative verify step),
    one per static key, in one memory pool: the counterpart of the JAX
    package's ``decode_chunk``, which jit compiles at first use for each
    set of static arguments.

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
    the kernels a replay launches from the graph itself. ``tracer``: the
    engine's :class:`~..utils.metrics.Tracer`, which records each replay
    (``graph.replay``) and each key's first use (``graph.capture``).
    """

    def __init__(self, device, tracer: Optional[Tracer] = None):
        self.device = torch.device(device)
        self.tracer = tracer or Tracer(device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.capture_s = 0.0
        # key -> (graph, its static outputs, [(counter, launches)])
        self._graphs: Dict[Any, tuple] = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self) -> List[Any]:
        """The keys captured so far, in capture order."""
        return list(self._graphs)

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def run(self, key, fn: Callable[[], Any],
            generator: Optional[torch.Generator] = None):
        """``fn()`` as the graph of ``key``: replayed, or at the key's first
        use run eagerly and captured. ``generator``: the one ``fn`` draws
        from, registered with the graph so that every replay draws fresh
        numbers from its current state. Returns ``fn``'s outputs (a graph's
        are overwritten by its next replay)."""
        entry = self._graphs.get(key)
        if entry is not None:
            with self.tracer.span("graph.replay"):
                current = torch.cuda.current_stream(self.device)
                self.stream.wait_stream(current)
                graph, out, ticks = entry
                with torch.cuda.stream(self.stream):
                    graph.replay()
                current.wait_stream(self.stream)
                for (f, a), n in ticks:
                    setattr(f, a, getattr(f, a) + n)
            return out
        with self.tracer.span("graph.capture", key=key):
            return self._capture(key, fn, generator)

    def _capture(self, key, fn: Callable[[], Any],
                 generator: Optional[torch.Generator]):
        """A key's first use: ``fn()`` run eagerly, then captured."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
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

    def node_types(self, key) -> Counter[str]:
        """The nodes of ``key``'s graph by type (kernel, memcpy, ...)."""
        return graph_census.node_types(self._graphs[key][0].raw_cuda_graph())

    def pool_bytes(self) -> int:
        """Device bytes the graphs' memory pool holds."""
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))


class DecodeEngine:
    """Slot-based continuous-batching decode engine over a Llama model."""

    def __init__(self, params, config: llama.LlamaConfig, *,
                 max_batch: int = 8, max_seq: Optional[int] = None,
                 quantized_kv: bool = True, seed: int = 0,
                 steps_per_sync: int = 8,
                 runtime_cache: Optional[str] = None,
                 speculative: Optional[str] = None, spec_gamma: int = 4,
                 prefill_chunk: Optional[int] = None,
                 ring_kv: bool = False, drop_packed="auto",
                 device="cuda", cuda_graphs: bool = True, mesh=None,
                 window_stage: bool = False):
        """``params`` must live on ``device``. ``quantized_kv``: an int8 KV
        cache (staged within a decode chunk); False keeps K/V in the
        config's dtype (the JAX package's exact-attention mode).
        ``steps_per_sync``: decode steps per host read-back (one decode
        chunk). ``runtime_cache``: an execution cache for every NF4
        weight: "int4" (which kernel K1 streams), "int8" or "bf16" (plain
        torch products, an XLA fusion in the JAX package), or "auto", the
        JAX package's rule: int8 where the cache-only footprint (cache + fp
        + KV + the activation estimate) fits 0.92 of the device's memory,
        else int4, else (with a warning each) None, which serves the
        params as they are (the packed bytes). ``drop_packed``: with a
        runtime cache, free the packed NF4 codes once the cache is built.
        "auto" (the default) drops them only where
        the footprint with them (packed + cache + fp + KV + the serving
        activation estimate) exceeds 0.92 of the device's memory
        (:meth:`footprint`), decided before the cache is built; True and
        False force either way. ``speculative``: "ngram" decodes
        all-greedy and sampled batches by prompt-lookup speculation
        (:mod:`.speculative`), ``spec_gamma`` drafts per verify step; greedy
        output stays that of plain greedy decoding (exactly in f32). A
        batch with a repetition penalty, logprobs, a prefill in flight or
        no room for gamma + 1 more tokens falls back to the decode chunk.
        ``prefill_chunk``: chunked prefill, at least
        16: a prompt longer than this is written into its slot
        ``prefill_chunk`` tokens per engine step, between decode chunks, so
        one long admission cannot stall every running stream for a whole
        prompt's forward. ``ring_kv``: for a model whose every layer has a
        sliding window (Mistral-class), a rolling KV cache of the window
        plus the positions in flight (``steps_per_sync``, ``spec_gamma`` +
        1, ``prefill_chunk``) and one, rounded up to 128: memory and the
        decode read become O(window) instead of O(``max_seq``); refused
        for other configs and where the ring would not be shorter than
        ``max_seq``. ``cuda_graphs``: on a CUDA device, run each decode
        chunk as a CUDA graph replay (:class:`ChunkGraphs`, one graph per
        span bucket, chunk length, all-greedy flag, penalty flag and
        logprobs flag, captured at first use; a verify step, one graph per
        span bucket and all-greedy flag); False runs the same chunk eagerly
        there. CPU devices run it eagerly.

        ``mesh``: a ("dp", "tp") mesh (:func:`~..parallel.make_mesh`) for
        tensor- and data-parallel serving, one process per device, each
        running this engine on the same requests. ``params`` (the whole
        tree, on any device) are sharded onto this rank's device
        (:func:`~..parallel.shard_params`; an int4 cache is built per
        shard), its KV cache holds its dp group's ``max_batch / dp`` slots
        and its ``H_kv / tp`` heads, and the steps run on the shards
        (:mod:`~..parallel.tp`). With dp > 1 admissions prefill one
        request at a time (the owning dp group writes the KV; the others
        receive its logits), with dp = 1 in groups as one device does; each
        chunk's sampled tokens and logprobs are gathered over dp, so every
        rank keeps the same host state and returns the same
        :meth:`generate` output. Fused projections must be laid out for
        the mesh's tp (``quantize_params(tp=)``,
        :func:`~..parallel.sharding.interleave_fused`).
        ``max_batch`` must divide by dp and the head counts by tp. CUDA
        graphs under a mesh need NCCL groups (the graph holds the
        collectives): ``cuda_graphs=True`` on a gloo mesh raises.

        ``window_stage``: stage each decode chunk in a compact window
        (:func:`decode_chunk`'s ``window_stage``; the JAX engine's
        ``TBNB_WINDOW_STAGE=1``). It holds only for an int8 cache that is
        not a ring, and where the footprint plus the window buffers (the
        KV cache's bytes times ``(max_seq + steps_per_sync) / max_seq``)
        fits 0.92 of the device's memory; elsewhere the mode is off.
        ``self.window_stage`` says which was taken."""
        if prefill_chunk is not None and prefill_chunk < 16:
            raise ValueError("prefill_chunk must be >= 16")
        if speculative not in (None, "ngram"):
            raise ValueError(f"unknown speculative mode: {speculative!r}")
        if int(spec_gamma) < 1:
            raise ValueError("spec_gamma must be >= 1")
        if runtime_cache not in (None, "int4", "int8", "bf16", "auto"):
            raise ValueError(f"unknown runtime_cache: {runtime_cache!r} "
                             "(None, 'int4', 'int8', 'bf16' or 'auto')")
        self.config = config
        self.device = torch.device(device)
        self.mesh = mesh
        self._tp = None             # parallel.tp.TPContext under a mesh
        self._shards = (1, 1)       # (tp, dp)
        if mesh is not None:
            self._check_mesh(mesh, max_batch, cuda_graphs)
        n_tp, n_dp = self._shards
        self.max_batch = max_batch
        self.max_seq = max_seq or config.max_seq_len
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.prefill_chunk = prefill_chunk
        self.speculative = speculative
        self.spec_gamma = int(spec_gamma)
        self.spec_stats = {"verify_steps": 0, "drafted": 0, "accepted": 0}
        w = config.sliding_window
        self._fully_windowed = (
            w is not None and config.sliding_window_pattern is None
            and (config.sliding_window_layers is None
                 or all(config.sliding_window_layers)))
        if ring_kv and not self._fully_windowed:
            raise ValueError("ring_kv requires a fully-sliding-window "
                             "config (every layer windowed)")
        slack = max(self.steps_per_sync, self.spec_gamma + 1,
                    prefill_chunk or 0) + 1
        self.ring_size = -(-(w + slack) // 128) * 128 if ring_kv else None
        if ring_kv and self.ring_size >= self.max_seq:
            raise ValueError(
                f"ring_kv is inert: ring {self.ring_size} >= max_seq "
                f"{self.max_seq} (window + in-flight slack leaves nothing "
                f"to roll) — drop ring_kv= or raise max_seq")
        if runtime_cache == "auto":
            runtime_cache = self._auto_runtime_cache(params, quantized_kv)
        self.runtime_cache = runtime_cache
        if runtime_cache is not None:
            drop = drop_packed
            if drop == "auto":
                # from the hypothetical footprint, before the cache exists
                # (building it and then dropping the codes would hold both)
                est = self._footprint_est(params, runtime_cache,
                                          quantized_kv)
                drop = not est["fits"]
                if drop:
                    warnings.warn(
                        "tpu-bitsandbytes: dropping packed NF4 codes — "
                        f"retaining them needs {est['total'] / 2**30:.1f} "
                        f"GiB > {0.92 * est['budget'] / 2**30:.1f} GiB HBM "
                        "budget (pass drop_packed=False to force-retain; "
                        "a dropped engine cannot re-checkpoint NF4)")
            if mesh is None or runtime_cache != "int4":
                params = llama.build_runtime_cache(params, runtime_cache,
                                                   drop_packed=bool(drop))
        if mesh is not None:
            # int4 is built shard by shard, from each rank's NF4 slices
            from ..parallel.sharding import (build_sharded_int4_cache,
                                             shard_params)
            from ..parallel.tp import TPContext
            params = shard_params(params, mesh)
            if runtime_cache == "int4":
                params = build_sharded_int4_cache(params,
                                                  drop_packed=bool(drop))
            self._tp = TPContext(mesh, config)
        self.params = params
        # this rank's slots [lo, hi) of the max_batch the host schedules
        b = max_batch // n_dp
        self._lo = 0 if self._tp is None else self._tp.dp_rank * b
        self._hi = self._lo + b
        self.cache = KVCache.create(config.num_layers, b, self.max_seq,
                                    config.num_kv_heads // n_tp,
                                    config.hd, quantized=quantized_kv,
                                    dtype=config.dtype, device=self.device,
                                    ring_size=self.ring_size)
        # a decode chunk's draws; under a mesh each dp group draws its own
        # stream, and first tokens come from a generator every rank holds
        # in the same state (so every rank samples the same first token)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed if self._tp is None else _dp_seed(seed, self._tp.dp_rank))
        self._first_gen = (self.generator if self._tp is None else
                           torch.Generator(device=self.device).manual_seed(
                               seed))
        # the chunk's static inputs: tokens, active and the seen mask staged
        # through (pinned, on CUDA) host buffers, and the sampling arrays,
        # refilled only when the active set's parameters change
        pin = self.device.type == "cuda"
        vocab = config.vocab_size
        self._tokens_host = torch.zeros((b,), dtype=torch.int32,
                                        pin_memory=pin)
        self._active_host = torch.zeros((b,), dtype=torch.bool,
                                        pin_memory=pin)
        self._seen_host = torch.zeros((b, vocab), dtype=torch.bool,
                                      pin_memory=pin)
        self._tokens = torch.zeros((b,), dtype=torch.int32,
                                   device=self.device)
        self._active = torch.zeros((b,), dtype=torch.bool, device=self.device)
        self._seen = torch.zeros((b, vocab), dtype=torch.bool,
                                 device=self.device)
        self._samp_static = SamplingArrays.build({}, b, device=self.device)
        self._samp_key = None
        # a verify step's static tokens [B, gamma + 1], staged alike
        g1 = self.spec_gamma + 1
        self._vtokens_host = torch.zeros((b, g1), dtype=torch.int32,
                                         pin_memory=pin)
        self._vtokens = torch.zeros((b, g1), dtype=torch.int32,
                                    device=self.device)
        # pinned host copies of the chunks in flight (run_pipelined)
        self._out_ring: List[tuple] = []
        # spans (off until tracer.start()) and counters (always on)
        self.tracer = Tracer(self.device)
        self._graphs = (ChunkGraphs(self.device, self.tracer)
                        if cuda_graphs and pin else None)
        # the JAX engine's gate: the window buffers must fit beside the
        # rest of the footprint
        self.window_stage = (bool(window_stage) and quantized_kv
                             and not self.cache.ring)
        if self.window_stage:
            est = self.footprint()
            win = est["kv"] * (self.max_seq + self.steps_per_sync
                               ) / self.max_seq
            self.window_stage = est["total"] + win <= 0.92 * est["budget"]
        self._uid = 0
        self.waiting: List[Request] = []
        self.active: Dict[int, Request] = {}   # slot -> request
        self.finished: List[Request] = []

    def _check_mesh(self, mesh, max_batch: int, cuda_graphs: bool):
        from ..parallel.mesh import axis_size
        from ..parallel.tp import graphs_allowed
        n_tp, n_dp = axis_size(mesh, "tp"), axis_size(mesh, "dp")
        if max_batch % n_dp != 0:
            raise ValueError(f"max_batch {max_batch} must divide by "
                             f"dp={n_dp}")
        if (cuda_graphs and self.device.type == "cuda"
                and not graphs_allowed(mesh)):
            raise ValueError(
                "cuda_graphs=True under a mesh needs NCCL process groups: a "
                "decode chunk's graph holds its collectives, and gloo's run "
                "on the host. Pass cuda_graphs=False to run the chunks "
                "eagerly over gloo.")
        if mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh serves on "
                             f"{mesh.device_type}, not {self.device}")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._shards = (n_tp, n_dp)

    # -- device-memory budget ---------------------------------------------
    def _footprint_from(self, pf: dict, quantized_kv: bool,
                        kv_bytes_actual: Optional[int] = None,
                        shards=(1, 1)) -> dict:
        """The footprint table from parameter-category bytes: the KV cache
        (its allocation, or what one would take), the serving activation
        estimate, their total, the device's memory as the budget, and
        whether the total fits 0.92 of it. ``shards``: (tp, dp) to divide
        a whole tree's weights (by tp) and KV estimate (by tp * dp) by, as
        the JAX package's per-chip table does."""
        cfg = self.config
        n_tp, n_dp = shards
        kv = kv_bytes_actual
        if kv is None:
            kv = kv_cache_bytes(cfg.num_layers, self.max_batch,
                                min(self.ring_size or self.max_seq,
                                    self.max_seq),
                                cfg.num_kv_heads, cfg.hd, quantized_kv)
        act = serving_act_bytes(cfg, self.max_batch,
                                _bucket(self.max_seq - 1, self.max_seq),
                                self.steps_per_sync)
        return per_device_footprint(pf, kv, act,
                                    device_memory_bytes(self.device),
                                    tp=n_tp, dp=n_dp)

    def _footprint_est(self, params, runtime_cache: Optional[str],
                       quantized_kv: bool) -> dict:
        """The footprint before the runtime cache is built (what
        ``drop_packed="auto"`` decides from), per device under a mesh."""
        return self._footprint_from(
            param_footprint(params, runtime_cache=runtime_cache),
            quantized_kv, shards=self._shards)

    def _auto_runtime_cache(self, params, quantized_kv: bool
                            ) -> Optional[str]:
        """``runtime_cache="auto"``: the JAX engine's rule and warnings.
        Each format's cache-only total (cache + fp + KV + activations, the
        packed codes left out as if dropped) is held against 0.92 of the
        device's memory: int8 if it fits, else int4, else None."""
        def cache_only(fmt):
            est = self._footprint_est(params, fmt, quantized_kv)
            total = sum(est[k] for k in ("exec_cache", "fp", "kv",
                                         "activations_est"))
            return total, est["budget"]

        t8, budget = cache_only("int8")
        if t8 <= 0.92 * budget:
            return "int8"
        t4, budget = cache_only("int4")
        if t4 <= 0.92 * budget:
            warnings.warn(
                "tpu-bitsandbytes: int8 execution cache does not "
                f"fit HBM ({t8 / 2**30:.1f} GiB > "
                f"{0.92 * budget / 2**30:.1f} GiB with "
                "drop_packed) — using the int4 execution cache "
                "(FP4-class int4-linear requantization, measured "
                "proxy ppl +0.18%; pass runtime_cache=None for "
                "bit-exact NF4 via the W4A8 kernel)")
            return "int4"
        warnings.warn(
            "tpu-bitsandbytes: no execution cache fits HBM "
            f"({t4 / 2**30:.1f} GiB int4 > "
            f"{0.92 * budget / 2**30:.1f} GiB) — "
            "serving off packed NF4 bytes (W4A8 decode kernel)")
        return None

    def footprint(self) -> dict:
        """Device memory by category, in bytes: the packed NF4 codes, the
        runtime cache, the fp parameters, the KV cache as allocated, a
        serving activation estimate; their ``total``, the device's memory
        (``budget``: a card's total memory, the host's RAM for a CPU
        engine) and ``fits`` (total within 0.92 of it). Under a mesh,
        what this rank's device holds: its weight shards and its KV cache.
        ``kv`` counts the compact-window stage's buffers once a chunk has
        allocated them (``window_stage``). Render it with
        :func:`~tpu_bitsandbytes_torch.utils.metrics.format_footprint`."""
        c = self.cache
        kv = c.window_bytes() + sum(
            t.numel() * t.element_size()
            for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None)
        return self._footprint_from(param_footprint(self.params),
                                    c.quantized, kv_bytes_actual=kv)

    # -- request management ---------------------------------------------
    def add_request(self, prompt_tokens,
                    sampling: Optional[SamplingParams] = None,
                    on_token: Optional[Callable[[int, int, bool], Any]] = None
                    ) -> int:
        """Queue a prompt. ``on_token(uid, token, done)`` is called for each
        of its emissions as chunks are collected
        (:meth:`generate_stream`)."""
        self._uid += 1
        self.waiting.append(Request(self._uid, [int(t) for t in prompt_tokens],
                                    sampling or SamplingParams(),
                                    on_token=on_token,
                                    t_submit=self.tracer.now()))
        return self._uid

    def cancel(self, uid: int) -> bool:
        """Cancel a request by uid (a client that went away). A waiting
        request never runs; an active or prefilling one is retired on the
        host, and what the device still emits for its slot in the current
        chunk is dropped as ``_collect_chunk`` drops a finished slot's. The
        slot's KV is garbage until the next prefill overwrites it. Returns
        True if the uid was found unfinished."""
        for i, req in enumerate(self.waiting):
            if req.uid == uid:
                req.done = req.cancelled = True
                self.finished.append(self.waiting.pop(i))
                return True
        for slot, req in list(self.active.items()):
            if req.uid == uid:
                req.done = req.cancelled = True
                req.pending_first = None
                del self.active[slot]
                self.finished.append(req)
                return True
        return False

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
            if self._tp is not None:        # this rank's slots
                src = SamplingArrays(*(t[self._lo:self._hi].contiguous()
                                       for t in src.tensors()))
            if self.device.type == "cuda":
                src = SamplingArrays(*(t.pin_memory() for t in src.tensors()))
            self._samp_static.copy_(src)
            self._samp_key = key
        return self._samp_static

    def _needs_seen_mask(self) -> bool:
        return any(r.params.repetition_penalty != 1.0
                   for r in self.active.values())

    def _history_mask(self, rows: List[Optional[Request]]) -> np.ndarray:
        """bool [len(rows), V]: each request's prompt and output tokens (the
        repetition penalty's history); a None row has none."""
        m = np.zeros((len(rows), self.config.vocab_size), bool)
        for i, req in enumerate(rows):
            if req is not None:
                m[i, req.prompt] = True
                m[i, req.generated] = True
        return m

    def _seen_mask(self) -> np.ndarray:
        """bool [B, V]: each decoding slot's history, rebuilt on the host
        for every chunk as the JAX package rebuilds it for every dispatch."""
        return self._history_mask([
            r if r is not None and not r.prefilling else None
            for r in map(self.active.get, range(self.max_batch))])

    # -- admission --------------------------------------------------------
    def _admit(self):
        """Admit waiting requests into free slots. Requests that want
        logprobs, prompts longer than ``prefill_chunk`` and, on a ring
        cache, prompts whose bucket exceeds the ring admit one at a time
        (the batched prefill samples first tokens only, a long prompt goes
        in chunk by chunk, and only a single prefill drops the padding a
        ring would wrap); the rest group by length bucket into one forward
        each. Under a mesh with dp > 1 every request admits alone, as in
        the JAX package (its dp group writes the KV); with dp = 1 every
        rank holds every slot and admits as one device does.

        Notes the waiting count, the free slots and the admitted uids on
        the serving loop's ``engine.admission`` span."""
        free = self._free_slots()
        tr = self.tracer
        if tr.on:
            tr.note("engine.admission", waiting=len(self.waiting),
                    free=len(free))
        groups: Dict[int, list] = {}
        uids = []
        while free and self.waiting:
            slot = free.pop(0)
            req = self.waiting.pop(0)
            req.slot = slot
            req.t_admit = tr.now()
            uids.append(req.uid)
            if len(req.prompt) >= self.max_seq:
                # keep the latest context that still leaves room to decode
                req.prompt = req.prompt[-(self.max_seq - 1):]
            if self._shards[1] > 1 or req.params.logprobs or (
                    self.prefill_chunk is not None
                    and len(req.prompt) > self.prefill_chunk) or (
                    self.cache.ring
                    and _bucket(len(req.prompt), self.max_seq)
                    > self.cache.max_seq):
                self._admit_one(slot, req)
                continue
            groups.setdefault(_bucket(len(req.prompt), self.max_seq),
                              []).append((slot, req))
        for s_pad, grp in sorted(groups.items()):
            if len(grp) == 1:
                self._admit_one(*grp[0])
            else:
                self._admit_group(s_pad, grp)
        tr.note("engine.admission", uids=uids)

    def _admit_one(self, slot: int, req: Request):
        s = len(req.prompt)
        if self.prefill_chunk is not None and s > self.prefill_chunk:
            # the slot is taken now; _advance_prefill writes the prompt
            req.prefilling = True
            req.prefill_pos = 0
            self.active[slot] = req
            return
        s_pad = _bucket(s, self.max_seq)
        with self.tracer.span("engine.prefill_one", device=True, tokens=s,
                              s_pad=s_pad, uid=req.uid):
            toks = torch.zeros((1, s_pad), dtype=torch.int32)
            toks[0, :s] = torch.tensor(req.prompt, dtype=torch.int32)
            last_logits = self._prefill(toks.to(self.device), slot, s)
            req.pending_first = self._sample_first(last_logits, req)
        self.tracer.count("prefill.tokens", s)
        self.tracer.count("prefill.padded_tokens", s_pad)
        self.active[slot] = req

    def _prefill(self, tokens: torch.Tensor, slot: int, true_len: int):
        """Prefill one request into ``slot``: f32 last logits [V] (on
        every rank under a mesh)."""
        if self._tp is None:
            logits, self.cache = prefill_step(self.params, self.cache,
                                              tokens, slot, true_len,
                                              self.config)
            return logits
        from ..parallel.tp import tp_prefill
        logits, self.cache = tp_prefill(self.params, self.cache, tokens,
                                        slot, true_len, self.config, self._tp)
        return logits

    def _prefill_chunk(self, tokens: torch.Tensor, slot: int, start: int,
                       new_len: int, attn_span, attn_start: int):
        """One chunked-prefill step into ``slot``: the chunk's hidden."""
        if self._tp is None:
            x, self.cache = prefill_chunk_step(
                self.params, self.cache, tokens, slot, start, new_len,
                self.config, attn_span=attn_span, attn_start=attn_start)
            return x
        from ..parallel.tp import tp_prefill_chunk
        x, self.cache = tp_prefill_chunk(
            self.params, self.cache, tokens, slot, start, new_len,
            self.config, self._tp, attn_span, attn_start)
        return x

    def _admit_group(self, s_pad: int, grp: list):
        """Prefill a same-bucket group in one forward. R pads to a power of
        two with copies of row 0, whose colliding KV writes are identical."""
        r = len(grp)
        r_pad = 1
        while r_pad < r:
            r_pad *= 2
        true = sum(len(req.prompt) for _, req in grp)
        with self.tracer.span("engine.prefill_group", device=True, rows=r,
                              r_pad=r_pad, s_pad=s_pad, tokens=true,
                              uids=[req.uid for _, req in grp]):
            rows = [grp[i if i < r else 0] for i in range(r_pad)]
            toks = np.zeros((r_pad, s_pad), np.int32)
            for i, (_, req) in enumerate(rows):
                toks[i, :len(req.prompt)] = req.prompt
            dev = self.device
            slots = torch.tensor([slot for slot, _ in rows],
                                 dtype=torch.int32, device=dev)
            lens = torch.tensor([len(req.prompt) for _, req in rows],
                                dtype=torch.int32, device=dev)
            samp = self._samp({i: req.params
                               for i, (_, req) in enumerate(rows)}, r_pad)
            mask = None
            if any(req.params.repetition_penalty != 1.0 for _, req in grp):
                mask = torch.from_numpy(
                    self._history_mask([req for _, req in rows])).to(dev)
            firsts, self.cache = prefill_batch(
                self.params, self.cache, torch.from_numpy(toks).to(dev),
                slots, lens, self._first_gen, samp, self.config,
                seen_mask=mask, tp=self._tp)
        self.tracer.count("prefill.tokens", true)
        self.tracer.count("prefill.padded_tokens", r_pad * s_pad)
        for i, (slot, req) in enumerate(grp):
            req.pending_first = firsts[i]
            self.active[slot] = req

    def _sample_first(self, logits: torch.Tensor, req: Request):
        """A request's first token from its prompt's last logits [V], with
        its repetition penalty over the prompt; with ``logprobs`` its
        logprob too (``pending_first_lp``). Both stay device scalars."""
        mask = None
        if req.params.repetition_penalty != 1.0:
            mask = torch.from_numpy(self._history_mask([req])).to(self.device)
        tok = sample(logits[None, :], self._first_gen, req.params, mask)[0]
        if req.params.logprobs:
            req.pending_first_lp = _token_logprob(logits, tok)
        return tok

    def _advance_prefill(self) -> bool:
        """Run one chunk of the oldest chunked prefill. Its final chunk
        takes the prompt's last logits (the lm_head once per admission),
        samples the first token and makes the request decodable. Returns
        True if a chunk ran."""
        pre = [(slot, r) for slot, r in self.active.items() if r.prefilling]
        if not pre:
            return False
        slot, req = min(pre, key=lambda sr: sr[1].uid)
        c, n = self.prefill_chunk, len(req.prompt)
        start = req.prefill_pos
        end = min(start + c, n)
        if self.cache.ring:
            span, a_start = None, 0
        else:
            span = _chunk_span_bucket(start + c, self.max_seq)
            a_start = self._win_start(start)
        with self.tracer.span("engine.prefill_chunk", device=True,
                              start=start, end=end, span=span, uid=req.uid):
            toks = torch.zeros((1, c), dtype=torch.int32)
            toks[0, :end - start] = torch.tensor(req.prompt[start:end],
                                                 dtype=torch.int32)
            x = self._prefill_chunk(toks.to(self.device), slot, start, end,
                                    span, a_start)
            req.prefill_pos = end
            if end >= n:
                logits = prefill_final_logits(self.params, x, n - 1 - start,
                                              self.config, tp=self._tp)
                req.pending_first = self._sample_first(logits, req)
                req.prefilling = False
        self.tracer.count("prefill.tokens", end - start)
        self.tracer.count("prefill.padded_tokens", c)
        return True

    # -- decode -------------------------------------------------------------
    def _win_start(self, upto: int) -> int:
        """The KV read's lower bound for a query at position ``upto`` in a
        fully-windowed model, in buckets of 1024 (a small set of graph
        keys); 0 for every other model."""
        if not self._fully_windowed:
            return 0
        return max(0, (upto - self.config.sliding_window) // 1024 * 1024)

    def _attn_window(self, extra_steps: int = 0):
        """(attn_start, attn_span) of the next decode chunk. A
        fully-windowed model reads from the shortest decoding slot's
        position minus the window (bucketed); a model with global layers
        reads from 0; a ring cache reads the whole ring: (0, None)."""
        if self.cache.ring:
            return 0, None
        span = self._attn_span(extra_steps)
        shortest = min((len(r.prompt) + len(r.generated)
                        for r in self.active.values() if not r.prefilling),
                       default=0)
        return self._win_start(shortest), span

    def _attn_span(self, extra_steps: int = 0) -> int:
        """Span bucket covering every decoding slot's position plus the
        chunk. ``extra_steps``: steps dispatched but not yet collected (a
        pipeline's host bookkeeping lags the device by that many)."""
        longest = max((len(r.prompt) + len(r.generated)
                       for r in self.active.values() if not r.prefilling),
                      default=0)
        return _span_bucket(longest + extra_steps + self.steps_per_sync,
                            self.max_seq)

    def _host_inputs(self):
        """This chunk's (tokens [B], active [B]) from host bookkeeping,
        consuming the first tokens (and logprobs) that prefill produced.
        Prefilling slots stay inactive. Traced as ``engine.first_tokens``:
        its first read waits for the prefill."""
        tokens = np.zeros((self.max_batch,), np.int32)
        active = np.zeros((self.max_batch,), bool)
        with self.tracer.span("engine.first_tokens"):
            for slot, req in list(self.active.items()):
                if req.prefilling:
                    continue
                if req.pending_first is not None:
                    first = int(req.pending_first)
                    lp = (None if req.pending_first_lp is None
                          else float(req.pending_first_lp))
                    req.pending_first = req.pending_first_lp = None
                    self._collect(slot, req, first, lp)
                    if req.done:
                        continue
                tokens[slot] = req.generated[-1]
                active[slot] = True
        return tokens, active

    def _collect_chunk(self, toks_seq, act_seq, lp_seq=None) -> int:
        """Hand a chunk's emissions to their requests; returns how many
        (counted in ``engine.decode_tokens`` and noted on the serving
        loop's ``engine.collect`` span)."""
        toks_seq = toks_seq.cpu().numpy()
        act_seq = act_seq.cpu().numpy()
        if lp_seq is not None:
            lp_seq = lp_seq.cpu().numpy()
        emitted = 0
        for i in range(toks_seq.shape[0]):
            for slot in list(self.active.keys()):
                req = self.active.get(slot)
                if req is None or not act_seq[i, slot]:
                    continue
                self._collect(slot, req, int(toks_seq[i, slot]),
                              None if lp_seq is None else lp_seq[i, slot])
                emitted += 1
        self.tracer.count("engine.decode_tokens", emitted)
        self.tracer.note("engine.collect", tokens=emitted)
        return emitted

    def _collect(self, slot: int, req: Request, token: int, lp=None):
        req.generated.append(token)
        if len(req.generated) == 1:
            req.t_first = self.tracer.now()
        sp = req.params
        if sp.logprobs and lp is not None:
            req.logprobs.append(float(lp))
        gen = req.generated
        out_of_room = len(req.prompt) + len(gen) >= self.max_seq - 1
        hit_stop = any(len(gen) >= len(st) and tuple(gen[-len(st):]) ==
                       tuple(st) for st in sp.stop)
        if ((sp.eos_token_id is not None and token == sp.eos_token_id)
                or len(gen) >= sp.max_new_tokens or out_of_room or hit_stop):
            req.done = True
            self.finished.append(req)
            del self.active[slot]
        if req.on_token is not None:
            req.on_token(req.uid, token, req.done)

    def run_chunk(self, tokens: np.ndarray, active: np.ndarray, *,
                  all_greedy: bool, attn_span: Optional[int],
                  seen: Optional[np.ndarray] = None,
                  want_logprobs: bool = False, attn_start: int = 0):
        """One decode chunk of ``steps_per_sync`` steps from host
        ``tokens`` int32 [B] and ``active`` bool [B], staged into the static
        device inputs without a host sync. ``seen`` bool [B, V]: the
        repetition penalty's history, staged into the engine's static seen
        mask, which the chunk then updates on the device; None runs without
        a penalty. ``attn_start`` and ``attn_span``: the KV read's window
        (:meth:`_attn_window`). On CUDA (unless the engine was built with
        ``cuda_graphs=False``) the chunk replays the graph of ``(attn_span,
        steps_per_sync, all_greedy, penalty, want_logprobs, attn_start)``,
        captured at the key's first use. Returns the device (tokens_seq,
        active_seq, logprobs_seq or None) [steps, B]; read them before the
        next chunk, which may overwrite them. Under a mesh the device
        inputs hold this rank's slots, and the outputs every slot. Traced
        as ``engine.stage`` (the staging), then :meth:`_dispatch`."""
        with self.tracer.span("engine.stage"):
            lo, hi = self._lo, self._hi
            self._tokens_host.numpy()[:] = tokens[lo:hi]
            self._active_host.numpy()[:] = active[lo:hi]
            self._tokens.copy_(self._tokens_host, non_blocking=True)
            self._active.copy_(self._active_host, non_blocking=True)
            if seen is not None:
                self._seen_host.numpy()[:] = seen[lo:hi]
                self._seen.copy_(self._seen_host, non_blocking=True)
            self._samp_arrays()
        return self._dispatch(all_greedy=all_greedy, attn_span=attn_span,
                              penalty=seen is not None,
                              want_logprobs=want_logprobs,
                              attn_start=attn_start)

    def _dispatch(self, *, all_greedy: bool, attn_span: Optional[int],
                  penalty: bool, want_logprobs: bool, attn_start: int = 0):
        """One decode chunk from the static device inputs as they stand
        (tokens, active, seen mask, sampling arrays). The chunk leaves its
        last tokens and active flags in the static tokens and active, so a
        pipeline's next chunk continues from them on the device.

        Counted (:meth:`_count_chunk`)."""
        n = self.steps_per_sync
        samp = self._samp_static
        key = (attn_span, n, all_greedy, penalty, want_logprobs, attn_start)
        self._count_chunk(key)

        def chunk():
            toks_seq, act_seq, _, last, live, lp_seq, _ = decode_chunk(
                self.params, self.cache, self._tokens, self._active,
                self.generator, samp, self.config, n_steps=n,
                all_greedy=all_greedy, attn_span=attn_span,
                seen_mask=self._seen if penalty else None,
                want_logprobs=want_logprobs, attn_start=attn_start,
                tp=self._tp, window_stage=self.window_stage)
            self._tokens.copy_(last)
            self._active.copy_(live)
            if self._tp is not None:        # every dp group's slots
                g = self._tp.gather_dp
                return g(toks_seq, 1), g(act_seq, 1), g(lp_seq, 1)
            return toks_seq, act_seq, lp_seq

        if self._graphs is None:
            return chunk()
        return self._graphs.run(key, chunk,
                                None if all_greedy else self.generator)

    def _count_chunk(self, key) -> None:
        """Count a decode chunk or verify step in ``engine.chunks``, and
        note on the serving loop's ``engine.dispatch`` span its graph key
        and how it runs ("replay", "capture" or "eager")."""
        tr = self.tracer
        tr.count("engine.chunks")
        if tr.on:
            how = ("eager" if self._graphs is None else
                   "replay" if key in self._graphs else "capture")
            tr.note("engine.dispatch", key=key, graph=how)

    def run_verify(self, tokens: np.ndarray, active: np.ndarray, *,
                   all_greedy: bool, attn_span: Optional[int]):
        """One speculative verify step from host ``tokens`` int32 [B,
        gamma + 1] (each slot's last token and its drafts) and ``active``
        bool [B], staged like :meth:`run_chunk`'s inputs. On CUDA (unless
        ``cuda_graphs=False``) it replays the graph of ``("verify",
        attn_span, gamma, all_greedy)``, captured at the key's first use.
        Returns the device (emitted [B, gamma + 1], counts [B]) of
        :func:`~.speculative.verify_step`; the lengths advance in place.
        Staged under ``engine.stage`` and counted as a decode chunk
        (:meth:`_count_chunk`)."""
        tr = self.tracer
        key = ("verify", attn_span, self.spec_gamma, all_greedy)
        gen = None if all_greedy else self.generator
        samp = self._samp_static

        def verify():
            emitted, counts, _ = spec.verify_step(
                self.params, self.cache, self._vtokens, self._active, gen,
                samp, self.config, attn_span=attn_span,
                all_greedy=all_greedy, tp=self._tp)
            if self._tp is not None:
                return self._tp.gather_dp(emitted), self._tp.gather_dp(counts)
            return emitted, counts

        self._count_chunk(key)
        with tr.span("engine.stage"):
            self._vtokens_host.numpy()[:] = tokens[self._lo:self._hi]
            self._active_host.numpy()[:] = active[self._lo:self._hi]
            self._vtokens.copy_(self._vtokens_host, non_blocking=True)
            self._active.copy_(self._active_host, non_blocking=True)
            self._samp_arrays()
        if self._graphs is None:
            return verify()
        return self._graphs.run(key, verify, gen)

    def graph_stats(self) -> dict:
        """Graphs captured, seconds spent capturing them (their eager
        first chunks excluded) and the bytes of their memory pool."""
        g = self._graphs
        if g is None:
            return {"graphs": 0, "capture_s": 0.0, "pool_bytes": 0}
        return {"graphs": len(g), "capture_s": g.capture_s,
                "pool_bytes": g.pool_bytes()}

    def graph_keys(self) -> List[tuple]:
        """The keys of the graphs captured so far, in capture order: a
        decode chunk's (attn_span, n_steps, all_greedy, penalty,
        want_logprobs, attn_start), a verify step's ("verify", attn_span,
        gamma, all_greedy)."""
        return [] if self._graphs is None else self._graphs.keys()

    def graph_kernel_names(self, attn_span: Optional[int],
                           all_greedy: bool = True, penalty: bool = False,
                           want_logprobs: bool = False,
                           attn_start: int = 0) -> Counter[str]:
        """The kernels one replay of the chunk graph of that key launches,
        by demangled name, read from the graph."""
        return self._graphs.kernel_names(
            (attn_span, self.steps_per_sync, all_greedy, penalty,
             want_logprobs, attn_start))

    def verify_kernel_names(self, attn_span: Optional[int],
                            all_greedy: bool = True) -> Counter[str]:
        """The kernels one replay of the verify graph of that key launches,
        by demangled name, read from the graph."""
        return self._graphs.kernel_names(
            ("verify", attn_span, self.spec_gamma, all_greedy))

    def step(self) -> bool:
        """One engine iteration: admit, one chunk of a chunked prefill,
        then one decode chunk (or, speculative, one verify step). Returns
        False when no work remains. Traced as ``engine.admission``, then
        ``engine.dispatch`` (a verify step's takes in its drafts and its
        read-back) and ``engine.collect``."""
        tr = self.tracer
        with tr.span("engine.admission"):
            self._admit()
            if not self.active:
                return bool(self.waiting)
            # one chunk of a chunked prefill runs before each decode chunk
            self._advance_prefill()
            tokens, active = self._host_inputs()
            if not active.any():
                return bool(self.waiting or self.active)
            reqs = self.active.values()
            all_greedy = all(r.params.temperature <= 0 for r in reqs)
            want_lp = any(r.params.logprobs for r in reqs)
            verify = (self.speculative == "ngram"
                      and not self._needs_seen_mask()
                      and not want_lp and not any(r.prefilling for r in reqs)
                      and max(len(r.prompt) + len(r.generated) for r in reqs)
                      + self.spec_gamma + 1 < self.max_seq - 1)
        with tr.span("engine.dispatch", device=True) as sp:
            if verify:
                emitted, counts = self._speculative_step(tokens, active,
                                                         all_greedy)
            else:
                a_start, span = self._attn_window()
                seen = self._seen_mask() if self._needs_seen_mask() else None
                outs = self.run_chunk(
                    tokens, active, all_greedy=all_greedy, attn_span=span,
                    seen=seen, want_logprobs=want_lp, attn_start=a_start)
            if sp is not None:
                # after the launch, which it would delay
                sp.attrs.update(self._kv_in_use(0))
        with tr.span("engine.collect"):
            if not verify:
                self._collect_chunk(*outs)
                return bool(self.waiting or self.active)
            n_emit = 0
            for slot in list(self.active.keys()):
                if not active[slot]:
                    continue
                for j in range(int(counts[slot])):
                    req = self.active.get(slot)
                    if req is None:
                        break
                    self._collect(slot, req, int(emitted[slot, j]))
                    n_emit += 1
            tr.count("engine.decode_tokens", n_emit)
            tr.note("engine.collect", tokens=n_emit)
        return bool(self.waiting or self.active)

    def _speculative_step(self, tokens: np.ndarray, active: np.ndarray,
                          all_greedy: bool):
        """One prompt-lookup verify: drafts proposed per slot on the host,
        scored in one verify step. Returns host (emitted [B, gamma + 1],
        counts [B])."""
        g = self.spec_gamma
        drafts = np.zeros((self.max_batch, g), np.int32)
        for slot, req in self.active.items():
            hist = req.prompt + req.generated
            prop = spec.propose_ngram(hist, g)
            # padded with self-repeats (cheap to reject) to keep the shape;
            # the padding is fed to the verifier and can be accepted, so it
            # counts as drafted
            self.spec_stats["drafted"] += g
            drafts[slot] = prop + [hist[-1]] * (g - len(prop))
        toks = np.concatenate([tokens[:, None], drafts], axis=1)
        longest = max(len(r.prompt) + len(r.generated)
                      for r in self.active.values())
        emitted, counts = self.run_verify(
            toks, active, all_greedy=all_greedy,
            attn_span=(None if self.cache.ring
                       else _span_bucket(longest + g + 1, self.max_seq)))
        emitted, counts = emitted.cpu().numpy(), counts.cpu().numpy()
        self.spec_stats["verify_steps"] += 1
        self.spec_stats["accepted"] += int(np.clip(counts - 1, 0, None).sum())
        return emitted, counts

    # -- warm-up: the graphs and shapes serving will meet -------------------
    def warmup_plan(self, prompt_lengths: Optional[List[int]] = None,
                    group_sizes: tuple = (), features: tuple = ()) -> dict:
        """What :meth:`warmup` will run, in the JAX package's terms:
        {"prefill_buckets", "group_sizes", "chunk_pairs" ((span, start) of
        each chunked-prefill step), "decode_windows" ((start, span) of each
        decode chunk), "variants", "n_compiles"}. Each decode window and
        variant is one decode-chunk graph (:meth:`plan_graph_keys`);
        ``n_compiles`` counts those graphs and the prefill and chunk shapes
        warm-up runs once, so a caller can bound warm-up before paying for
        it. Chunk spans bucket geometrically above 2048
        (:func:`_chunk_span_bucket`), which bounds the pairs."""
        buckets = sorted({_bucket(s, self.max_seq)
                          for s in (prompt_lengths
                                    or [16, self.max_seq - 1])})
        plan = {"prefill_buckets": buckets,
                "group_sizes": tuple(group_sizes)}
        if self.prefill_chunk is not None:
            c = self.prefill_chunk
            if self.cache.ring:
                pairs = {(None, 0)}
            else:
                pairs = {(_chunk_span_bucket(st + c, self.max_seq),
                          self._win_start(st))
                         for b in buckets for st in range(0, b, c)}
            plan["chunk_pairs"] = sorted(pairs,
                                         key=lambda p: (p[0] or 0, p[1]))
        else:
            plan["chunk_pairs"] = []
        if self.cache.ring:
            plan["decode_windows"] = [(0, None)]
        else:
            plan["decode_windows"] = sorted(
                {(self._win_start(b),
                  _span_bucket(b + self.steps_per_sync, self.max_seq))
                 for b in buckets} | {(0, 128)})
        variants = [dict(all_greedy=True)]
        if "sampled" in features:
            variants.append(dict(all_greedy=False))
        if "logprobs" in features:
            variants.append(dict(all_greedy=True, want_logprobs=True))
        if "penalty" in features:
            variants.append(dict(all_greedy=True, seen_mask="mask"))
        plan["variants"] = variants
        plan["n_compiles"] = (
            len(buckets) * (1 + len(group_sizes))
            + len(plan["chunk_pairs"])
            + (1 if self.prefill_chunk is not None else 0)  # final logits
            + len(plan["decode_windows"]) * len(variants))
        return plan

    def plan_graph_keys(self, plan: dict) -> List[tuple]:
        """The decode-chunk graph keys (attn_span, n_steps, all_greedy,
        penalty, want_logprobs, attn_start) of a :meth:`warmup_plan`: its
        decode windows times its variants, in warm-up order ("sampled" is
        ``all_greedy=False``, "penalty" a seen mask, "logprobs"
        ``want_logprobs``)."""
        return [(span, self.steps_per_sync, var["all_greedy"],
                 "seen_mask" in var, var.get("want_logprobs", False), start)
                for start, span in plan["decode_windows"]
                for var in plan["variants"]]

    def warmup(self, prompt_lengths: Optional[List[int]] = None,
               group_sizes: tuple = (), features: tuple = ()) -> dict:
        """Run, ahead of the first request, what serving would otherwise
        pay for at first use: on a card, build and load every kernel and
        capture the decode-chunk graph of every key the given prompt
        lengths reach (default: the buckets up to ``max_seq``); run the
        prefill of each bucket (and, batched, of each padded
        ``group_sizes`` entry), each chunked-prefill step and its final
        logits once. ``features``: a subset of {"sampled", "logprobs",
        "penalty"}, each a variant of every decode graph. The exact set is
        :meth:`warmup_plan`.

        Runs on the engine's own cache and static inputs, so the graphs
        replay against them; afterwards every slot's length is zero again
        and the generator is in the state it was. Refuses an engine that
        holds requests. Returns the plan with ``"seconds"``, the warm-up's
        wall time."""
        if self.waiting or self.active:
            raise RuntimeError("warmup needs an engine without requests")
        t0 = time.perf_counter()
        plan = self.warmup_plan(prompt_lengths, group_sizes, features)
        if self.device.type == "cuda":
            _build.load_all()
        rng_state = self.generator.get_state()
        dev, b = self.device, self.max_batch
        for s_pad in plan["prefill_buckets"]:
            toks = torch.zeros((1, s_pad), dtype=torch.int32, device=dev)
            self._prefill(toks, 0, 1)
            # batched-admission shapes (a mesh over dp groups admits one
            # request at a time)
            for r_pad in group_sizes if self._shards[1] == 1 else ():
                prefill_batch(
                    self.params, self.cache,
                    torch.zeros((r_pad, s_pad), dtype=torch.int32,
                                device=dev),
                    torch.zeros((r_pad,), dtype=torch.int32, device=dev),
                    torch.ones((r_pad,), dtype=torch.int32, device=dev),
                    self.generator, self._samp({}, r_pad), self.config,
                    tp=self._tp)
        if self.prefill_chunk is not None:
            toks = torch.zeros((1, self.prefill_chunk), dtype=torch.int32,
                               device=dev)
            for span, a_start in plan["chunk_pairs"]:
                x = self._prefill_chunk(toks, 0, 0, 1, span, a_start)
            prefill_final_logits(self.params, x, 0, self.config,
                                 tp=self._tp)
        zeros = np.zeros((b,), np.int32)
        ones = np.ones((b,), bool)
        for (span, _, greedy, penalty, want_lp,
             a_start) in self.plan_graph_keys(plan):
            # each chunk from empty slots (at a window's start), so span
            # covers every position
            self.cache.lengths.fill_(a_start)
            self.run_chunk(
                zeros, ones, all_greedy=greedy, attn_span=span,
                seen=(np.zeros((b, self.config.vocab_size), bool)
                      if penalty else None),
                want_logprobs=want_lp, attn_start=a_start)
        self.cache.lengths.zero_()
        self.generator.set_state(rng_state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        plan["seconds"] = time.perf_counter() - t0
        return plan

    # -- failure recovery: snapshot and restart ---------------------------
    def save_state(self, path: str) -> None:
        """Snapshot what a token-identical restart needs, in the JAX
        package's file format (:mod:`~..utils.checkpoint`): the KV cache
        (codes, scales, lengths), the generator's state (the JAX engine's
        PRNG key), the uid counter and every waiting, active and finished
        request with its bookkeeping (prefill position, logprobs, a first
        token not yet emitted). The parameters are not included, nor
        ``on_token`` callbacks. Under a mesh each rank writes its own
        file (:func:`rank_path`): its KV shard and its generators."""
        def enc_req(r: Request) -> dict:
            return {"uid": r.uid, "prompt": list(r.prompt),
                    "sampling": dataclasses.asdict(r.params),
                    "generated": list(r.generated), "slot": r.slot,
                    "done": r.done, "cancelled": r.cancelled,
                    "prefilling": r.prefilling, "prefill_pos": r.prefill_pos,
                    "logprobs": list(r.logprobs),
                    "pending_first": None if r.pending_first is None
                    else int(r.pending_first),
                    "pending_first_lp": None if r.pending_first_lp is None
                    else float(r.pending_first_lp)}

        c = self.cache
        dtype = c.k.dtype if not c.quantized else self.config.dtype
        extra = {}
        if self._tp is not None:
            path = rank_path(path)
            extra["first_generator"] = self._first_gen.get_state()
        save_checkpoint(path, {**extra,
            "cache": {"k": c.k, "v": c.v, "k_scale": c.k_scale,
                      "v_scale": c.v_scale, "lengths": c.lengths,
                      "quantized": c.quantized, "ring": c.ring,
                      "max_positions": c.max_positions,
                      "dtype": str(dtype).replace("torch.", "")},
            "generator": self.generator.get_state(), "uid": self._uid,
            "waiting": [enc_req(r) for r in self.waiting],
            "active": {str(s): enc_req(r) for s, r in self.active.items()},
            "finished": [enc_req(r) for r in self.finished],
        })

    def load_state(self, path: str) -> None:
        """Restore a :meth:`save_state` snapshot into this engine (same
        model, batch, ``max_seq`` and cache mode); decoding resumes
        token-identically. The snapshot is copied into the engine's own
        cache tensors and generator, so graphs captured before the load
        replay against the restored state. Under a mesh each rank reads
        the file its rank wrote (:func:`rank_path`)."""
        def dec_req(d: dict) -> Request:
            sd = dict(d["sampling"])
            sd["stop"] = tuple(tuple(st) for st in sd.get("stop", ()))
            return Request(uid=int(d["uid"]), prompt=list(d["prompt"]),
                           params=SamplingParams(**sd),
                           generated=list(d["generated"]), slot=d["slot"],
                           done=bool(d["done"]),
                           cancelled=bool(d["cancelled"]),
                           prefilling=bool(d["prefilling"]),
                           prefill_pos=int(d["prefill_pos"]),
                           logprobs=list(d["logprobs"]),
                           pending_first=d["pending_first"],
                           pending_first_lp=d["pending_first_lp"])

        st = load_checkpoint(path if self._tp is None else rank_path(path))
        snap, c = st["cache"], self.cache
        if (bool(snap["quantized"]) != c.quantized
                or bool(snap["ring"]) != c.ring):
            raise ValueError("load_state: the snapshot's cache mode differs "
                             "from this engine's")
        for name in ("k", "v", "k_scale", "v_scale", "lengths"):
            dst, src = getattr(c, name), snap[name]
            if dst is None:
                continue
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(f"load_state: cache {name} "
                                 f"{tuple(src.shape)} {src.dtype}, this "
                                 f"engine's {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)
        self.generator.set_state(st["generator"])
        if self._tp is not None:
            self._first_gen.set_state(st["first_generator"])
        self._uid = int(st["uid"])
        self.waiting = [dec_req(d) for d in st["waiting"]]
        self.active = {int(s): dec_req(d) for s, d in st["active"].items()}
        self.finished = [dec_req(d) for d in st["finished"]]
        self._samp_key = None

    # -- pipelined dispatch -------------------------------------------------
    def _to_host(self, outs, i: int):
        """A chunk's outputs (tokens_seq, active_seq, logprobs_seq or None),
        to be read on the host without blocking the next dispatch: on a
        card, copied into the ``i``-th set of pinned buffers on the current
        stream (ahead of the next replay, which overwrites a graph's
        outputs), with the event that marks the copy's end; on the CPU as
        they are."""
        if self.device.type != "cuda":
            return outs, None
        while len(self._out_ring) <= i:
            self._out_ring.append(tuple(
                torch.empty((self.steps_per_sync, self.max_batch),
                            dtype=dt, pin_memory=True)
                for dt in (torch.int32, torch.bool, torch.float32)))
        host = self._out_ring[i]
        for dst, src in zip(host, outs):
            if src is not None:
                dst.copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return (host[0], host[1], None if outs[2] is None else host[2]), event

    def run_pipelined(self, depth: int = 2) -> None:
        """Drive all queued work to completion with up to ``depth`` decode
        chunks in flight.

        :meth:`step` waits for each chunk before it stages the next, so the
        host's read-back and bookkeeping take turns with the device. Here
        chunk k+1 is dispatched from chunk k's carry on the device (the
        cache, the static tokens and active flags, the seen mask and the
        generator never come back to the host), then chunk k's outputs,
        copied to pinned host buffers, are collected while the device works.

        The pipeline drains, and the host admits, when a request finishes
        while others wait for a slot, and to advance a chunked prefill: the
        delay to admission is bounded by ``depth`` chunks. No chunk is
        dispatched once the chunks in flight reach every active request's
        token budget (the JAX package's loop dispatches one more, whose
        tokens are all dropped). A slot whose
        request the host retires mid-flight (``max_new_tokens``, a stop
        sequence) keeps decoding on the device until the drain; its
        emissions are dropped and its KV is overwritten by the next prefill
        into the slot. Token-identical to the :meth:`step` loop for greedy
        requests. A speculative engine runs the step loop.

        Traced (:attr:`tracer`) so that its spans cover the loop's body:
        ``engine.admission`` from the top of the loop to the burst's first
        dispatch, ``engine.dispatch`` per chunk with the KV in use
        (:meth:`_kv_in_use`), ``engine.collect`` per chunk collected with
        its ``engine.collect_wait``, and ``engine.drain`` for the chunks
        left in flight, with the reason the burst ended
        (:meth:`_burst_end`).
        """
        if self.speculative:
            while self.step():
                pass
            return
        n = self.steps_per_sync
        tr = self.tracer
        while True:
            with tr.span("engine.admission"):
                self._admit()
                if not self.active:
                    if not self.waiting:
                        return
                    continue
                self._advance_prefill()
                tokens, active = self._host_inputs()
                if not active.any():
                    if not (self.waiting or self.active):
                        return
                    continue
                reqs = self.active.values()
                all_greedy = all(r.params.temperature <= 0 for r in reqs)
                want_lp = any(r.params.logprobs for r in reqs)
                seen = self._seen_mask() if self._needs_seen_mask() else None
            inflight: collections.deque = collections.deque()
            dispatched = 0          # steps in flight, not yet collected
            k = 0                   # chunks dispatched in this burst
            why = None              # why the burst ends
            while why is None:
                with tr.span("engine.dispatch", device=True) as sp:
                    a_start, span = self._attn_window(extra_steps=dispatched)
                    if k == 0:
                        outs = self.run_chunk(tokens, active,
                                              all_greedy=all_greedy,
                                              attn_span=span, seen=seen,
                                              want_logprobs=want_lp,
                                              attn_start=a_start)
                    else:
                        outs = self._dispatch(all_greedy=all_greedy,
                                              attn_span=span,
                                              penalty=seen is not None,
                                              want_logprobs=want_lp,
                                              attn_start=a_start)
                    inflight.append(self._to_host(outs, k % depth))
                    if sp is not None:
                        # after the launch, which it would delay
                        sp.attrs.update(self._kv_in_use(dispatched))
                    k += 1
                    dispatched += n
                    full = len(inflight) == depth
                    if not full:
                        why = self._budget_in_flight(dispatched)
                if full:
                    with tr.span("engine.collect"):
                        self._collect_host(*inflight.popleft())
                        dispatched -= n
                        why = self._burst_end(dispatched)
            with tr.span("engine.drain", reason=why):
                while inflight:
                    with tr.span("engine.collect"):
                        self._collect_host(*inflight.popleft())

    def _burst_end(self, dispatched: int) -> Optional[str]:
        """Why a pipelined burst of decode chunks ends after a collection,
        or None to dispatch on: no request is active ("idle"); a slot is
        free while requests wait ("slot_free": a request can also retire
        at ``_host_inputs``, before any chunk finishes it); a chunked
        prefill is advancing ("prefill"); or the ``dispatched`` steps in
        flight reach every request's token budget ("budget")."""
        if not self.active:
            return "idle"
        if self.waiting and len(self.active) < self.max_batch:
            return "slot_free"
        if any(r.prefilling for r in self.active.values()):
            return "prefill"
        return self._budget_in_flight(dispatched)

    def _budget_in_flight(self, dispatched: int) -> Optional[str]:
        """"budget" once the chunks in flight end every request (the JAX
        package's loop dispatches one more, whose tokens are all dropped),
        else None."""
        if dispatched and all(self._steps_left(r) <= dispatched
                              for r in self.active.values()):
            return "budget"
        return None

    def _kv_in_use(self, extra_steps: int) -> dict:
        """KV positions the slots hold at a decode chunk's start, from the
        host's bookkeeping alone (no device read): each decoding request's
        prompt and emitted tokens but the last (the chunk's first input)
        and ``extra_steps`` in flight, each prefilling request's
        ``prefill_pos``, each at most the cache's S axis (the ring's size
        in ring mode); against the S axis of every slot."""
        s = self.cache.max_seq
        used = sum(min(r.prefill_pos if r.prefilling else
                       len(r.prompt) + len(r.generated) - 1 + extra_steps, s)
                   for r in self.active.values())
        return {"kv_used": used, "kv_reserved": self.max_batch * s}

    def _steps_left(self, req: Request) -> int:
        """Decode steps after which ``req`` ends at the latest (its token
        budget, or the cache's room)."""
        used = len(req.generated)
        return min(req.params.max_new_tokens - used,
                   self.max_seq - 1 - len(req.prompt) - used)

    def _collect_host(self, outs, event) -> int:
        if event is not None:
            with self.tracer.span("engine.collect_wait"):
                event.synchronize()
        return self._collect_chunk(*outs)

    def _add_all(self, prompts, sampling, on_token=None) -> List[int]:
        """Queue every prompt. ``sampling``: one SamplingParams for all
        prompts, or one each."""
        if sampling is None or isinstance(sampling, SamplingParams):
            sampling = [sampling] * len(prompts)
        if len(sampling) != len(prompts):
            raise ValueError(f"{len(sampling)} sampling params for "
                             f"{len(prompts)} prompts")
        return [self.add_request(p, sp, on_token)
                for p, sp in zip(prompts, sampling)]

    def generate(self, prompts: List[List[int]], sampling=None,
                 pipeline_depth: int = 2) -> List[List[int]]:
        """Run every prompt to completion: through :meth:`run_pipelined`
        with ``pipeline_depth`` chunks in flight, or with
        ``pipeline_depth=1`` through the :meth:`step` loop. ``sampling``:
        one SamplingParams for all prompts, or one each."""
        uids = self._add_all(prompts, sampling)
        if pipeline_depth > 1:
            self.run_pipelined(pipeline_depth)
        else:
            while self.step():
                pass
        by_uid = {r.uid: r.generated for r in self.finished}
        return [by_uid[u] for u in uids]

    def generate_stream(self, prompts: List[List[int]], sampling=None
                        ) -> Iterator[tuple]:
        """Yield ``(uid, token, done)`` in emission order as chunks are
        collected (the tokens :meth:`generate` gives). The uids are the
        generator's return value."""
        events: List[tuple] = []
        uids = self._add_all(prompts, sampling,
                             lambda u, t, d: events.append((u, t, d)))
        while self.step():
            while events:
                yield events.pop(0)
        while events:
            yield events.pop(0)
        return uids

    @property
    def stats(self) -> dict:
        """Requests active, waiting and finished, the KV cache's bytes per
        token, ``tokens`` (the decode chunks' emissions, the tracer's
        ``engine.decode_tokens``) and, speculative, the verify counts."""
        out = {"active": len(self.active), "waiting": len(self.waiting),
               "finished": len(self.finished),
               "kv_bytes_per_token": self.cache.bytes_per_token(),
               "tokens": self.tracer.counts["engine.decode_tokens"]}
        if self.speculative:
            out["speculative"] = dict(self.spec_stats)
        return out
