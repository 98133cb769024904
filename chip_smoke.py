"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure raises: traceback, nonzero exit):
  1. header: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 off for matmuls and cuDNN, bf16 GEMMs reduce in f32.
  2. kernels: builds every kernel from ``tpu_bitsandbytes_torch/csrc`` and
     holds each against its plain PyTorch version on the card, at the
     shapes the served paths give it (Llama-2-7B for K1/K2, Llama-2-13B
     for K2/K3/K4/K5, Mixtral-8x7B's five matmul shapes for K4 at M = 1,
     8, 32, 64 and for K5 at M = 128, 256) and at odd ones (K2: spans of 128 to 8192 keys, rep
     8, a span past the single-block shared memory limit, an all-masked slot
     beside live ones, window + softcap); times kernel (device time, replayed
     from a CUDA graph), plain version, the one PyTorch call that computes
     the same function where there is one (SDPA for K3), for K5
     ``torch.matmul`` by its already-decoded bf16 weight (``gemm_ms``, a
     yardstick of the product alone) and the route, and the least time
     the card could take (bytes over HBM bandwidth, or operations over the
     peak for their type, whichever is larger). K4 is timed at decode M=8
     and at the 32/64 prefill buckets; K2 at the 7B step and at the 13B step
     at phase 5's last positions (``ms_13b_step``); K3 at the 13B path's
     two prefills and at d = 256 (64-key tiles) at one Gemma-7B layer
     (16 heads of 256, S = 2048), which no served path here runs.
  3. (run after phase 11a, in this process while phase 12a's ranks serve
     on the card; its card runs are not timed) full width against the
     CPU: a Llama-2-7B-width model with the int4
     cache, and (3b) a Llama-2-13B-width model off its packed NF4 bytes,
     each cut to 2 layers and built once from a numpy seed, run prefill
     and 8 staged decode steps on the card (kernels) and on the CPU (plain
     versions), both bf16. 3b runs the card twice: fed the CPU's
     activation at every K4 call, and on its own A8 codes, held to the
     CPU's own bf16-vs-f32 gap. 3c: 3b's model takes a 600-token prompt
     as three 256-token prefill chunks (K5 at M = 256, then K4 for the
     lm_head at M = 1) on the card and the CPU: hidden states and (fed the
     CPU's K4 input) final logits within E2E_TOL.
  4. Llama-2-7B at its 32 layers, random NF4 weights from a seed, served by
     ``DecodeEngine.generate`` (int4 runtime cache, B=8, 32-step chunks)
     for 8 requests of 16-200 prompt tokens and 64 greedy new tokens each.
  5. Llama-2-13B at its 40 layers, random NF4 weights from a seed, served
     off the packed bytes (``runtime_cache=None``, B=8, ``max_seq`` 2048,
     32-step chunks) for 8 prompts of 24-1800 tokens with 48 greedy new
     tokens each: K4 for decode and the 32/64 buckets, K5 for 128/256, K3
     and the plain GEMM for 1024/2048; each admission group's prefill timed.
     Phases 4 and 5 serve each workload twice on an engine whose decode
     chunks are CUDA graph replays (``cuda_graphs=True``, the default; the
     first pass captures the graphs, the second is timed), then once on
     one that launches the same chunks from the host. Greedy tokens must
     be identical between the two, request by request. Each mode then runs
     one more 32-step chunk at the slots' final positions: host ms per
     step, device busy ms per step (profiler kernel records, graph
     replays included) and idle share, the device's span (CUDA events),
     and launches per step, which must be 129 K1 + 32 K2 (7B) and 161 K4
     + 40 K2 (13B) on both paths, by the counters (a graph's holder adds
     its capture's counts at each replay) and, graphed, by the kernel
     nodes of the chunk's graph alike; then one eager decode step there, counted alone,
     whose wrapper-counted launches must be the same and whose logits
     must be finite. The kernels line's launches are the eager pass's,
     counted by the wrappers; the graphed pass's must equal them. Each
     mode's line has graphs captured, capture seconds, the graph pool's
     MiB and peak device memory. Phase 4 also counts the kernels one
     decode-shaped matmul launches besides K1 (the A8 quantization), and
     records teacher-forced logits of its graphed engine on its greedy
     tokens for phase 12.
  6. The request API on phase 5's model cut to its first 10 layers
     (``prefill_chunk`` 256): nine requests (phase 5's prompts and a queued 300-token one) with
     repetition penalties, logprobs, a sampled request and a cancel,
     streamed through ``generate_stream`` on a graphed engine (pass A); the
     same prompts all greedy on that engine and on an eager one (pass B:
     tokens identical, logprobs within 1e-5, 41 K4 + 10 K2 per step of a
     penalty-and-logprobs chunk by the counters and by its graph's nodes);
     five of them on a bf16 KV cache (pass C: no K2, 41 K4 per step,
     served once eager and twice graphed, tokens identical to eager);
     every 256-token chunk 80 K5 launches on the wgmma kernel and every
     final chunk 1 K4; then the
     1800-token prompt chunked against one bucket-2048 ``prefill_step``
     (K3) in both cache modes. Each pass prints its chunk ms, decode step
     ms beside and without a prefill chunk, graph keys, capture seconds,
     pool MiB and peak memory.
  7. The engine's lifecycle on phase 4's model: ``footprint()`` against
     the allocations, ``warmup`` (the graphs captured are the plan's keys;
     phase 4's tokens after it), a snapshot after 2 steps loaded back into
     the warmed engine (tokens equal the uninterrupted run's), pipelined
     ``generate`` against the step loop (64 new tokens), and
     ``speculative="ngram"`` (a verify step held at every position
     against decode steps fed the same tokens); the path's launches from
     an eager drive.
  8. ``runtime_cache="auto"`` on phase 5's model (its first 10 layers) and
     prompts: "auto" must
     pick the int8 cache (``footprint()``), keep the packed codes, and
     serve graphed and eager, as phases 4-5, with
     identical tokens, one K2 per layer and no K1, K4
     or K5 launch per decode step (counters and graph nodes), K3 for the
     1024/2048 buckets; then one graphed serving of the prompts of at
     most 256 tokens through the bf16 cache. Phase 2 times the int8 and
     bf16 caches' product (plain torch, not a TPU kernel: an XLA fusion in
     JAX) for one 7B and one 13B decode step against its bound
     (``cache_dots``); phase 3d builds both caches for 3b's model on the
     card and the CPU (bit-identical) and holds the logits of a prefill
     and 8 decode steps at E2E_TOL.
  9. The bitsandbytes-style API at Llama-2-7B widths, from one numpy
     seed: ``quantize_model`` (NF4 with double quantization, then int8) of
     one decoder layer's seven projections and the embedding (converted,
     cosine > 0.95 to the dense model, not equal to it); Linear4bit (nf4,
     fp4) at M = 1, 8, 128 (one K5 launch each) and 512 (none); Linear8bit,
     LinearFP8, OutlierAwareLinear and the 4-bit and int8 embeddings
     against their CPU twins; SwitchBackLinear's gradients equal to a
     dense Linear's; a ``state_dict`` round trip.
  10. QLoRA training at Llama-2-7B width (32 layers, random packed NF4
     weights at blocksize 64 drawn on the card, bf16, no runtime cache;
     LoRA r 8, alpha 16 on q_proj and v_proj): 4 steps of
     ``make_qlora_train_step`` (adam8bit(1e-4)) on one seeded 1 x 257
     batch, every frozen linear's forward on K5's wgmma kernel at M = 256
     (225 launches a step, counted by the wrapper against the tree), losses
     finite and falling, ``lora_B`` non-zero after step 1; a ``remat``
     step and gradients equal to the plain ones bit for bit (the layers'
     recomputed forwards counted too); a step at 2 x 513 (M = 1024, no
     K5); a ``PagedAdamW`` step on the LoRA leaves, its states in pinned
     host memory; then 2 layers of full width, 2 steps on the card against
     the CPU (loss, LoRA gradients, parameters, 8-bit codes) and the
     trained tree through ``save_checkpoint``/``load_checkpoint`` (logits
     identical). Each step's line has its time, peak memory and 8-bit
     state bytes beside the card's name and power limit.
  11. The model families. (a) Mixtral-8x7B at its 32 layers and 8
     experts (top-2, rope theta 1e6), random packed NF4 weights from a
     seed, served off the packed bytes (B=8, ``max_seq`` 2048, 16-step
     chunks, phase 5's prompts, 48 greedy new tokens) graphed and eager
     as phase 5: tokens identical, 577 K4 + 32 K2 per decode step by the
     counters and the graph's nodes, K4 for the 32/64 buckets, K5 on its
     wgmma kernel for 128/256 (2 x 577), K3 for 1024/2048 (2 x 32),
     ``footprint()`` equal to the allocations. (b) Mixtral at full width,
     2 layers, one 128-token prompt (K5 at M = 128 in every expert and
     the lm_head: the prefill's logits are the card's own) and 4 decode
     steps against the CPU, the card fed the CPU's K4 inputs and experts:
     routing flips counted with the CPU's top-2 gap (a flip at a gap of
     1e-2 or more fails), every K4 input but o_proj's (K2's output) and
     all logits within E2E_TOL, each K2 call against its plain version.
     (c) Gemma2-9B at full width, 2 layers (layer 0 windowed at 4,096),
     one 4,400-token prompt through K3 and 16 decode steps through K2 (d
     = 256, softcap 50, scale 256^-0.5; final softcap 30, tied
     256,000-row embedding) against the CPU: hidden states and logits
     within E2E_TOL of its bf16 run, and of its f32 run within E2E_TOL
     plus the CPU's own bf16-vs-f32 gap; K3's and K2's calls of that run
     against their plain versions and timed. The CPU references of (b)
     and (c) run in phase 11 itself, after every timed phase.
  12. Tensor parallelism (``parallel/``, ``DecodeEngine(mesh=)``). The
     card is one, so a tp = 2 mesh is two processes on it over gloo
     (``--mesh-rank``; each reports through a file, only this process
     prints; a rank's failure or the time limit fails the phase). (a)
     Phase 4's model and requests at tp = 2 (fused rows re-laid for the
     mesh, the int4 cache built per shard, chunks eager): 129 K1 + 32 K2
     per decode step on each rank, K1 at each shard shape within K1_TOL of
     its plain version, a row shard's A8 codes equal to the unsharded
     row's, teacher-forced logits on phase 4's tokens within E2E_TOL of
     phase 4's (which phase 4 records on its graphed engine), and greedy
     tokens equal to phase 4's up to any position where phase 4's top-2
     gap is below ``TP_TIE_GAP``; step ms and tokens/s of two processes
     sharing one card through host-staged collectives (not a scaling
     number). (b) Llama-2-13B at full width, 4 layers, off the packed
     bytes, tp = 2: prompts in the 64, 256 and 1024 buckets (K4, K5, K3
     on shard shapes) and 8 forced decode steps against the same layers on
     one device here computing o_proj and down_proj as the shards do (K4
     quantizes each K slice with its own A8 scale, as JAX's shards do):
     the ranks take that run's activation at every K4 call (as phase 3b),
     their own K4 inputs but o_proj's and their logits within E2E_TOL;
     reported, how far the per-shard scales move the plain single-device
     run's logits, beside its own bf16-vs-f32 gap; each kernel's first
     call per shard shape against its plain version. (c) A one-rank NCCL group in
     this process: phase 4's model at 8 layers served graphed through
     ``mesh=make_mesh(tp=1)`` (the chunk graphs capture the collectives)
     with tokens identical to the plain graphed engine's, capture s and
     step ms of both, their graphs' nodes by type.

Prints JSON lines; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA card it exits with code 2 and prints no result.
"""

import atexit
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

K1_TOL = 1e-5   # exact int32 block dots; only the f32 sum order differs
K2_TOL = 1e-3   # one flipped p code where an exp rounds differently
# of each query row's own max|ref| (a long row's outputs are far below the
# first rows'): bf16 p and outputs that round differently on the card;
# one bf16 ulp of an output is at most 2^-7 of its row's max
K3_TOL = 1e-2
K4_TOL = 1e-5   # exact int32 block dots; only the f32 sum order differs
# f32: exact products, another sum order; bf16: the same bf16 operands (each
# weight rounded once), another f32 sum order (a weight rounded twice, or to
# f16, would miss it)
K5_TOL = {"f32": 1e-5, "bf16": 1e-4}
E2E_TOL = 3e-2  # bf16 logits and activations, card vs CPU, of max|ref|


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_rates(name: str):
    """(HBM bytes/s, dense int8 ops/s, dense bf16 FLOP/s) of the H100
    variant ``name``."""
    if "PCIe" in name:
        return 2.0e12, 1513e12, 756e12
    return 3.35e12, 1979e12, 989e12


def time_ms(calls, iters: int) -> float:
    """Mean ms per call over ``iters`` calls cycling through ``calls``
    (closures over distinct buffers, so operands come from HBM, not L2),
    launched from the host: for the plain versions."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_CAPTURE_STREAM = []


def time_graph_ms(calls, iters: int) -> float:
    """Device ms per call of ``iters`` calls cycling through ``calls``,
    captured in one CUDA graph after a warm-up call each and replayed: the
    host's launch cost (Python, ctypes) is not counted, so a kernel's time
    stands against its bound. The warm-up runs on the capture stream (one
    for every timing graph), so the split-K scratch it needs exists before
    the capture."""
    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    stream = _CAPTURE_STREAM[0]
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for c in calls:
            c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    # the scratch kept for this stream's earlier graphs, all deleted (a
    # tree from before release_held needs none released)
    from tpu_bitsandbytes_torch.ops import _build
    if hasattr(_build, "release_held"):
        _build.release_held(stream)
    return ms


def err(got, ref):
    got, ref = got.float(), ref.float()
    abs_err = (got - ref).abs().max().item()
    return abs_err, abs_err / max(ref.abs().max().item(), 1e-30)


def row_err(got, ref):
    """Worst |got - ref| over each row of the last axis, as a share of that
    row's max|ref|."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().amax(-1)
            / ref.abs().amax(-1).clamp(min=1e-30)).max().item()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# (name, N, K, launches per decode step) at Llama-2-7B, fused projections
K1_DECODE = [("qkv", 12288, 4096, 32), ("o", 4096, 4096, 32),
             ("gateup", 22016, 4096, 32), ("down", 4096, 11008, 32),
             ("lm_head", 32000, 4096, 1)]
# (M, N, K): other decode widths, a prefill-sized M, prime and odd N, K=384,
# and a speculative verify step's M = B x (gamma + 1) = 40
K1_EXTRA = [(1, 4096, 4096), (3, 4099, 4096), (64, 4096, 4096),
            (8, 2053, 11008), (3, 1013, 384), (13, 127, 384),
            (40, 4096, 4096)]
VERIFY_M = 40       # phase 7's verify step: B = 8 slots x (gamma + 1 = 5)


def k1_inputs(m, n, k, gen, dev, copies=1):
    kp = -(-k // 128) * 128
    nb = kp // 128
    xq = torch.randint(-127, 128, (m, kp), generator=gen, device=dev,
                       dtype=torch.int16).to(torch.int8)
    s_x = torch.rand((m,), generator=gen, device=dev) * 0.05 + 1e-3
    ws = [(torch.randint(0, 256, (n, kp // 2), generator=gen, device=dev,
                         dtype=torch.uint8),
           torch.rand((nb, n), generator=gen, device=dev) * 0.01 + 1e-3)
          for _ in range(copies)]
    return xq, s_x, ws


def k1_bound_ms(m, n, kp, bw, int8_peak):
    nb = kp // 128
    nbytes = n * kp // 2 + 4 * n * nb + m * kp + 4 * m + 4 * m * n
    ops = 2 * m * n * kp
    return max(nbytes / bw, ops / int8_peak) * 1e3, (
        "bytes" if nbytes / bw >= ops / int8_peak else "operations")


def phase_kernels_k1(K1, gen, dev, bw, int8_peak):
    worst = [0.0, 0.0]
    rows = []
    for m, n, k in K1_EXTRA + [(mm, n, k) for _, n, k, _ in K1_DECODE
                               for mm in (8, VERIFY_M)]:
        xq, s_x, ((w, sc),) = k1_inputs(m, n, k, gen, dev)
        got = K1.int4_mm(xq, w, sc, s_x)
        ref = K1.int4_mm_plain(xq, w, sc, s_x)
        torch.cuda.synchronize()
        a, r = err(got, ref)
        if not (r <= K1_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"K1 M={m} N={n} K={k}: rel err {r}")
        worst = [max(worst[0], a), max(worst[1], r)]
    # one decode step (M = 8) and one verify step (M = 40) at Llama-2-7B
    total = {m: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
             for m in (8, VERIFY_M)}
    for m in (8, VERIFY_M):
        for name, n, k, per_step in K1_DECODE:
            w_bytes = n * k // 2
            copies = max(2, math.ceil(200e6 / w_bytes))
            xq, s_x, ws = k1_inputs(m, n, k, gen, dev, copies)
            kern = time_graph_ms([lambda w=w, sc=sc: K1.int4_mm(xq, w, sc,
                                                                s_x)
                                  for w, sc in ws], iters=max(40, 2 * copies))
            plain = time_ms([lambda: K1.int4_mm_plain(xq, *ws[0], s_x)],
                            iters=3)
            bound, by = k1_bound_ms(m, n, k, bw, int8_peak)
            rows.append({"shape": f"{name} M={m} N={n} K={k}",
                         "kernel_ms": kern, "plain_ms": plain,
                         "bound_ms": bound, "bound_by": by,
                         "per_step": per_step})
            for key, v in (("ms", kern), ("plain_ms", plain),
                           ("bound_ms", bound)):
                total[m][key] += per_step * v
            del ws
    emit({"phase": "kernels", "kernel": "K1_int4_matmul", "shapes": rows})
    verify, total = total[VERIFY_M], total[8]
    return {
        "name": "K1_int4_matmul", "route": "cuda",
        "source": "tpu_bitsandbytes_torch/csrc/int4_matmul.cu",
        "replaces": "tpu_bitsandbytes/ops/int4cache.py:137",
        "shape": "one decode step at Llama-2-7B, M=8: 32 x (qkv 12288x4096, "
                 "o 4096x4096, gateup 22016x4096, down 4096x11008) + lm_head "
                 "32000x4096",
        "max_abs_err": worst[0], "max_rel_err": worst[1],
        "ms": total["ms"], "kernel_ms": total["ms"],
        "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "verify_step": {
            "shape": f"one speculative verify step at Llama-2-7B, "
                     f"M={VERIFY_M} (B=8, gamma=4): the same 129 matmuls",
            # phase 7 puts its verify graph's K1 launches here
            "launches_per_step": None, **verify, "bound_by": "bytes"}}


def k2_inputs(gen, dev, *, layers, b, h, h_kv, d, s, span, c, start=0):
    """A cache-shaped int8 KV with span views, a stage, q and positions."""
    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int16).to(torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 1.5 + 0.5

    kc, vc = codes(layers, b, h_kv, s, d), codes(layers, b, h_kv, s, d)
    ksc, vsc = scales(layers, b, h_kv, s), scales(layers, b, h_kv, s)
    stk, stv = codes(layers, b, h_kv, c, d), codes(layers, b, h_kv, c, d)
    stks, stvs = scales(layers, b, h_kv, c), scales(layers, b, h_kv, c)
    q = (torch.randn((b, h, d), generator=gen, device=dev) * 0.3).to(
        torch.bfloat16)
    len0 = torch.randint(max(start, span // 3), span - c, (b,),
                         generator=gen, device=dev, dtype=torch.int32)
    sl = slice(start, span)
    per_layer = [((kc[li, :, :, sl], ksc[li, :, :, sl], vc[li, :, :, sl],
                   vsc[li, :, :, sl]), (stk[li], stks[li], stv[li], stvs[li]))
                 for li in range(layers)]
    return q, len0, per_layer


def k2_bound_ms(keys, b, h, h_kv, d, bw, int8_peak):
    """``keys``: the keys the masks keep, summed over the B slots (codes
    and scales of K and V read once per kv head; q in, f32 out)."""
    nbytes = 2 * h_kv * keys * (d + 4) + b * h * d * (2 + 4) + 4 * b
    ops = 4 * h * keys * d
    return max(nbytes / bw, ops / int8_peak) * 1e3


def k2_kept_keys(off, step, span, c):
    """Keys the masks keep at these positions: each slot's main keys up to
    ``off - step - 1`` (``step`` the stage's last filled row), and the
    stage's ``step + 1``."""
    main = (off - step).clamp(min=0, max=span)
    return int(main.sum()) + off.shape[0] * min(c, step + 1)


def phase_kernels_k2(K2, gen, dev, bw, int8_peak):
    worst = [0.0, 0.0]
    final_13b = [p + 47 for p in PACKED_PROMPTS]   # phase 5's last step
    cases = [  # (geometry, step, options, offsets or None for random)
        (dict(b=8, h=32, h_kv=32, d=128, s=512, span=384, c=32), 31, {}, None),
        (dict(b=8, h=32, h_kv=32, d=128, s=512, span=384, c=32), 0, {}, None),
        (dict(b=8, h=32, h_kv=32, d=128, s=512, span=384, c=32), None, {},
         None),
        (dict(b=4, h=32, h_kv=8, d=128, s=512, span=256, c=32), 7, {}, None),
        (dict(b=3, h=8, h_kv=4, d=64, s=128, span=96, c=16), 5,
         dict(window=40, softcap=30.0), None),
        (dict(b=2, h=8, h_kv=4, d=128, s=512, span=512, c=8, start=128), 3,
         dict(kpos_start=128), None),
        # short, medium and long spans; rep 8; past the single-block limit
        (dict(b=4, h=16, h_kv=16, d=128, s=256, span=128, c=32), 31, {},
         None),
        (dict(b=3, h=32, h_kv=4, d=128, s=1024, span=600, c=16), 5, {},
         None),
        (dict(b=2, h=32, h_kv=4, d=128, s=8192, span=8192, c=8), 7, {},
         None),
        (dict(b=8, h=40, h_kv=40, d=128, s=2048, span=1920, c=32), 31, {},
         final_13b),
        # an all-masked slot (off = 5 below kpos_start) beside live ones
        (dict(b=3, h=16, h_kv=8, d=128, s=768, span=768, c=8, start=128),
         None, dict(kpos_start=128), [5, 300, 700]),
        (dict(b=2, h=16, h_kv=8, d=128, s=768, span=700, c=16), 9,
         dict(window=300, softcap=30.0), None),
    ]
    for geo, step, opts, offs in cases:
        q, len0, ((kv, st),) = k2_inputs(gen, dev, layers=1, **geo)
        if offs is not None:
            off = torch.tensor(offs, dtype=torch.int32, device=dev)
        else:
            off = len0 + (0 if step is None else step)
        staged = None if step is None else st + (step,)
        got = K2.flash_decode_attention(q, *kv, off, staged=staged, **opts)
        if staged is None:      # the dummy block the wrapper passes the kernel
            zeros = torch.zeros((geo["b"], geo["h_kv"], 8, geo["d"]),
                                dtype=torch.int8, device=dev)
            ones = torch.ones((geo["b"], geo["h_kv"], 8), device=dev)
            plain_st = (zeros, ones, zeros, ones, -1)
        else:
            plain_st = staged
        ref = K2.flash_decode_plain(
            q, *kv, off, *plain_st, scale=1.0 / geo["d"] ** 0.5,
            window=opts.get("window"), kpos_start=opts.get("kpos_start", 0),
            softcap=opts.get("softcap"))
        torch.cuda.synchronize()
        a, r = err(got, ref)
        if not (r <= K2_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"K2 {geo} step={step} {opts}: rel err {r}")
        worst = [max(worst[0], a), max(worst[1], r)]
        del q, kv, st
    rows = []
    # Llama-2-7B: 32 layers, span 384
    geo = dict(b=8, h=32, h_kv=32, d=128, s=512, span=384, c=32)
    q, len0, layers = k2_inputs(gen, dev, layers=8, **geo)
    off = len0 + 31
    kern = time_graph_ms([lambda kv=kv, st=st: K2.flash_decode_attention(
        q, *kv, off, staged=st + (31,)) for kv, st in layers], iters=64)
    kv, st = layers[0]
    plain = time_ms([lambda: K2.flash_decode_plain(
        q, *kv, off, *st, 31, scale=1.0 / 128 ** 0.5, window=None,
        kpos_start=0, softcap=None)], iters=3)
    kept = k2_kept_keys(off, 31, 384, 32)
    bound = k2_bound_ms(kept, 8, 32, 32, 128, bw, int8_peak)
    bound_span = k2_bound_ms(8 * (384 + 32), 8, 32, 32, 128, bw, int8_peak)
    rows.append({"shape": "7B: B=8 H=32 H_kv=32 D=128 T=384 C=32",
                 "kept_keys": kept, "cluster": K2.cluster_size(1, 384, 32, 128, 8, 32, dev),
                 "kernel_ms": kern, "plain_ms": plain, "bound_ms": bound,
                 "bound_span_ms": bound_span, "per_step": 32})
    del q, layers, kv, st
    # Llama-2-13B at phase 5's last step: 40 layers, span 1920, the slots
    # at PACKED_PROMPTS + 48 tokens (8 distinct layers, cycled)
    geo = dict(b=8, h=40, h_kv=40, d=128, s=2048, span=1920, c=32)
    q, _, layers = k2_inputs(gen, dev, layers=8, **geo)
    off = torch.tensor(final_13b, dtype=torch.int32, device=dev)
    kern13 = time_graph_ms([lambda kv=kv, st=st: K2.flash_decode_attention(
        q, *kv, off, staged=st + (31,)) for kv, st in layers], iters=80)
    kv, st = layers[0]
    plain13 = time_ms([lambda: K2.flash_decode_plain(
        q, *kv, off, *st, 31, scale=1.0 / 128 ** 0.5, window=None,
        kpos_start=0, softcap=None)], iters=3)
    kept13 = k2_kept_keys(off, 31, 1920, 32)
    bound13 = k2_bound_ms(kept13, 8, 40, 40, 128, bw, int8_peak)
    bound13_span = k2_bound_ms(8 * (1920 + 32), 8, 40, 40, 128, bw,
                               int8_peak)
    rows.append({"shape": "13B: B=8 H=40 H_kv=40 D=128 T=1920 C=32",
                 "kept_keys": kept13, "cluster": K2.cluster_size(1, 1920, 32, 128, 8, 40, dev),
                 "kernel_ms": kern13, "plain_ms": plain13,
                 "bound_ms": bound13, "bound_span_ms": bound13_span,
                 "per_step": 40})
    del q, layers, kv, st
    emit({"phase": "kernels", "kernel": "K2_flash_decode", "shapes": rows})
    return {
        "name": "K2_flash_decode", "route": "cuda",
        "source": "tpu_bitsandbytes_torch/csrc/flash_decode.cu",
        "replaces": "tpu_bitsandbytes/ops/flash_decode.py:48",
        "shape": "one decode step at Llama-2-7B: 32 x (B=8 H=32 H_kv=32 "
                 "D=128 T=384 C=32); ms_13b_step: one at Llama-2-13B, 40 x "
                 "(B=8 H=40 D=128 T=1920 C=32) at phase 5's last positions",
        "max_abs_err": worst[0], "max_rel_err": worst[1],
        "ms": 32 * kern, "kernel_ms": 32 * kern, "plain_ms": 32 * plain,
        "bound_ms": 32 * bound, "bound_by": "bytes", "library_ms": None,
        "ms_13b_step": 40 * kern13, "plain_ms_13b_step": 40 * plain13,
        "bound_13b_step_ms": 40 * bound13,
        "bound_span_13b_step_ms": 40 * bound13_span}


# (name, N, K, launches per decode step) at Llama-2-13B, fused projections
K4_DECODE = [("qkv", 15360, 5120, 40), ("o", 5120, 5120, 40),
             ("gateup", 27648, 5120, 40), ("down", 5120, 13824, 40),
             ("lm_head", 32000, 5120, 1)]
# (M, N, K, blocksize): other decode widths, prefill buckets, blocksizes
# 128, 32 and 2048 (a block longer than the kernel's chunk), odd N and M
K4_EXTRA = [(1, 5120, 5120, 128), (64, 27648, 5120, 64),
            (8, 15360, 5120, 128), (32, 5120, 13824, 64),
            (3, 256, 512, 16), (33, 5120, 5120, 32), (9, 1000, 4096, 2048)]
K4_M = (8, 32, 64)   # decode, and the 32/64 prefill buckets
# (name, N, K) of Mixtral-8x7B's matmuls (fused qkv, each expert's fused
# gate/up and its down): phase 11's K4 shapes (M = 1 in 11b, 8 in 11a's
# decode, 32/64 in its prefill buckets) and K5 shapes (M = 128/256)
MIXTRAL_NK = [("qkv", 6144, 4096), ("o", 4096, 4096),
              ("gateup", 28672, 4096), ("down", 4096, 14336),
              ("lm_head", 32000, 4096)]


def packed_inputs(n, k, bs, gen, dev, copies=1):
    """Random packed NF4 codes [N, K/2] and absmax [N, K/bs], ``copies``
    times."""
    return [(torch.randint(0, 256, (n, k // 2), generator=gen, device=dev,
                           dtype=torch.uint8),
             torch.rand((n, k // bs), generator=gen, device=dev) * 0.03
             + 0.005) for _ in range(copies)]


def packed_bytes(n, k, bs):
    return n * k // 2 + 4 * n * (k // bs)


def phase_kernels_k4(K4, gen, dev, bw, int8_peak):
    def inputs(m, k):
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int16).to(torch.int8)
        return xq, torch.rand((m,), generator=gen, device=dev) * 0.05 + 1e-3

    worst = [0.0, 0.0]
    for m, n, k, bs in (K4_EXTRA
                        + [(8, n, k, 64) for _, n, k, _ in K4_DECODE]
                        + [(m, n, k, 64) for m in (1,) + K4_M
                           for _, n, k in MIXTRAL_NK]):
        xq, s_x = inputs(m, k)
        ((w, am),) = packed_inputs(n, k, bs, gen, dev)
        got = K4.w4a8_mm(xq, w, am, s_x)
        ref = K4.w4a8_mm_plain(xq, w, am, s_x)
        torch.cuda.synchronize()
        a, r = err(got, ref)
        if not (r <= K4_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"K4 M={m} N={n} K={k} bs={bs}: rel err {r}")
        worst = [max(worst[0], a), max(worst[1], r)]
    rows = []
    # M=8: one decode step; M=32/64: one prefill of those buckets (161
    # launches each, as many as a decode step)
    totals = {m: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
              for m in K4_M}
    for name, n, k, per_step in K4_DECODE:
        copies = max(2, math.ceil(200e6 / packed_bytes(n, k, 64)))
        ws = packed_inputs(n, k, 64, gen, dev, copies)
        for m in K4_M:
            xq, s_x = inputs(m, k)
            kern = time_graph_ms(
                [lambda w=w, am=am: K4.w4a8_mm(xq, w, am, s_x)
                 for w, am in ws], iters=max(40, 2 * copies))
            plain = time_ms([lambda: K4.w4a8_mm_plain(xq, *ws[0], s_x)],
                            iters=3)
            nbytes = packed_bytes(n, k, 64) + m * k + 4 * m + 4 * m * n
            ops = 2 * m * n * k
            bound = max(nbytes / bw, ops / int8_peak) * 1e3
            rows.append({"shape": f"{name} M={m} N={n} K={k}",
                         "kernel_ms": kern, "plain_ms": plain,
                         "bound_ms": bound, "x_bound": kern / bound,
                         "bound_by": "bytes" if nbytes / bw >= ops / int8_peak
                         else "operations", "per_step": per_step})
            for key, val in (("ms", kern), ("plain_ms", plain),
                             ("bound_ms", bound)):
                totals[m][key] += per_step * val
        del ws
    emit({"phase": "kernels", "kernel": "K4_w4a8_matmul", "shapes": rows,
          "per_161_launches": {f"M={m}": t for m, t in totals.items()}})
    total = totals[8]
    return {
        "name": "K4_w4a8_matmul", "route": "cuda",
        "source": "tpu_bitsandbytes_torch/csrc/w4a8_matmul.cu",
        "replaces": "tpu_bitsandbytes/ops/w4a8.py:92",
        "shape": "one decode step at Llama-2-13B, M=8, blocksize 64: 40 x "
                 "(qkv 15360x5120, o 5120x5120, gateup 27648x5120, down "
                 "5120x13824) + lm_head 32000x5120",
        "max_abs_err": worst[0], "max_rel_err": worst[1],
        "ms": total["ms"], "kernel_ms": total["ms"],
        "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "prefill_buckets": {f"M={m}": totals[m] for m in K4_M[1:]}}


def k5_bound(m, n, k, bs, bw, bf16_peak):
    nbytes = packed_bytes(n, k, bs) + 2 * m * k + 4 * m * n
    ops = 2 * m * n * k
    return (max(nbytes / bw, ops / bf16_peak) * 1e3,
            "bytes" if nbytes / bw >= ops / bf16_peak else "operations")


def dequant_bf16(w, am, book):
    """The bf16 weight [N, K] K5 multiplies by: book[code] * absmax in f32,
    rounded once."""
    scale = am.repeat_interleave(2 * w.shape[1] // am.shape[1], dim=1)
    codes = torch.stack([w & 15, w >> 4], dim=-1).reshape(w.shape[0], -1)
    return (book[codes.long()] * scale).to(torch.bfloat16)


def phase_kernels_k5(K5, TF, gen, dev, bw, bf16_peak):
    shapes13 = [(n, k) for _, n, k, _ in K4_DECODE]
    cases = ([(m, n, k, 64, "nf4", "bf16") for m in (65, 128, 256)
              for n, k in shapes13]
             + [(m, n, k, 64, "nf4", "bf16") for m in (128, 256)
                for _, n, k in MIXTRAL_NK]
             + [(128, 1000, 4032, 64, qt, mode) for qt in ("nf4", "fp4")
                for mode in ("bf16", "f32")]
             + [(65, 5120, 5120, 64, "nf4", "f32"),
                (256, 15360, 5120, 64, "fp4", "bf16"),
                # the wgmma kernel's narrowest tokens, K_pad half a stage
                # past a whole one with blocks of 32; the ragged bf16 kernel
                (1, 5120, 5120, 64, "nf4", "bf16"),
                (129, 5120, 4064, 32, "nf4", "bf16"),
                (100, 131, 200, 8, "nf4", "bf16")])
    worst = {"bf16": [0.0, 0.0], "f32": [0.0, 0.0]}
    routes = {}

    def x_of(m, k, mode):
        x = torch.randn((m, k), generator=gen, device=dev)
        return x.to(torch.bfloat16 if mode == "bf16" else torch.float32)

    for m, n, k, bs, qt, mode in cases:
        ((w, am),) = packed_inputs(n, k, bs, gen, dev)
        x = x_of(m, k, mode)
        book = TF.codebook(qt, dev)
        got = K5.matmul4bit_mm(x, w, am, book, mode)
        ref = K5.matmul4bit_plain(x, w, am, book, mode)
        torch.cuda.synchronize()
        a, r = err(got, ref)
        route = K5.kernel_of(m, n, k, bs, mode)
        if not (r <= K5_TOL[mode] and torch.isfinite(got).all()):
            raise AssertionError(f"K5 M={m} N={n} K={k} bs={bs} {qt} {mode} "
                                 f"({route}): rel err {r}")
        worst[mode] = [max(worst[mode][0], a), max(worst[mode][1], r)]
        routes[route] = routes.get(route, 0) + 1
    if set(routes) != {"wgmma", "bf16", "f32"}:
        raise AssertionError(f"K5 cases reached {routes}")
    # double-quantized absmax through the wrapper (K = 4000: K padding)
    w = torch.randn((1000, 4000), generator=gen, device=dev) * 0.05
    packed, st = TF.quantize_4bit(w, blocksize=64, compress_statistics=True)
    x = torch.randn((100, 4000), generator=gen, device=dev).to(torch.bfloat16)
    got = K5.fused_matmul_4bit(x, packed, st, mxu_dtype=torch.bfloat16)
    am = TF.dequantize_blockwise(st.absmax, st.state2).reshape(1000, -1)
    ref = K5.matmul4bit_plain(torch.nn.functional.pad(x, (0, 32)),
                              packed.reshape(1000, -1), am,
                              TF.codebook("nf4", dev), "bf16")
    torch.cuda.synchronize()
    a, r = err(got, ref.to(got.dtype))
    if not r <= K5_TOL["bf16"]:
        raise AssertionError(f"K5 double-quant wrapper: rel err {r}")
    rows = []
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "gemm_ms": 0.0}
    book = TF.codebook("nf4", dev)
    for m in (128, 256):   # the two K5 prefill buckets of the served path
        for name, n, k, per_prefill in K4_DECODE:
            copies = max(2, math.ceil(200e6 / packed_bytes(n, k, 64)))
            ws = packed_inputs(n, k, 64, gen, dev, copies)
            x = x_of(m, k, "bf16")
            kern = time_graph_ms([lambda w=w, am=am: K5.matmul4bit_mm(
                x, w, am, book, "bf16") for w, am in ws],
                iters=max(20, 2 * copies))
            plain = time_ms([lambda: K5.matmul4bit_plain(x, *ws[0], book,
                                                         "bf16")], iters=3)
            # a yardstick of the product alone, never called by the port:
            # torch.matmul of x by the already-decoded bf16 weight
            wd = dequant_bf16(*ws[0], book)
            gemm = time_graph_ms([lambda: torch.matmul(x, wd.t())], iters=20)
            del wd
            bound, by = k5_bound(m, n, k, 64, bw, bf16_peak)
            rows.append({"shape": f"{name} M={m} N={n} K={k} bf16",
                         "route": K5.kernel_of(m, n, k, 64, "bf16"),
                         "kernel_ms": kern, "plain_ms": plain,
                         "gemm_ms": gemm, "bound_ms": bound, "bound_by": by,
                         "x_bound": kern / bound,
                         "per_prefill": per_prefill})
            for key, val in (("ms", kern), ("plain_ms", plain),
                             ("bound_ms", bound), ("gemm_ms", gemm)):
                total[key] += per_prefill * val
            del ws
    x = x_of(65, 5120, "f32")
    ((w, am),) = packed_inputs(5120, 5120, 64, gen, dev)
    f32_ms = time_graph_ms([lambda: K5.matmul4bit_mm(x, w, am, book, "f32")],
                           20)
    emit({"phase": "kernels", "kernel": "K5_matmul4bit", "shapes": rows,
          "per_run": total, "f32_mode_o_M65_ms": f32_ms,
          "cases_by_route": routes,
          "worst_rel_err": {k: v[1] for k, v in worst.items()}})
    return {
        "name": "K5_matmul4bit", "route": "cuda",
        "source": "tpu_bitsandbytes_torch/csrc/matmul4bit.cu",
        "replaces": "tpu_bitsandbytes/ops/matmul4bit.py:72",
        "shape": "the two prefills of the 128 and 256 buckets at "
                 "Llama-2-13B, bf16, blocksize 64: 2 x (40 x (qkv, o, "
                 "gateup, down) + lm_head)",
        "max_abs_err": max(v[0] for v in worst.values()),
        "max_rel_err": max(v[1] for v in worst.values()),
        "ms": total["ms"], "kernel_ms": total["ms"],
        "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in rows) else "mixed",
        "library_ms": None, "gemm_ms": total["gemm_ms"]}


def k3_bound(b, s, h, h_kv, d, s_real, window, bw, bf16_peak, K3):
    pairs = K3.kept_pairs(s, s_real, window)
    ops = 4 * b * h * d * pairs
    nbytes = 2 * b * s * d * (2 * h + 2 * h_kv)
    return (max(nbytes / bw, ops / bf16_peak) * 1e3,
            "bytes" if nbytes / bw >= ops / bf16_peak else "operations")


def phase_kernels_k3(K3, gen, dev, bw, bf16_peak):
    cases = [  # (B, S, H, H_kv, D, s_real, options)
        (1, 1024, 40, 40, 128, 1024, {}),
        (4, 2048, 40, 40, 128, 2048, {}),
        (2, 2048, 32, 8, 128, 1900, {}),
        (2, 1100, 16, 4, 64, 1000, {}),
        (1, 2048, 32, 8, 128, 2048, {"window": 300}),
        (1, 1024, 16, 16, 128, 1024, {"softcap": 50.0}),
        # d = 256 (64-key tiles) over the lengths JAX's kernel takes there
        (1, 2048, 16, 16, 256, 2048, {}),
        (2, 1024, 16, 4, 256, 1000, {"window": 300, "softcap": 50.0}),
        (1, 512, 8, 8, 256, 512, {}),
        (1, 5632, 8, 2, 256, 5632, {}),
    ]

    def qkv(b, s, h, h_kv, d):
        return [(torch.randn(shape, generator=gen, device=dev) * 0.5).to(
            torch.bfloat16) for shape in ((b, s, h, d), (b, s, h_kv, d),
                                          (b, s, h_kv, d))]

    worst = [0.0, 0.0, 0.0]   # abs, share of max|ref|, share of the row's
    for b, s, h, h_kv, d, s_real, opts in cases:
        q, k, v = qkv(b, s, h, h_kv, d)
        scale = 1.0 / d ** 0.5
        got = K3.flash_prefill_attention(q, k, v, s_real=s_real, scale=scale,
                                         **opts)
        ref = K3.flash_prefill_plain(q, k, v, s_real=s_real, scale=scale,
                                     block_k=K3.KEY_TILE[d], **opts)
        torch.cuda.synchronize()
        a, r = err(got[:, :s_real], ref[:, :s_real])
        rr = row_err(got[:, :s_real], ref[:, :s_real])
        if not (rr <= K3_TOL and torch.isfinite(got[:, :s_real]).all()):
            raise AssertionError(f"K3 B={b} S={s} H={h}/{h_kv} D={d} "
                                 f"s_real={s_real} {opts}: rel err {rr} of "
                                 "a query row's max")
        worst = [max(worst[0], a), max(worst[1], r), max(worst[2], rr)]
    def timed_row(b, s, h, d):
        q, k, v = qkv(b, s, h, h, d)
        scale = 1.0 / d ** 0.5
        kern = time_graph_ms([lambda: K3.flash_prefill_attention(
            q, k, v, s_real=s, scale=scale)], iters=10)
        plain = time_ms([lambda: K3.flash_prefill_plain(
            q, k, v, s_real=s, scale=scale, block_k=K3.KEY_TILE[d])],
            iters=2)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = time_graph_ms(
            [lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True)], iters=10)
        bound, by = k3_bound(b, s, h, h, d, s, None, bw, bf16_peak, K3)
        return {"shape": f"B={b} S={s} H={h} D={d}", "kernel_ms": kern,
                "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                "bound_by": by, "key_tile": K3.KEY_TILE[d],
                "tflops": 4 * b * h * d * K3.kept_pairs(s, s) / kern / 1e9}

    rows = []
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for b, s in ((1, 1024), (4, 2048)):   # the served path's two buckets
        row = timed_row(b, s, 40, 128)
        rows.append(dict(row, per_prefill=40))
        for key, val in (("ms", row["kernel_ms"]),
                         ("plain_ms", row["plain_ms"]),
                         ("library_ms", row["library_ms"]),
                         ("bound_ms", row["bound_ms"])):
            total[key] += 40 * val
    # d = 256: one layer of Gemma-7B (google/gemma-7b: 16 heads of 256,
    # MHA) at S = 2048, B = 1; no served path of this script runs it
    d256 = timed_row(1, 2048, 16, 256)
    rows.append(d256)
    emit({"phase": "kernels", "kernel": "K3_flash_prefill", "shapes": rows})
    return {
        "name": "K3_flash_prefill", "route": "cuda",
        "source": "tpu_bitsandbytes_torch/csrc/flash_prefill.cu",
        "replaces": "tpu_bitsandbytes/ops/flash_prefill.py:64",
        "shape": "the prefills of the 1024 (B=1) and 2048 (B=4) buckets at "
                 "Llama-2-13B, bf16: 40 layers x (H=40, D=128)",
        "max_abs_err": worst[0], "max_rel_err": worst[1],
        "max_row_rel_err": worst[2],
        "ms": total["ms"], "kernel_ms": total["ms"],
        "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": "operations", "library_ms": total["library_ms"],
        "d256_gemma7b_layer": {k: d256[k] for k in (
            "shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "tflops")}}



# ---------------------------------------------------------------------------
# phase 2, not a TPU kernel: the int8 and bf16 runtime caches' product
# ---------------------------------------------------------------------------

def phase_cache_dots(dev, gen, bw):
    """The int8 and bf16 runtime caches' product (``layers.cache_matmul``:
    the cache widened to bf16, one GEMM with an f32 output, the row scale
    and the cast; an XLA fusion in the JAX package, no Pallas kernel, so
    plain torch in the port) at M = 8 over one decode step's matmuls: 129
    at Llama-2-7B (K1's shapes) and 161 at Llama-2-13B (K4's), timed from
    a CUDA graph, beside the bound: the cache's bytes (and scales), x and
    the output once, over HBM bandwidth. Each shape is checked against an
    f32 product on the card (bf16 output: one ulp of 2^-8)."""
    from tpu_bitsandbytes_torch.models.layers import cache_matmul
    rows, totals = [], {}
    for model, table in (("llama2_7b", K1_DECODE), ("llama2_13b", K4_DECODE)):
        for fmt in ("int8", "bf16"):
            tot = totals.setdefault(f"{model}_{fmt}",
                                    {"ms": 0.0, "bound_ms": 0.0,
                                     "launches_per_step": 0})
            for name, n, k, per_step in table:
                wb = n * k * (1 if fmt == "int8" else 2)
                copies = max(2, math.ceil(200e6 / wb))
                x = (torch.randn((8, k), generator=gen, device=dev)
                     ).to(torch.bfloat16)
                ws = []
                for _ in range(copies):
                    if fmt == "int8":
                        w = torch.randint(-127, 128, (n, k), generator=gen,
                                          device=dev, dtype=torch.int16
                                          ).to(torch.int8)
                        sc = torch.rand((n,), generator=gen,
                                        device=dev) * 0.01 + 1e-3
                    else:
                        w = (torch.randn((n, k), generator=gen, device=dev)
                             * 0.02).to(torch.bfloat16)
                        sc = None
                    ws.append((w, sc))
                w, sc = ws[0]
                got = cache_matmul(x, w, sc, None, torch.bfloat16)
                ref = x.float() @ w.float().t()
                if sc is not None:
                    ref = ref * sc[None, :]
                a, r = err(got, ref)
                if not (r <= 1e-2 and torch.isfinite(got).all()):
                    raise AssertionError(f"{fmt} cache dot {name}: {r}")
                ms = time_graph_ms(
                    [lambda w=w, sc=sc: cache_matmul(x, w, sc, None,
                                                     torch.bfloat16)
                     for w, sc in ws], iters=max(20, 2 * copies))
                nbytes = wb + (4 * n if fmt == "int8" else 0) + 2 * 8 * (k + n)
                bound = nbytes / bw * 1e3
                rows.append({"model": model, "cache": fmt,
                             "shape": f"{name} M=8 N={n} K={k}", "ms": ms,
                             "bound_ms": bound, "per_step": per_step,
                             "max_rel_err": r})
                tot["ms"] += per_step * ms
                tot["bound_ms"] += per_step * bound
                tot["launches_per_step"] += per_step
                del ws, w, sc, got, ref
            torch.cuda.empty_cache()
    emit({"phase": "cache_dots", "not_a_tpu_kernel":
          "JAX: XLA fusion (tpu_bitsandbytes/models/layers.py:199-209)",
          "route": "torch (cache.to(bf16), mm out_dtype=f32, scale, cast)",
          "totals_per_decode_step": totals, "shapes": rows})
    return totals


# ---------------------------------------------------------------------------
# model builders
# ---------------------------------------------------------------------------

def random_params(cfg, rand_bytes, rand_unit, rand_normal, device,
                  fused=True):
    """Llama params with random packed NF4 weights (blocksize 64, absmax
    U*0.03+0.005) in the fused qkv/gateup layout (or, with ``fused``
    False, the seven projections apart), unit norms, a normal(0, 0.02)
    embedding. A MoE config (``num_experts`` > 0) gets each expert's
    fused gate/up and down in place of the MLP, and a normal(0, 0.02)
    router in ``cfg.dtype``."""
    from tpu_bitsandbytes_torch.models.layers import QLinear4
    h, hd = cfg.hidden_size, cfg.hd
    n_q, n_kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    i = cfg.intermediate_size
    shapes = ({"qkv_proj": (n_q + 2 * n_kv, h), "o_proj": (h, n_q),
               "gateup_proj": (2 * i, h), "down_proj": (h, i)} if fused else
              {"q_proj": (n_q, h), "k_proj": (n_kv, h), "v_proj": (n_kv, h),
               "o_proj": (h, n_q), "gate_proj": (i, h), "up_proj": (i, h),
               "down_proj": (h, i)})

    def qlinear(n, k):
        return QLinear4(packed=rand_bytes((n, k // 2)),
                        absmax=rand_unit((n, k // 64)) * 0.03 + 0.005,
                        shape=(n, k), blocksize=64, quant_type="nf4",
                        dtype=cfg.dtype)

    def ones():
        return torch.ones((h,), dtype=cfg.dtype, device=device)

    mlp = ("gateup_proj", "down_proj")
    layers = []
    for _ in range(cfg.num_layers):
        layer = {name: qlinear(*shape) for name, shape in shapes.items()
                 if not (cfg.num_experts and name in mlp)}
        if cfg.num_experts:
            layer["moe"] = {
                "router": (rand_normal((cfg.num_experts, h)) * 0.02).to(
                    cfg.dtype),
                "experts": [{n: qlinear(*shapes[n]) for n in mlp}
                            for _ in range(cfg.num_experts)]}
        layer["input_norm"], layer["post_attn_norm"] = ones(), ones()
        layers.append(layer)
    return {"embed": (rand_normal((cfg.vocab_size, h)) * 0.02).to(cfg.dtype),
            "layers": layers, "final_norm": ones(),
            "lm_head": qlinear(cfg.vocab_size, h)}


# ---------------------------------------------------------------------------
# phase 3: full width, card against CPU
# ---------------------------------------------------------------------------

def run_prefill_decode(params, cfg, device, prompts, forced, max_seq=256,
                       n_steps=8, hidden=None):
    """Prefill each prompt into its slot of an int8 cache, then a staged
    chunk of ``n_steps`` decode steps fed ``forced`` tokens (or greedy ones
    when None). Returns the prefill's last-token logits [slots, V], the
    decode steps' logits [n_steps, slots, V] and the tokens fed, all on
    the CPU.

    The prefill is the engine's ``prefill_step`` (the prompt padded to its
    bucket, the head on every position) unless ``hidden`` is a list: then
    each prompt runs layer by layer at its own length, its hidden states
    after the last layer ([S, H] f32 on the CPU) are appended to
    ``hidden``, and the head runs on its last token only (Gemma2's
    256,000-row head over 4,400 positions would take 4.5 GB of logits)."""
    from tpu_bitsandbytes_torch.engine import engine as E
    from tpu_bitsandbytes_torch.engine.kvcache import KVCache
    from tpu_bitsandbytes_torch.models import llama as L
    cache = KVCache.create(cfg.num_layers, len(prompts), max_seq,
                           cfg.num_kv_heads, cfg.hd, dtype=cfg.dtype,
                           device=device)
    pre = []
    for slot, pr in enumerate(prompts):
        if hidden is None:
            padded = torch.zeros((1, E._bucket(len(pr), max_seq)),
                                 dtype=torch.int32)
            padded[0, :len(pr)] = torch.tensor(pr, dtype=torch.int32)
            logits, cache = E.prefill_step(params, cache, padded.to(device),
                                           slot, len(pr), cfg)
            pre.append(logits.cpu())
            continue
        tok = torch.tensor([pr], dtype=torch.int32, device=device)
        cos, sin = (t[None, :len(pr)] for t in L._rope(cfg, device))
        x = L._embed_tokens(params, tok, cfg)
        for li, layer in enumerate(params["layers"]):
            x, (k, v) = L._layer(layer, x, cos, sin, cfg, li)
            cache.write_prefill(li, slot, k[0], v[0])
        cache.lengths[slot] = len(pr)
        hidden.append(x[0].float().cpu())
        xl = L._norm(x[:, -1:], params["final_norm"], cfg)
        pre.append(L.head_logits(params, xl, cfg)[0, 0].float().cpu())
    toks = torch.stack(pre).argmax(-1).to(torch.int32)
    active = torch.ones((len(prompts),), dtype=torch.bool, device=device)
    span = E._span_bucket(max(map(len, prompts)) + n_steps, max_seq)
    cache.begin_stage(n_steps)
    steps, fed = [], []
    for i in range(n_steps):
        t_in = toks if forced is None else forced[i]
        fed.append(t_in)
        logits, cache = E.decode_step(params, cache, t_in.to(device), active,
                                      cfg, attn_span=span)
        steps.append(logits.float().cpu())
        toks = logits.argmax(-1).to(torch.int32).cpu()
    cache.flush_stage()
    return torch.stack(pre), torch.stack(steps), fed


def seeded_params(cfg, rng, dev):
    """``random_params`` drawn from the numpy generator ``rng``."""
    return random_params(
        cfg,
        lambda s: torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)
                                   ).to(dev),
        lambda s: torch.from_numpy(rng.random(s, dtype=np.float32)).to(dev),
        lambda s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                   ).to(dev),
        dev)


def slot_gaps(got_pre, ref_pre, got_steps, ref_steps):
    """Each slot's worst |got - ref| over its prefill logits and over its
    decode steps, as a share of max|ref| of the same logits."""
    def rel(got, ref):
        return (got - ref).abs().amax(-1) / ref.abs().amax(-1)
    return {"prefill": rel(got_pre, ref_pre).tolist(),
            "decode": rel(got_steps, ref_steps).amax(0).tolist()}


def compare_card_cpu(what, got_pre, ref_pre, got_steps, ref_steps, tol=None):
    """Card logits within ``tol`` of the CPU's (``{"prefill": [per slot],
    "decode": [per slot]}``, default E2E_TOL), each as a share of the
    slot's own max|ref|, and no greedy token apart where the CPU's top-2
    margin exceeds the tolerance. Returns :func:`slot_gaps`."""
    n = ref_pre.shape[0]
    tol = tol or {"prefill": [E2E_TOL] * n, "decode": [E2E_TOL] * n}
    worst = slot_gaps(got_pre, ref_pre, got_steps, ref_steps)
    mismatched = 0
    entries = [("prefill", got_pre, ref_pre)] + [
        ("decode", g, r) for g, r in zip(got_steps, ref_steps)]
    for kind, got, ref in entries:
        for i in range(n):
            scale = ref[i].abs().max().item()
            r = (got[i] - ref[i]).abs().max().item() / scale
            if not (r <= tol[kind][i] and torch.isfinite(got[i]).all()):
                raise AssertionError(f"{what}: {kind} slot {i} card vs CPU "
                                     f"rel err {r} > {tol[kind][i]} "
                                     f"({worst})")
            top2 = ref[i].topk(2).values
            if (top2[0] - top2[1] > tol[kind][i] * scale
                    and got[i].argmax() != ref[i].argmax()):
                mismatched += 1
    if mismatched:
        raise AssertionError(f"{what}: {mismatched} greedy tokens differ "
                             "where the CPU's top-2 margin is clear")
    return worst


def as_f32(tree):
    """A params tree with its float tensors, and its ``QLinear4``s' compute
    dtype, in f32 (LoRA adapters keep theirs)."""
    from tpu_bitsandbytes_torch.models.layers import QLinear4
    from tpu_bitsandbytes_torch.models.lora import LoRALinear
    if isinstance(tree, QLinear4):
        return dataclasses.replace(tree, dtype=torch.float32)
    if isinstance(tree, LoRALinear):
        return LoRALinear(as_f32(tree.base), tree.lora_A, tree.lora_B,
                          tree.scaling)
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_f32(v) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.float()
    return tree


def phase_full_width(dev):
    from tpu_bitsandbytes_torch.models.llama import (LlamaConfig,
                                                     build_runtime_cache,
                                                     to_device)
    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), num_layers=2)
    rng = np.random.default_rng(1234)
    params = build_runtime_cache(seeded_params(cfg, rng, dev), "int4",
                                 drop_packed=True)
    cpu_params = to_device(params, "cpu")
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (9, 33, 64, 100)]
    t0 = time.perf_counter()
    ref_pre, ref_steps, fed = run_prefill_decode(cpu_params, cfg, "cpu",
                                                 prompts, None)
    cpu_s = time.perf_counter() - t0
    got_pre, got_steps, _ = run_prefill_decode(params, cfg, dev, prompts,
                                               fed)
    worst = compare_card_cpu("full width", got_pre, ref_pre, got_steps,
                             ref_steps)
    emit({"phase": "full_width", "layers": 2, "hidden": cfg.hidden_size,
          "logit_rel_err_by_slot": worst, "tol": E2E_TOL, "cpu_s": cpu_s})


def numpy_normal(rng, dev):
    """``normal(shape)``: standard normal f32 tensors on ``dev`` drawn from
    the numpy generator ``rng``."""
    return lambda shape: torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(dev)


def normal_nf4_params(cfg, normal, dev):
    """Llama params from normal(0, 0.02) weights (``normal(shape)``: standard
    normal f32 tensors on ``dev``) quantized to NF4 (blocksize 64) on
    ``dev``, in the fused qkv/gateup layout; unit norms. A MoE config
    (``num_experts`` > 0) gets each expert's fused gate/up and its down in
    place of the MLP, and a normal(0, 0.02) router in ``cfg.dtype``."""
    from tpu_bitsandbytes_torch.models.layers import QLinear4
    h, i = cfg.hidden_size, cfg.intermediate_size

    def qlinear(n, k):
        return QLinear4.quantize(normal((n, k)) * 0.02, blocksize=64,
                                 dtype=cfg.dtype)

    def ones():
        return torch.ones((h,), dtype=cfg.dtype, device=dev)

    def mlp():
        return {"gateup_proj": qlinear(2 * i, h), "down_proj": qlinear(h, i)}

    layers = []
    for _ in range(cfg.num_layers):
        layer = {"qkv_proj": qlinear((cfg.num_heads + 2 * cfg.num_kv_heads)
                                     * cfg.hd, h),
                 "o_proj": qlinear(h, cfg.num_heads * cfg.hd)}
        if cfg.num_experts:
            layer["moe"] = {
                "router": (normal((cfg.num_experts, h)) * 0.02).to(cfg.dtype),
                "experts": [mlp() for _ in range(cfg.num_experts)]}
        else:
            layer.update(mlp())
        layer["input_norm"], layer["post_attn_norm"] = ones(), ones()
        layers.append(layer)
    return {"embed": (normal((cfg.vocab_size, h)) * 0.02).to(cfg.dtype),
            "layers": layers, "final_norm": ones(),
            "lm_head": qlinear(cfg.vocab_size, h)}


@contextlib.contextmanager
def k4_inputs(record=None, feed=None):
    """Taps the K4 wrapper as ``QLinear4`` calls it. ``record``: a list
    that collects each call's activation, on the CPU. ``feed``: a run's
    record, handed to the wrapper call by call in place of this run's
    activation (so both runs quantize the same values to the same A8
    codes); yields a list with, per call, the weight's shape, how far this
    run's activation was from the fed one (share of max|fed|) and how many
    of its A8 codes differ."""
    from tpu_bitsandbytes_torch.models import layers
    from tpu_bitsandbytes_torch.ops.w4a8 import quantize_a8
    orig = layers.w4a8_matmul_4bit
    notes = []

    def tap(x, packed_flat, st, **kw):
        if record is not None:
            record.append(x.cpu())
        if feed is not None:
            ref = feed[len(notes)].to(x.device)
            kp = packed_flat.numel() // st.shape[0] * 2
            codes = (quantize_a8(x, kp)[0] != quantize_a8(ref, kp)[0])
            notes.append({"shape": st.shape, "m": x.shape[0],
                          "rel_err": ((x.float() - ref.float()).abs().max()
                                      / ref.float().abs().max()).item(),
                          "codes_differ": int(codes.sum()),
                          "codes": codes.numel()})
            x = ref
        return orig(x, packed_flat, st, **kw)

    layers.w4a8_matmul_4bit = tap
    try:
        yield notes
    finally:
        layers.w4a8_matmul_4bit = orig


def phase_full_width_packed(dev, counters):
    """3b: Llama-2-13B width, 2 layers, no runtime cache: prompts of 40
    (bucket 64: K4), 100 (bucket 128: K5 at M=128) and 1,000 tokens
    (bucket 1024: the plain GEMM and K3), then 8 decode steps (K4, K2).

    The weights are normal(0, 0.02) quantized to NF4: uniformly random
    codes average +0.0235 of absmax (the NF4 codebook is not symmetric), a
    common mode that grows with K and leaves some decode steps of this
    2-layer cut ill-conditioned.

    K4 quantizes its activations to int8 per row (A8), so where card and
    CPU differ by one bf16 ulp at a row's largest element, every code of
    the row is rescaled. The card is therefore held twice against the CPU:
    fed the CPU's activation at every K4 call (every K4 input, each as the
    card computed it from the layers before, and all logits at E2E_TOL),
    and on its own codes, within the CPU's own bf16-vs-f32 gap on the same
    steps (at least E2E_TOL): no further from the CPU than bf16 is from
    f32."""
    from tpu_bitsandbytes_torch.models.llama import LlamaConfig, to_device
    cfg = dataclasses.replace(LlamaConfig.llama2_13b(), num_layers=2)
    rng = np.random.default_rng(2468)
    params = normal_nf4_params(cfg, numpy_normal(rng, dev), dev)
    cpu_params = to_device(params, "cpu")
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (40, 100, 1000)]
    t0 = time.perf_counter()
    cpu_x = []
    with k4_inputs(record=cpu_x):
        ref_pre, ref_steps, fed = run_prefill_decode(
            cpu_params, cfg, "cpu", prompts, None, max_seq=2048)
    f32_pre, f32_steps, _ = run_prefill_decode(
        as_f32(cpu_params), dataclasses.replace(cfg, dtype=torch.float32),
        "cpu", prompts, fed, max_seq=2048)
    cpu_s = time.perf_counter() - t0
    bf16_gap = slot_gaps(ref_pre, f32_pre, ref_steps, f32_steps)

    before = {k: f.launches for k, f in counters.items()}
    with k4_inputs(feed=cpu_x) as notes:
        got_pre, got_steps, _ = run_prefill_decode(params, cfg, dev, prompts,
                                                   fed, max_seq=2048)
    launches = {k: f.launches - before[k] for k, f in counters.items()}
    for k in ("K3_flash_prefill", "K4_w4a8_matmul", "K5_matmul4bit",
              "K2_flash_decode"):
        if not launches[k]:
            raise AssertionError(f"full width packed: {k} never launched "
                                 f"({launches})")
    if len(notes) != len(cpu_x):
        raise AssertionError(f"full width packed: {len(notes)} K4 calls on "
                             f"the card, {len(cpu_x)} on the CPU")
    by_shape = {}
    for note in notes:
        key = "x".join(map(str, note["shape"]))
        row = by_shape.setdefault(key, {"calls": 0, "rel_err": 0.0,
                                        "codes_differ": 0, "codes": 0})
        row["calls"] += 1
        row["rel_err"] = max(row["rel_err"], note["rel_err"])
        row["codes_differ"] += note["codes_differ"]
        row["codes"] += note["codes"]
        if not note["rel_err"] <= E2E_TOL:
            raise AssertionError(f"full width packed: K4 input {key} M="
                                 f"{note['m']} card vs CPU rel err "
                                 f"{note['rel_err']} > {E2E_TOL}")
    fed_gap = compare_card_cpu("full width packed, fed the CPU's K4 inputs",
                               got_pre, ref_pre, got_steps, ref_steps)

    own_pre, own_steps, _ = run_prefill_decode(params, cfg, dev, prompts, fed,
                                               max_seq=2048)
    own_tol = {kind: [max(E2E_TOL, g) for g in gaps]
               for kind, gaps in bf16_gap.items()}
    own_gap = compare_card_cpu("full width packed, own A8 codes", own_pre,
                               ref_pre, own_steps, ref_steps, tol=own_tol)
    emit({"phase": "full_width_packed", "layers": 2,
          "hidden": cfg.hidden_size, "prompt_lens": [len(p) for p in prompts],
          "tol": E2E_TOL, "fed_logit_rel_err_by_slot": fed_gap,
          "k4_inputs_by_shape": by_shape,
          "own_codes_logit_rel_err_by_slot": own_gap,
          "cpu_bf16_vs_f32_by_slot": bf16_gap, "own_codes_tol": own_tol,
          "cpu_s": cpu_s, "launches": launches})
    return params, cpu_params


def qlinears(params):
    """The :class:`QLinear4` weights of a Llama params tree, in order."""
    from tpu_bitsandbytes_torch.models.layers import QLinear4
    return [w for layer in params["layers"] for w in layer.values()
            if isinstance(w, QLinear4)] + [params["lm_head"]]


def phase_full_width_caches(dev, counters, params, cpu_params):
    """3d: 3b's Llama-2-13B-width model (2 layers) with the int8 runtime
    cache, then the bf16 one, each built on the card and on the CPU from
    the same NF4 weights: the caches bit-identical (the int8 codes and
    row scales are one division and one rounding per weight, with no
    reciprocal on the card: ``div_exact``); then prompts of 40 and 100
    tokens and 8 staged decode steps on both, logits within E2E_TOL. The
    cache products are plain torch (no K1, K4 or K5); decode runs K2."""
    from tpu_bitsandbytes_torch.models.llama import (LlamaConfig,
                                                     build_runtime_cache)
    cfg = dataclasses.replace(LlamaConfig.llama2_13b(), num_layers=2)
    rng = np.random.default_rng(3579)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (40, 100)]
    for fmt in ("int8", "bf16"):
        t0 = time.perf_counter()
        card = build_runtime_cache(params, fmt)
        cpu = build_runtime_cache(cpu_params, fmt)
        pairs = list(zip(qlinears(card), qlinears(cpu)))
        if len(pairs) != 4 * cfg.num_layers + 1:
            raise AssertionError(f"{fmt} cache: {len(pairs)} layers")
        for c, h in pairs:
            same = torch.equal(c.w_cache.cpu(), h.w_cache) and (
                (c.cache_scale is None and h.cache_scale is None)
                or torch.equal(c.cache_scale.cpu(), h.cache_scale))
            if not same or c.w_cache.dtype != {"int8": torch.int8,
                                               "bf16": torch.bfloat16}[fmt]:
                raise AssertionError(f"{fmt} cache {c.shape}: card and CPU "
                                     "caches differ")
        ref_pre, ref_steps, fed = run_prefill_decode(cpu, cfg, "cpu",
                                                     prompts, None)
        cpu_s = time.perf_counter() - t0
        before = counts(counters)
        got_pre, got_steps, _ = run_prefill_decode(card, cfg, dev, prompts,
                                                   fed)
        launches = {k: n - before[k] for k, n in counts(counters).items()}
        if (launches["K2_flash_decode"] != 8 * cfg.num_layers
                or any(launches[k] for k in ("K1_int4_matmul",
                                             "K4_w4a8_matmul",
                                             "K5_matmul4bit"))):
            raise AssertionError(f"{fmt} cache launches {launches}")
        worst = compare_card_cpu(f"full width, {fmt} cache", got_pre,
                                 ref_pre, got_steps, ref_steps)
        emit({"phase": "full_width_cache", "cache": fmt, "layers": 2,
              "hidden": cfg.hidden_size,
              "prompt_lens": [len(p) for p in prompts],
              "caches_identical_card_cpu": True,
              "logit_rel_err_by_slot": worst, "tol": E2E_TOL,
              "cpu_s": cpu_s, "launches": launches})
        del card, cpu
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 4-5: the served paths, eager and graphed
# ---------------------------------------------------------------------------

def scratch_mib():
    """MiB of split-K scratch (K1, K4 and K5's partials and counts) held per
    stream, largest first: kept once a stream has run a split launch, so it
    counts in every later peak."""
    from tpu_bitsandbytes_torch.ops import _build
    return sorted((b / 2 ** 20 for b in _build.scratch_bytes().values()),
                  reverse=True)


def reset(counters, plains):
    for f in counters.values():
        f.launches = 0
        if hasattr(f, "wgmma_launches"):
            f.wgmma_launches = 0
    for f in plains:
        f.cuda_calls = 0


def counts(counters):
    return {k: f.launches for k, f in counters.items()}


# each counter's kernels, by their demangled names (a graph's kernel nodes
# and the profiler's records name them alike)
KERNEL_RE = {"K1_int4_matmul": r"tc_kernel<[^,]*\bInt4,",
             "K2_flash_decode": r"flash_decode_kernel<",
             "K3_flash_prefill": r"flash_prefill_kernel",
             "K4_w4a8_matmul": r"tc_kernel<[^,]*\bNf4,|w4a8_dp4a_kernel",
             "K5_matmul4bit": r"mm4_(bf16|f32|wgmma)_kernel"}


def step_breakdown(restore, run_chunk, steps, counters):
    """Per decode step of one chunk of ``steps``, each chunk run from the
    state ``restore()`` sets (after a warm-up chunk, which captures the
    chunk's graph on the graphed path): the host clock around a chunk
    that ends in a synchronization (``host_ms``); the device's kernel time
    in a profiled chunk (``device_busy_ms``, the profiler's kernel records,
    which cover the kernels of a graph replay too) and ``idle_share``, 1 -
    busy / host; CUDA events around a chunk (``device_span_ms``, the
    stream's time from the chunk's first operation to its last); and the
    launches of a chunk by the kernels' counters. ``restore()`` runs, and
    the device finishes its work, outside every measured window. Also the
    breakdown's own cost: the profiled chunk with the profiler's
    processing (``profiler_s``) and the whole (``seconds``)."""
    def restored():
        restore()
        torch.cuda.synchronize()

    t_bd = time.perf_counter()
    restored()
    run_chunk()
    restored()
    t0 = time.perf_counter()
    run_chunk()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    restored()
    t_prof = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run_chunk()
        torch.cuda.synchronize()
    ops = device_ops(prof)
    profiler_s = time.perf_counter() - t_prof
    busy_ms = sum(ms for ms, _ in ops.values())
    top = sorted(ops.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    restore()
    before = counts(counters)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run_chunk()
    end.record()
    torch.cuda.synchronize()
    return {"steps": steps, "host_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_span_ms_per_step": start.elapsed_time(end) / steps,
            "launches_per_step": {k: (n - before[k]) / steps
                                  for k, n in counts(counters).items()},
            "profiler_s": profiler_s, "seconds": time.perf_counter() - t_bd,
            "top_device_ops": [
                {"op": name[:60], "ms_per_step": ms / steps,
                 "calls_per_step": n / steps} for name, (ms, n) in top]}


def device_ops(prof):
    """{name: (ms, count)} of the device's records (kernels, copies and
    fills, a graph replay's included) in a finished profile, read from the
    raw trace: building the profiler's event tree (``key_averages``) took
    8-23 s per 32- or 64-step chunk on the H100 machine's host."""
    from torch.autograd import DeviceType
    ops = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ms, n = ops.get(e.name(), (0.0, 0))
            ops[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return ops


def profiler_check(dev):
    """The device time :func:`device_ops` reads against the profiler's
    ``key_averages`` on a small trace: three bf16 GEMMs launched from the
    host and a CUDA graph of three more, replayed. Reported, not a gate."""
    a = torch.randn((2048, 2048), device=dev, dtype=torch.bfloat16)
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            a @ a
        with torch.cuda.graph(g):
            for _ in range(3):
                a @ a
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            a @ a
        g.replay()
        torch.cuda.synchronize()
    ops = device_ops(prof)
    emit({"phase": "profiler_check", "calls": 6,
          "raw_trace_ms": sum(ms for ms, _ in ops.values()),
          "raw_trace_calls": sum(n for _, n in ops.values()),
          "key_averages_ms": sum(e.self_device_time_total
                                 for e in prof.key_averages()) / 1e3})


def kernel_launches(fn):
    """The device kernels one call of ``fn`` launches (after a warm-up
    call), by name, from the profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.count for e in prof.key_averages()
            if e.self_device_time_total > 0}


# graphed first: its engine serves twice (the first pass captures the
# graphs), then eager serves once (nothing to capture) on a warm card
MODES = ("graphed", "eager")


def serve_mode(dev, params, cfg, engine_kw, mode, prompts, sp, counters,
               plains, want_per_step, pass_ctx=contextlib.nullcontext):
    """Serve ``prompts`` on one engine built for ``mode``: graphed (each
    decode chunk a CUDA graph replay) twice, the first pass capturing the
    graphs (as the JAX engine compiles at first use), the second timed;
    eager (the same chunks launched from the host) once, as it has nothing
    to capture; then the step breakdown of
    one more chunk of the served length at the slots' final positions,
    whose launches per step, by the counters and (graphed) by the kernel
    nodes of its graph, must equal ``want_per_step``; then one eager decode step from there,
    counted alone, whose launches must equal it too and whose logits must
    be finite. Each pass runs inside ``pass_ctx()``. Returns (the result,
    the engine)."""
    from tpu_bitsandbytes_torch.engine import engine as E
    from tpu_bitsandbytes_torch.utils.metrics import MetricsLogger
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = scratch_mib()
    t0 = time.perf_counter()
    engine = E.DecodeEngine(params, cfg, device=dev,
                            cuda_graphs=mode == "graphed", **engine_kw)
    torch.cuda.synchronize()
    res = {"mode": mode, "build_s": time.perf_counter() - t0, "passes": []}
    for _ in range(2 if mode == "graphed" else 1):
        engine.metrics = MetricsLogger()
        reset(counters, plains)
        with pass_ctx() as extra:
            t0 = time.perf_counter()
            # the step loop, as in every PR before the pipelined default
            outs = engine.generate(prompts, sp, pipeline_depth=1)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
        hist = engine.metrics.history
        steps = len(hist) * engine.steps_per_sync
        res["passes"].append({
            "outs": outs, "generate_s": gen_s, "launches": counts(counters),
            "wgmma_launches": counters["K5_matmul4bit"].wgmma_launches,
            "plain_calls_on_cuda": sum(f.cuda_calls for f in plains),
            "decode_steps": steps,
            "decode_step_ms": sum(m.wall_s for m in hist) / steps * 1e3,
            "decode_tokens_per_s": engine.metrics.summary()["tokens_per_s"],
            "extra": extra})
    last = res["passes"][-1]
    if last["plain_calls_on_cuda"]:
        raise AssertionError(f"{mode}: {last['plain_calls_on_cuda']} plain-"
                             "version calls on CUDA tensors in the path")
    if not all(len(o) == sp.max_new_tokens
               and all(0 <= t < cfg.vocab_size for t in o) for o in outs):
        raise AssertionError(f"{mode}: wrong token counts or ids")
    # one more chunk of the served length from the slots' final positions
    lengths = engine.cache.lengths.clone()
    n = engine.steps_per_sync
    toks = np.array([o[-1] for o in outs], np.int32)
    active = np.ones((engine.max_batch,), bool)
    span = E._span_bucket(int(lengths.max()) + n, engine.max_seq)
    bd = step_breakdown(
        lambda: engine.cache.lengths.copy_(lengths),
        lambda: engine.run_chunk(toks, active, all_greedy=True,
                                 attn_span=span), n, counters)
    if mode == "graphed":
        names = engine.graph_kernel_names(span)
        bd["graph_launches_per_step"] = {
            k: sum(c for nm, c in names.items() if re.search(rx, nm)) / n
            for k, rx in KERNEL_RE.items()}
    got = {src: bd[src] for src in ("launches_per_step",
                                    "graph_launches_per_step") if src in bd}
    if any(c != want_per_step for c in got.values()):
        raise AssertionError(f"{mode}: launches per decode step {got}, "
                             f"expected {want_per_step}")
    # one decode step at full depth from the same positions, launched from
    # the host: each wrapper counts its own launches, and the logits of
    # every layer's output must stay finite
    engine.cache.lengths.copy_(lengths)
    reset(counters, plains)
    logits, _ = E.decode_step(engine.params, engine.cache,
                              torch.from_numpy(toks).to(dev),
                              torch.from_numpy(active).to(dev), cfg,
                              attn_span=span)
    torch.cuda.synchronize()
    step_launches = counts(counters)
    if (step_launches != want_per_step
            or sum(f.cuda_calls for f in plains)):
        raise AssertionError(f"{mode}: an eager decode step launched "
                             f"{step_launches}, expected {want_per_step}, "
                             "with no plain-version calls on CUDA tensors")
    if not (logits.shape == (engine.max_batch, cfg.vocab_size)
            and torch.isfinite(logits).all()):
        raise AssertionError(f"{mode}: decode-step logits not finite")
    res.update(step_breakdown=bd, lengths=lengths,
               graphs=engine.graph_stats(),
               max_memory_allocated_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30,
               max_memory_reserved_gib=torch.cuda.max_memory_reserved()
               / 2 ** 30,
               split_scratch_mib={"at_peak_reset": held,
                                  "at_end": scratch_mib()})
    return res, engine


def serve_lines(model, results, common):
    """Emit each mode's ``serve`` line and the modes' comparison; the
    greedy tokens of the two modes must be identical, request by
    request, in every pass (a mode served once is held in its one pass
    against each pass of the other)."""
    for mode in MODES:
        r = results[mode]
        p1, p2 = r["passes"][0], r["passes"][-1]
        graphs = r["graphs"]
        first = ({"first_pass_generate_s": p1["generate_s"],
                  "first_pass_decode_step_ms": p1["decode_step_ms"]}
                 if len(r["passes"]) > 1 else {})
        emit({"phase": "serve", "model": model, "mode": mode, **common,
              "passes": len(r["passes"]),
              "build_s": r["build_s"], "generate_s": p2["generate_s"],
              "decode_steps": p2["decode_steps"],
              "decode_step_ms": p2["decode_step_ms"],
              "decode_tokens_per_s": p2["decode_tokens_per_s"], **first,
              **{k: v for k, v in r["step_breakdown"].items()
                 if k != "top_device_ops"},
              "graphs_captured": graphs["graphs"],
              "capture_s": graphs["capture_s"],
              "graph_pool_mib": graphs["pool_bytes"] / 2 ** 20,
              "max_memory_allocated_gib": r["max_memory_allocated_gib"],
              "max_memory_reserved_gib": r["max_memory_reserved_gib"],
              "split_scratch_mib": r["split_scratch_mib"],
              "launches": p2["launches"],
              "plain_calls_on_cuda": p2["plain_calls_on_cuda"],
              **({"prefill_groups": p2["extra"]} if p2["extra"] else {})})
        emit({"phase": "step_breakdown", "model": model, "mode": mode,
              "top_device_ops": r["step_breakdown"]["top_device_ops"]})
    e, g = results["eager"], results["graphed"]
    # the eager pass's launches, counted by the wrappers, and the graphed
    # pass's, counted at capture and added per replay
    if e["passes"][-1]["launches"] != g["passes"][-1]["launches"]:
        raise AssertionError(f"{model}: the graphed pass counted "
                             f"{g['passes'][-1]['launches']} launches, the "
                             f"eager pass {e['passes'][-1]['launches']}")
    n = max(len(e["passes"]), len(g["passes"]))
    for i in range(n):
        eo = e["passes"][min(i, len(e["passes"]) - 1)]["outs"]
        go = g["passes"][min(i, len(g["passes"]) - 1)]["outs"]
        differ = [j for j, (a, b) in enumerate(zip(eo, go)) if a != b]
        if differ or len(eo) != len(go):
            raise AssertionError(f"{model}: pass {i + 1}: greedy tokens of "
                                 f"requests {differ} differ between the "
                                 "eager and the graphed chunks")
    emit({"phase": "serve_compare", "model": model,
          "greedy_tokens_identical": True,
          "decode_step_ms": {m: results[m]["passes"][-1]["decode_step_ms"]
                             for m in MODES},
          "speedup": e["passes"][-1]["decode_step_ms"]
          / g["passes"][-1]["decode_step_ms"],
          "peak_allocated_gib_delta": g["max_memory_allocated_gib"]
          - e["max_memory_allocated_gib"],
          "peak_reserved_gib_delta": g["max_memory_reserved_gib"]
          - e["max_memory_reserved_gib"]})


def free_memory():
    """Return what the dropped engine held (its KV cache, graphs and their
    pool) to the device before the next engine is built."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def llama7b_workload(dev):
    """Phase 4's model and requests: (cfg, params, prompts, sampling,
    engine keywords) for Llama-2-7B at its 32 layers, random NF4 weights
    from a seed (the engine builds the int4 cache), B=8, ``max_seq`` 512,
    32-step chunks, 8 prompts of 16-200 tokens, 64 greedy new tokens."""
    from tpu_bitsandbytes_torch.engine.sampler import SamplingParams
    from tpu_bitsandbytes_torch.models.llama import LlamaConfig
    cfg = LlamaConfig.llama2_7b()
    gen = torch.Generator(device=dev).manual_seed(7)
    params = random_params(
        cfg,
        lambda s: torch.randint(0, 256, s, generator=gen, device=dev,
                                dtype=torch.uint8),
        lambda s: torch.rand(s, generator=gen, device=dev),
        lambda s: torch.randn(s, generator=gen, device=dev), dev)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in rng.integers(16, 201, 8)]
    kw = dict(max_batch=8, max_seq=512, steps_per_sync=32,
              runtime_cache="int4")
    return cfg, params, prompts, SamplingParams(max_new_tokens=64), kw


def teacher_forced(params, cfg, dev, prompts, outs, max_seq, cache,
                   tp=None):
    """Each prompt prefilled into its slot of ``cache`` (``prefill_step``),
    then unstaged decode steps (``decode_step``, every slot active) fed
    each request's tokens ``outs``: f32 logits [T, B, V] on the CPU, T =
    len(outs[0]); row 0 the prefills' last logits, row j the step fed the
    (j-1)-th token. ``tp``: a mesh engine's context (every slot local)."""
    from tpu_bitsandbytes_torch.engine import engine as E
    rows = []
    for slot, pr in enumerate(prompts):
        padded = torch.zeros((1, E._bucket(len(pr), max_seq)),
                             dtype=torch.int32)
        padded[0, :len(pr)] = torch.tensor(pr, dtype=torch.int32)
        logits, cache = E.prefill_step(params, cache, padded.to(dev), slot,
                                       len(pr), cfg, tp=tp)
        rows.append(logits.float().cpu())
    steps = [torch.stack(rows)]
    n = len(outs[0])
    active = torch.ones((len(prompts),), dtype=torch.bool, device=dev)
    span = E._span_bucket(max(map(len, prompts)) + n, max_seq)
    for j in range(n - 1):
        toks = torch.tensor([o[j] for o in outs], dtype=torch.int32)
        logits, cache = E.decode_step(params, cache, toks.to(dev), active,
                                      cfg, attn_span=span, tp=tp)
        steps.append(logits.float().cpu())
    torch.cuda.synchronize()
    return torch.stack(steps)


def phase_serve(dev, counters, plains):
    """4: Llama-2-7B, 32 layers, int4 runtime cache, eager and graphed.
    Returns the eager pass's launches (equal to the graphed pass's), the
    graphed engine's greedy tokens (an engine not warmed up) and, for
    phase 12, that engine's teacher-forced logits on them
    (:func:`teacher_forced`)."""
    cfg, params, prompts, sp, kw = llama7b_workload(dev)
    want = {"K1_int4_matmul": 129, "K2_flash_decode": 32,
            "K3_flash_prefill": 0, "K4_w4a8_matmul": 0, "K5_matmul4bit": 0}
    results = {}
    for mode in MODES:
        res, engine = serve_mode(dev, params, cfg, kw, mode, prompts, sp,
                                 counters, plains, want)
        launches = res["passes"][-1]["launches"]
        steps = res["passes"][-1]["decode_steps"]
        if launches["K2_flash_decode"] != 32 * steps:
            raise AssertionError(f"{mode}: K2 launches {launches} for "
                                 f"{steps} decode steps")
        if launches["K1_int4_matmul"] < 129 * steps:
            raise AssertionError(f"{mode}: K1 launches {launches} for "
                                 f"{steps} decode steps")
        if mode == "eager":
            # what one decode-shaped matmul launches besides K1: the A8
            # activation quantization, padding and casts (QLinear4 ->
            # int4_matmul), and the packed path's quantize_a8 alone
            from tpu_bitsandbytes_torch.ops import int4cache, w4a8
            lin = engine.params["layers"][0]["o_proj"]
            x = torch.randn((8, cfg.hidden_size), device=dev).to(cfg.dtype)
            per_matmul = {
                "qlinear4_int4_cache": kernel_launches(lambda: lin(x)),
                "int4_matmul": kernel_launches(lambda: int4cache.int4_matmul(
                    x, lin.w_cache, lin.cache_scale)),
                "quantize_a8": kernel_launches(
                    lambda: w4a8.quantize_a8(x, cfg.hidden_size))}
            emit({"phase": "a8_launches", "model": "llama2_7b", "m": 8,
                  "k": cfg.hidden_size, "kernels_per_call": per_matmul,
                  "launches_per_call": {k: sum(v.values())
                                        for k, v in per_matmul.items()}})
        if mode == "graphed":
            t0 = time.perf_counter()
            forced = teacher_forced(engine.params, cfg, dev, prompts,
                                    res["passes"][-1]["outs"],
                                    kw["max_seq"], engine.cache)
            emit({"phase": "teacher_forced", "model": "llama2_7b",
                  "rows": list(forced.shape),
                  "seconds": time.perf_counter() - t0})
        results[mode] = res
        del engine
        free_memory()
    serve_lines("llama2_7b", results, {
        "layers": cfg.num_layers, "batch": 8, "steps_per_sync": 32,
        "prompt_lens": [len(p) for p in prompts], "new_tokens": 64})
    return (results["eager"]["passes"][-1]["launches"],
            results["graphed"]["passes"][-1]["outs"], forced)


PACKED_PROMPTS = [24, 60, 100, 200, 700, 1100, 1500, 1800]


def packed_workload(dev):
    """Phase 5's model and requests: (cfg, params, prompts, sampling,
    engine keywords) for Llama-2-13B at its 40 layers, random NF4 weights
    from a seed, served off the packed bytes."""
    from tpu_bitsandbytes_torch.engine.sampler import SamplingParams
    from tpu_bitsandbytes_torch.models.llama import LlamaConfig
    cfg = LlamaConfig.llama2_13b()
    gen = torch.Generator(device=dev).manual_seed(13)
    params = random_params(
        cfg,
        lambda s: torch.randint(0, 256, s, generator=gen, device=dev,
                                dtype=torch.uint8),
        lambda s: torch.rand(s, generator=gen, device=dev),
        lambda s: torch.randn(s, generator=gen, device=dev), dev)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in PACKED_PROMPTS]
    kw = dict(max_batch=8, max_seq=2048, steps_per_sync=32,
              runtime_cache=None)
    return cfg, params, prompts, SamplingParams(max_new_tokens=48), kw


@contextlib.contextmanager
def timed_prefills(counters):
    """Each admission group's prefill, timed between synchronizations,
    with its launches by ``counters``: yields the list of groups."""
    from tpu_bitsandbytes_torch.engine import engine as E
    groups = []
    orig = {"prefill_step": E.prefill_step,
            "prefill_batch": E.prefill_batch}

    def timed(fn):
        def run(params, cache, tokens, *args, **kw):
            before = counts(counters)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(params, cache, tokens, *args, **kw)
            torch.cuda.synchronize()
            groups.append({
                "rows": tokens.shape[0], "bucket": tokens.shape[1],
                "ms": (time.perf_counter() - t) * 1e3,
                "launches": {k: n - before[k]
                             for k, n in counts(counters).items()
                             if n - before[k]}})
            return out
        return run

    for name, fn in orig.items():
        setattr(E, name, timed(fn))
    try:
        yield groups
    finally:
        for name, fn in orig.items():
            setattr(E, name, fn)


def phase_serve_packed(dev, counters, plains, bw, int8_peak, workload):
    """5: Llama-2-13B, 40 layers, off the packed NF4 bytes, eager and
    graphed (``workload``: :func:`packed_workload`). Returns the eager
    pass's launches (equal to the graphed pass's) and K2's bound for one
    decode step at the slots' final positions (ms, 40 layers)."""
    cfg, params, prompts, sp, kw = workload
    want = {"K1_int4_matmul": 0, "K2_flash_decode": cfg.num_layers,
            "K3_flash_prefill": 0, "K4_w4a8_matmul": 4 * cfg.num_layers + 1,
            "K5_matmul4bit": 0}
    results = {}
    want_k5 = 2 * (4 * cfg.num_layers + 1)
    for mode in MODES:
        res, engine = serve_mode(dev, params, cfg, kw, mode, prompts, sp,
                                 counters, plains, want,
                                 lambda: timed_prefills(counters))
        last = res["passes"][-1]
        launches = last["launches"]
        if not (launches["K3_flash_prefill"] and launches["K5_matmul4bit"]
                and launches["K4_w4a8_matmul"]) or launches["K1_int4_matmul"]:
            raise AssertionError(f"{mode}: packed path launches {launches}")
        groups = sorted(last["extra"], key=lambda g: g["bucket"])
        if [g["bucket"] for g in groups] != [32, 64, 128, 256, 1024, 2048]:
            raise AssertionError(f"{mode}: admission groups {groups}")
        last["extra"] = groups
        # the 128 and 256 buckets: 4 matmuls a layer and the head, each on
        # K5's wgmma kernel
        if not launches["K5_matmul4bit"] == last["wgmma_launches"] == want_k5:
            raise AssertionError(f"{mode}: K5 launches "
                                 f"{launches['K5_matmul4bit']} "
                                 f"({last['wgmma_launches']} wgmma), "
                                 f"expected {want_k5} on the wgmma kernel")
        if (launches["K2_flash_decode"]
                != cfg.num_layers * last["decode_steps"]):
            raise AssertionError(f"{mode}: K2 launches {launches} for "
                                 f"{last['decode_steps']} decode steps")
        results[mode] = res
        del engine
        free_memory()
    # K2 keeps keys 0..position of each slot: the bound of one step at the
    # slots' final lengths
    kept_keys = int(results["graphed"]["lengths"].sum()) + 8
    k2_bound = cfg.num_layers * k2_bound_ms(
        kept_keys, 8, cfg.num_heads, cfg.num_kv_heads, cfg.hd, bw, int8_peak)
    serve_lines("llama2_13b", results, {
        "runtime_cache": None, "layers": cfg.num_layers, "batch": 8,
        "max_seq": 2048, "steps_per_sync": 32, "prompt_lens": PACKED_PROMPTS,
        "new_tokens": 48, "k5_wgmma_launches": want_k5,
        "k2_kept_keys": kept_keys, "k2_bound_ms_per_step": k2_bound})
    return results["eager"]["passes"][-1]["launches"], k2_bound


# ---------------------------------------------------------------------------
# phase 3c and phase 6: the request API (chunked prefill, repetition
# penalty, logprobs, cancel, streaming, the bf16 KV cache)
# ---------------------------------------------------------------------------

CHUNK = 256         # phase 6's prefill_chunk: K5 at M = 256
REQUESTS_LAYERS = 10    # phases 6 and 8 serve the first 10 of phase 5's
#                         layers (the script's time; the paths are 5's)


def cut_depth(workload, layers):
    """A workload (cfg, params, prompts, sampling, engine keywords) cut to
    its first ``layers`` layers: the same weights, embedding and head."""
    cfg, params, *rest = workload
    return (dataclasses.replace(cfg, num_layers=layers),
            dict(params, layers=params["layers"][:layers]), *rest)


def run_chunks(params, cfg, device, prompt, *, quantized=True, cache=None):
    """``prompt`` into slot 0 of a fresh one-slot cache (max_seq 2048) by
    ``CHUNK``-token ``prefill_chunk_step`` calls, then
    ``prefill_final_logits``. Returns (each chunk's hidden [1, C, H] on the
    CPU, f32 logits [V] on the CPU)."""
    from tpu_bitsandbytes_torch.engine import engine as E
    from tpu_bitsandbytes_torch.engine.kvcache import KVCache
    cache = KVCache.create(cfg.num_layers, 1, 2048, cfg.num_kv_heads,
                           cfg.hd, quantized=quantized, dtype=cfg.dtype,
                           device=device)
    n, hidden = len(prompt), []
    for start in range(0, n, CHUNK):
        end = min(start + CHUNK, n)
        toks = torch.zeros((1, CHUNK), dtype=torch.int32)
        toks[0, :end - start] = torch.tensor(prompt[start:end])
        x, cache = E.prefill_chunk_step(
            params, cache, toks.to(device), 0, start, end, cfg,
            attn_span=E._chunk_span_bucket(start + CHUNK, 2048))
        hidden.append(x[0, :end - start].float().cpu())
    logits = E.prefill_final_logits(params, x, n - 1 - start, cfg)
    return hidden, logits.float().cpu()


def phase_chunked_prefill(dev, counters):
    """3c: phase 3b's Llama-2-13B-width model (2 layers, NF4-quantized
    normal weights, seed 2468) takes a 600-token prompt as three 256-token
    chunks, on the card (K5 at M = 256, then K4 for the lm_head at M = 1)
    and on the CPU (plain versions). Each chunk's hidden states must agree
    within E2E_TOL; the final logits too, with the card fed the CPU's K4
    input (per-row A8 codes turn one bf16 ulp into a few per cent, as in
    3b); the card's own-codes gap is printed beside it."""
    from tpu_bitsandbytes_torch.models.llama import LlamaConfig, to_device
    cfg = dataclasses.replace(LlamaConfig.llama2_13b(), num_layers=2)
    params = normal_nf4_params(
        cfg, numpy_normal(np.random.default_rng(2468), dev), dev)
    cpu_params = to_device(params, "cpu")
    prompt = np.random.default_rng(2469).integers(1, cfg.vocab_size,
                                                  600).tolist()
    t0 = time.perf_counter()
    cpu_x = []
    with k4_inputs(record=cpu_x):
        ref_h, ref_l = run_chunks(cpu_params, cfg, "cpu", prompt)
    cpu_s = time.perf_counter() - t0
    before = counts(counters)
    wg = counters["K5_matmul4bit"].wgmma_launches
    with k4_inputs(feed=cpu_x) as notes:
        got_h, got_l = run_chunks(params, cfg, dev, prompt)
    launches = {k: n - before[k] for k, n in counts(counters).items()}
    wgmma = counters["K5_matmul4bit"].wgmma_launches - wg
    want = {k: 0 for k in counters}
    want.update(K5_matmul4bit=3 * 4 * cfg.num_layers, K4_w4a8_matmul=1)
    if launches != want or wgmma != want["K5_matmul4bit"] or len(notes) != 1:
        raise AssertionError(f"chunked prefill: launches {launches} "
                             f"({wgmma} wgmma, {len(notes)} K4 inputs fed), "
                             f"expected {want} all on the wgmma kernel")
    hidden_err = [err(g, r)[1] for g, r in zip(got_h, ref_h)]
    fed_err = err(got_l, ref_l)[1]
    _, own_l = run_chunks(params, cfg, dev, prompt)
    own_err = err(own_l, ref_l)[1]
    if not (max(hidden_err) <= E2E_TOL and fed_err <= E2E_TOL
            and torch.isfinite(own_l).all()):
        raise AssertionError(f"chunked prefill card vs CPU: hidden "
                             f"{hidden_err}, fed logits {fed_err} > "
                             f"{E2E_TOL}")
    emit({"phase": "chunked_prefill", "layers": 2, "hidden": cfg.hidden_size,
          "prompt_len": len(prompt), "chunk": CHUNK, "tol": E2E_TOL,
          "hidden_rel_err_by_chunk": hidden_err,
          "fed_logit_rel_err": fed_err, "own_codes_logit_rel_err": own_err,
          "k4_input_rel_err": notes[0]["rel_err"],
          "k4_codes_differ": notes[0]["codes_differ"], "cpu_s": cpu_s,
          "launches": launches})


@contextlib.contextmanager
def timed_chunks(counters):
    """Each prefill chunk (``prefill_chunk_step``) and final logits
    (``prefill_final_logits``) call, timed between synchronizations, with
    its launches by ``counters`` and K5's wgmma launches: yields the list
    of calls."""
    from tpu_bitsandbytes_torch.engine import engine as E
    calls = []
    orig = {"prefill_chunk_step": E.prefill_chunk_step,
            "prefill_final_logits": E.prefill_final_logits}
    k5 = counters["K5_matmul4bit"]

    def timed(name, fn):
        def run(*args, **kw):
            before, wg = counts(counters), k5.wgmma_launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            calls.append({"call": name, "ms": (time.perf_counter() - t) * 1e3,
                          "wgmma": k5.wgmma_launches - wg,
                          "launches": {k: n - before[k] for k, n in
                                       counts(counters).items()
                                       if n - before[k]}})
            return out
        return run

    for name, fn in orig.items():
        setattr(E, name, timed(name, fn))
    try:
        yield calls
    finally:
        for name, fn in orig.items():
            setattr(E, name, fn)


def new_engine(dev, params, cfg, kw, mode):
    """A fresh engine (graphed or eager), built after the last one's memory
    went back to the device."""
    from tpu_bitsandbytes_torch.engine import engine as E
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    return E.DecodeEngine(params, cfg, device=dev,
                          cuda_graphs=mode == "graphed", **kw)


def serve_stream(engine, mode, prompts, sps, counters, plains, cancel=None,
                 must_replay=True):
    """Serve ``prompts`` once through ``generate_stream`` on ``engine``,
    cancelling request ``cancel`` (its index in ``prompts``) after its
    first streamed token. Checks what every pass must hold (stream events
    equal each request's tokens, logprobs, token ids, no plain-version call
    on a CUDA tensor, and, graphed with ``must_replay``, some decode chunk
    replayed a graph rather than captured one). Returns the result, whose
    ``launches`` each wrapper counted where it launched only if ``mode`` is
    eager (a graph's are counted at capture and added per replay)."""
    cfg = engine.config
    reset(counters, plains)
    # each decode chunk: (a prefill chunk ran before it in its step, it
    # captured a graph, wall s)
    state = {"beside": False, "graphs": engine.graph_stats()["graphs"]}
    decode = []
    advance, record = engine._advance_prefill, engine.metrics.record

    def advance_logged():
        state["beside"] = advance()
        return state["beside"]

    def record_logged(emitted, wall_s):
        graphs = engine.graph_stats()["graphs"]
        decode.append((state["beside"], graphs > state["graphs"], wall_s))
        state["graphs"] = graphs
        record(emitted, wall_s)

    engine._advance_prefill, engine.metrics.record = (advance_logged,
                                                      record_logged)
    events = []
    first_uid = engine._uid + 1
    t0 = time.perf_counter()
    with timed_chunks(counters) as calls:
        stream = engine.generate_stream(prompts, sps)
        while True:
            try:
                ev = next(stream)
            except StopIteration as stop:
                uids = stop.value
                break
            events.append(ev)
            if cancel is not None and ev[0] == first_uid + cancel:
                engine.cancel(ev[0])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    engine._advance_prefill, engine.metrics.record = advance, record
    reqs = {r.uid: r for r in engine.finished if r.uid in uids}
    if (uids != list(range(first_uid, first_uid + len(prompts)))
            or sorted(reqs) != uids):
        raise AssertionError(f"{mode}: uids {uids}, finished {sorted(reqs)}")
    for u in uids:
        r = reqs[u]
        mine = [(t, d) for uu, t, d in events if uu == u]
        if [t for t, _ in mine] != r.generated or not mine:
            raise AssertionError(f"{mode}: request {u}'s stream events "
                                 f"differ from its tokens")
        if not r.cancelled and [d for _, d in mine] != (
                [False] * (len(mine) - 1) + [True]):
            raise AssertionError(f"{mode}: request {u}'s last event is not "
                                 "its only done=True")
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"{mode}: request {u}: token out of range")
        if r.params.logprobs and not (
                len(r.logprobs) == len(r.generated)
                and all(math.isfinite(x) and x <= 0 for x in r.logprobs)):
            raise AssertionError(f"{mode}: request {u}: logprobs "
                                 f"{r.logprobs[:4]}... for "
                                 f"{len(r.generated)} tokens")
    plain_calls = sum(f.cuda_calls for f in plains)
    if plain_calls:
        raise AssertionError(f"{mode}: {plain_calls} plain-version calls on "
                             "CUDA tensors")
    chunks = [c for c in calls if c["call"] == "prefill_chunk_step"]
    finals = [c for c in calls if c["call"] == "prefill_final_logits"]
    for c in chunks:
        if c["launches"] != {"K5_matmul4bit": 4 * cfg.num_layers} or (
                c["wgmma"] != 4 * cfg.num_layers):
            raise AssertionError(f"{mode}: a prefill chunk launched {c}")
    for c in finals:
        if c["launches"] != {"K4_w4a8_matmul": 1}:
            raise AssertionError(f"{mode}: final logits launched {c}")
    n = engine.steps_per_sync
    capturing = sum(c for _, c, _ in decode)
    if mode == "graphed" and must_replay and not capturing < len(decode):
        raise AssertionError(f"{mode}: all {len(decode)} decode chunks "
                             "captured a graph; none replayed one")

    def step_ms(beside):
        """Mean decode step ms of the chunks beside (or not beside) a
        prefill chunk, those that captured a graph left out."""
        walls = [w for b, cap, w in decode if b == beside and not cap]
        return (sum(walls) / len(walls) / n * 1e3) if walls else None

    res = {"mode": mode, "wall_s": wall_s, "uids": uids, "reqs": reqs,
           "launches": counts(counters),
           "wgmma_launches": counters["K5_matmul4bit"].wgmma_launches,
           "chunk_ms": [c["ms"] for c in chunks],
           "final_chunk_ms": [c["ms"] for c in finals],
           "decode_chunks": len(decode),
           "decode_chunks_beside_prefill": sum(b for b, _, _ in decode),
           "decode_chunks_capturing": capturing,
           "decode_step_ms_beside_prefill": step_ms(True),
           "decode_step_ms_alone": step_ms(False),
           "graph_keys": engine.graph_keys(), "graphs": engine.graph_stats(),
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated()
           / 2 ** 30,
           "max_memory_reserved_gib": torch.cuda.max_memory_reserved()
           / 2 ** 30}
    return res


def chunk_launches(engine, key, counters):
    """Launches per decode step of one more chunk of ``key`` (span,
    n_steps, all_greedy, penalty, want_logprobs, attn_start) from every
    slot's current position: by the counters (eager: each wrapper's own;
    graphed: the replay's), and, graphed, by the kernel nodes of the key's
    graph."""
    span, n, greedy, penalty, want_lp, a_start = key
    b, vocab = engine.max_batch, engine.config.vocab_size
    before = counts(counters)
    engine.run_chunk(np.ones((b,), np.int32), np.ones((b,), bool),
                     all_greedy=greedy, attn_span=span,
                     seen=np.zeros((b, vocab), bool) if penalty else None,
                     want_logprobs=want_lp, attn_start=a_start)
    torch.cuda.synchronize()
    got = {"counters": {k: (c - before[k]) / n
                        for k, c in counts(counters).items()}}
    if engine.graph_keys():
        names = engine.graph_kernel_names(span, greedy, penalty, want_lp,
                                          a_start)
        got["graph_nodes"] = {
            k: sum(c for nm, c in names.items() if re.search(rx, nm)) / n
            for k, rx in KERNEL_RE.items()}
    return got


def request_line(res):
    """A pass's printed numbers."""
    g = res["graphs"]
    return {"mode": res["mode"], "wall_s": res["wall_s"],
            "prefill_chunks": len(res["chunk_ms"]), "chunk_ms": res["chunk_ms"],
            "final_chunk_ms": res["final_chunk_ms"],
            "decode_chunks": res["decode_chunks"],
            "decode_chunks_beside_prefill":
                res["decode_chunks_beside_prefill"],
            "decode_chunks_capturing": res["decode_chunks_capturing"],
            "decode_step_ms_beside_prefill":
                res["decode_step_ms_beside_prefill"],
            "decode_step_ms_alone": res["decode_step_ms_alone"],
            "graph_keys": res["graph_keys"], "graphs_captured": g["graphs"],
            "capture_s": g["capture_s"],
            "graph_pool_mib": g["pool_bytes"] / 2 ** 20,
            "max_memory_allocated_gib": res["max_memory_allocated_gib"],
            "max_memory_reserved_gib": res["max_memory_reserved_gib"],
            "launches": res["launches"],
            "k5_wgmma_launches": res["wgmma_launches"]}


def phase_requests(dev, counters, plains, workload):
    """6: the request API at Llama-2-13B width (phase 5's model off the
    packed bytes, cut to ``REQUESTS_LAYERS`` layers by the caller; the
    counts below are at 40), B=8, max_seq 2048, 32-step chunks,
    ``prefill_chunk`` 256, nine requests: phase 5's eight prompts and a
    300-token one, queued until request 6's slot frees. Pass A (graphed,
    through ``generate_stream``): greedy, penalties, logprobs, a sampled
    request and request 6 cancelled after its first streamed token. Pass B
    (graphed on pass A's engine, eager on a fresh one): the same prompts
    all greedy, penalties and logprobs kept; tokens identical and logprobs
    within 1e-5, 161 K4 + 40 K2 per step of a penalty-and-logprobs chunk
    by the counters and the graph's nodes. Pass C (bf16 KV): requests 0-3 and 7, 16 greedy
    tokens, served once eager and twice on one graphed engine (the second
    serving replays the graphs the first captured); both graphed servings'
    tokens identical to the eager one's, no K2, 161
    K4 per step, finite logits of a decode step at the end. Every graphed
    serving but pass C's first must replay a graph. Then, on fresh caches, the
    1800-token prompt chunked against one bucket-2048 ``prefill_step``
    (K3), in both cache modes. Every 256-token chunk runs 160 K5 launches
    on the wgmma kernel and every final chunk 1 K4. Returns pass B's eager
    launches (equal to its graphed pass's)."""
    from tpu_bitsandbytes_torch.engine import engine as E
    from tpu_bitsandbytes_torch.engine.kvcache import KVCache
    t_phase = time.perf_counter()
    cfg, params, prompts, greedy, kw = workload
    prompts = prompts + [np.random.default_rng(19).integers(
        1, cfg.vocab_size, 300).tolist()]
    kw = dict(kw, prefill_chunk=CHUNK)
    pen = dataclasses.replace(greedy, repetition_penalty=1.3)
    lp = dataclasses.replace(greedy, logprobs=True)
    both = dataclasses.replace(pen, logprobs=True)
    hot = dataclasses.replace(greedy, temperature=0.8, top_p=0.9)
    common = {"model": "llama2_13b", "layers": cfg.num_layers, "batch": 8,
              "max_seq": 2048, "steps_per_sync": 32, "prefill_chunk": CHUNK,
              "prompt_lens": [len(p) for p in prompts]}
    per_step = {k: 0.0 for k in KERNEL_RE}
    per_step.update(K4_w4a8_matmul=4 * cfg.num_layers + 1.0,
                    K2_flash_decode=float(cfg.num_layers))

    # pass A: graphed, the full mix
    engine_a = new_engine(dev, params, cfg, kw, "graphed")
    res_a = serve_stream(
        engine_a, "graphed", prompts,
        [greedy, greedy, pen, lp, both, hot, greedy, greedy, greedy],
        counters, plains, cancel=6)
    reqs = res_a["reqs"]
    if not (reqs[7].cancelled and len(reqs[7].generated) < 48
            and all(len(reqs[u].generated) == 48 for u in reqs if u != 7)):
        raise AssertionError("pass A: token counts "
                             f"{ {u: len(r.generated) for u, r in reqs.items()} }")
    emit({"phase": "requests", "pass": "A", **common, **request_line(res_a),
          "cancelled_tokens": len(reqs[7].generated),
          "slots": {u: r.slot for u, r in reqs.items()},
          "logprobs_per_request": {u: len(r.logprobs) for u, r in reqs.items()
                                   if r.params.logprobs}})

    # pass B: all greedy, penalties and logprobs kept; graphed on pass A's
    # engine (the keys both mixes reach replay A's graphs), then eager on a
    # fresh engine
    sps_b = [greedy, greedy, pen, lp, both, greedy, greedy, greedy, greedy]
    res_b, steps_b = {}, {}
    for mode in MODES:
        if mode == "graphed":
            engine, engine_a = engine_a, None
        else:
            engine = new_engine(dev, params, cfg, kw, mode)
        res = serve_stream(engine, mode, prompts, sps_b, counters, plains)
        keys = [k for k in res["graph_keys"] if k[3] and k[4]]
        key = keys[0] if keys else (256, 32, True, True, True, 0)
        steps_b[mode] = chunk_launches(engine, key, counters)
        if any(c != per_step for c in steps_b[mode].values()):
            raise AssertionError(f"pass B {mode}: launches per step of a "
                                 f"penalty-and-logprobs chunk "
                                 f"{steps_b[mode]}, expected {per_step}")
        res_b[mode] = res
        del engine
    # the path's launches: the eager pass's, each counted by its wrapper
    # where it launched; the graphed pass's, counted at capture and added
    # per replay, must equal them
    launches = res_b["eager"]["launches"]
    if res_b["graphed"]["launches"] != launches:
        raise AssertionError(f"pass B: the graphed pass counted "
                             f"{res_b['graphed']['launches']} launches, the "
                             f"eager pass {launches}")
    for k in ("K2_flash_decode", "K4_w4a8_matmul", "K5_matmul4bit"):
        if not launches[k]:
            raise AssertionError(f"pass B: {k} never launched")
    # request by request, in order (the graphed engine's uids follow pass
    # A's)
    e_reqs, g_reqs = ([res_b[m]["reqs"][u] for u in res_b[m]["uids"]]
                      for m in ("eager", "graphed"))
    lp_gap = 0.0
    for i, (e, g) in enumerate(zip(e_reqs, g_reqs)):
        if e.generated != g.generated:
            raise AssertionError(f"pass B: request {i}'s tokens differ "
                                 "between eager and graphed chunks")
        if e.logprobs:
            lp_gap = max(lp_gap, float(np.abs(
                np.array(e.logprobs) - np.array(g.logprobs)).max()))
    if not lp_gap <= 1e-5:
        raise AssertionError(f"pass B: logprobs eager vs graphed {lp_gap}")
    for mode in MODES:
        emit({"phase": "requests", "pass": "B", **common,
              **request_line(res_b[mode]),
              "launches_per_step_penalty_logprobs": steps_b[mode]})
    emit({"phase": "requests_compare", "pass": "B",
          "tokens_identical": True, "logprob_max_abs_gap": lp_gap,
          "decode_step_ms_alone": {
              m: res_b[m]["decode_step_ms_alone"] for m in MODES}})

    # pass C: bf16 KV, eager once and graphed twice on one engine: the
    # first graphed serving captures each key's graph, the second replays;
    # both are held to the eager serving
    kw_c = dict(kw, quantized_kv=False)
    pick = [0, 1, 2, 3, 7]
    sp_c = dataclasses.replace(greedy, max_new_tokens=16)
    per_step_c = dict(per_step, K2_flash_decode=0.0)
    res_c, steps_c = {}, {}
    for mode in MODES:
        engine = new_engine(dev, params, cfg, kw_c, mode)
        res_c[mode] = [serve_stream(engine, mode, [prompts[i] for i in pick],
                                    [sp_c] * len(pick), counters, plains,
                                    must_replay=i > 0)
                       for i in range(2 if mode == "graphed" else 1)]
        lengths = engine.cache.lengths.clone()
        span = E._span_bucket(int(lengths.max()) + 32, 2048)
        steps_c[mode] = chunk_launches(engine,
                                       (span, 32, True, False, False, 0),
                                       counters)
        if any(c != per_step_c for c in steps_c[mode].values()):
            raise AssertionError(f"pass C {mode}: launches per step "
                                 f"{steps_c[mode]}, expected {per_step_c}")
        engine.cache.lengths.copy_(lengths)
        last = res_c[mode][-1]
        toks = torch.tensor([last["reqs"][u].generated[-1]
                             for u in last["uids"]]
                            + [0] * (8 - len(pick)), dtype=torch.int32,
                            device=dev)
        logits = E.decode_step(engine.params, engine.cache, toks,
                               torch.ones((8,), dtype=torch.bool,
                                          device=dev), cfg,
                               attn_span=span)[0]
        if not torch.isfinite(logits).all():
            raise AssertionError(f"pass C {mode}: decode-step logits not "
                                 "finite")
        del engine, logits
    e = res_c["eager"][0]
    for i, g in enumerate(res_c["graphed"]):
        if ([e["reqs"][u].generated for u in e["uids"]]
                != [g["reqs"][u].generated for u in g["uids"]]):
            raise AssertionError(f"pass C, serving {i + 1}: tokens differ "
                                 "between eager and graphed chunks")
    for mode in MODES:
        for i, res in enumerate(res_c[mode]):
            emit({"phase": "requests", "pass": "C", "kv": "bf16",
                  "serving": i + 1, **common,
                  "prompt_lens": [len(prompts[j]) for j in pick],
                  "new_tokens": 16, **request_line(res),
                  "launches_per_step": steps_c[mode]})

    # chunked against unchunked, the 1800-token prompt, fresh caches: the
    # last-token logits within E2E_TOL of max|ref| and the same argmax, in
    # both cache modes (with int8 KV the chunks attend over int8 codes, the
    # unchunked forward over its own bf16 K/V; JAX's tests hold that mode
    # only to the first token, tests/test_engine.py:772-784)
    free_memory()
    long_prompt = prompts[7]
    gaps = {}
    for quantized in (False, True):
        _, chunked = run_chunks(params, cfg, dev, long_prompt,
                                quantized=quantized)
        cache = KVCache.create(cfg.num_layers, 1, 2048, cfg.num_kv_heads,
                               cfg.hd, quantized=quantized, dtype=cfg.dtype,
                               device=dev)
        padded = torch.zeros((1, 2048), dtype=torch.int32)
        padded[0, :len(long_prompt)] = torch.tensor(long_prompt)
        k3 = counters["K3_flash_prefill"].launches
        ref, cache = E.prefill_step(params, cache, padded.to(dev), 0,
                                    len(long_prompt), cfg)
        if counters["K3_flash_prefill"].launches - k3 != cfg.num_layers:
            raise AssertionError("unchunked prefill did not run K3")
        ref = ref.float().cpu()
        gaps["int8" if quantized else "bf16"] = {
            "rel_err": err(chunked, ref)[1],
            "argmax_equal": bool(chunked.argmax() == ref.argmax())}
        del cache
        free_memory()
    if not all(g["rel_err"] <= E2E_TOL and g["argmax_equal"]
               for g in gaps.values()):
        raise AssertionError(f"chunked vs unchunked: {gaps} (tol "
                             f"{E2E_TOL}, argmax equal)")
    emit({"phase": "chunked_vs_unchunked", "prompt_len": len(long_prompt),
          "chunk": CHUNK, "gaps": gaps, "tol": E2E_TOL})
    emit({"phase": "requests_wall", "seconds": time.perf_counter() - t_phase})
    return launches



# ---------------------------------------------------------------------------
# phase 8: runtime_cache="auto" at Llama-2-13B (the int8 cache on 80 GB)
# ---------------------------------------------------------------------------

def phase_auto(dev, counters, plains, workload):
    """8: phase 5's model, prompts and 48 greedy tokens served through
    ``runtime_cache="auto"``, graphed and eager (:func:`serve_mode`):
    "auto" must pick the int8 cache (its cache-only total
    fits 0.92 of the card) and keep the packed codes (their total fits
    too); tokens identical between the modes; every decode step 40 K2 and
    no K1, K4 or K5 launch, by the counters and the graph's nodes; K3 for
    the 1024 and 2048 buckets; no K1, K4 or K5 anywhere in the pass. Then
    one graphed serving of the prompts of at most 256 tokens through the
    bf16 cache, with the same launches per step. Returns the eager pass's
    launches."""
    from tpu_bitsandbytes_torch.utils.metrics import format_footprint
    t_phase = time.perf_counter()
    cfg, params, prompts, sp, kw = workload
    want = {"K1_int4_matmul": 0, "K2_flash_decode": cfg.num_layers,
            "K3_flash_prefill": 0, "K4_w4a8_matmul": 0, "K5_matmul4bit": 0}
    no_matmul_kernels = ("K1_int4_matmul", "K4_w4a8_matmul", "K5_matmul4bit")
    kw = dict(kw, runtime_cache="auto")
    results, footprint = {}, None
    for mode in MODES:
        res, engine = serve_mode(dev, params, cfg, kw, mode, prompts, sp,
                                 counters, plains, want,
                                 lambda: timed_prefills(counters))
        fp = engine.footprint()
        if (engine.runtime_cache != "int8" or not fp["packed"]
                or not fp["fits"] or not all(
                    w.packed is not None and w.w_cache.dtype == torch.int8
                    for w in qlinears(engine.params))):
            raise AssertionError(f"auto picked {engine.runtime_cache}, "
                                 f"footprint {fp}: expected the int8 cache "
                                 "with the packed codes kept")
        footprint = fp
        last = res["passes"][-1]
        launches = last["launches"]
        if (not launches["K3_flash_prefill"]
                or any(launches[k] for k in no_matmul_kernels)
                or launches["K2_flash_decode"]
                != cfg.num_layers * last["decode_steps"]):
            raise AssertionError(f"auto {mode}: launches {launches}")
        last["extra"] = sorted(last["extra"], key=lambda g: g["bucket"])
        results[mode] = res
        del engine
        free_memory()
    emit({"phase": "auto", "model": "llama2_13b", "picked": "int8",
          "footprint": footprint,
          "footprint_gib": {k: footprint[k] / 2 ** 30
                            for k in ("packed", "exec_cache", "fp", "kv",
                                      "activations_est", "total",
                                      "budget")},
          "table": format_footprint(footprint).splitlines()})
    serve_lines("llama2_13b_auto_int8", results, {
        "runtime_cache": "auto -> int8", "layers": cfg.num_layers,
        "batch": 8, "max_seq": 2048, "steps_per_sync": 32,
        "prompt_lens": PACKED_PROMPTS, "new_tokens": sp.max_new_tokens})

    # the bf16 cache, graphed, the prompts of at most 256 tokens
    short = [p for p in prompts if len(p) <= 256]
    kw_bf16 = dict(kw, runtime_cache="bf16", max_seq=512,
                   max_batch=len(short))
    res, engine = serve_mode(dev, params, cfg, kw_bf16, "graphed", short, sp,
                             counters, plains, want)
    launches = res["passes"][-1]["launches"]
    if (any(launches[k] for k in no_matmul_kernels) or not all(
            w.w_cache.dtype == torch.bfloat16
            for w in qlinears(engine.params))):
        raise AssertionError(f"bf16 cache: launches {launches}")
    p2 = res["passes"][-1]
    emit({"phase": "serve", "model": "llama2_13b_bf16_cache",
          "mode": "graphed", "runtime_cache": "bf16", "layers": cfg.num_layers,
          "batch": len(short), "max_seq": 512,
          "prompt_lens": [len(p) for p in short],
          "new_tokens": sp.max_new_tokens,
          "decode_step_ms": p2["decode_step_ms"],
          "decode_tokens_per_s": p2["decode_tokens_per_s"],
          **{k: v for k, v in res["step_breakdown"].items()
             if k != "top_device_ops"},
          "graph_pool_mib": res["graphs"]["pool_bytes"] / 2 ** 20,
          "capture_s": res["graphs"]["capture_s"],
          "max_memory_allocated_gib": res["max_memory_allocated_gib"],
          "max_memory_reserved_gib": res["max_memory_reserved_gib"],
          "footprint_gib": {k: v / 2 ** 30 for k, v in engine.footprint(
          ).items() if k not in ("fits",)},
          "launches": launches})
    del engine
    free_memory()
    emit({"phase": "auto_wall", "seconds": time.perf_counter() - t_phase})
    return results["eager"]["passes"][-1]["launches"]


# ---------------------------------------------------------------------------
# phase 7: the engine's lifecycle at Llama-2-7B width (footprint, warm-up,
# snapshot and restore, pipelined dispatch, speculative decoding)
# ---------------------------------------------------------------------------

# new tokens per request of the snapshot and the pipelined timing: three
# chunks, the requests mid-flight after two steps, within phase 4's spans
LIFECYCLE_NEW = 96
# the pipelined comparison's new tokens: two chunks, within the script's
# time with phases 8-9
PIPELINED_NEW = 64
SPEC_GAMMA = 4
# the verify check's slots with wrong drafts: slot -> its first wrong draft
# (1 .. gamma), so that one slot accepts none and one accepts two
SPEC_WRONG = {2: 1, 5: 3}
# least share of the speculative engine's greedy tokens equal to plain
# greedy's at bf16: a flipped near-tie forks only its own slot's stream
# (PERF.md); a verify that broke acceptance would fork every slot
SPEC_SAME_FLOOR = 0.75


def tensor_bytes(tree) -> int:
    """Bytes of every distinct tensor in a parameter tree (dicts, lists,
    dataclasses such as QLinear4), counted by walking the tree itself."""
    seen, total = set(), 0

    def visit(t):
        nonlocal total
        if isinstance(t, torch.Tensor):
            key = (t.data_ptr(), t.numel(), t.dtype)
            if key not in seen:
                seen.add(key)
                total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            for v in t.values():
                visit(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                visit(v)
        elif dataclasses.is_dataclass(t) and not isinstance(t, type):
            for f in dataclasses.fields(t):
                visit(getattr(t, f.name))

    visit(tree)
    return total


def no_plain_calls(plains, what):
    n = sum(f.cuda_calls for f in plains)
    if n:
        raise AssertionError(f"{what}: {n} plain-version calls on CUDA "
                             "tensors")


def graph_nodes(names):
    """Launches per counter in a graph's kernel census."""
    return {k: sum(c for nm, c in names.items() if re.search(rx, nm))
            for k, rx in KERNEL_RE.items()}


def verify_against_decode_steps(eng, outs, counters, cfg, dev, E, S):
    """One verify step from the speculative engine's cache state after
    serving ``outs`` (each slot's last token its first input), held against
    sequential decode steps from the same state. The
    drafts are each slot's greedy tokens, except in ``SPEC_WRONG``'s slots,
    whose drafts from the one named on are the decode step's least likely
    token. (a) The eager verify's logits at all gamma + 1 positions against
    gamma + 1 decode steps fed the same tokens, within E2E_TOL; its launches
    by the counters. (b) A replay of the verify graph: its launches by the
    counters and by the graph's kernel nodes (129 K1, no K2); its emitted
    tokens and counts those of the greedy rule on (a)'s logits, each wrong
    draft rejected. (c) Two decode steps after that replay, which leaves the
    rejected drafts' KV behind the lengths, fed each slot's accepted tokens'
    greedy continuation, against decode steps fed the same tokens from the
    first state, within E2E_TOL. Returns the readings, the graph's key, the
    state's lengths and the verify's tokens."""
    g1 = SPEC_GAMMA + 1
    cache = eng.cache
    lengths = cache.lengths.clone()
    b = lengths.shape[0]
    ones = torch.ones((b,), dtype=torch.bool, device=dev)
    active = np.ones((b,), bool)
    span = E._span_bucket(int(lengths.max()) + g1 + 3, eng.max_seq)
    wrong_from = torch.tensor([SPEC_WRONG.get(i, g1) for i in range(b)],
                              device=dev)

    def decode_steps(first, pick, n):
        """``n`` decode steps from ``lengths``, step j fed column j of the
        returned tokens [B, n]: ``first``, then ``pick(j, logits of step
        j - 1)``; and the steps' logits [B, n, V]."""
        cache.lengths.copy_(lengths)
        toks, logits = [first], []
        for j in range(1, n + 1):
            lg = E.decode_step(eng.params, cache, toks[-1], ones, cfg,
                               attn_span=span)[0]
            logits.append(lg)
            toks.append(pick(j, lg).to(torch.int32))
        cache.lengths.copy_(lengths)
        return torch.stack(toks[:n], 1), torch.stack(logits, 1)

    last = torch.tensor([o[-1] for o in outs], dtype=torch.int32,
                        device=dev)
    vt, ref1 = decode_steps(
        last, lambda j, lg: torch.where(j >= wrong_from, lg.argmin(-1),
                                        lg.argmax(-1)), g1)
    # (a) the eager verify against the decode steps, at every position
    before = counts(counters)
    v_logits = S.verify_logits(eng.params, cache, vt, cfg, attn_span=span)
    torch.cuda.synchronize()
    eager = {k: n - before[k] for k, n in counts(counters).items()}
    cache.lengths.copy_(lengths)
    logit_err = err(v_logits, ref1)[1]
    pos0_err = err(v_logits[:, 0], ref1[:, 0])[1]
    preds = v_logits.argmax(-1).to(torch.int32)
    n_acc = torch.cumprod((preds[:, :-1] == vt[:, 1:]).to(torch.int32),
                          dim=1).sum(1)
    want_emit = torch.where(
        torch.arange(g1, device=dev)[None, :] < n_acc[:, None],
        torch.cat([vt[:, 1:], vt[:, :1]], 1), preds.gather(1, n_acc[:, None]))
    # each slot's accepted tokens, then its greedy continuation
    tok2, ref2 = decode_steps(
        last, lambda j, lg: torch.where(j <= n_acc, vt[:, min(j, g1 - 1)],
                                        lg.argmax(-1)), g1 + 2)
    # (b) the verify graph, captured at the key's first use
    key = ("verify", span, SPEC_GAMMA, True)
    vt_np = vt.cpu().numpy()
    if key not in eng.graph_keys():
        eng.run_verify(vt_np, active, all_greedy=True, attn_span=span)
        cache.lengths.copy_(lengths)
    before = counts(counters)
    emitted, cnt = (t.clone() for t in eng.run_verify(
        vt_np, active, all_greedy=True, attn_span=span))
    torch.cuda.synchronize()
    replay = {k: n - before[k] for k, n in counts(counters).items()}
    nodes = graph_nodes(eng.verify_kernel_names(span, True))
    upto = torch.arange(g1, device=dev)[None, :] <= n_acc[:, None]
    rule_ok = (torch.equal(cnt, (n_acc + 1).to(cnt.dtype))
               and bool(((emitted == want_emit) | ~upto).all()))
    # (c) two decode steps over the stale draft KV
    cont_err = 0.0
    for c in range(2):
        at = (cnt.long() + c)[:, None]
        lg = E.decode_step(eng.params, cache, tok2.gather(1, at)[:, 0], ones,
                           cfg, attn_span=span)[0]
        want = ref2.gather(1, at[..., None].expand(b, 1, ref2.shape[-1]))
        cont_err = max(cont_err, err(lg, want[:, 0])[1])
    cache.lengths.copy_(lengths)
    want_v = {k: 0 for k in KERNEL_RE}
    want_v["K1_int4_matmul"] = 4 * cfg.num_layers + 1
    rejected = all(int(n_acc[i]) < w for i, w in SPEC_WRONG.items())
    if (eager != want_v or replay != want_v or nodes != want_v
            or not logit_err <= E2E_TOL or not cont_err <= E2E_TOL
            or not rule_ok or not rejected
            or not torch.isfinite(v_logits).all()):
        raise AssertionError(
            f"verify step: launches eager {eager}, replay {replay}, graph "
            f"nodes {nodes} (want {want_v}); logits {logit_err} and after "
            f"rejection {cont_err} of max|ref| from decode steps' (tol "
            f"{E2E_TOL}); accepted {n_acc.tolist()} (wrong drafts from "
            f"{SPEC_WRONG}), replay counts {cnt.tolist()}, rule held "
            f"{rule_ok}")
    plain_next = tok2[:, 1:]
    return {"key": key, "lengths": lengths, "tokens": vt_np,
            "verify_launches_eager": eager, "verify_launches_replay": replay,
            "verify_graph_nodes": nodes,
            "verify_vs_decode_logits_rel_err": logit_err,
            "verify_vs_decode_pos0_rel_err": pos0_err,
            "after_rejection_vs_decode_logits_rel_err": cont_err,
            "wrong_drafts_from": SPEC_WRONG,
            "accepted_drafts_per_slot": n_acc.tolist(),
            "emitted_equal_to_plain_greedy": bool(
                ((emitted == plain_next[:, :g1]) | ~upto).all())}


def phase_lifecycle(dev, counters, plains, unwarmed_outs):
    """7: the engine's lifecycle on phase 4's model, prompts and seed
    (Llama-2-7B, 32 layers, int4 cache, B=8, ``max_seq`` 512, 32-step
    chunks), the int4 parameters built once and shared by every engine.
    (1) ``footprint()`` against the real allocations. (2) ``warmup`` of
    phase 4's prompt lengths with the sampled variant on a fresh graphed
    engine: the graphs captured are the plan's keys; then phase 4's
    workload, whose greedy tokens must equal ``unwarmed_outs`` (phase 4's
    graphed engine). (3) Snapshot after 2 steps; the run finished, the
    cache and lengths zeroed, the snapshot loaded into that engine, whose
    graphs predate the load: its tokens equal the uninterrupted run's.
    (4) the pipelined decode loop (``generate``'s default) against the
    step loop on that engine, phase 4's prompts with ``PIPELINED_NEW`` new
    tokens: ``step_breakdown`` of each loop from the state after the
    admission, the two loops' tokens identical. (5) ``speculative=
    "ngram"``, gamma 4: phase 4's workload served graphed, at least ``SPEC_SAME_FLOOR`` of its greedy
    tokens equal to ``unwarmed_outs``; a verify step held against decode
    steps (:func:`verify_against_decode_steps`). Then the path's launches,
    counted by the wrappers in an eager drive of the pipelined
    ``generate`` and of the speculative engine (whose tokens must equal
    the graphed ones). Returns them and the verify graph's K1 launches."""
    import tempfile
    from tpu_bitsandbytes_torch.engine import engine as E
    from tpu_bitsandbytes_torch.engine import speculative as S
    from tpu_bitsandbytes_torch.models.layers import QLinear4
    from tpu_bitsandbytes_torch.utils.metrics import (MetricsLogger,
                                                      format_footprint)
    t_phase = time.perf_counter()
    cfg, params, prompts, sp, kw = llama7b_workload(dev)
    lens = [len(p) for p in prompts]
    common = {"model": "llama2_7b", "layers": cfg.num_layers, "batch": 8,
              "max_seq": 512, "steps_per_sync": 32, "prompt_lens": lens}
    reset(counters, plains)

    # (1) the footprint against the allocations
    free_memory()
    engine = E.DecodeEngine(params, cfg, device=dev, **kw)
    fp = engine.footprint()
    shared = engine.params
    del params
    c = engine.cache
    kv = sum(t.numel() * t.element_size()
             for t in (c.k, c.v, c.k_scale, c.v_scale))
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    qlin = [w for layer in shared["layers"] for w in layer.values()
            if isinstance(w, QLinear4)] + [shared["lm_head"]]
    got = {"params": fp["packed"] + fp["exec_cache"] + fp["fp"],
           "kv": fp["kv"], "budget": fp["budget"]}
    want = {"params": tensor_bytes(shared), "kv": kv, "budget": total_mem}
    if got != want or not fp["fits"] or not fp["packed"] or not all(
            w.packed is not None and w.w_cache is not None for w in qlin):
        raise AssertionError(f"footprint {fp}: {got} against the "
                             f"allocations {want}; the codes must be kept")
    emit({"phase": "lifecycle", "step": "footprint", **common,
          "footprint": fp, "allocated": want,
          "mem_get_info_total": torch.cuda.mem_get_info(dev)[1],
          "table": format_footprint(fp).splitlines(),
          "t_s": time.perf_counter() - t_phase})
    del engine, c
    kw = dict(kw, runtime_cache=None)       # the shared params carry it

    # (2) warm-up, then phase 4's workload
    free_memory()
    eng_a = E.DecodeEngine(shared, cfg, device=dev, **kw)
    plan = eng_a.warmup(prompt_lengths=lens, features=("sampled",))
    keys = eng_a.graph_keys()
    if keys != eng_a.plan_graph_keys(plan):
        raise AssertionError(f"warm-up captured {keys}, the plan's keys "
                             f"are {eng_a.plan_graph_keys(plan)}")
    if eng_a.cache.lengths.any():
        raise AssertionError("warm-up left lengths behind")
    warm = eng_a.graph_stats()
    t0 = time.perf_counter()
    outs = eng_a.generate(prompts, sp, pipeline_depth=1)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    if outs != unwarmed_outs:
        differ = [i for i, (a, b) in enumerate(zip(outs, unwarmed_outs))
                  if a != b]
        raise AssertionError(f"warmed engine: requests {differ} differ from "
                             "the unwarmed engine's greedy tokens")
    emit({"phase": "lifecycle", "step": "warmup", **common,
          "features": ["sampled"],
          "plan": {k: v for k, v in plan.items() if k != "variants"},
          "variants": plan["variants"], "seconds": plan["seconds"],
          "graphs_captured": warm["graphs"], "graph_keys": keys,
          "capture_s": warm["capture_s"],
          "graph_pool_mib": warm["pool_bytes"] / 2 ** 20,
          "served_generate_s": serve_s,
          "served_decode_step_ms": eng_a.metrics.summary()["mean_step_ms"]
          / 32,
          "keys_serving_captured": eng_a.graph_keys()[len(keys):],
          "greedy_tokens_identical_to_unwarmed": True,
          "t_s": time.perf_counter() - t_phase})
    no_plain_calls(plains, "warm-up")

    # (3) snapshot after 2 steps, the run finished uninterrupted, then the
    # snapshot loaded back into the same engine: every graph it replays
    # (warm-up's) predates the load, and the cache and lengths are zeroed
    # first, so only a load into the captured tensors restores them;
    # LIFECYCLE_NEW tokens, so that the requests are mid-flight
    sp_long = dataclasses.replace(sp, max_new_tokens=LIFECYCLE_NEW)
    first = eng_a._uid + 1
    for p in prompts:
        eng_a.add_request(p, sp_long)
    for _ in range(2):
        eng_a.step()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/engine_state.npz"
        t0 = time.perf_counter()
        eng_a.save_state(path)
        save_s = time.perf_counter() - t0
        snap_bytes = os.path.getsize(path)
        while eng_a.step():
            pass
        ref = {r.uid: r.generated for r in eng_a.finished if r.uid >= first}
        keys_b = eng_a.graph_keys()
        c = eng_a.cache
        for t in (c.k, c.v, c.k_scale, c.v_scale, c.lengths):
            t.zero_()
        eng_a.finished.clear()
        t0 = time.perf_counter()
        eng_a.load_state(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    while eng_a.step():
        pass
    got = {r.uid: r.generated for r in eng_a.finished if r.uid >= first}
    if got != ref or len(got) != len(prompts):
        raise AssertionError("restored engine: tokens differ from the "
                             "uninterrupted run's")
    if eng_a.graph_keys() != keys_b:
        raise AssertionError(f"restored engine captured "
                             f"{eng_a.graph_keys()[len(keys_b):]} after the "
                             f"load; it had {keys_b}")
    emit({"phase": "lifecycle", "step": "snapshot", **common,
          "new_tokens": LIFECYCLE_NEW, "steps_before_save": 2,
          "snapshot_bytes": snap_bytes,
          "save_s": save_s, "load_s": load_s,
          "graphs_captured_before_load": len(keys_b),
          "keys_captured_after_load": eng_a.graph_keys()[len(keys_b):],
          "tokens_identical_to_uninterrupted": True,
          "t_s": time.perf_counter() - t_phase})
    no_plain_calls(plains, "snapshot")

    # (4) pipelined (the default) against the step loop, one engine: each
    # decode loop timed from the state after the admission (the prefills
    # run in restore, outside the windows), their tokens compared
    sp_pipe = dataclasses.replace(sp, max_new_tokens=PIPELINED_NEW)
    steps = 32 * -(-(PIPELINED_NEW - 1) // 32)

    def restore():
        eng_a.finished.clear()
        eng_a.cache.lengths.zero_()
        for p in prompts:
            eng_a.add_request(p, sp_pipe)
        eng_a._admit()
        eng_a.metrics = MetricsLogger()

    def step_loop():
        while eng_a.step():
            pass

    runs, outs = {}, {}
    for depth, loop in ((2, lambda: eng_a.run_pipelined(2)), (1, step_loop)):
        bd = runs[depth] = step_breakdown(restore, loop, steps, counters)
        outs[depth] = [r.generated for r in sorted(eng_a.finished,
                                                   key=lambda r: r.uid)]
        if len(outs[depth]) != len(prompts) or any(
                len(o) != PIPELINED_NEW for o in outs[depth]):
            raise AssertionError(f"depth {depth}: token counts")
        bd["chunks_collected"] = len(eng_a.metrics.history)
        bd["decode_step_ms"] = eng_a.metrics.summary()["mean_step_ms"] / 32
        emit({"phase": "lifecycle", "step": "pipelined", **common,
              "pipeline_depth": depth, "new_tokens": PIPELINED_NEW,
              "steps_per_request": steps,
              **{k: v for k, v in bd.items() if k != "top_device_ops"},
          "t_s": time.perf_counter() - t_phase})
    if outs[2] != outs[1]:
        raise AssertionError("pipelined and step-loop greedy tokens differ")
    emit({"phase": "lifecycle", "step": "pipelined_compare",
          "tokens_identical": True,
          **{key: {d: runs[d][key] for d in runs}
             for key in ("host_ms_per_step", "device_idle_share")}})
    no_plain_calls(plains, "pipelined")
    del eng_a
    free_memory()

    # (5) speculative decoding, gamma 4, graphed
    eng_s = E.DecodeEngine(shared, cfg, device=dev, speculative="ngram",
                           spec_gamma=SPEC_GAMMA, **kw)
    t0 = time.perf_counter()
    spec_outs = eng_s.generate(prompts, sp)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    stats = dict(eng_s.spec_stats)
    hist = eng_s.metrics.history
    same = sum(a == b for o, u in zip(spec_outs, unwarmed_outs)
               for a, b in zip(o, u))
    same_share = same / sum(len(u) for u in unwarmed_outs)
    verify = verify_against_decode_steps(eng_s, spec_outs, counters, cfg,
                                         dev, E, S)
    verify_k1 = verify["verify_launches_replay"]["K1_int4_matmul"]
    vkey, lengths, vt = verify.pop("key"), verify.pop("lengths"), verify.pop(
        "tokens")
    active = np.ones((8,), bool)
    # one verify step's host and device time, replayed from that state
    vbd = step_breakdown(
        lambda: eng_s.cache.lengths.copy_(lengths),
        lambda: eng_s.run_verify(vt, active, all_greedy=vkey[3],
                                 attn_span=vkey[1]),
        1, counters)
    eng_s.cache.lengths.copy_(lengths)
    if not same_share >= SPEC_SAME_FLOOR:
        raise AssertionError(f"speculative greedy tokens: {same_share} of "
                             f"plain greedy's, floor {SPEC_SAME_FLOOR}")
    verify_ms = [m.wall_s * 1e3 for m in hist]
    emit({"phase": "lifecycle", "step": "speculative", **common,
          "spec_gamma": SPEC_GAMMA, "generate_s": spec_s,
          "spec_stats": stats,
          "tokens_per_verify_step": sum(m.tokens for m in hist)
          / max(1, stats["verify_steps"]),
          # drafts are gamma per active slot and verify step
          "tokens_per_slot_per_verify_step":
              1 + stats["accepted"] * SPEC_GAMMA / max(1, stats["drafted"]),
          "verify_ms_mean": sum(verify_ms) / len(verify_ms),
          "verify_ms_min": min(verify_ms),
          "graph_keys": eng_s.graph_keys(),
          "graphs": eng_s.graph_stats()["graphs"],
          "greedy_tokens_equal_to_plain_share": same_share,
          "greedy_share_floor": SPEC_SAME_FLOOR, **verify,
          "verify_step_breakdown": {k: v for k, v in vbd.items()
                                    if k != "launches_per_step"},
          "tol": E2E_TOL, "t_s": time.perf_counter() - t_phase})
    no_plain_calls(plains, "speculative")
    del eng_s
    free_memory()

    # the path's launches: an eager drive of the pipelined generate and of
    # the speculative engine, each wrapper counting its own launches
    reset(counters, plains)
    eager = E.DecodeEngine(shared, cfg, device=dev, cuda_graphs=False, **kw)
    eager_outs = eager.generate(prompts, sp)
    del eager
    free_memory()
    eager_s = E.DecodeEngine(shared, cfg, device=dev, cuda_graphs=False,
                             speculative="ngram", spec_gamma=SPEC_GAMMA, **kw)
    eager_spec = eager_s.generate(prompts, sp)
    torch.cuda.synchronize()
    launches = counts(counters)
    no_plain_calls(plains, "eager drive")
    if eager_outs != unwarmed_outs or eager_spec != spec_outs:
        raise AssertionError("eager pipelined or speculative tokens differ "
                             "from the graphed engines'")
    if not launches["K1_int4_matmul"] or not launches["K2_flash_decode"]:
        raise AssertionError(f"eager drive launches {launches}")
    emit({"phase": "lifecycle", "step": "eager_drive", **common,
          "launches": launches,
          "verify_steps": eager_s.spec_stats["verify_steps"],
          "tokens_identical_to_graphed": True,
          "t_s": time.perf_counter() - t_phase})
    del eager_s, shared
    free_memory()
    emit({"phase": "lifecycle_wall", "seconds": time.perf_counter() - t_phase})
    return launches, verify_k1



# ---------------------------------------------------------------------------
# phase 9: the bitsandbytes-style API at Llama-2-7B widths
# ---------------------------------------------------------------------------

LIB_M = (1, 8, 128, 512)   # K5 up to M = 256, dequantize + matmul at 512
# Llama-2-7B: hidden, intermediate and vocabulary widths
LIB_H, LIB_I, LIB_VOCAB = 4096, 11008, 32000
# bf16 outputs, card against the CPU twin, of max|ref|: one bf16 ulp of an
# output (2^-8) after another f32 sum order
LIB_TOL = 1e-2
# quantized model against the dense one (the verify flow's bound)
LIB_COSINE = 0.95


class DecoderLinears(torch.nn.Module):
    """One Llama-2-7B decoder layer's seven projections (bias-free bf16
    ``torch.nn.Linear``) and the 32000 x 4096 embedding, composed so that
    every module runs: the attention projections summed and projected
    back, the SiLU-gated MLP, and the residual."""

    def __init__(self, rng, dev):
        super().__init__()
        h, i, vocab = LIB_H, LIB_I, LIB_VOCAB

        def lin(k, n):
            m = torch.nn.Linear(k, n, bias=False, device=dev,
                                dtype=torch.bfloat16)
            with torch.no_grad():
                m.weight.copy_(torch.from_numpy(rng.standard_normal(
                    (n, k), dtype=np.float32) * 0.02))
            return m

        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, lin(h, h))
        self.gate_proj, self.up_proj = lin(h, i), lin(h, i)
        self.down_proj = lin(i, h)
        self.embed = torch.nn.Embedding(vocab, h, device=dev,
                                        dtype=torch.bfloat16)
        with torch.no_grad():
            self.embed.weight.copy_(torch.from_numpy(rng.standard_normal(
                (vocab, h), dtype=np.float32)))

    def forward(self, ids):
        x = self.embed(ids)
        a = self.o_proj(self.q_proj(x) + self.k_proj(x) + self.v_proj(x))
        m = self.down_proj(torch.nn.functional.silu(self.gate_proj(x))
                           * self.up_proj(x))
        return x + a + m


def cosine(a, b):
    a, b = a.float().reshape(-1), b.float().reshape(-1)
    return float(a @ b / (a.norm() * b.norm()))


def phase_library(dev, counters, plains):
    """9: the bitsandbytes-style API at Llama-2-7B widths, from one numpy
    seed. ``quantize_model`` of :class:`DecoderLinears` with NF4 and
    double quantization, then with int8: every projection converted, the
    output changed and within cosine 0.95 of the dense model's. Linear4bit
    (nf4, fp4) at M = 1, 8, 128, 512: one K5 launch per call up to M = 256
    (on its wgmma kernel), none at 512; Linear8bit, LinearFP8,
    OutlierAwareLinear (planted outlier columns; its int8 product through
    ``torch._int_mm``) and the 4-bit and int8 embeddings: each held to
    its twin on the CPU. SwitchBackLinear forward and backward: gradients
    equal to a dense ``torch.nn.Linear`` whose weight is the master weight.
    A Linear4bit ``state_dict`` round trip. No plain version of K1-K5 runs
    on a CUDA tensor. Returns the phase's launches."""
    import copy
    import tpu_bitsandbytes_torch as P
    t_phase = time.perf_counter()
    h, i, vocab = LIB_H, LIB_I, LIB_VOCAB
    rng = np.random.default_rng(4242)
    dense = DecoderLinears(rng, dev)
    ids = torch.from_numpy(rng.integers(0, vocab, (2, 64))).to(dev)
    xs = {m: torch.from_numpy(rng.standard_normal((m, h),
                                                  dtype=np.float32)
                              ).to(dev, torch.bfloat16) for m in LIB_M}
    reset(counters, plains)
    k5 = counters["K5_matmul4bit"]
    with torch.no_grad():
        ref = dense(ids)
    lines = {}

    # quantize_model, NF4 with double quantization, then int8
    names = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
             "down_proj")
    for bits, cfg in ((4, P.BitsAndBytesConfig(
            load_in_4bit=True, bnb_4bit_quant_type="nf4",
            bnb_4bit_use_double_quant=True)),
                      (8, P.BitsAndBytesConfig(load_in_8bit=True))):
        before = k5.launches
        q = P.quantize_model(copy.deepcopy(dense), cfg)
        cls = P.Linear4bit if bits == 4 else P.Linear8bit
        if not all(isinstance(getattr(q, n), cls) for n in names):
            raise AssertionError(f"quantize_model {bits}-bit: not converted")
        with torch.no_grad():
            out = q(ids)
        cos = cosine(out, ref)
        if torch.allclose(out, ref) or not cos > LIB_COSINE:
            raise AssertionError(f"quantize_model {bits}-bit: cosine {cos}")
        lines[f"quantize_model_{bits}bit"] = {
            "cosine": cos, "k5_launches": k5.launches - before,
            "footprint": P.get_memory_footprint(q)}
        if bits == 4 and k5.launches - before != len(names):
            raise AssertionError("quantize_model 4-bit: K5 launches "
                                 f"{k5.launches - before}")
        del q

    # Linear4bit at M = 1 .. 512, against its CPU twin
    def twin_err(mod, x):
        """(card vs CPU twin error, the card call's K5 launches and wgmma
        launches)."""
        before = (k5.launches, k5.wgmma_launches)
        with torch.no_grad():
            got = mod(x)
            n = (k5.launches - before[0], k5.wgmma_launches - before[1])
            want = copy.deepcopy(mod).to("cpu")(x.cpu())
        a, r = err(got.cpu(), want)
        if not (r <= LIB_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"{type(mod).__name__} M={x.shape[0]}: "
                                 f"card vs CPU {r}")
        return r, n

    lin4 = {}
    for qt in ("nf4", "fp4"):
        mod = P.Linear4bit.from_linear(dense.q_proj, quant_type=qt)
        per_m = {}
        for m, x in xs.items():
            r, n = twin_err(mod, x)
            if n != ((1, 1) if m <= 256 else (0, 0)):
                raise AssertionError(f"Linear4bit {qt} M={m}: K5 launches "
                                     f"{n}")
            per_m[m] = {"rel_err": r, "k5_launches": n[0]}
        lin4[qt] = per_m
    lines["linear4bit"] = lin4

    # the other modules, against their CPU twins
    planted = copy.deepcopy(dense.q_proj)
    with torch.no_grad():
        planted.weight[:, [17, h // 2 + 1]] *= 40.0
    mods = {"Linear8bit": P.Linear8bit.from_linear(dense.gate_proj),
            "LinearFP8": P.LinearFP8.from_linear(dense.down_proj),
            "OutlierAwareLinear": P.OutlierAwareLinear.from_linear(planted)}
    found = set(mods["OutlierAwareLinear"].outlier_indices.tolist())
    if not {17, h // 2 + 1} <= found:
        raise AssertionError(f"OutlierAwareLinear: outliers {found}, the "
                             "planted columns missing")
    others = {}
    for name, mod in mods.items():
        k = mod.in_features
        others[name] = {m: twin_err(mod, (xs[m] if k == h else torch.cat(
            [xs[m]] * 3, dim=1)[:, :k]))[0] for m in (8, 128)}
    for name, mod in (("Embedding4bit", P.Embedding4bit.from_embedding(
            dense.embed)), ("Embedding8bit", P.Embedding8bit.from_embedding(
            dense.embed))):
        got = mod(ids)
        want = copy.deepcopy(mod).to("cpu")(ids.cpu())
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{name}: card and CPU lookups differ")
        others[name] = {"identical": True, "cosine_to_dense": cosine(
            got, dense.embed(ids).detach())}
    lines["modules"] = others

    # SwitchBackLinear: forward, and gradients against a dense Linear
    sb = P.SwitchBackLinear.from_linear(dense.q_proj)
    x = xs[128].clone().requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((128, h), dtype=np.float32)
                         ).to(dev, torch.bfloat16)
    out = sb(x)
    out.backward(g)
    ref_lin = torch.nn.Linear(h, h, bias=False, device=dev,
                              dtype=torch.bfloat16)
    with torch.no_grad():
        ref_lin.weight.copy_(sb.weight_fp)
    xr = xs[128].clone().requires_grad_(True)
    ref_lin(xr).backward(g)
    if not (torch.equal(x.grad, xr.grad)
            and torch.equal(sb.weight_fp.grad, ref_lin.weight.grad)):
        raise AssertionError("SwitchBackLinear: gradients differ from the "
                             "dense Linear's")
    lines["switchback"] = {"grads_equal_dense": True,
                           "forward_cosine_to_dense": cosine(
                               out.detach(), ref_lin(xs[128]).detach())}

    # a state_dict round trip
    src = P.Linear4bit.from_linear(dense.up_proj, compress_statistics=True)
    fresh = P.Linear4bit(h, i, bias=False, device=dev)
    fresh.load_state_dict(src.state_dict())
    with torch.no_grad():
        if not torch.equal(fresh(xs[8]), src(xs[8])):
            raise AssertionError("Linear4bit state_dict round trip differs")
    lines["state_dict_round_trip"] = True
    launches = counts(counters)
    no_plain_calls(plains, "library")
    emit({"phase": "library", "widths": "Llama-2-7B", "m": list(LIB_M),
          "tol": LIB_TOL, **lines, "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    del dense, mods, sb, src, fresh
    free_memory()
    return launches


# ---------------------------------------------------------------------------
# phase 10: QLoRA training at Llama-2-7B width
# ---------------------------------------------------------------------------

QLORA_STEPS = 4
QLORA_LR = 1e-4     # the train step's default optimizer, adam8bit(1e-4)
# card against the CPU at 2 layers of full width, bf16 operands and f32
# sums in other orders (K5's wgmma against its plain version, cuBLAS
# against the CPU's GEMMs), bf16 rounding every activation and cotangent:
# the loss, a mean over 256 tokens, within 1e-3 relative; the LoRA
# gradients (each leaf as a share of its max|ref|) within twice the gap
# between the CPU's bf16 gradients and its own f32 ones on the same step
# (at least E2E_TOL): if the card's bf16 gradients are no further from
# f32 than the CPU's are, the triangle inequality bounds card against
# CPU by twice that gap (phase 3b holds logits to the gap itself, which
# one bf16 run's noise against another's can exceed). Adam divides
# each gradient element by its own RMS, so an element whose gradient sits
# within that error of zero can move its update by up to 2 lr in each step
# (Adam's first steps move an element by at most about lr, and the 8-bit
# moments' rounding a little more): at least 95% of the elements within
# 0.1 lr, all within 2.5 lr per step taken.
QLORA_LOSS_TOL = 1e-3
QLORA_PARAM_TOL = (0.1, 0.95, 2.5)


def frozen_linears(tree):
    """(the QLinear4s one forward runs, those inside the layers): each
    layer's seven projections (a LoRA adapter's base among them) and the
    quantized lm_head."""
    from tpu_bitsandbytes_torch.models.layers import QLinear4
    in_layers = sum(isinstance(getattr(w, "base", w), QLinear4)
                    for layer in tree["layers"] for w in layer.values())
    return in_layers + isinstance(tree.get("lm_head"), QLinear4), in_layers


def state_bytes(opt_state) -> int:
    """Bytes of an adam8bit state: the int8/uint8 codes and their f32
    absmax/max."""
    from tpu_bitsandbytes_torch.optim.transforms import tree_leaves
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(list(opt_state)[1:]))


def lora_7b(cfg, dev, seed):
    """``cfg`` with random packed NF4 weights drawn on the card (the seven
    projections apart) and LoRA at the JAX package's defaults (r 8, alpha
    16, q_proj and v_proj, bf16)."""
    from tpu_bitsandbytes_torch.models.lora import attach_lora
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = random_params(
        cfg,
        lambda s: torch.randint(0, 256, s, generator=gen, device=dev,
                                dtype=torch.uint8),
        lambda s: torch.rand(s, generator=gen, device=dev),
        lambda s: torch.randn(s, generator=gen, device=dev), dev,
        fused=False)
    return attach_lora(params, generator=gen)


def leaves_equal(a, b) -> bool:
    from tpu_bitsandbytes_torch.optim.transforms import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def qlora_card_vs_cpu(dev, cfg, tokens, smi):
    """2 layers of full width: two steps (the train step's pieces, so the
    gradients can be read) on the card and on the CPU from the same
    weights and adapters, held to the QLORA tolerances; then the card's
    trained tree through ``save_checkpoint``/``load_checkpoint``."""
    import tempfile
    from tpu_bitsandbytes_torch.models import llama as L
    from tpu_bitsandbytes_torch.models.lora import (lora_trainable,
                                                    merge_lora_trainable)
    from tpu_bitsandbytes_torch.optim import transforms as T
    from tpu_bitsandbytes_torch.parallel.train import qlora_loss_and_grads
    from tpu_bitsandbytes_torch.utils.checkpoint import (load_checkpoint,
                                                         save_checkpoint)
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    cfg32 = dataclasses.replace(cfg2, dtype=torch.float32)
    frozen = {"card": lora_7b(cfg2, dev, seed=21)}
    frozen["cpu"] = L.to_device(frozen["card"], "cpu")
    cpu_f32 = as_f32(frozen["cpu"])
    tx = T.adam8bit(QLORA_LR)
    tr = {k: lora_trainable(v) for k, v in frozen.items()}
    st = {k: tx.init(v) for k, v in tr.items()}
    toks = {"card": tokens, "cpu": tokens.cpu()}
    lines, secs = [], {"card": 0.0, "cpu": 0.0}
    for step in range(2):
        # the yardstick: the CPU's f32 gradients at the same adapters
        t0 = time.perf_counter()
        _, g32 = qlora_loss_and_grads(cfg32, tr["cpu"], cpu_f32, toks["cpu"])
        secs["cpu_f32"] = secs.get("cpu_f32", 0.0) + time.perf_counter() - t0
        out = {}
        for where in ("card", "cpu"):
            t0 = time.perf_counter()
            loss, g = qlora_loss_and_grads(cfg2, tr[where], frozen[where],
                                           toks[where])
            with torch.no_grad():
                upd, st[where] = tx.update(g, st[where], tr[where])
                tr[where] = T.apply_updates(tr[where], upd)
            if where == "card":
                torch.cuda.synchronize()
            secs[where] += time.perf_counter() - t0
            out[where] = (float(loss), g)
        loss_gap = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])

        def gap(got, ref):
            return max(err(a.float().cpu(), b.float())[1] for a, b in zip(
                T.tree_leaves(got), T.tree_leaves(ref)) if b.any())
        grad_gap = gap(out["card"][1], out["cpu"][1])
        cpu_gap = gap(out["cpu"][1], g32)
        grad_tol = max(E2E_TOL, 2 * cpu_gap)
        d = torch.cat([(a.float().cpu() - b.float()).abs().reshape(-1)
                       for a, b in zip(T.tree_leaves(tr["card"]),
                                       T.tree_leaves(tr["cpu"]))])
        within, share, most = QLORA_PARAM_TOL
        param_share = float((d <= within * QLORA_LR).float().mean())
        codes = [(a.cpu() == b).float().mean().item()
                 for f in ("exp_avg_int8", "exp_avg_sq_uint8")
                 for a, b in zip(T.tree_leaves(getattr(st["card"], f)),
                                 T.tree_leaves(getattr(st["cpu"], f)))]
        lines.append({"step": step + 1, "loss_card": out["card"][0],
                      "loss_cpu": out["cpu"][0], "loss_rel_gap": loss_gap,
                      "grad_rel_err": grad_gap, "grad_tol": grad_tol,
                      "cpu_bf16_vs_f32_grad": cpu_gap,
                      "card_vs_cpu_f32_grad": gap(out["card"][1], g32),
                      "param_share_within_0.1lr": param_share,
                      "param_max_gap_lr": float(d.max()) / QLORA_LR,
                      "codes_equal_share": min(codes)})
        if not (loss_gap <= QLORA_LOSS_TOL and grad_gap <= grad_tol
                and param_share >= share
                and float(d.max()) <= most * (step + 1) * QLORA_LR):
            raise AssertionError(f"qlora card vs CPU: {lines[-1]}")
    trained = merge_lora_trainable(frozen["card"], tr["card"])
    probe = tokens[:, :-1]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "qlora_2l")
        t0 = time.perf_counter()
        save_checkpoint(path, trained)
        back = L.to_device(load_checkpoint(path), dev)
        ckpt_s = time.perf_counter() - t0
    with torch.no_grad():
        same = torch.equal(L.forward(trained, probe, cfg2),
                           L.forward(back, probe, cfg2))
    if not same:
        raise AssertionError("qlora: logits of the reloaded checkpoint "
                             "differ from the trained tree's")
    emit({"phase": "qlora_card_vs_cpu", "layers": 2,
          "widths": "Llama-2-7B", "card": smi, "steps": lines,
          "tol": {"loss_rel": QLORA_LOSS_TOL, "param": QLORA_PARAM_TOL},
          "card_s": secs["card"], "cpu_s": secs["cpu"],
          "cpu_f32_s": secs["cpu_f32"],
          "checkpoint_round_trip_s": ckpt_s, "logits_identical": same})


def phase_qlora(dev, counters, plains, smi):
    """10: QLoRA training through the port's entry points at Llama-2-7B
    width (32 layers, packed NF4 at blocksize 64, bf16 compute, no runtime
    cache; LoRA r 8 on q_proj and v_proj; ``make_qlora_train_step`` with
    adam8bit(1e-4)): 4 steps on one seeded 1 x 257 batch (every frozen
    linear at M = 256 on K5's wgmma kernel), one ``remat`` step and the
    gradients with and without ``remat`` from the same start (bit for
    bit), one step at 2 x 513 (M = 1024, the dequantized product), a
    ``PagedAdamW`` step on the LoRA leaves; then 2 layers against the CPU.
    Returns the 4 steps' launches."""
    from tpu_bitsandbytes_torch.models import llama as L
    from tpu_bitsandbytes_torch.models.lora import (lora_trainable,
                                                    merge_lora_trainable)
    from tpu_bitsandbytes_torch.optim import PagedAdamW
    from tpu_bitsandbytes_torch.optim.transforms import tree_leaves
    from tpu_bitsandbytes_torch.parallel.train import (make_qlora_train_step,
                                                       qlora_loss_and_grads)
    t_phase = time.perf_counter()
    k5 = counters["K5_matmul4bit"]
    cfg = L.LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    frozen = lora_7b(cfg, dev, seed=20)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    per_fwd, per_layers = frozen_linears(frozen)
    if per_fwd != 7 * cfg.num_layers + 1:
        raise AssertionError(f"qlora: {per_fwd} frozen linears per forward")
    rng = np.random.default_rng(10)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, 257))).to(dev)
    init, train_step = make_qlora_train_step(cfg)
    start = lora_trainable(frozen)
    tr, st = start, init(start)

    def counted(fn, want, what):
        reset(counters, plains)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = (k5.launches, k5.wgmma_launches)
        if got != (want, want):
            raise AssertionError(f"qlora {what}: K5 launches (all, wgmma) "
                                 f"{got}, the tree gives {want}")
        no_plain_calls(plains, f"qlora {what}")
        return out, ms, torch.cuda.max_memory_allocated() / 2 ** 30

    steps, launches = [], {k: 0 for k in counters}
    for i in range(QLORA_STEPS):
        (tr, st, loss), ms, peak = counted(
            lambda: train_step(tr, st, frozen, tokens), per_fwd,
            f"step {i + 1}")
        for k, n in counts(counters).items():
            launches[k] += n
        steps.append({"step": i + 1, "loss": float(loss), "step_ms": ms,
                      "peak_allocated_gib": peak,
                      "state_bytes_8bit": state_bytes(st),
                      "k5_launches": k5.launches, "card": smi})
        if i == 0:
            after_1 = tr
            if not any(b["B"].any() for b in tr.values()):
                raise AssertionError("qlora: lora_B still zero after step 1")
    losses = [s["loss"] for s in steps]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"qlora: losses {losses} not finite and "
                             "falling")
    # remat: the same kernels in the same order, so the same bits
    remat_fwd = per_fwd + per_layers
    (loss_r, _, tr_r), ms_r, peak_r = counted(
        lambda: make_qlora_train_step(cfg, remat=True)[1](
            start, init(start), frozen, tokens)[::-1], remat_fwd,
        "remat step")
    (loss_p, g_p), _, _ = counted(
        lambda: qlora_loss_and_grads(cfg, start, frozen, tokens), per_fwd,
        "gradients")
    (loss_g, g_r), _, _ = counted(
        lambda: qlora_loss_and_grads(cfg, start, frozen, tokens, remat=True),
        remat_fwd, "remat gradients")
    remat_same = (float(loss_r) == losses[0] == float(loss_p)
                  == float(loss_g) and leaves_equal(g_p, g_r)
                  and leaves_equal(tr_r, after_1))
    if not remat_same:
        raise AssertionError("qlora: remat loss, gradients or step differ "
                             "from the plain step's")
    # 2 x 513: M = 1024, past K5's 256 rows
    wide = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 513))).to(dev)
    (_, _, loss_w), ms_w, peak_w = counted(
        lambda: train_step(start, init(start), frozen, wide), 0, "2 x 513")
    if not math.isfinite(float(loss_w)):
        raise AssertionError("qlora: 2 x 513 loss not finite")
    # PagedAdamW on the LoRA leaves, through torch.optim's protocol
    params = merge_lora_trainable(frozen, {
        k: {"A": v["A"].detach().clone(), "B": v["B"].detach().clone()}
        for k, v in start.items()})
    leaves = tree_leaves(lora_trainable(params))
    opt = PagedAdamW(leaves, lr=QLORA_LR)

    def backward():
        with torch.enable_grad():
            logits = L.forward(params, tokens[:, :-1], cfg)
            torch.nn.functional.cross_entropy(
                logits[0].float(), tokens[0, 1:].long()).backward()
    counted(backward, per_fwd, "PagedAdamW's backward")
    before = [p.detach().clone() for p in leaves]
    t0 = time.perf_counter()
    opt.step()
    opt.synchronize()
    paged_ms = (time.perf_counter() - t0) * 1e3
    pinned = all(s[n].device.type == "cpu" and s[n].is_pinned()
                 for s in opt.state.values()
                 for n in ("exp_avg", "exp_avg_sq"))
    moved = any(not torch.equal(a, b) for a, b in zip(before, leaves))
    if not (pinned and moved and len(opt.state) == len(leaves)):
        raise AssertionError(f"qlora: PagedAdamW states pinned {pinned}, "
                             f"parameters moved {moved}")
    del params, leaves, opt, g_p, g_r
    qlora_card_vs_cpu(dev, cfg, tokens, smi)
    emit({"phase": "qlora", "model": "Llama-2-7B", "layers": cfg.num_layers,
          "card": smi, "build_s": build_s, "tokens": [1, 257],
          "frozen_linears_per_forward": per_fwd, "steps": steps,
          "remat": {"step_ms": ms_r, "peak_allocated_gib": peak_r,
                    "k5_launches": remat_fwd, "identical": remat_same},
          "wide_2x513": {"loss": float(loss_w), "step_ms": ms_w,
                         "peak_allocated_gib": peak_w, "k5_launches": 0},
          "paged_adamw": {"step_ms": paged_ms, "states_pinned": pinned,
                          "leaves": len(before)},
          "launches": launches, "seconds": time.perf_counter() - t_phase})
    del frozen, tr, st, start, after_1, tr_r
    free_memory()
    return launches


# ---------------------------------------------------------------------------
# phase 11: the model families (Mixtral-8x7B, Gemma2-9B)
# ---------------------------------------------------------------------------

MIXTRAL_NEW = 48    # 11a: greedy tokens per request
# 11a's decode chunk: 16 steps, about 100k kernel nodes a graph (a 32-step
# chunk's capture took 16.5 s and each step breakdown's profile 20-29 s)
MIXTRAL_CHUNK = 16
MOE_PROMPT = 128    # 11b: one prompt (K5 at M = 128 in every expert) ...
MOE_STEPS = 4       # ... and decode steps (K4 at M = 1)
# 11b: a token whose routing differs between card and CPU is a near tie
# where the CPU's k-th and (k+1)-th probabilities are closer than this
# (chosen before any run: one bf16 ulp of a router input moves its f32
# logits by about 4e-3 of their size, so a probability gap below 1e-2 can
# flip); a flip at a wider gap fails the phase
MOE_TIE_GAP = 1e-2
GEMMA2_PROMPT = 4400    # 11c: past the 4,096 window, inside K3's 5,632
GEMMA2_STEPS = 16
GEMMA2_MAX_SEQ = 4608


@contextlib.contextmanager
def routing_record(out, feed=None):
    """Collects (experts [.., k], probs [.., E]) of every MoE router call,
    on the CPU, in call order. ``feed``: another run's record, whose
    experts this run takes call by call, each weighted by this run's own
    probabilities (renormalized where the config says), as the K4 inputs
    are fed (:func:`k4_inputs`); what is recorded is this run's own
    choice."""
    from tpu_bitsandbytes_torch.models import llama as L
    orig = L.moe_routing

    def tap(router, x, config):
        top, topv, probs = orig(router, x, config)
        out.append((top.cpu(), probs.cpu()))
        if feed is not None:
            top = feed[len(out) - 1][0].to(probs.device)
            topv = probs.gather(-1, top)
            if config.moe_norm_topk:
                topv = topv / topv.sum(dim=-1, keepdim=True)
        return top, topv, probs

    L.moe_routing = tap
    try:
        yield out
    finally:
        L.moe_routing = orig


@contextlib.contextmanager
def recorded_calls(module, name, calls):
    """Appends the (args, kwargs) of every call of ``module.name`` to
    ``calls`` while it is open."""
    orig = getattr(module, name)

    def tap(*a, **kw):
        calls.append((a, dict(kw)))
        return orig(*a, **kw)

    setattr(module, name, tap)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def k2_against_plain(K2, a, kw, what):
    """Replays one recorded K2 call (``flash_decode_attention(*a, **kw)``)
    and its plain version on the same inputs; returns the rel err, and
    raises past K2_TOL."""
    q, kq, ks, vq, vs, off = a
    kw = dict(kw)
    st = kw.pop("staged")
    got = K2.flash_decode_attention(q, kq, ks, vq, vs, off, staged=st, **kw)
    if st is None:      # an unstaged step: the wrapper's masked dummy block
        st = K2._dummy_stage(q.shape[0], kq.shape[1], q.shape[2], q.device)
    # the wrapper's defaults, which the plain version takes explicitly
    plain_kw = {"window": None, "kpos_start": 0, "softcap": None, **kw}
    if plain_kw.get("scale") is None:
        plain_kw["scale"] = 1.0 / q.shape[-1] ** 0.5
    ref = K2.flash_decode_plain(q, kq, ks, vq, vs, off, *st, **plain_kw)
    torch.cuda.synchronize()
    r = err(got, ref)[1]
    if not (r <= K2_TOL and torch.isfinite(got).all()):
        raise AssertionError(f"{what} K2 {kw}: rel err {r}")
    return r


def mixtral_workload(dev):
    """11a: (cfg, params, prompts, sampling, engine keywords) for
    Mixtral-8x7B at its 32 layers and 8 experts, random packed NF4 weights
    drawn on the card from a seed, served off the packed bytes at B=8,
    ``max_seq`` 2048, 16-step chunks, phase 5's prompt lengths."""
    from tpu_bitsandbytes_torch.engine.sampler import SamplingParams
    from tpu_bitsandbytes_torch.models.llama import LlamaConfig
    cfg = LlamaConfig.mixtral_8x7b()
    gen = torch.Generator(device=dev).manual_seed(87)
    params = random_params(
        cfg,
        lambda s: torch.randint(0, 256, s, generator=gen, device=dev,
                                dtype=torch.uint8),
        lambda s: torch.rand(s, generator=gen, device=dev),
        lambda s: torch.randn(s, generator=gen, device=dev), dev)
    rng = np.random.default_rng(88)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in PACKED_PROMPTS]
    kw = dict(max_batch=8, max_seq=2048, steps_per_sync=MIXTRAL_CHUNK,
              runtime_cache=None)
    return cfg, params, prompts, SamplingParams(
        max_new_tokens=MIXTRAL_NEW), kw


def phase_mixtral(dev, counters, plains):
    """11a: Mixtral-8x7B served off the packed bytes (16-step chunks),
    graphed and eager
    (:func:`serve_mode`): 577 K4 (32 x (qkv + o + 8 x (gate/up + down)) +
    lm_head) and 32 K2 per decode step by the counters and the graph's
    nodes; K4 for the 32/64 buckets, K5 on its wgmma kernel for 128/256
    (2 x 577 launches), K3 for 1024/2048 (2 x 32); tokens identical
    between the modes; ``footprint()`` against the allocations. Returns
    the eager pass's launches."""
    from tpu_bitsandbytes_torch.engine import engine as E
    cfg, params, prompts, sp, kw = mixtral_workload(dev)
    per_step = cfg.num_layers * (2 + 2 * cfg.num_experts) + 1
    want = {"K1_int4_matmul": 0, "K2_flash_decode": cfg.num_layers,
            "K3_flash_prefill": 0, "K4_w4a8_matmul": per_step,
            "K5_matmul4bit": 0}
    results, fp = {}, None
    for mode in MODES:
        res, engine = serve_mode(dev, params, cfg, kw, mode, prompts, sp,
                                 counters, plains, want,
                                 lambda: timed_prefills(counters))
        last = res["passes"][-1]
        launches = last["launches"]
        groups = sorted(last["extra"], key=lambda g: g["bucket"])
        if [g["bucket"] for g in groups] != [32, 64, 128, 256, 1024, 2048]:
            raise AssertionError(f"mixtral {mode}: admission groups {groups}")
        last["extra"] = groups
        if not (launches["K5_matmul4bit"] == last["wgmma_launches"]
                == 2 * per_step):
            raise AssertionError(f"mixtral {mode}: K5 launches {launches} "
                                 f"({last['wgmma_launches']} wgmma), "
                                 f"expected {2 * per_step} on the wgmma "
                                 "kernel")
        if (launches["K3_flash_prefill"] != 2 * cfg.num_layers
                or launches["K1_int4_matmul"]
                or launches["K2_flash_decode"]
                != cfg.num_layers * last["decode_steps"]):
            raise AssertionError(f"mixtral {mode}: launches {launches} for "
                                 f"{last['decode_steps']} decode steps")
        if mode == "graphed":
            fp = engine.footprint()
            c = engine.cache
            want_fp = {"params": tensor_bytes(engine.params),
                       "kv": sum(t.numel() * t.element_size()
                                 for t in (c.k, c.v, c.k_scale, c.v_scale))}
            got_fp = {"params": fp["packed"] + fp["exec_cache"] + fp["fp"],
                      "kv": fp["kv"]}
            if got_fp != want_fp or not fp["fits"]:
                raise AssertionError(f"mixtral footprint {fp}: {got_fp} "
                                     f"against the allocations {want_fp}")
            del c
        results[mode] = res
        del engine
        free_memory()
    serve_lines("mixtral_8x7b", results, {
        "runtime_cache": None, "layers": cfg.num_layers,
        "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
        "batch": 8, "max_seq": 2048, "steps_per_sync": MIXTRAL_CHUNK,
        "prompt_lens": PACKED_PROMPTS, "new_tokens": MIXTRAL_NEW,
        "k4_per_step": per_step, "footprint": fp,
        "param_bytes": tensor_bytes(params)})
    del params
    free_memory()
    return results["eager"]["passes"][-1]["launches"]


def mixtral_2l_cpu(dev):
    """11b's model (Mixtral-8x7B at full width, 2 layers, normal weights
    quantized to NF4 on the card) and its CPU run, with every K4 input and
    router choice recorded (:func:`phase_mixtral_2l`)."""
    from tpu_bitsandbytes_torch.models import llama as L
    cfg = dataclasses.replace(L.LlamaConfig.mixtral_8x7b(), num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(811)
    params = normal_nf4_params(
        cfg, lambda shape: torch.randn(shape, generator=gen, device=dev), dev)
    cpu_params = L.to_device(params, "cpu")
    prompt = np.random.default_rng(812).integers(1, cfg.vocab_size,
                                                 MOE_PROMPT).tolist()
    t0 = time.perf_counter()
    cpu_x, cpu_routes = [], []
    with k4_inputs(record=cpu_x), routing_record(cpu_routes):
        ref_pre, ref_steps, fed = run_prefill_decode(
            cpu_params, cfg, "cpu", [prompt], None, n_steps=MOE_STEPS)
    return {"cfg": cfg, "params": params, "prompt": prompt, "fed": fed,
            "cpu_x": cpu_x, "routes": cpu_routes, "pre": ref_pre,
            "steps": ref_steps, "cpu_s": time.perf_counter() - t0}


def phase_mixtral_2l(dev, counters, plains, K2, cpu):
    """11b: Mixtral-8x7B at full width, 2 layers (normal weights quantized
    to NF4 on the card, copied to the CPU), one 128-token prompt and 4
    decode steps on the CPU (plain versions), then on the card.

    The prefill is the engine's ``prefill_step`` at bucket 128: every
    matmul, the lm_head's too, runs K5 at M = 128 on the card, so the
    prefill's logits are the card's own (every expert, the expert-weighted
    sums, the attention) and must be within E2E_TOL of the CPU's. In the
    decode steps K4 quantizes its activations to int8 per row, where one
    bf16 ulp at a row's largest element rescales every code, so the card
    is fed the CPU's activation at every K4 call, and each K4 input as the
    card computed it from the layers before is held to the fed one at
    E2E_TOL: the qkv and expert inputs (the residual stream after the
    attention and the expert-weighted sums), the expert down inputs and
    the lm_head's (the final hidden state, normed). The o_proj inputs,
    K2's outputs, are reported, not gated: K2's int8 q and p codes move by
    one where the prefill's bf16 K/V differ by an ulp (up to 3.74e-2 of
    max on an H100 at 700 W, with every other input within 6e-3); each of
    the run's K2 calls is held against K2's plain version on its own
    inputs instead (K2_TOL). Every decode step's logits must be within
    E2E_TOL.

    The card also takes the CPU's experts for every token and layer, each
    weighted by the card's own probabilities, so that a near tie in the
    router, where one bf16 ulp of input picks another expert, does not
    carry into every later token. Each side's own choice is recorded for
    every token and layer: a token whose top-k differs is a flip, allowed
    only where the CPU's k-th vs (k+1)-th probability gap is below
    ``MOE_TIE_GAP``. ``cpu``: :func:`mixtral_2l_cpu`'s model and CPU
    run."""
    from tpu_bitsandbytes_torch.models import llama as L
    cfg, prompt, fed = cpu["cfg"], cpu["prompt"], cpu["fed"]
    params, cpu_x, cpu_routes = cpu.pop("params"), cpu["cpu_x"], \
        cpu["routes"]
    ref_pre, ref_steps, cpu_s = cpu["pre"], cpu["steps"], cpu["cpu_s"]
    routes, k2_calls = [], []
    reset(counters, plains)
    with k4_inputs(feed=cpu_x) as notes, \
            routing_record(routes, feed=cpu_routes), \
            recorded_calls(L, "flash_decode_attention", k2_calls):
        got_pre, got_steps, _ = run_prefill_decode(
            params, cfg, dev, [prompt], fed, n_steps=MOE_STEPS)
    torch.cuda.synchronize()
    launches = counts(counters)
    no_plain_calls(plains, "mixtral 2 layers")
    per_layer = 2 + 2 * cfg.num_experts
    want = {"K1_int4_matmul": 0, "K3_flash_prefill": 0,
            "K2_flash_decode": MOE_STEPS * cfg.num_layers,
            "K4_w4a8_matmul": MOE_STEPS * (cfg.num_layers * per_layer + 1),
            "K5_matmul4bit": cfg.num_layers * per_layer + 1}
    if launches != want or len(notes) != len(cpu_x):
        raise AssertionError(f"mixtral 2 layers: launches {launches}, "
                             f"expected {want}; {len(notes)} K4 calls fed "
                             f"of {len(cpu_x)}")
    k2_err = max(k2_against_plain(K2, a, kw, "mixtral 2 layers")
                 for a, kw in k2_calls)
    reset(counters, plains)     # the comparisons' launches are not the path's
    del k2_calls
    o_shape = (cfg.hidden_size, cfg.num_heads * cfg.hd)
    calls = [{"call": i, "shape": list(n["shape"]), "m": n["m"],
              "rel_err": n["rel_err"], "codes_differ": n["codes_differ"],
              "gated": tuple(n["shape"]) != o_shape}
             for i, n in enumerate(notes)]
    gated = [c for c in calls if c["gated"]]
    worst_gated = max(c["rel_err"] for c in gated)
    worst_o = max((c["rel_err"] for c in calls if not c["gated"]),
                  default=None)
    if len(routes) != len(cpu_routes):
        raise AssertionError("mixtral 2 layers: router calls differ")
    k = cfg.experts_per_token
    flips, tokens = [], 0
    for call, ((top_c, _), (top_r, probs_r)) in enumerate(
            zip(routes, cpu_routes)):
        same = (top_c.sort(-1).values == top_r.sort(-1).values).all(-1)
        srt = probs_r.sort(-1, descending=True).values
        gap = srt[..., k - 1] - srt[..., k]
        tokens += same.numel()
        # call order: layer 0 and 1 of the prefill, then of each step
        step = 0 if call < cfg.num_layers else 1 + (call - cfg.num_layers) \
            // cfg.num_layers
        for g in gap[~same].tolist():
            flips.append({"step": step, "layer": call % cfg.num_layers,
                          "cpu_gap": g})
    wide = [f for f in flips if f["cpu_gap"] >= MOE_TIE_GAP]
    got = torch.cat([got_pre, got_steps[:, 0]])
    ref = torch.cat([ref_pre, ref_steps[:, 0]])
    rel = (got - ref).abs().amax(-1) / ref.abs().amax(-1)
    emit({"phase": "families", "part": "11b", "model": "mixtral_8x7b",
          "layers": cfg.num_layers, "prompt_len": MOE_PROMPT,
          "decode_steps": MOE_STEPS, "launches": launches,
          "k4_inputs_fed": len(notes), "k4_inputs_gated": len(gated),
          "k4_input_worst_rel_err_gated": worst_gated,
          "k4_input_worst_rel_err_o_proj": worst_o,
          "k4_input_worst_calls": sorted(calls,
                                         key=lambda c: -c["rel_err"])[:6],
          "k2_worst_rel_err_vs_plain": k2_err, "k2_tol": K2_TOL,
          "routing_tokens_x_layers": tokens, "routing_flips": flips,
          "tie_gap": MOE_TIE_GAP,
          "logit_rel_err_prefill_then_steps": rel.tolist(),
          "tol": E2E_TOL, "cpu_s": cpu_s})
    if wide:
        raise AssertionError(f"mixtral 2 layers: routing differs where the "
                             f"CPU's top-{k} gap is clear: {wide}")
    if not worst_gated <= E2E_TOL:
        raise AssertionError(f"mixtral 2 layers: K4 inputs card vs CPU "
                             f"{[c for c in gated if c['rel_err'] > E2E_TOL]}"
                             f" (tol {E2E_TOL})")
    if not (rel <= E2E_TOL).all() or not torch.isfinite(got).all():
        raise AssertionError(f"mixtral 2 layers: logits rel err "
                             f"{rel.tolist()} (tol {E2E_TOL})")
    del params
    free_memory()
    return launches


def gemma2_cpu(dev):
    """11c's model (Gemma2-9B at full width, 2 layers, bf16 weights drawn
    on the card) and its CPU runs in f32 and bf16 (:func:`phase_gemma2`)."""
    from tpu_bitsandbytes_torch.models import llama as L
    cfg = dataclasses.replace(L.LlamaConfig.gemma2_9b(), num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(813)
    params = L.init_params(cfg, generator=gen, device=dev)
    cpu_params = L.to_device(params, "cpu")
    prompt = np.random.default_rng(814).integers(1, cfg.vocab_size,
                                                 GEMMA2_PROMPT).tolist()
    t0 = time.perf_counter()
    f32_hidden, bf16_hidden = [], []
    ref32 = run_prefill_decode(
        as_f32(cpu_params), dataclasses.replace(cfg, dtype=torch.float32),
        "cpu", [prompt], None, GEMMA2_MAX_SEQ, GEMMA2_STEPS, f32_hidden)
    fed = ref32[2]
    ref16 = run_prefill_decode(cpu_params, cfg, "cpu", [prompt], fed,
                               GEMMA2_MAX_SEQ, GEMMA2_STEPS, bf16_hidden)
    return {"cfg": cfg, "params": params, "prompt": prompt, "fed": fed,
            "ref32": ref32, "ref16": ref16, "f32_hidden": f32_hidden,
            "bf16_hidden": bf16_hidden, "cpu_s": time.perf_counter() - t0}


def phase_gemma2(dev, counters, plains, bw, bf16_peak, int8_peak, K2, K3,
                 cpu):
    """11c: Gemma2-9B at full width, 2 layers (layer 0 windowed at 4,096,
    layer 1 global; bf16, unquantized weights drawn on the card from a
    seed, copied to the CPU), one 4,400-token prompt through K3 (d = 256,
    the window on layer 0, softcap 50, scale 256^-0.5) and 16 staged
    decode steps through K2 with the same arguments, fed the CPU's greedy
    tokens; the final softcap 30 and the tied 256,000-row embedding.
    Against the CPU: the prefill's hidden states and every step's logits
    within E2E_TOL of max|ref| of the CPU's bf16 run (the same arithmetic
    but for the kernels' sum orders), and of its f32 run within E2E_TOL
    plus the CPU's own bf16-vs-f32 gap on the same tensor (the triangle
    bound: bf16 alone is 1.5-6e-2 from f32 at this width, the CPU's run as
    the card's, on an H100 at 700 W). Then K3's and K2's calls of this
    run, each layer's, against their plain versions on the same inputs
    (K3 1e-2 of each row's max, K2 1e-3), timed beside their bounds (and
    K3 beside SDPA, which takes no window or softcap: null). ``cpu``:
    :func:`gemma2_cpu`'s model and CPU runs."""
    from tpu_bitsandbytes_torch.models import layers as LY
    from tpu_bitsandbytes_torch.models import llama as L
    cfg, params, prompt, fed = (cpu["cfg"], cpu.pop("params"),
                                cpu["prompt"], cpu["fed"])
    ref32, ref16, cpu_s = cpu["ref32"], cpu["ref16"], cpu["cpu_s"]
    f32_hidden, bf16_hidden, hidden = (cpu["f32_hidden"], cpu["bf16_hidden"],
                                       [])
    k2_calls, k3_calls = [], []
    reset(counters, plains)
    with recorded_calls(L, "flash_decode_attention", k2_calls), \
            recorded_calls(LY, "flash_prefill_attention", k3_calls):
        got = run_prefill_decode(params, cfg, dev, [prompt], fed,
                                 GEMMA2_MAX_SEQ, GEMMA2_STEPS, hidden)
    torch.cuda.synchronize()
    launches = counts(counters)
    no_plain_calls(plains, "gemma2")
    want = {"K1_int4_matmul": 0, "K4_w4a8_matmul": 0, "K5_matmul4bit": 0,
            "K3_flash_prefill": cfg.num_layers,
            "K2_flash_decode": GEMMA2_STEPS * cfg.num_layers}
    if launches != want:
        raise AssertionError(f"gemma2: launches {launches}, expected {want}")
    del k2_calls[cfg.num_layers:]   # the first step's calls, one a layer

    def rows(a, b):
        return ((a - b).abs().amax(-1) / b.abs().amax(-1)).tolist()

    got, ref32, ref16 = (torch.cat([pre, steps[:, 0]])
                         for pre, steps, _ in (got, ref32, ref16))
    gaps = {  # card vs the CPU in bf16 and in f32; the CPU's own gap
        "card_bf16": {"hidden": err(hidden[0], bf16_hidden[0])[1],
                      "logits": rows(got, ref16)},
        "card_f32": {"hidden": err(hidden[0], f32_hidden[0])[1],
                     "logits": rows(got, ref32)},
        "cpu_bf16_f32": {"hidden": err(bf16_hidden[0], f32_hidden[0])[1],
                         "logits": rows(ref16, ref32)}}
    # |card - f32| <= |card - bf16| + |bf16 - f32|: the first is gated at
    # E2E_TOL, the second is the CPU's own bf16-vs-f32 gap
    tol_f32 = {"hidden": E2E_TOL + gaps["cpu_bf16_f32"]["hidden"],
               "logits": [E2E_TOL + g
                          for g in gaps["cpu_bf16_f32"]["logits"]]}
    ok = (gaps["card_bf16"]["hidden"] <= E2E_TOL
          and max(gaps["card_bf16"]["logits"]) <= E2E_TOL
          and gaps["card_f32"]["hidden"] <= tol_f32["hidden"]
          and all(g <= t for g, t in zip(gaps["card_f32"]["logits"],
                                         tol_f32["logits"]))
          and torch.isfinite(got).all()
          and got.abs().max() <= cfg.final_logit_softcap)
    if not ok:
        raise AssertionError(f"gemma2: card vs CPU {gaps} (tol {E2E_TOL}; "
                             f"against f32 {tol_f32})")
    windows = [L._layer_window(cfg, li) for li in range(cfg.num_layers)]
    seen = {name: [kw.get("window") for _, kw in calls]
            for name, calls in (("K2", k2_calls), ("K3", k3_calls))}
    if windows != [cfg.sliding_window, None] or any(
            w != windows for w in seen.values()):
        raise AssertionError(f"gemma2: windows {windows}, by call {seen}")
    # K3 and K2 at exactly these calls' arguments against the plain versions
    kern_rows = {"K3": [], "K2": []}
    s = GEMMA2_PROMPT
    for (q, k, v), kw in k3_calls:
        got3 = K3.flash_prefill_attention(q, k, v, **kw)
        ref3 = K3.flash_prefill_plain(q, k, v, block_k=K3.KEY_TILE[256],
                                      **kw)
        torch.cuda.synchronize()
        rr = row_err(got3[:, :s], ref3[:, :s])
        if not (rr <= K3_TOL and torch.isfinite(got3[:, :s]).all()):
            raise AssertionError(f"gemma2 K3 {kw}: rel err {rr} of a row's "
                                 "max")
        b, sp, h, d = q.shape
        bound, by = k3_bound(b, sp, h, k.shape[2], d, s, kw["window"], bw,
                             bf16_peak, K3)
        kern_rows["K3"].append({
            "window": kw["window"], "softcap": kw["softcap"],
            "scale": kw["scale"], "shape": f"B={b} S={sp} H={h} "
            f"H_kv={k.shape[2]} D={d} s_real={s}", "max_row_rel_err": rr,
            "ms": time_graph_ms([lambda: K3.flash_prefill_attention(
                q, k, v, **kw)], iters=5),
            "plain_ms": time_ms([lambda: K3.flash_prefill_plain(
                q, k, v, block_k=K3.KEY_TILE[256], **kw)], iters=1),
            "bound_ms": bound, "bound_by": by, "library_ms": None})
    for a, kw in k2_calls:
        r = k2_against_plain(K2, a, kw, "gemma2")
        q, kq, ks, vq, vs, off = a
        kw = dict(kw)
        st = kw.pop("staged")
        step = st[4]
        kept = k2_kept_keys(off, step, kq.shape[2], st[0].shape[2])
        if kw["window"] is not None:
            kept = min(kept, q.shape[0] * kw["window"])
        kern_rows["K2"].append({
            "window": kw["window"], "softcap": kw["softcap"],
            "scale": kw["scale"], "kpos_start": kw["kpos_start"],
            "shape": f"B={q.shape[0]} H={q.shape[1]} H_kv={kq.shape[1]} "
            f"D={q.shape[2]} T={kq.shape[2]} C={st[0].shape[2]}",
            "cluster": K2.cluster_size(q.shape[1] // kq.shape[1],
                                       kq.shape[2], st[0].shape[2],
                                       q.shape[2], q.shape[0], kq.shape[1],
                                       dev),
            "max_rel_err": r, "kept_keys": kept,
            "ms": time_graph_ms([lambda: K2.flash_decode_attention(
                q, kq, ks, vq, vs, off, staged=st, **kw)], iters=20),
            "plain_ms": time_ms([lambda: K2.flash_decode_plain(
                q, kq, ks, vq, vs, off, *st, **kw)], iters=2),
            "bound_ms": k2_bound_ms(kept, q.shape[0], q.shape[1],
                                    kq.shape[1], q.shape[2], bw, int8_peak),
            "bound_by": "bytes", "library_ms": None})
    reset(counters, plains)     # the comparisons' launches are not the path's
    emit({"phase": "families", "part": "11c", "model": "gemma2_9b",
          "layers": cfg.num_layers, "windows": windows,
          "prompt_len": GEMMA2_PROMPT, "decode_steps": GEMMA2_STEPS,
          "attn_softcap": cfg.attn_logit_softcap,
          "final_softcap": cfg.final_logit_softcap,
          "rel_err": gaps, "tol": E2E_TOL, "tol_against_f32": tol_f32,
          "launches": launches, "kernels": kern_rows, "cpu_s": cpu_s})
    del params, k2_calls, k3_calls
    free_memory()
    return launches, kern_rows


# ---------------------------------------------------------------------------
# phase 12: tensor- and data-parallel serving over torch.distributed
# ---------------------------------------------------------------------------

MESH_TP = 2
# greedy tokens of the tp = 2 engine must equal phase 4's wherever phase
# 4's top-2 logit gap is at least this share of the row's max|logit|: two
# logit rows within E2E_TOL of max|ref| of each other can swap their
# top two only where the gap is below twice that
TP_TIE_GAP = 2 * E2E_TOL
MESH_TIMEOUT_S = 420    # a world of ranks that outlives this is killed
MESH13_LAYERS = 4
MESH13_PROMPTS = [50, 200, 1000]   # buckets 64 (K4), 256 (K5), 1024 (K3)
MESH13_STEPS = 8
NCCL_LAYERS = 8
MESH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "mesh")


class _FirstCalls:
    """Stands in for a kernel wrapper: keeps the (args, kwargs) of its
    first call at each set of argument shapes, calls it, and passes every
    attribute through to it (a wrapper bumps its own launch counter
    through its module's name for it, which is this stand-in)."""

    def __init__(self, orig, calls):
        object.__setattr__(self, "_orig", orig)
        object.__setattr__(self, "_calls", calls)

    def __call__(self, *a, **kw):
        key = tuple(tuple(t.shape) if isinstance(t, torch.Tensor) else t
                    for t in a if not isinstance(t, (tuple, list)))
        self._calls.setdefault(key, (a, dict(kw)))
        return self._orig(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._orig, name)

    def __setattr__(self, name, value):
        setattr(self._orig, name, value)


@contextlib.contextmanager
def first_calls(module, name, calls):
    """Keeps the (args, kwargs) of the first call of ``module.name`` at each
    set of argument shapes in ``calls`` (shape key -> call) while open."""
    orig = getattr(module, name)
    setattr(module, name, _FirstCalls(orig, calls))
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def kernel_calls_against_plain(rec):
    """Replays each recorded kernel call and its plain version on the same
    inputs; raises past the kernel's tolerance. ``rec``: kernel name ->
    {shape key: (args, kwargs)}. Returns name -> [{shape, rel_err}]."""
    from tpu_bitsandbytes_torch.ops import flash_decode as K2
    from tpu_bitsandbytes_torch.ops import flash_prefill as K3
    from tpu_bitsandbytes_torch.ops import int4cache as K1
    from tpu_bitsandbytes_torch.ops import matmul4bit as K5
    from tpu_bitsandbytes_torch.ops import w4a8 as K4
    out = {}
    for name, calls in rec.items():
        rows = []
        for key, (a, kw) in calls.items():
            if name == "K2_flash_decode":
                r = k2_against_plain(K2, a, kw, "phase 12")
            elif name == "K3_flash_prefill":
                q, k, v = a
                got = K3.flash_prefill_attention(q, k, v, **kw)
                ref = K3.flash_prefill_plain(
                    q, k, v, block_k=K3.KEY_TILE[q.shape[-1]], **kw)
                s = kw["s_real"]
                r = row_err(got[:, :s], ref[:, :s])
                if not r <= K3_TOL:
                    raise AssertionError(f"phase 12 K3 {key}: {r}")
            else:
                fn, plain, tol = {
                    "K1_int4_matmul": (K1.int4_mm, K1.int4_mm_plain, K1_TOL),
                    "K4_w4a8_matmul": (K4.w4a8_mm, K4.w4a8_mm_plain, K4_TOL),
                    "K5_matmul4bit": (K5.matmul4bit_mm, K5.matmul4bit_plain,
                                      K5_TOL.get(a[-1] if a else "bf16",
                                                 K5_TOL["bf16"]))}[name]
                got, ref = fn(*a, **kw), plain(*a, **kw)
                r = err(got, ref)[1]
                if not (r <= tol and torch.isfinite(got).all()):
                    raise AssertionError(f"phase 12 {name} {key}: {r}")
            rows.append({"shape": [list(x) if isinstance(x, tuple) else x
                                   for x in key], "rel_err": r})
        out[name] = rows
    torch.cuda.synchronize()
    return out


@contextlib.contextmanager
def recorded_kernel_calls(rec):
    """Records each kernel wrapper's first call per argument shapes into
    ``rec`` (:func:`first_calls`) where the model code reaches it."""
    from tpu_bitsandbytes_torch.models import layers as LY
    from tpu_bitsandbytes_torch.models import llama as L
    from tpu_bitsandbytes_torch.ops import int4cache as K1
    from tpu_bitsandbytes_torch.ops import matmul4bit as K5
    from tpu_bitsandbytes_torch.ops import w4a8 as K4
    taps = [(K1, "int4_mm", "K1_int4_matmul"),
            (L, "flash_decode_attention", "K2_flash_decode"),
            (LY, "flash_prefill_attention", "K3_flash_prefill"),
            (K4, "w4a8_mm", "K4_w4a8_matmul"),
            (K5, "matmul4bit_mm", "K5_matmul4bit")]
    with contextlib.ExitStack() as stack:
        for mod, fn, name in taps:
            stack.enter_context(first_calls(mod, fn, rec.setdefault(name,
                                                                    {})))
        yield rec


def mesh13_model(dev):
    """12b's model: Llama-2-13B at full width, ``MESH13_LAYERS`` layers,
    normal(0, 0.02) weights drawn on the card from a seed and quantized to
    NF4 (blocksize 64), fused projections at tp = 1."""
    from tpu_bitsandbytes_torch.models.llama import LlamaConfig
    cfg = dataclasses.replace(LlamaConfig.llama2_13b(),
                              num_layers=MESH13_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(1313)
    return cfg, normal_nf4_params(
        cfg, lambda s: torch.randn(s, generator=gen, device=dev), dev)


class RowShards:
    """A row-parallel linear as a tp-way mesh computes it, on one device:
    each K slice of x through its shard (K4 quantizes each slice with its
    own A8 scale, as JAX's shards do), the outputs summed in the output
    dtype in rank order, the bias added once."""

    def __init__(self, w, tp):
        from tpu_bitsandbytes_torch.parallel.sharding import (_linear_spec,
                                                              shard_local)
        spec = _linear_spec(w, col=False)
        self.shards = [dataclasses.replace(
            shard_local(w, spec, tp, r, w.packed.device), bias=None)
            for r in range(tp)]
        self.bias = w.bias

    rank = None     # the shard being applied, for :func:`k4_calls`

    def __call__(self, x):
        k = x.shape[-1] // len(self.shards)
        out = None
        for r, w in enumerate(self.shards):
            RowShards.rank = r
            try:
                part = w(x[..., r * k:(r + 1) * k])
            finally:
                RowShards.rank = None
            out = part if out is None else out + part
        return out if self.bias is None else out + self.bias.to(out.dtype)


def row_sharded(params, tp):
    """``params`` with every row-parallel linear (o_proj, down_proj) a
    :class:`RowShards`: the single-device model with the arithmetic a
    tp-way mesh gives it."""
    layers = [{k: RowShards(w, tp) if k in ("o_proj", "down_proj") else w
               for k, w in layer.items()} for layer in params["layers"]]
    return dict(params, layers=layers)


def prefill_then_steps(params, cfg, dev, prompts, forced, max_seq, tp=None):
    """12b's run: each prompt prefilled into its slot of a fresh int8 cache
    (``prefill_step``, its dp group's: every slot local here), then
    unstaged decode steps fed ``forced`` [steps, B]; returns f32 (prefill
    logits [B, V], step logits [steps, B, V]) on the CPU and the launches
    of each prefill and of each step."""
    from tpu_bitsandbytes_torch.engine import engine as E
    from tpu_bitsandbytes_torch.engine.kvcache import KVCache
    n_tp = 1 if tp is None else tp.tp
    cache = KVCache.create(cfg.num_layers, len(prompts), max_seq,
                           cfg.num_kv_heads // n_tp, cfg.hd, dtype=cfg.dtype,
                           device=dev)
    counters = kernel_counters()
    pre, steps, launches = [], [], {"prefill": [], "step": []}
    for slot, pr in enumerate(prompts):
        padded = torch.zeros((1, E._bucket(len(pr), max_seq)),
                             dtype=torch.int32)
        padded[0, :len(pr)] = torch.tensor(pr, dtype=torch.int32)
        reset(counters, ())
        logits, cache = E.prefill_step(params, cache, padded.to(dev), slot,
                                       len(pr), cfg, tp=tp)
        launches["prefill"].append(counts(counters))
        pre.append(logits.float().cpu())
    active = torch.ones((len(prompts),), dtype=torch.bool, device=dev)
    span = E._span_bucket(max(map(len, prompts)) + len(forced), max_seq)
    for toks in forced:
        reset(counters, ())
        logits, cache = E.decode_step(params, cache,
                                      torch.tensor(toks, dtype=torch.int32,
                                                   device=dev),
                                      active, cfg, attn_span=span, tp=tp)
        launches["step"].append(counts(counters))
        steps.append(logits.float().cpu())
    torch.cuda.synchronize()
    return torch.stack(pre), torch.stack(steps), launches


def kernel_counters():
    from tpu_bitsandbytes_torch.ops import flash_decode as K2
    from tpu_bitsandbytes_torch.ops import flash_prefill as K3
    from tpu_bitsandbytes_torch.ops import int4cache as K1
    from tpu_bitsandbytes_torch.ops import matmul4bit as K5
    from tpu_bitsandbytes_torch.ops import w4a8 as K4
    return {"K1_int4_matmul": K1.int4_mm,
            "K2_flash_decode": K2.flash_decode_attention,
            "K3_flash_prefill": K3.flash_prefill_attention,
            "K4_w4a8_matmul": K4.w4a8_mm,
            "K5_matmul4bit": K5.matmul4bit_mm}


def kernel_plains():
    from tpu_bitsandbytes_torch.ops import flash_decode as K2
    from tpu_bitsandbytes_torch.ops import flash_prefill as K3
    from tpu_bitsandbytes_torch.ops import int4cache as K1
    from tpu_bitsandbytes_torch.ops import matmul4bit as K5
    from tpu_bitsandbytes_torch.ops import w4a8 as K4
    return (K1.int4_mm_plain, K2.flash_decode_plain, K3.flash_prefill_plain,
            K4.w4a8_mm_plain, K5.matmul4bit_plain)


def mesh_rank_7b(mesh, dev, job):
    """12a, one rank: phase 4's model and requests on a tp = 2 engine over
    gloo (the int4 cache built per shard, chunks eager). K1 at each shard
    shape against its plain version; a row shard's A8 codes against the
    unsharded row's; the served tokens, launches and step time; the
    launches of one more decode step, counted alone; teacher-forced logits
    on phase 4's tokens."""
    from tpu_bitsandbytes_torch.engine import engine as E
    from tpu_bitsandbytes_torch.ops import int4cache as K1
    from tpu_bitsandbytes_torch.ops.w4a8 import quantize_a8
    from tpu_bitsandbytes_torch.parallel.sharding import interleave_fused
    from tpu_bitsandbytes_torch.utils.metrics import MetricsLogger
    counters, plains = kernel_counters(), kernel_plains()
    t0 = time.perf_counter()
    cfg, params, prompts, sp, kw = llama7b_workload(dev)
    params = interleave_fused(params, cfg, MESH_TP)
    engine = E.DecodeEngine(params, cfg, device=dev, mesh=mesh,
                            cuda_graphs=False, **kw)
    del params
    free_memory()
    out = {"build_s": time.perf_counter() - t0, "layers": cfg.num_layers}
    ctx = engine._tp
    # K1 at each shard shape (M = 8), against its plain version
    gen = torch.Generator(device=dev).manual_seed(12)
    k1 = []
    layer = engine.params["layers"][0]
    for name, w in [(n, layer[n]) for n in ("qkv_proj", "o_proj",
                                            "gateup_proj", "down_proj")] + [
            ("lm_head", engine.params["lm_head"])]:
        n, kp = w.w_cache.shape[0], w.w_cache.shape[1] * 2
        x = torch.randn((8, kp), generator=gen, device=dev).to(cfg.dtype)
        xq, s_x = quantize_a8(x, kp)
        got = K1.int4_mm(xq, w.w_cache, w.cache_scale, s_x)
        ref = K1.int4_mm_plain(xq, w.w_cache, w.cache_scale, s_x)
        r = err(got, ref)[1]
        if not (r <= K1_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"12a K1 {name} {n}x{kp}: rel err {r}")
        k1.append({"linear": name, "n": n, "k_pad": kp, "rel_err": r,
                   "takes_kernel": K1.takes_kernel(8, n, kp, 128)})
    out["k1_shards"] = k1
    # a row shard's A8 codes: the row scale all-reduced over tp
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((8, cfg.hidden_size), generator=g, device=dev).to(
        cfg.dtype)
    k = cfg.hidden_size // ctx.tp
    sl = slice(ctx.tp_rank * k, (ctx.tp_rank + 1) * k)
    q_sh, s_sh = quantize_a8(x[:, sl], k, ctx.tp_group)
    q_full, s_full = quantize_a8(x, cfg.hidden_size)
    q_own, _ = quantize_a8(x[:, sl], k)
    out["a8"] = {"codes_equal": bool(torch.equal(q_sh, q_full[:, sl])),
                 "scales_equal": bool(torch.equal(s_sh, s_full)),
                 "own_scale_codes_equal": bool(torch.equal(q_own,
                                                           q_full[:, sl]))}
    # phase 4's requests: the step loop, as phase 4 serves them
    reset(counters, plains)
    engine.metrics = MetricsLogger()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, sp, pipeline_depth=1)
    torch.cuda.synchronize()
    hist = engine.metrics.history
    steps = len(hist) * engine.steps_per_sync
    out.update(outs=outs, generate_s=time.perf_counter() - t0,
               launches=counts(counters), decode_steps=steps,
               decode_step_ms=sum(m.wall_s for m in hist) / steps * 1e3,
               decode_tokens_per_s=engine.metrics.summary()["tokens_per_s"],
               plain_calls_on_cuda=sum(f.cuda_calls for f in plains),
               max_memory_allocated_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30)
    # one more decode step from the slots' final positions, counted alone
    toks = torch.tensor([o[-1] for o in outs], dtype=torch.int32,
                        device=dev)
    span = E._span_bucket(int(engine.cache.lengths.max()) + 1,
                          engine.max_seq)
    reset(counters, plains)
    logits, _ = E.decode_step(engine.params, engine.cache, toks,
                              torch.ones_like(toks, dtype=torch.bool), cfg,
                              attn_span=span, tp=ctx)
    torch.cuda.synchronize()
    if not torch.isfinite(logits).all():
        raise AssertionError("12a: a decode step's logits are not finite")
    out["launches_per_step"] = counts(counters)
    # teacher-forced logits on phase 4's tokens
    out["forced"] = teacher_forced(engine.params, cfg, dev, prompts,
                                   job["outs"], kw["max_seq"], engine.cache,
                                   tp=ctx)
    return out


def mesh_rank_13b(mesh, dev, job):
    """12b, one rank: 12b's model (:func:`mesh13_model`) on tp = 2 shards
    off the packed bytes: ``prefill_then_steps`` of 12b's prompts and
    forced tokens, each kernel's first call per shape recorded and held
    against its plain version."""
    from tpu_bitsandbytes_torch.parallel import shard_params
    from tpu_bitsandbytes_torch.parallel.sharding import interleave_fused
    from tpu_bitsandbytes_torch.parallel.tp import TPContext
    cfg, params = mesh13_model(dev)
    local = shard_params(interleave_fused(params, cfg, MESH_TP), mesh)
    del params
    free_memory()
    ctx = TPContext(mesh, cfg)
    rec = {}
    t0 = time.perf_counter()
    with recorded_kernel_calls(rec), \
            k4_inputs(feed=job["feeds"][ctx.tp_rank]) as notes:
        pre, steps, launches = prefill_then_steps(
            local, cfg, dev, job["prompts"], job["forced"], 1024, tp=ctx)
    run_s = time.perf_counter() - t0
    if len(notes) != len(job["feeds"][ctx.tp_rank]):
        raise AssertionError(f"12b: {len(notes)} K4 calls fed of "
                             f"{len(job['feeds'][ctx.tp_rank])}")
    return {"pre": pre, "steps": steps, "launches": launches,
            "k4_inputs": [{k: n[k] for k in ("shape", "m", "rel_err")}
                          for n in notes],
            "run_s": run_s, "kernels": kernel_calls_against_plain(rec),
            "shard_shapes": {k: list(w.shape) for k, w in
                             local["layers"][0].items()
                             if hasattr(w, "packed")}}


@contextlib.contextmanager
def k4_calls(out):
    """Appends (the :class:`RowShards` shard applied or None, activation on
    the CPU) of every K4 call that a ``QLinear4`` makes to ``out`` while
    open."""
    from tpu_bitsandbytes_torch.models import layers
    orig = layers.w4a8_matmul_4bit

    def tap(x, packed_flat, st, **kw):
        out.append((RowShards.rank, x.cpu()))
        return orig(x, packed_flat, st, **kw)

    layers.w4a8_matmul_4bit = tap
    try:
        yield out
    finally:
        layers.w4a8_matmul_4bit = orig


def rank_feeds(calls, tp):
    """Each tp rank's K4 inputs from a :func:`row_sharded` run's
    :func:`k4_calls`: a column-parallel call's whole activation, and of a
    row-parallel linear's shard calls the rank's own."""
    return [[x for shard, x in calls if shard in (None, r)]
            for r in range(tp)]


def mesh_rank_main(argv) -> int:
    """``chip_smoke.py --mesh-rank PART RANK WORLD PORT DIR``: one rank of
    phase 12's world over gloo on device 0; writes its results to
    ``DIR/rankRANK.pt``."""
    import datetime
    import pickle
    import torch.distributed as dist
    from tpu_bitsandbytes_torch.ops import _build
    from tpu_bitsandbytes_torch.parallel import make_mesh
    part, rank, world, port, d = (argv[0], int(argv[1]), int(argv[2]),
                                  int(argv[3]), argv[4])
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    with open(os.path.join(d, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    timeout = datetime.timedelta(seconds=MESH_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=timeout)
    try:
        _build.load_all()
        mesh = make_mesh(tp=MESH_TP, dp=world // MESH_TP, device_type="cuda",
                         timeout=timeout)
        fn = {"7b": mesh_rank_7b, "13b": mesh_rank_13b}[part]
        torch.save(fn(mesh, dev, job), os.path.join(d, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


class MeshWorld:
    """``world`` ranks of ``part`` (:func:`mesh_rank_main`), each a process
    of its own on device 0, started now; :meth:`join` waits for them and
    returns their results. A rank that fails, or a world that outlives
    ``MESH_TIMEOUT_S`` (its processes then killed), raises with every
    failed rank's output."""

    def __init__(self, part, job, world=MESH_TP):
        import pickle
        import socket
        self.part, self.world = part, world
        self.dir = os.path.join(MESH_DIR, part)
        os.makedirs(self.dir, exist_ok=True)
        with open(os.path.join(self.dir, "job.pkl"), "wb") as f:
            pickle.dump(job, f)
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        self.t0 = time.perf_counter()
        self.deadline = time.monotonic() + MESH_TIMEOUT_S
        self.procs = []
        atexit.register(self.kill)      # no rank outlives this process
        for r in range(world):
            log = open(os.path.join(self.dir, f"rank{r}.log"), "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                 part, str(r), str(world), str(port), self.dir],
                stdout=log, stderr=subprocess.STDOUT), log))

    def kill(self) -> bool:
        """Kills the ranks still running; True if there were any."""
        alive = False
        for p, log in self.procs:
            if p.poll() is None:
                alive = True
                p.kill()
                p.wait()
            log.close()
        return alive

    def join(self):
        for p, _ in self.procs:
            try:
                p.wait(timeout=max(0.1, self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
        timed_out = self.kill()
        bad = [r for r, (p, _) in enumerate(self.procs) if p.returncode != 0]
        if bad:
            tails = "\n".join(
                f"--- rank {r} (exit {self.procs[r][0].returncode}) ---\n"
                + open(os.path.join(self.dir, f"rank{r}.log")).read()[-4000:]
                for r in bad)
            raise AssertionError(f"phase 12 {self.part}: ranks {bad} failed"
                                 + (" (killed at the time limit)"
                                    if timed_out else "") + f"\n{tails}")
        self.wall_s = time.perf_counter() - self.t0
        return [torch.load(os.path.join(self.dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def token_rule(outs, ref_outs, forced):
    """12a's token rule: request by request, the tp engine's greedy tokens
    equal phase 4's up to the first position where they differ; there
    phase 4's top-2 gap (of its teacher-forced logits ``forced``, as a
    share of the row's max|logit|) must be below ``TP_TIE_GAP``, and the
    rest of that request is not compared. Returns the positions compared
    and where requests stopped."""
    compared, stops = 0, []
    for b, (got, ref) in enumerate(zip(outs, ref_outs)):
        for j, (a, r) in enumerate(zip(got, ref)):
            row = forced[j, b]
            top = row.topk(2).values
            gap = float((top[0] - top[1]) / row.abs().max())
            if a == r:
                compared += 1
                continue
            if gap >= TP_TIE_GAP:
                raise AssertionError(
                    f"12a: request {b} token {j}: {a} != phase 4's {r} at a "
                    f"top-2 gap of {gap:.4f} of max|logit| (>= {TP_TIE_GAP})")
            stops.append({"request": b, "token": j, "gap": gap})
            break
    return compared, stops


def phase_mesh_7b(world, outs_7b, forced_7b, smi):
    """12a: Llama-2-7B at full width and depth on tp = 2 (two ranks over
    gloo on the one card, ``world``, started with ``{"outs": outs_7b}``),
    against phase 4's run."""
    res = world.join()
    r0 = res[0]
    # phase 4's: 129 K1 (4 fused linears a layer and the lm_head) and 32
    # K2 at 32 layers; every shard shape takes K1 by JAX's rule
    n_l = r0["layers"]
    want = {"K1_int4_matmul": 4 * n_l + 1, "K2_flash_decode": n_l,
            "K3_flash_prefill": 0, "K4_w4a8_matmul": 0, "K5_matmul4bit": 0}
    for r, out in enumerate(res):
        if out["launches_per_step"] != want:
            raise AssertionError(f"12a rank {r}: launches per decode step "
                                 f"{out['launches_per_step']}, expected "
                                 f"{want}")
        steps = out["decode_steps"]
        if (out["launches"]["K2_flash_decode"] != n_l * steps
                or out["launches"]["K1_int4_matmul"] < (4 * n_l + 1) * steps
                or out["plain_calls_on_cuda"]):
            raise AssertionError(f"12a rank {r}: launches {out['launches']}"
                                 f" for {steps} steps, "
                                 f"{out['plain_calls_on_cuda']} plain calls")
        if not (out["a8"]["codes_equal"] and out["a8"]["scales_equal"]):
            raise AssertionError(f"12a rank {r}: row-shard A8 {out['a8']}")
        if out["outs"] != r0["outs"] or not torch.equal(out["forced"],
                                                        r0["forced"]):
            raise AssertionError(f"12a: rank {r}'s output differs from "
                                 "rank 0's")
    got = r0["forced"]
    if got.shape != forced_7b.shape or not torch.isfinite(got).all():
        raise AssertionError(f"12a: teacher-forced logits {got.shape}")
    rel = ((got - forced_7b).abs().amax(dim=(1, 2))
           / forced_7b.abs().amax(dim=(1, 2)))
    if not (rel <= E2E_TOL).all():
        raise AssertionError(f"12a: teacher-forced logits off phase 4's by "
                             f"{rel.max().item()} of max|ref|")
    compared, stops = token_rule(r0["outs"], outs_7b, forced_7b)
    emit({"phase": "mesh_7b_tp2", "model": "llama2_7b", "tp": MESH_TP,
          "dp": 1, "ranks": len(res), "backend": "gloo", "layers": 32,
          "batch": 8, "new_tokens": 64, "card": smi,
          "note": "two processes sharing one card through host-staged "
                  "gloo collectives, beside phase 3 and phase 11's CPU "
                  "references in the parent: not a scaling number",
          "world_wall_s": world.wall_s,
          "build_s": [o["build_s"] for o in res],
          "generate_s": [o["generate_s"] for o in res],
          "decode_step_ms": [o["decode_step_ms"] for o in res],
          "decode_tokens_per_s": [o["decode_tokens_per_s"] for o in res],
          "max_memory_allocated_gib": [o["max_memory_allocated_gib"]
                                       for o in res],
          "launches": r0["launches"],
          "launches_per_step": r0["launches_per_step"],
          "k1_shards": r0["k1_shards"], "a8_row_shard": r0["a8"],
          "teacher_forced_rel_err_max": rel.max().item(),
          "teacher_forced_rel_err_by_step": rel.tolist(),
          "tie_gap": TP_TIE_GAP, "tokens_compared": compared,
          "tokens_total": sum(map(len, outs_7b)), "token_stops": stops,
          "tokens_identical": r0["outs"] == outs_7b})
    return r0["launches"]


def phase_mesh_13b(dev, smi):
    """12b: Llama-2-13B at full width, 4 layers, off the packed bytes, on
    tp = 2 (two ranks over gloo), against the same 4 layers on one device
    in this process: with the row-parallel linears split as the shards
    split them (:func:`row_sharded`, gated), plain, and in f32."""
    rng = np.random.default_rng(1212)
    cfg, params = mesh13_model(dev)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in MESH13_PROMPTS]
    forced = rng.integers(1, cfg.vocab_size,
                          (MESH13_STEPS, len(prompts))).tolist()
    pre, steps, launches = prefill_then_steps(params, cfg, dev, prompts,
                                              forced, 1024)
    # the same layers in f32: the single-device run's own bf16 gap
    pre32, steps32, _ = prefill_then_steps(
        as_f32(params), dataclasses.replace(cfg, dtype=torch.float32), dev,
        prompts, forced, 1024)
    # and with the mesh's row-parallel arithmetic (each K slice its own A8
    # scale) on this one device, every K4 input recorded to feed the ranks
    rs_params = row_sharded(params, MESH_TP)
    calls = []
    with k4_calls(calls):
        pre_rs, steps_rs, _ = prefill_then_steps(rs_params, cfg, dev,
                                                 prompts, forced, 1024)
    del params, rs_params
    free_memory()
    feeds = rank_feeds(calls, MESH_TP)
    res = MeshWorld("13b", {"prompts": prompts, "forced": forced,
                            "feeds": feeds}).join()
    r0 = res[0]
    for r, out in enumerate(res):
        if not (torch.equal(out["pre"], r0["pre"])
                and torch.equal(out["steps"], r0["steps"])):
            raise AssertionError(f"12b: rank {r}'s logits differ from "
                                 "rank 0's")
    def gaps(a_pre, a_steps, b_pre, b_steps):
        return ((a_pre - b_pre).abs().amax(-1) / b_pre.abs().amax(-1),
                (a_steps - b_steps).abs().amax(dim=(1, 2))
                / b_steps.abs().amax(dim=(1, 2)))

    own_pre, own_steps = gaps(pre, steps, pre32, steps32)
    jax_pre, jax_steps = gaps(pre_rs, steps_rs, pre, steps)
    rs_pre, rs_steps = gaps(r0["pre"], r0["steps"], pre_rs, steps_rs)
    # K4 quantizes each row-parallel shard's slice with its own A8 scale
    # (JAX's arithmetic), so the mesh is held to the single-device model
    # computing its row-parallel linears the way the shards do
    # (:func:`row_sharded`). K4's A8 codes turn one bf16 ulp at a row's
    # largest element into a rescaled row (phase 3b), and the two runs'
    # kernels split their sums differently, so the ranks take that run's
    # activation at every K4 call; each of their own K4 inputs but
    # o_proj's (K2's outputs) is held to the fed one at E2E_TOL, and so
    # are the logits. How far JAX's per-shard scales move the logits from
    # the plain single-device run is reported beside that run's own
    # bf16-vs-f32 gap.
    o_shape = [cfg.hidden_size, cfg.num_heads * cfg.hd // MESH_TP]
    k4 = [n for out in res for n in out["k4_inputs"]]
    worst = max(n["rel_err"] for n in k4 if list(n["shape"]) != o_shape)
    worst_o = max((n["rel_err"] for n in k4 if list(n["shape"]) == o_shape),
                  default=None)
    if not ((rs_pre <= E2E_TOL).all() and (rs_steps <= E2E_TOL).all()
            and worst <= E2E_TOL and torch.isfinite(r0["steps"]).all()):
        raise AssertionError(
            f"12b: logits off the single-device run with the mesh's "
            f"row-parallel arithmetic by {rs_pre.tolist()} / "
            f"{rs_steps.tolist()}, K4 inputs by {worst} (tol {E2E_TOL})")
    lp = r0["launches"]
    # the prompts' routes: K4 at 64, K5 at 256, K3 at 1024
    if not (lp["prefill"][0]["K4_w4a8_matmul"] > 0
            and lp["prefill"][1]["K5_matmul4bit"] > 0
            and lp["prefill"][2]["K3_flash_prefill"] == MESH13_LAYERS
            and all(s["K4_w4a8_matmul"] == 4 * MESH13_LAYERS + 1
                    and s["K2_flash_decode"] == MESH13_LAYERS
                    for s in lp["step"])):
        raise AssertionError(f"12b: launches {lp}")
    emit({"phase": "mesh_13b_tp2", "model": "llama2_13b", "tp": MESH_TP,
          "layers": MESH13_LAYERS, "prompt_lens": MESH13_PROMPTS,
          "decode_steps": MESH13_STEPS, "backend": "gloo", "card": smi,
          "shard_shapes": r0["shard_shapes"],
          "rel_err_prefill": rs_pre.tolist(),
          "rel_err_steps": rs_steps.tolist(),
          "k4_inputs_fed": len(k4), "k4_input_worst_rel_err": worst,
          "k4_input_worst_rel_err_o_proj": worst_o,
          "row_sharded_vs_single_prefill": jax_pre.tolist(),
          "row_sharded_vs_single_steps": jax_steps.tolist(),
          "single_bf16_vs_f32_prefill": own_pre.tolist(),
          "single_bf16_vs_f32_steps": own_steps.tolist(), "tol": E2E_TOL,
          "launches_rank0": lp, "launches_single_device": launches,
          "kernels_against_plain": r0["kernels"],
          "run_s": [o["run_s"] for o in res]})
    total = {k: sum(d[k] for d in lp["prefill"] + lp["step"])
             for k in lp["step"][0]}
    return total


def phase_nccl_tp1(dev, counters, plains, smi):
    """12c: a one-rank NCCL group in this process: phase 4's model cut to
    ``NCCL_LAYERS`` layers served graphed through ``mesh=make_mesh(tp=1)``
    (the chunk's graph holds the collectives) and on the plain engine;
    greedy tokens identical, capture seconds and step ms of both."""
    import datetime
    import socket
    import torch.distributed as dist
    from tpu_bitsandbytes_torch.engine import engine as E
    from tpu_bitsandbytes_torch.parallel import make_mesh
    from tpu_bitsandbytes_torch.utils.metrics import MetricsLogger
    cfg, params, prompts, sp, kw = cut_depth(llama7b_workload(dev),
                                             NCCL_LAYERS)

    def serve(engine):
        res = []
        for _ in range(2):      # the first pass captures, the second replays
            engine.metrics = MetricsLogger()
            reset(counters, plains)
            t0 = time.perf_counter()
            outs = engine.generate(prompts, sp, pipeline_depth=1)
            torch.cuda.synchronize()
            hist = engine.metrics.history
            steps = len(hist) * engine.steps_per_sync
            res.append({"outs": outs, "generate_s": time.perf_counter() - t0,
                        "decode_step_ms": sum(m.wall_s for m in hist)
                        / steps * 1e3, "launches": counts(counters)})
        key = engine.graph_keys()[-1]
        census = {"kernels": dict(engine._graphs.kernel_names(key)),
                  "nodes": dict(engine._graphs.node_types(key)),
                  "key": list(key)}
        return res, engine.graph_stats(), census

    plain = E.DecodeEngine(params, cfg, device=dev, **kw)
    p_res, p_graphs, p_census = serve(plain)
    del plain
    free_memory()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(tp=1, dp=1, device_type="cuda")
        engine = E.DecodeEngine(params, cfg, device=dev, mesh=mesh, **kw)
        m_res, m_graphs, m_census = serve(engine)
        del engine
        free_memory()
    finally:
        dist.destroy_process_group()
    for i in range(2):
        if m_res[i]["outs"] != p_res[i]["outs"]:
            raise AssertionError(f"12c: pass {i + 1}: the one-rank NCCL mesh "
                                 "engine's tokens differ from the plain "
                                 "engine's")
    nccl = {k: v for k, v in m_census["kernels"].items()
            if "nccl" in k.lower()}
    emit({"phase": "mesh_nccl_tp1", "model": "llama2_7b",
          "layers": NCCL_LAYERS, "backend": "nccl", "ranks": 1,
          "card": smi, "tokens_identical": True,
          "capture_s": {"mesh": m_graphs["capture_s"],
                        "plain": p_graphs["capture_s"]},
          "decode_step_ms": {"mesh": m_res[1]["decode_step_ms"],
                             "plain": p_res[1]["decode_step_ms"]},
          "first_pass_decode_step_ms": {"mesh": m_res[0]["decode_step_ms"],
                                        "plain": p_res[0]["decode_step_ms"]},
          "graph_nodes": {"mesh": m_census["nodes"],
                          "plain": p_census["nodes"]},
          "nccl_kernel_nodes": nccl,
          "graph_kernel_nodes": {"mesh": sum(m_census["kernels"].values()),
                                 "plain": sum(p_census["kernels"].values())},
          "launches": {"mesh": m_res[1]["launches"],
                       "plain": p_res[1]["launches"]}})
    if m_res[1]["launches"] != p_res[1]["launches"]:
        raise AssertionError(f"12c: launches {m_res[1]['launches']} != the "
                             f"plain engine's {p_res[1]['launches']}")
    return m_res[1]["launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tpu_bitsandbytes_torch import functional as TF
    from tpu_bitsandbytes_torch.ops import _build
    from tpu_bitsandbytes_torch.ops import flash_decode as K2
    from tpu_bitsandbytes_torch.ops import flash_prefill as K3
    from tpu_bitsandbytes_torch.ops import int4cache as K1
    from tpu_bitsandbytes_torch.ops import matmul4bit as K5
    from tpu_bitsandbytes_torch.ops import w4a8 as K4

    t_script = time.perf_counter()
    ends = {}   # each phase's end, seconds from the script's start

    def phase_end(name):
        ends[name] = time.perf_counter() - t_script
        emit({"phase": "phase_end", "name": name, "t_s": ends[name]})
    # 1. header
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "header", "device": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "host_cpus": os.cpu_count(),
          "torch_threads": torch.get_num_threads()})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs (the plain prefill product above M = 256) reduce in f32,
    # as XLA's bf16 dot does
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    bw, int8_peak, bf16_peak = card_rates(name)
    dev = torch.device("cuda", 0)

    # 2. kernels
    t0 = time.perf_counter()
    _build.load_all()
    build_s = time.perf_counter() - t0
    # ptxas -v: each kernel's name, then its registers, shared memory, spills
    ptxas = [line.strip() for src in _build.sources()
             for line in _build.build_log(src.stem).splitlines()
             if "Compiling entry function" in line or "registers" in line
             or "spill" in line]
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = [phase_kernels_k1(K1, gen, dev, bw, int8_peak),
               phase_kernels_k2(K2, gen, dev, bw, int8_peak),
               phase_kernels_k3(K3, gen, dev, bw, bf16_peak),
               phase_kernels_k4(K4, gen, dev, bw, int8_peak),
               phase_kernels_k5(K5, TF, gen, dev, bw, bf16_peak)]
    torch.cuda.empty_cache()
    # not a TPU kernel: the int8 and bf16 runtime caches' product
    phase_cache_dots(dev, gen, bw)
    torch.cuda.empty_cache()
    profiler_check(dev)
    counters, plains = kernel_counters(), kernel_plains()

    phase_end("2")
    # 4. Llama-2-7B through the int4 cache
    by_path = {}
    by_path["llama2_7b_int4"], outs_7b, forced_7b = phase_serve(
        dev, counters, plains)
    torch.cuda.empty_cache()

    phase_end("4")
    # 5. Llama-2-13B off the packed bytes
    workload = packed_workload(dev)
    by_path["llama2_13b_packed"], k2_bound_13b = phase_serve_packed(
        dev, counters, plains, bw, int8_peak, workload)
    torch.cuda.empty_cache()

    phase_end("5")
    # 6. the request API on the same model, cut to its first 10 layers
    by_path["llama2_13b_requests"] = phase_requests(
        dev, counters, plains, cut_depth(workload, REQUESTS_LAYERS))
    free_memory()

    phase_end("6")
    # 8. runtime_cache="auto" (the int8 cache) on the same model, cut to its
    # first 10 layers
    by_path["llama2_13b_auto_int8"] = phase_auto(
        dev, counters, plains, cut_depth(workload, REQUESTS_LAYERS))
    del workload
    free_memory()

    phase_end("8")
    # 7. the engine's lifecycle on phase 4's model
    by_path["llama2_7b_lifecycle"], verify_k1 = phase_lifecycle(
        dev, counters, plains, outs_7b)
    kernels[0]["verify_step"]["launches_per_step"] = verify_k1

    phase_end("7")
    # 9. the bitsandbytes-style API at Llama-2-7B widths
    by_path["bnb_api_7b"] = phase_library(dev, counters, plains)
    phase_end("9")
    # 10. QLoRA training at Llama-2-7B width
    by_path["qlora_7b"] = phase_qlora(dev, counters, plains, smi)
    phase_end("10")
    # 11. the model families: Mixtral-8x7B served, Mixtral and Gemma2-9B
    # at 2 layers against the CPU
    free_memory()
    by_path["mixtral_8x7b_packed"] = phase_mixtral(dev, counters, plains)
    free_memory()
    # 12a's two ranks serve on the card while this process runs phase 3
    # (full width against the CPU: CPU references and untimed card runs)
    # and 11b's and 11c's CPU references
    world_7b = MeshWorld("7b", {"outs": outs_7b})
    phase_full_width(dev)
    torch.cuda.empty_cache()
    packed_2l = phase_full_width_packed(dev, counters)
    torch.cuda.empty_cache()
    phase_full_width_caches(dev, counters, *packed_2l)
    del packed_2l
    torch.cuda.empty_cache()
    phase_chunked_prefill(dev, counters)
    torch.cuda.empty_cache()
    phase_end("3")
    moe_cpu, g2_cpu = mixtral_2l_cpu(dev), gemma2_cpu(dev)
    res_7b = phase_mesh_7b(world_7b, outs_7b, forced_7b, smi)
    by_path["mixtral_2l"] = phase_mixtral_2l(dev, counters, plains, K2,
                                             moe_cpu)
    by_path["gemma2_9b_2l"], g2_rows = phase_gemma2(
        dev, counters, plains, bw, bf16_peak, int8_peak, K2, K3, g2_cpu)
    del moe_cpu, g2_cpu
    kernels[1]["gemma2_9b_decode_layers"] = g2_rows["K2"]
    kernels[2]["gemma2_9b_prefill_layers"] = g2_rows["K3"]
    # K2's bound at the 13B path's positions in the step counted alone
    kernels[1]["bound_13b_served_step_ms"] = k2_bound_13b
    phase_end("11")
    # 12. tensor parallelism: tp = 2 over gloo (two ranks on the one card)
    # at Llama-2-7B's full width and depth (12a, above) and at Llama-2-13B's
    # width, and a one-rank NCCL mesh whose chunk graphs hold the
    # collectives
    free_memory()
    by_path["llama2_7b_tp2_rank0"] = res_7b
    by_path["llama2_13b_4l_tp2_rank0"] = phase_mesh_13b(dev, smi)
    by_path["llama2_7b_8l_nccl_tp1"] = phase_nccl_tp1(dev, counters, plains,
                                                      smi)
    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        if not k["launches"]:
            raise AssertionError(f"{k['name']} never launched on a path")
    phase_end("12")
    emit({"phase": "script_wall", "seconds": time.perf_counter() - t_script,
          "seconds_at_end_of_phase": ends})
    emit({"kernels": kernels})
    # one card: the run uses device 0 alone
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(sys.argv[2:]))
    sys.exit(main())
