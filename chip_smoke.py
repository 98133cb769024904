"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure raises: traceback, nonzero exit):
  1. header: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 off for matmuls and cuDNN.
  2. kernels: builds every kernel from ``tpu_bitsandbytes_torch/csrc`` and
     holds each against its plain PyTorch version on the card, at the
     Llama-2-7B decode shapes and at odd ones; times kernel, plain version
     and the least time the card could take (bytes over HBM bandwidth, or
     int8 operations over the int8 peak, whichever is larger).
  3. full width against the CPU: a Llama-2-7B-width model cut to 2 layers,
     built once from a numpy seed, runs prefill and 8 staged decode steps on
     the card (kernels) and on the CPU (plain versions), both bf16.
  4. the slice: Llama-2-7B at its 32 layers, random NF4 weights from a
     seed, served by ``DecodeEngine.generate`` (int4 runtime cache, B=8,
     32-step chunks) for 8 requests of 16-200 prompt tokens and 64 greedy
     new tokens each. Counts kernel launches per decode step.

Prints JSON lines; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA card it exits with code 2 and prints no result.
"""

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

K1_TOL = 1e-5   # exact int32 block dots; only the f32 sum order differs
K2_TOL = 1e-3   # one flipped p code where an exp rounds differently
E2E_TOL = 3e-2  # bf16 logits, card vs CPU, as a share of max|ref|


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_rates(name: str):
    """(HBM bytes/s, dense int8 ops/s) of the H100 variant ``name``."""
    if "PCIe" in name:
        return 2.0e12, 1513e12
    return 3.35e12, 1979e12


def time_ms(calls, iters: int) -> float:
    """Mean ms per call over ``iters`` calls cycling through ``calls``
    (closures over distinct buffers, so operands come from HBM, not L2)."""
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


def err(got, ref):
    got, ref = got.float(), ref.float()
    abs_err = (got - ref).abs().max().item()
    return abs_err, abs_err / max(ref.abs().max().item(), 1e-30)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# (name, N, K, launches per decode step) at Llama-2-7B, fused projections
K1_DECODE = [("qkv", 12288, 4096, 32), ("o", 4096, 4096, 32),
             ("gateup", 22016, 4096, 32), ("down", 4096, 11008, 32),
             ("lm_head", 32000, 4096, 1)]
# (M, N, K): other decode widths, a prefill-sized M, prime and odd N, K=384
K1_EXTRA = [(1, 4096, 4096), (3, 4099, 4096), (64, 4096, 4096),
            (8, 2053, 11008), (3, 1013, 384), (13, 127, 384)]


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
    for m, n, k in K1_EXTRA + [(8, n, k) for _, n, k, _ in K1_DECODE]:
        xq, s_x, ((w, sc),) = k1_inputs(m, n, k, gen, dev)
        got = K1.int4_mm(xq, w, sc, s_x)
        ref = K1.int4_mm_plain(xq, w, sc, s_x)
        torch.cuda.synchronize()
        a, r = err(got, ref)
        if not (r <= K1_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"K1 M={m} N={n} K={k}: rel err {r}")
        worst = [max(worst[0], a), max(worst[1], r)]
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for name, n, k, per_step in K1_DECODE:
        w_bytes = n * k // 2
        copies = max(2, math.ceil(200e6 / w_bytes))
        xq, s_x, ws = k1_inputs(8, n, k, gen, dev, copies)
        kern = time_ms([lambda w=w, sc=sc: K1.int4_mm(xq, w, sc, s_x)
                        for w, sc in ws], iters=max(40, 2 * copies))
        plain = time_ms([lambda: K1.int4_mm_plain(xq, *ws[0], s_x)], iters=3)
        bound, by = k1_bound_ms(8, n, k, bw, int8_peak)
        rows.append({"shape": f"{name} M=8 N={n} K={k}", "kernel_ms": kern,
                     "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                     "per_step": per_step})
        total["ms"] += per_step * kern
        total["plain_ms"] += per_step * plain
        total["bound_ms"] += per_step * bound
        del ws
    emit({"phase": "kernels", "kernel": "K1_int4_matmul", "shapes": rows})
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
        "bound_by": "bytes", "library_ms": None}


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


def phase_kernels_k2(K2, gen, dev, bw, int8_peak):
    worst = [0.0, 0.0]
    cases = [  # (geometry, step, options)
        (dict(b=8, h=32, h_kv=32, d=128, s=512, span=384, c=32), 31, {}),
        (dict(b=8, h=32, h_kv=32, d=128, s=512, span=384, c=32), 0, {}),
        (dict(b=8, h=32, h_kv=32, d=128, s=512, span=384, c=32), None, {}),
        (dict(b=4, h=32, h_kv=8, d=128, s=512, span=256, c=32), 7, {}),
        (dict(b=3, h=8, h_kv=4, d=64, s=128, span=96, c=16), 5,
         dict(window=40, softcap=30.0)),
        (dict(b=2, h=8, h_kv=4, d=128, s=512, span=512, c=8, start=128), 3,
         dict(kpos_start=128)),
    ]
    for geo, step, opts in cases:
        q, len0, ((kv, st),) = k2_inputs(gen, dev, layers=1, **geo)
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
    geo = dict(b=8, h=32, h_kv=32, d=128, s=512, span=384, c=32)
    q, len0, layers = k2_inputs(gen, dev, layers=8, **geo)
    off = len0 + 31
    kern = time_ms([lambda kv=kv, st=st: K2.flash_decode_attention(
        q, *kv, off, staged=st + (31,)) for kv, st in layers], iters=64)
    kv, st = layers[0]
    plain = time_ms([lambda: K2.flash_decode_plain(
        q, *kv, off, *st, 31, scale=1.0 / 128 ** 0.5, window=None,
        kpos_start=0, softcap=None)], iters=3)
    # the main block keeps len0 keys of each slot, the stage all 32 (step 31)
    bound = k2_bound_ms(int(len0.sum()) + 8 * 32, 8, 32, 32, 128, bw,
                        int8_peak)
    bound_span = k2_bound_ms(8 * (384 + 32), 8, 32, 32, 128, bw, int8_peak)
    emit({"phase": "kernels", "kernel": "K2_flash_decode",
          "shapes": [{"shape": "B=8 H=32 H_kv=32 D=128 T=384 C=32",
                      "kept_keys": int(len0.sum()) + 8 * 32,
                      "kernel_ms": kern, "plain_ms": plain,
                      "bound_ms": bound, "bound_span_ms": bound_span,
                      "per_step": 32}]})
    return {
        "name": "K2_flash_decode", "route": "cuda",
        "source": "tpu_bitsandbytes_torch/csrc/flash_decode.cu",
        "replaces": "tpu_bitsandbytes/ops/flash_decode.py:48",
        "shape": "one decode step at Llama-2-7B: 32 x (B=8 H=32 H_kv=32 "
                 "D=128 T=384 C=32)",
        "max_abs_err": worst[0], "max_rel_err": worst[1],
        "ms": 32 * kern, "kernel_ms": 32 * kern, "plain_ms": 32 * plain,
        "bound_ms": 32 * bound, "bound_by": "bytes", "library_ms": None}


# ---------------------------------------------------------------------------
# model builders
# ---------------------------------------------------------------------------

def random_params(cfg, rand_bytes, rand_unit, rand_normal, device):
    """Llama params with random packed NF4 weights (blocksize 64, absmax
    U*0.03+0.005) in the fused qkv/gateup layout, unit norms, a normal(0,
    0.02) embedding."""
    from tpu_bitsandbytes_torch.models.layers import QLinear4
    h, hd = cfg.hidden_size, cfg.hd
    n_q, n_kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    shapes = {"qkv_proj": (n_q + 2 * n_kv, h), "o_proj": (h, n_q),
              "gateup_proj": (2 * cfg.intermediate_size, h),
              "down_proj": (h, cfg.intermediate_size)}

    def qlinear(n, k):
        return QLinear4(packed=rand_bytes((n, k // 2)),
                        absmax=rand_unit((n, k // 64)) * 0.03 + 0.005,
                        shape=(n, k), blocksize=64, quant_type="nf4",
                        dtype=cfg.dtype)

    def ones():
        return torch.ones((h,), dtype=cfg.dtype, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        layer = {name: qlinear(*shape) for name, shape in shapes.items()}
        layer["input_norm"], layer["post_attn_norm"] = ones(), ones()
        layers.append(layer)
    return {"embed": (rand_normal((cfg.vocab_size, h)) * 0.02).to(cfg.dtype),
            "layers": layers, "final_norm": ones(),
            "lm_head": qlinear(cfg.vocab_size, h)}


# ---------------------------------------------------------------------------
# phase 3: full width, card against CPU
# ---------------------------------------------------------------------------

def run_prefill_decode(params, cfg, device, prompts, forced):
    """Prefill each prompt into its slot, then a staged chunk of decode
    steps fed ``forced`` tokens (or greedy ones when None). Returns the
    prefill logits, the decode-step logits and the tokens fed."""
    from tpu_bitsandbytes_torch.engine import engine as E
    from tpu_bitsandbytes_torch.engine.kvcache import KVCache
    n_steps = 8
    cache = KVCache.create(cfg.num_layers, len(prompts), 256,
                           cfg.num_kv_heads, cfg.hd, device=device)
    pre = []
    for slot, pr in enumerate(prompts):
        padded = torch.zeros((1, E._bucket(len(pr), 256)), dtype=torch.int32)
        padded[0, :len(pr)] = torch.tensor(pr, dtype=torch.int32)
        logits, cache = E.prefill_step(params, cache, padded.to(device), slot,
                                       len(pr), cfg)
        pre.append(logits.cpu())
    toks = torch.stack(pre).argmax(-1).to(torch.int32)
    active = torch.ones((len(prompts),), dtype=torch.bool, device=device)
    span = E._span_bucket(max(map(len, prompts)) + n_steps, 256)
    cache.begin_stage(n_steps)
    steps, fed = [], []
    for i in range(n_steps):
        t_in = toks if forced is None else forced[i]
        fed.append(t_in)
        logits, cache = E.decode_step(params, cache, t_in.to(device), active,
                                      cfg, attn_span=span)
        steps.append(logits.cpu())
        toks = logits.argmax(-1).to(torch.int32).cpu()
    cache.flush_stage()
    return torch.stack(pre), torch.stack(steps), fed


def phase_full_width(dev):
    from tpu_bitsandbytes_torch.models.llama import (LlamaConfig,
                                                     build_runtime_cache,
                                                     to_device)
    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), num_layers=2)
    rng = np.random.default_rng(1234)
    params = random_params(
        cfg,
        lambda s: torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)
                                   ).to(dev),
        lambda s: torch.from_numpy(rng.random(s, dtype=np.float32)).to(dev),
        lambda s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                   ).to(dev),
        dev)
    params = build_runtime_cache(params, "int4", drop_packed=True)
    cpu_params = to_device(params, "cpu")
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (9, 33, 64, 100)]
    t0 = time.perf_counter()
    ref_pre, ref_steps, fed = run_prefill_decode(cpu_params, cfg, "cpu",
                                                 prompts, None)
    cpu_s = time.perf_counter() - t0
    got_pre, got_steps, _ = run_prefill_decode(params, cfg, dev, prompts,
                                               fed)
    worst = 0.0
    mismatched = 0
    for got, ref in [(got_pre, ref_pre)] + list(zip(got_steps, ref_steps)):
        scale = ref.abs().max().item()
        r = (got - ref).abs().max().item() / scale
        if not (r <= E2E_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"full width: card vs CPU rel err {r}")
        worst = max(worst, r)
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > E2E_TOL * scale
        same = got.argmax(-1) == ref.argmax(-1)
        mismatched += int((clear & ~same).sum())
    if mismatched:
        raise AssertionError(f"full width: {mismatched} greedy tokens differ "
                             "where the CPU's top-2 margin is clear")
    emit({"phase": "full_width", "layers": 2, "hidden": cfg.hidden_size,
          "logit_rel_err": worst, "tol": E2E_TOL, "cpu_s": cpu_s})


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

def phase_serve(dev, K1, K2):
    from tpu_bitsandbytes_torch.engine import engine as E
    from tpu_bitsandbytes_torch.engine.sampler import (SamplingArrays,
                                                       SamplingParams)
    from tpu_bitsandbytes_torch.models.llama import LlamaConfig
    cfg = LlamaConfig.llama2_7b()
    gen = torch.Generator(device=dev).manual_seed(7)
    t0 = time.perf_counter()
    params = random_params(
        cfg,
        lambda s: torch.randint(0, 256, s, generator=gen, device=dev,
                                dtype=torch.uint8),
        lambda s: torch.rand(s, generator=gen, device=dev),
        lambda s: torch.randn(s, generator=gen, device=dev), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = E.DecodeEngine(params, cfg, max_batch=8, max_seq=512,
                            steps_per_sync=32, runtime_cache="int4",
                            device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in rng.integers(16, 201, 8)]

    counters = (K1.int4_mm, K2.flash_decode_attention)
    plains = (K1.int4_mm_plain, K2.flash_decode_plain)
    for f in counters:
        f.launches = 0
    for f in plains:
        f.cuda_calls = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, SamplingParams(max_new_tokens=64))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {"K1_int4_matmul": K1.int4_mm.launches,
                "K2_flash_decode": K2.flash_decode_attention.launches}
    plain_cuda = sum(f.cuda_calls for f in plains)
    hist = engine.metrics.history
    decode_steps = len(hist) * engine.steps_per_sync
    chunk_s = sum(m.wall_s for m in hist)
    if plain_cuda:
        raise AssertionError(f"{plain_cuda} plain-version calls on CUDA "
                             "tensors in the main path")
    if not all(len(o) == 64 and all(0 <= t < cfg.vocab_size for t in o)
               for o in outs):
        raise AssertionError("generate: wrong token counts or ids")
    if launches["K2_flash_decode"] != 32 * decode_steps:
        raise AssertionError(f"K2 launches {launches} for {decode_steps} "
                             "decode steps")
    if launches["K1_int4_matmul"] < 129 * decode_steps:
        raise AssertionError(f"K1 launches {launches} for {decode_steps} "
                             "decode steps")

    # one more decode step, counted alone: the per-step launch budget
    for f in counters:
        f.launches = 0
    toks = torch.tensor([o[-1] for o in outs], dtype=torch.int32, device=dev)
    active = torch.ones((8,), dtype=torch.bool, device=dev)
    logits, _ = E.decode_step(engine.params, engine.cache, toks, active, cfg,
                              attn_span=384)
    torch.cuda.synchronize()
    per_step = (K1.int4_mm.launches, K2.flash_decode_attention.launches)
    if per_step != (4 * 32 + 1, 32):
        raise AssertionError(f"launches per decode step {per_step}, "
                             "expected (129, 32)")
    if not (logits.shape == (8, cfg.vocab_size)
            and torch.isfinite(logits).all()):
        raise AssertionError("decode-step logits not finite")
    # where a decode step's time goes: host clock around an unprofiled
    # chunk, then the device's kernel time in a profiled one
    samp = SamplingArrays.build({}, 8, device=dev)
    chunk = 8

    def run_chunk():
        E.decode_chunk(engine.params, engine.cache, toks, active, gen, samp,
                       cfg, n_steps=chunk, all_greedy=True, attn_span=384)
        torch.cuda.synchronize()

    run_chunk()
    t0 = time.perf_counter()
    run_chunk()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run_chunk()
    ops = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total,
                 reverse=True)
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    emit({"phase": "step_breakdown", "steps": chunk,
          "host_ms_per_step": wall_ms / chunk,
          "device_busy_ms_per_step": busy_ms / chunk,
          "device_idle_share": 1.0 - busy_ms / wall_ms,
          "top_device_ops": [
              {"op": e.key[:60], "ms_per_step":
               e.self_device_time_total / 1e3 / chunk,
               "calls_per_step": e.count / chunk} for e in ops[:10]]})
    emit({"phase": "serve", "model": "llama2_7b", "layers": cfg.num_layers,
          "batch": 8, "steps_per_sync": 32,
          "prompt_lens": [len(p) for p in prompts], "new_tokens": 64,
          "build_s": build_s, "generate_s": gen_s,
          "decode_steps": decode_steps,
          "decode_step_ms": chunk_s / decode_steps * 1e3,
          "decode_tokens_per_s": engine.metrics.summary()["tokens_per_s"],
          "max_memory_allocated_gib":
              torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": launches,
          "launches_per_decode_step": {"K1_int4_matmul": per_step[0],
                                       "K2_flash_decode": per_step[1]},
          "plain_calls_on_cuda": plain_cuda})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tpu_bitsandbytes_torch.ops import _build
    from tpu_bitsandbytes_torch.ops import flash_decode as K2
    from tpu_bitsandbytes_torch.ops import int4cache as K1

    # 1. header
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "header", "device": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bw, int8_peak = card_rates(name)
    dev = torch.device("cuda", 0)

    # 2. kernels
    t0 = time.perf_counter()
    _build.load_all()
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for src in _build.sources()
             for line in _build.build_log(src.stem).splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = [phase_kernels_k1(K1, gen, dev, bw, int8_peak),
               phase_kernels_k2(K2, gen, dev, bw, int8_peak)]
    torch.cuda.empty_cache()

    # 3. full width against the CPU
    phase_full_width(dev)
    torch.cuda.empty_cache()

    # 4. the slice
    launches = phase_serve(dev, K1, K2)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
