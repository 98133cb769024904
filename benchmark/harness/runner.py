"""One run of one cell: set-up, the closed loop's window, the metrics, the
correctness check and the result line."""

from __future__ import annotations

import gc
import sys
import time
from typing import Optional

import torch

from . import check, spec, traffic as traffic_kinds
from .accounting import attempted, failed
from .record import Run
from .serve import Loop, sync, warm_up
from .trace import Instrument, busy_ns

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_bitsandbytes")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device, t0: float, fault=None, after=None) -> dict:
    """Run ``cell`` once and return the result line's object.

    ``t0``: the process's start on the host clock (set-up counts from
    it). ``fault``: the tests' hook, ``fault(engine)`` called once the
    engine is warm, to break the timed path underneath. ``after``: the
    control's hook, ``after(tree, chosen, hold, ref)`` called with the
    weights, the sampled requests, the holders read back and the
    reference's logits and K and V (:func:`check.readings`) once the check
    has read them; its dict goes under the result's ``"after"``."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_initialized():
        # an earlier run in this process (the control's seeds) is gone
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    cfg, settings = cell.config, cell.settings
    eng_kw = settings["engine"]
    layout = spec.layout(cfg)
    tree = layout.make_weights(cfg, seed, device)
    eng = layout.build_engine(tree, cfg, eng_kw, seed, device)
    traffic = traffic_kinds.load(cell.traffic, seed, cfg["vocab_size"])
    warm = warm_up(eng, traffic, eng_kw)
    setup_s = time.perf_counter() - t0
    capture_s = eng.graph_stats()["capture_s"]
    log(f"setup {setup_s:.3f} s: {len(warm['keys'])} graph keys "
        f"(capture {capture_s:.3f} s), prefill buckets "
        f"{warm['prefill_buckets']}")
    if fault is not None:
        fault(eng)
    loop = Loop(eng, traffic, seconds)
    inst = (Instrument(loop, **settings["trace"]) if trace else None)
    t_loop = time.perf_counter()
    win = loop.run()
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)
    cut = sum(1 for r in loop.reqs if r.cancelled)
    log(f"ramp {win.open - t_loop:.3f} s, window {win.seconds:.3f} s, "
        f"after the close {time.perf_counter() - win.close:.3f} s; "
        f"{len(loop.reqs)} requests, {cut} cut at the close")
    if loop.captured_in_window():
        log(f"WARNING: {loop.captured_in_window()} graph(s) captured "
            "inside the window")
    if inst is not None:
        inst.read_trace()
    run = Run(cell=cell.name, cfg=cfg, engine=eng_kw, window=win,
              reqs=loop.reqs, setup_s=setup_s, capture_s=capture_s,
              memory_peak=mem, device_kind=_kind(device), inst=inst)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for name, m in spec.readers(cell, kind).items():
        v = m.read(run)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": m.unit}
    att, bad = attempted(loop.reqs, win), failed(loop.reqs, win)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _kind(device), "count": cell.chips,
           "memory_peak_bytes": int(mem)}
    out = {"metrics": metrics}
    if inst is not None:
        dev["busy_s"] = busy_ns(inst.span.records) / 1e9
        dev["window_s"] = inst.span.seconds
        out["breakdown"] = inst.breakdown()
        inst.engine = None
    # the holders' KV is read back, then the server's state goes before
    # the reference runs
    hold = check.held(loop.reqs, loop.holders, eng.cache.lengths.tolist(),
                      eng.cache.max_seq if eng.cache.ring else None, seed)
    kv = layout.read_kv(eng, [(h[1], h[2]) for h in hold]) if hold else []
    loop.detach()
    eng = None
    gc.collect()
    if device.type == "cuda":
        sync(device)
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    chosen = check.sample(loop.reqs, seed, settings["check"]["requests"])
    values, ref = check.readings(tree, cfg, chosen, hold, kv,
                                 cfg["precision"], keep=after is not None)
    del kv
    values["short_requests"] = sum(
        1 for r in loop.reqs if r.t_done is not None
        and len(r.tokens) != r.n_out)
    verdict = check.judge(values, {**settings["check"]["limits"],
                                   "short_requests": 0})
    log(f"reference {time.perf_counter() - t_ref:.3f} s over "
        f"{len(chosen)} requests, {values['tokens']} served tokens, and "
        f"the KV of {len(hold)} holders, "
        f"{sum(h[2].numel() for h in hold)} positions; readings {values}")
    if after is not None:
        out["after"] = after(tree, chosen, hold, ref)
    return {"correct": verdict["correct"] and bool(chosen),
            "attempted": len(att), "failed": len(bad), **out,
            "device": dev, "checks": verdict["checks"]}


def _kind(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(argv: Optional[list] = None, t0: Optional[float] = None) -> int:
    import argparse
    import json
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        log(f"{args.workload} needs {cell.chips} CUDA card(s); this machine "
            f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda:0", t0)
    bad = forbidden_modules()
    if bad:
        log("modules of JAX or the JAX package were loaded: "
            + ", ".join(bad))
        return 4
    check.report(result["checks"])
    print(json.dumps(result), flush=True)
    return 0
