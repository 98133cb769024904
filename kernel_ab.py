"""Times the kernels of two trees of the port on one CUDA card, alternately.

    git archive <commit> tpu_bitsandbytes_torch | tar -x -C build/ab_base
    python3 kernel_ab.py --base build/ab_base [--out build/ab.jsonl]
    python3 kernel_ab.py --base build/ab_base --prefill

Runs one worker process per tree in the order base, this tree, this tree,
base. Each worker imports ``tpu_bitsandbytes_torch`` from its tree, builds
that tree's kernels, and times K3, K4 and K5 at ``chip_smoke.py`` phase
2's timed shapes (K3 at B=1 S=1024 and B=4 S=2048, H=40, D=128, bf16, and
at one Gemma-7B layer, B=1 S=2048 H=16 D=256, null in a tree whose K3
does not take d = 256; K4 at
the five Llama-2-13B shapes, blocksize 64, M = 8, 32, 64; K5 at the same
shapes, bf16, M = 128 and 256, the two prefills' 322 launches; K1 at the five
Llama-2-7B shapes, M = 8; K2 at the 7B step, span 384, and at the 13B
step, span 1920, at phase 5's last positions and with every slot long or
short), each two ways: replayed from a CUDA graph (device time, as phase
2 reports it) and launched from the host (as phase 2 reported it before
the graph). The inputs come from
the same seed in every worker.

With ``--prefill`` each worker serves ``chip_smoke.py`` phase 5's
workload (Llama-2-13B at its 40 layers off the packed bytes, the same
seeded weights and 8 prompts of 24-1800 tokens, 48 greedy new tokens)
twice on its tree's engine, and reports each admission group's prefill
ms (timed between synchronizations) and the decode step ms of the second
pass: for the engine's defaults and, in a tree whose engine takes
``cuda_graphs``, for ``cuda_graphs=False`` too.

Prints one JSON line per worker, then one summary line: per row, each
tree's mean over its two workers (null where a tree has no such row).
Without a CUDA card it exits with code 2 and prints no result.
"""

import argparse
import inspect
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as C

HERE = Path(__file__).resolve().parent


def timed(calls, iters):
    return {"graph_ms": C.time_graph_ms(calls, iters),
            "host_ms": C.time_ms(calls, iters)}


def import_tree(root: Path) -> None:
    """Import ``tpu_bitsandbytes_torch`` from the tree at ``root``."""
    sys.path.insert(0, str(root))
    import tpu_bitsandbytes_torch
    pkg = Path(tpu_bitsandbytes_torch.__file__).resolve()
    if root.resolve() not in pkg.parents:
        raise RuntimeError(f"imported {pkg}, not the tree at {root}")


def start_step_record(engine):
    """Record the step loop's decode chunks from here on; returns the
    reader of their host ms per decode step, from dispatch through
    collection: the engine tracer's spans (``chip_smoke.traced_chunks``),
    or on a tree from before the tracer its ``MetricsLogger``."""
    n = engine.steps_per_sync
    if hasattr(engine, "tracer"):
        engine.tracer.start()

        def read(eng):
            ch = C.traced_chunks(eng)
            return ch["s"] * 1e3 / (ch["chunks"] * n)
        return read
    from tpu_bitsandbytes_torch.utils.metrics import MetricsLogger
    engine.metrics = MetricsLogger()

    def read_logger(eng):
        hist = eng.metrics.history
        return sum(m.wall_s for m in hist) * 1e3 / (len(hist) * n)
    return read_logger


def prefill_worker(root: Path) -> dict:
    import_tree(root)
    from tpu_bitsandbytes_torch.engine import engine as E
    from tpu_bitsandbytes_torch.ops import _build
    _build.load_all()
    dev = torch.device("cuda", 0)
    cfg, params, prompts, sp, kw = C.packed_workload(dev)
    modes = {"default": {}}
    if "cuda_graphs" in inspect.signature(E.DecodeEngine).parameters:
        modes["cuda_graphs=False"] = {"cuda_graphs": False}
    # the step loop on every tree (the pipelined default came later)
    gen_kw = ({"pipeline_depth": 1} if "pipeline_depth"
              in inspect.signature(E.DecodeEngine.generate).parameters
              else {})
    rows = {}
    for mode, extra in modes.items():
        engine = E.DecodeEngine(params, cfg, device=dev, **kw, **extra)
        for _ in range(2):
            record = start_step_record(engine)
            with C.timed_prefills({}) as groups:
                engine.generate(prompts, sp, **gen_kw)
                torch.cuda.synchronize()
        for g in sorted(groups, key=lambda g: g["bucket"]):
            rows[f"{mode}: prefill, bucket {g['bucket']}, {g['rows']} "
                 "rows"] = {"ms": g["ms"]}
        rows[f"{mode}: decode step"] = {"ms": record(engine)}
        del engine
        C.free_memory()
    return {"tree": str(root), "rows": rows}


def worker(root: Path) -> dict:
    import_tree(root)
    from tpu_bitsandbytes_torch.ops import _build
    from tpu_bitsandbytes_torch.ops import flash_decode as K2
    from tpu_bitsandbytes_torch.ops import flash_prefill as K3
    from tpu_bitsandbytes_torch import functional as TF
    from tpu_bitsandbytes_torch.ops import int4cache as K1
    from tpu_bitsandbytes_torch.ops import matmul4bit as K5
    from tpu_bitsandbytes_torch.ops import w4a8 as K4
    _build.load_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    for b, s in ((1, 1024), (4, 2048)):
        q, k, v = [(torch.randn((b, s, 40, 128), generator=gen, device=dev)
                    * 0.5).to(torch.bfloat16) for _ in range(3)]
        rows[f"K3 B={b} S={s} H=40 D=128, per layer"] = timed(
            [lambda: K3.flash_prefill_attention(q, k, v, s_real=s,
                                                scale=128 ** -0.5)], 10)
        del q, k, v
    q, k, v = [(torch.randn((1, 2048, 16, 256), generator=gen, device=dev)
                * 0.5).to(torch.bfloat16) for _ in range(3)]
    row = "K3 B=1 S=2048 H=16 D=256 (one Gemma-7B layer)"
    if 256 in getattr(K3, "HEAD_DIMS", ()):
        rows[row] = timed([lambda: K3.flash_prefill_attention(
            q, k, v, s_real=2048, scale=256 ** -0.5)], 10)
    else:
        rows[row] = {"graph_ms": None, "host_ms": None}
    del q, k, v

    per_161 = {m: {"graph_ms": 0.0, "host_ms": 0.0} for m in C.K4_M}
    for name, n, k, per_step in C.K4_DECODE:
        copies = max(2, math.ceil(200e6 / C.packed_bytes(n, k, 64)))
        ws = C.packed_inputs(n, k, 64, gen, dev, copies)
        for m in C.K4_M:
            xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                               dtype=torch.int16).to(torch.int8)
            s_x = torch.rand((m,), generator=gen, device=dev) * 0.05 + 1e-3
            t = timed([lambda w=w, am=am: K4.w4a8_mm(xq, w, am, s_x)
                       for w, am in ws], max(40, 2 * copies))
            rows[f"K4 {name} M={m} N={n} K={k}"] = t
            for key in t:
                per_161[m][key] += per_step * t[key]
        del ws
    for m, t in per_161.items():
        rows[f"K4 M={m}, per 161 launches"] = t

    per_step = {"graph_ms": 0.0, "host_ms": 0.0}
    for name, n, k, count in C.K1_DECODE:
        copies = max(2, math.ceil(200e6 / (n * k // 2)))
        xq, s_x, ws = C.k1_inputs(8, n, k, gen, dev, copies)
        t = timed([lambda w=w, sc=sc: K1.int4_mm(xq, w, sc, s_x)
                   for w, sc in ws], max(40, 2 * copies))
        for key in t:
            per_step[key] += count * t[key]
        del ws
    rows["K1 per 7B decode step (129 launches)"] = per_step

    q, len0, layers = C.k2_inputs(gen, dev, layers=8, b=8, h=32, h_kv=32,
                                  d=128, s=512, span=384, c=32)
    off = len0 + 31
    t = timed([lambda kv=kv, st=st: K2.flash_decode_attention(
        q, *kv, off, staged=st + (31,)) for kv, st in layers], 64)
    rows["K2 per 7B decode step (32 launches)"] = {
        key: 32 * val for key, val in t.items()}
    del layers

    # the 13B step at phase 5's last positions, and with every slot long
    # (1,863 positions) or short (71): where the split pays and where not
    q, _, layers = C.k2_inputs(gen, dev, layers=8, b=8, h=40, h_kv=40,
                               d=128, s=2048, span=1920, c=32)
    for what, offs in (("phase 5's last positions",
                        [p + 47 for p in C.PACKED_PROMPTS]),
                       ("every slot at 1,863", [1863] * 8),
                       ("every slot at 71", [71] * 8)):
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        t = timed([lambda kv=kv, st=st: K2.flash_decode_attention(
            q, *kv, off, staged=st + (31,)) for kv, st in layers], 80)
        rows[f"K2 per 13B decode step, {what} (40 launches)"] = {
            key: 40 * val for key, val in t.items()}

    # K5 last: its split-K scratch, shared with K1 and K4, must not change
    # where the earlier rows' buffers lie
    book = TF.codebook("nf4", dev)
    per_run = {"graph_ms": 0.0, "host_ms": 0.0}
    for m in (128, 256):
        for name, n, k, per_prefill in C.K4_DECODE:
            copies = max(2, math.ceil(200e6 / C.packed_bytes(n, k, 64)))
            ws = C.packed_inputs(n, k, 64, gen, dev, copies)
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            t = timed([lambda w=w, am=am: K5.matmul4bit_mm(x, w, am, book,
                                                           "bf16")
                       for w, am in ws], max(20, 2 * copies))
            rows[f"K5 {name} M={m} N={n} K={k}"] = t
            for key in t:
                per_run[key] += per_prefill * t[key]
            del ws
    rows["K5 per run: the 128 and 256 prefills (322 launches)"] = per_run
    return {"tree": str(root), "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, help="root of the other tree")
    ap.add_argument("--out", type=Path, help="also write the lines here")
    ap.add_argument("--prefill", action="store_true",
                    help="time phase 5's served prefills, not the kernels")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        run = prefill_worker if args.prefill else worker
        print(json.dumps(run(args.worker)), flush=True)
        return 0
    if args.base is None or not (args.base / "tpu_bitsandbytes_torch").is_dir():
        ap.error("--base must hold a tpu_bitsandbytes_torch package")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = [{"nvidia_smi": smi, "torch": torch.__version__}]
    runs = []
    for label, root in (("base", args.base), ("this", HERE),
                        ("this", HERE), ("base", args.base)):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--worker", str(root.resolve())]
                             + ["--prefill"] * args.prefill, cwd=HERE,
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"{label} worker ({root}) exited "
                               f"{out.returncode}:\n{out.stderr[-4000:]}")
        run = json.loads(out.stdout.strip().splitlines()[-1])
        run["label"] = label
        runs.append(run)
        lines.append(run)
    summary = {}
    for row in dict.fromkeys(row for r in runs for row in r["rows"]):
        keys = next(r["rows"][row] for r in runs if row in r["rows"])
        summary[row] = {}
        for label in ("base", "this"):
            mine = [r["rows"].get(row) for r in runs if r["label"] == label]
            summary[row][label] = {
                key: None if None in mine or None in (t[key] for t in mine)
                else sum(t[key] for t in mine) / len(mine)
                for key in keys}
    lines.append({"summary": summary})
    text = "\n".join(json.dumps(line) for line in lines)
    print(text, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
