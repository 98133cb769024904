"""The control of the correctness check, at a cell's own size on the card.

    python3 benchmark/tests/control.py --workload <cell> --seeds 11 12 13 \\
        --seconds 1

For each seed, one ordinary run of the cell (set-up, the ramp that
finishes every client's first request, a short window, the check) prints
its result line; then the reference is put in the program's place one
precision step below the configuration's (int4 where it states int8: the
KV cache alone, the decode matmuls' activations alone), over the same
prompts, served tokens and held positions: the token it puts first at
each position is read against the full-precision reference, as the check
reads the program's served tokens, and the K and V it would store against
the reference's, as the check reads the program's cache. Each control's
numbers go through the check's own judge with the cell's limits. Beside
them, the reference's own rounding of K and V at the stated precision
(``kv_stated``), which is what a sound cache reads. Prints one JSON line
per seed. The benchmark's own runs never run this.
"""

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

LOWER = {"kv_int4": {"kv_cache": "int4"},
         "act_int4": {"decode_activations": "int4"},
         "kv_act_int4": {"kv_cache": "int4", "decode_activations": "int4"}}


def control_readings(tree, cfg, chosen, hold, ref, limits,
                     variants=("kv_int4", "act_int4")) -> dict:
    """Each lower precision's readings and the judge's verdict on them,
    the stated precision's own KV rounding, and the reference's margins
    (top-1 minus top-2) at the served positions."""
    import torch
    from harness import check
    R = check.reference_for(cfg)
    seqs = [(r.prompt, r.tokens) for r in chosen + [h[0] for h in hold]]
    top2 = torch.cat([r.topk(2, dim=-1).values for r in ref["logits"]])
    margin = (top2[:, 0] - top2[:, 1]).double()
    out = {"margin_min": float(margin.min()),
           "margin_median": float(margin.median())}
    stated = R.BITS[cfg["precision"]["kv_cache"]]
    gap = check.KVGap(cfg["num_hidden_layers"])
    for j, (r, _, pos) in enumerate(hold):
        for layer, (k, v) in enumerate(ref["kv"][j]):
            gap.add(layer, (R.quant_kv(k, stated), R.quant_kv(v, stated)),
                    (k, v), pos.to(k.device) >= len(r.prompt))
    out["kv_stated"] = gap.readings()
    for name in variants:
        prec = {**cfg["precision"], **LOWER[name]}
        bits = R.BITS[prec["kv_cache"]]
        gap = check.KVGap(cfg["num_hidden_layers"])

        def sink(layer, j, k, v):
            if j < len(chosen):
                return
            r, _, pos = hold[j - len(chosen)]
            pos = pos.to(k.device)
            gap.add(layer, (R.quant_kv(k[pos], bits),
                            R.quant_kv(v[pos], bits)),
                    ref["kv"][j - len(chosen)][layer], pos >= len(r.prompt))

        ctrl = R.forward_logits(tree, cfg, prec, seqs, sink)
        vals = R.compare(ref["logits"], [r.tokens for r in chosen],
                         ctrl[:len(chosen)])
        del ctrl
        vals.update(gap.readings())
        vals["short_requests"] = 0
        verdict = check.judge(vals, limits)
        out[name] = {**vals, "correct": verdict["correct"]}
    return out


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    from harness import runner, spec
    cell = spec.load_cell(args.workload)
    limits = {**cell.settings["check"]["limits"], "short_requests": 0}
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = runner.execute(
            cell, seed, args.seconds, False, "cuda:0", t0,
            after=lambda tree, chosen, hold, ref: control_readings(
                tree, cell.config, chosen, hold, ref, limits))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **res}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
