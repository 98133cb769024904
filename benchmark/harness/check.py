"""How ``correct`` is decided: what the server produced against the plain
reference.

Once the window has closed and the peak memory has been read, the loop's
holders (the request whose KV each slot holds at the close) are read back
from the engine's KV cache; then the server is freed. The reference of the
configuration's family (``benchmark/reference/<model_type>.py``) runs
once, teacher-forced over a sample of the finished greedy requests drawn
from the seed, with the longest among them, and over :data:`KV_REQUESTS`
of the holders, the longest among them:

- each served token's reference logit lies some gap below the
  reference's best at its position (0 where the server chose the
  reference's argmax); greedy serving at the stated precision keeps those
  gaps within rounding (``gap_mean``, ``gap_max``);
- the cache's K and V of the holders against the reference's K and V
  before any rounding, at the same positions: per layer, the relative
  distance (Frobenius norm of the difference over the reference's) of K
  and of V over the prompt's positions and over the decode steps'
  positions, the largest of those four (``kv_err_first`` at the first
  layer, whose K and V follow from the embedding through one norm and one
  matmul; ``kv_err_max`` over every layer). At the stated int8 the cache
  departs by its rounding; a cache kept at fewer bits departs by more.

The cell file's ``check.limits`` name the numbers compared and their
limits (``PERF.md`` gives the readings each was set from); besides them
every finished request must have delivered exactly its output length
(``short_requests``, limit 0). A number that could not be read (None)
fails.
"""

from __future__ import annotations

import importlib
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .accounting import Req

KV_REQUESTS = 2         # holders whose KV is read back


def reference_for(cfg: dict):
    """The plain reference of a configuration's family."""
    return importlib.import_module(f"reference.{cfg['model_type']}")


def sample(reqs: List[Req], seed: int, n: int) -> List[Req]:
    """``n`` finished greedy requests: the longest (prompt and output),
    then the rest drawn from the seed."""
    done = [r for r in reqs if r.greedy and r.t_done is not None
            and len(r.tokens) == r.n_out]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + r.n_out, -r.uid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed % 2 ** 64, 0xC4EC])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def held(reqs: List[Req], holders: Dict[int, int], lengths: List[int],
         ring: Optional[int], seed: int, n: int = KV_REQUESTS
         ) -> List[Tuple[Req, int, torch.Tensor]]:
    """(request, slot, positions) of up to ``n`` holders: the one with the
    most positions, then the rest drawn from the seed. A request of P
    prompt and t emitted tokens wrote positions [0, P + t - 1); a ring
    cache of ``ring`` entries whose slot reached length L (an ended
    request's slot runs on for the rest of its chunk) keeps those from
    L + 1 - ring on."""
    cands = []
    for r in reqs:
        if r.uid not in holders or not r.tokens:
            continue
        slot = holders[r.uid]
        end = len(r.prompt) + len(r.tokens) - 1
        lo = 0 if ring is None else max(0, lengths[slot] + 1 - ring)
        if lo < end:
            cands.append((r, slot, torch.arange(lo, end)))
    if not cands:
        return []
    first = max(cands, key=lambda c: (c[2].numel(), -c[0].uid))
    rest = [c for c in cands if c is not first]
    rng = np.random.default_rng([seed % 2 ** 64, 0x4B56])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [first] + [rest[i] for i in sorted(pick)]


class KVGap:
    """Per layer, the relative distance of stored K and V from the
    reference's over prompt and over decode positions."""

    def __init__(self, n_layers: int):
        # [layer, K/V, prompt/decode, (squared difference, squared ref)]
        self.sums = np.zeros((n_layers, 2, 2, 2))

    def add(self, layer: int, stored, ref, decode: torch.Tensor) -> None:
        """``stored``, ``ref``: (k, v) [P, H, D]; ``decode``: bool [P]."""
        for i, (s, r) in enumerate(zip(stored, ref)):
            d2 = (s.float() - r).pow(2).sum(dim=(1, 2)).double()
            r2 = r.pow(2).sum(dim=(1, 2)).double()
            for g, m in enumerate((~decode, decode)):
                self.sums[layer, i, g] += (float(d2[m].sum()),
                                           float(r2[m].sum()))

    def readings(self) -> Dict[str, Optional[float]]:
        d, r = self.sums[..., 0], self.sums[..., 1]
        with np.errstate(divide="ignore", invalid="ignore"):
            err = np.where(r > 0, np.sqrt(d / np.where(r > 0, r, 1)), 0.0)
        if not (r > 0).any():
            return {"kv_err_first": None, "kv_err_max": None}
        per_layer = err.reshape(err.shape[0], -1).max(axis=1)
        return {"kv_err_first": float(per_layer[0]),
                "kv_err_max": float(per_layer.max())}


def readings(tree: dict, cfg: dict, chosen: List[Req], hold: list,
             kv: list, precision: dict, keep: bool = False
             ) -> Tuple[Dict[str, float], dict]:
    """The compared numbers of the served tokens of ``chosen`` and the KV
    ``kv`` (:func:`harness.model.read_kv`) of the holders ``hold``; and,
    with ``keep``, the reference's logits and the holders' K and V (f32,
    at their positions), for the control to read."""
    ref_model = reference_for(cfg)
    seqs = [(r.prompt, r.tokens) for r in chosen + [h[0] for h in hold]]
    gap = KVGap(cfg["num_hidden_layers"])
    kept = [[] for _ in hold]

    def sink(layer, j, k, v):
        if j < len(chosen):
            return
        r, _, pos = hold[j - len(chosen)]
        pos = pos.to(k.device)
        ref = (k[pos], v[pos])
        gap.add(layer, kv[j - len(chosen)][layer], ref,
                pos >= len(r.prompt))
        if keep:
            kept[j - len(chosen)].append(ref)

    logits = ref_model.forward_logits(tree, cfg, precision, seqs, sink)
    out = ref_model.compare(logits[:len(chosen)], [r.tokens for r in chosen])
    out["distinct_tokens"] = len({t for r in chosen for t in r.tokens})
    out.update(gap.readings())
    return out, {"logits": logits[:len(chosen)] if keep else None,
                 "kv": kept}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each compared number beside its limit, and whether all hold; a
    number that could not be read fails."""
    checks = {k: {"value": values.get(k), "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return {"correct": ok, "checks": checks}


def report(checks: dict) -> None:
    """The compared numbers as the last lines on standard error."""
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
