"""Rolling per-step engine metrics, and the device-memory footprint of a
served model (the JAX package's ``utils/metrics.py``, budgeted against the
device's own memory)."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import torch


@dataclasses.dataclass
class StepMetrics:
    step: int
    tokens: int
    wall_s: float
    tokens_per_s: float


class MetricsLogger:
    """Tokens and wall time of the last ``window`` engine steps."""

    def __init__(self, window: int = 100):
        self.window = window
        self.history: List[StepMetrics] = []
        self._step = 0

    def record(self, tokens: int, wall_s: float) -> StepMetrics:
        self._step += 1
        m = StepMetrics(self._step, tokens, wall_s,
                        tokens / wall_s if wall_s > 0 else 0.0)
        self.history.append(m)
        if len(self.history) > self.window:
            self.history.pop(0)
        return m

    def summary(self) -> Dict[str, float]:
        if not self.history:
            return {}
        toks = sum(m.tokens for m in self.history)
        secs = sum(m.wall_s for m in self.history)
        return {
            "steps": len(self.history),
            "tokens": toks,
            "tokens_per_s": toks / secs if secs else 0.0,
            "mean_step_ms": secs / len(self.history) * 1e3,
        }


# -- device-memory budget accounting (the JAX package's utils/metrics.py) --

def device_memory_bytes(device) -> int:
    """The memory a footprint is budgeted against: a CUDA device's total
    memory, or the host's RAM for a CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def param_footprint(params, runtime_cache: Optional[str] = None,
                    drop_packed: bool = False) -> Dict[str, int]:
    """Bytes by category of a (quantized) parameter tree.

    ``runtime_cache`` ("int8", "int4" or "bf16"): count a hypothetical
    execution cache for :class:`QLinear4` leaves that carry none yet, as
    the JAX package counts it (1, 0.5 or 2 bytes per weight, plus 4 bytes
    per row, or per (row, 128-block) for int4); the engine decides
    ``drop_packed`` and "auto" its format from this before it builds the
    cache (building it and then dropping the codes would hold both at
    once). ``drop_packed``: count no packed bytes for a leaf with a (real
    or hypothetical) cache, as if the codes were freed.

    Returns {"packed": NF4 codes + absmax, "exec_cache": the runtime cache,
    "fp": everything else}.
    """
    if runtime_cache not in (None, "int8", "int4", "bf16"):
        raise ValueError(f"unknown runtime cache format: {runtime_cache!r}")
    from ..models.layers import QLinear4
    from ..ops.int4cache import INT4_BLOCK
    out = {"packed": 0, "exec_cache": 0, "fp": 0}

    def visit(w):
        if isinstance(w, QLinear4):
            pk = (_nbytes(w.packed) + _nbytes(w.absmax)
                  + _nbytes(w.absmax_q))
            if w.absmax_state is not None:
                pk += _nbytes(w.absmax_state.absmax)
            ex = _nbytes(w.w_cache) + _nbytes(w.cache_scale)
            if ex == 0 and runtime_cache is not None:
                n, k = w.shape
                per = {"int8": 1, "bf16": 2, "int4": 0.5}[runtime_cache]
                sc = (k // INT4_BLOCK) * 4 if runtime_cache == "int4" else 4
                ex = int(n * k * per) + n * sc
            if drop_packed and ex:
                pk = 0
            out["packed"] += pk
            out["exec_cache"] += ex
            out["fp"] += _nbytes(w.bias)
        elif isinstance(w, dict):
            for v in w.values():
                visit(v)
        elif isinstance(w, (list, tuple)):
            for v in w:
                visit(v)
        elif isinstance(w, torch.Tensor):
            out["fp"] += _nbytes(w)

    visit(params)
    return out


def per_device_footprint(pf: Dict[str, int], kv_bytes: int,
                         act_bytes: int, budget: int, tp: int = 1,
                         dp: int = 1) -> Dict[str, Any]:
    """One device's share of a (dp, tp)-sharded serving deployment, the
    JAX package's per-chip table: ``pf`` (:func:`param_footprint` of the
    whole tree) with the weights split over tp (the fp leaves whole on
    every device), ``kv_bytes`` (the whole KV cache) split over tp * dp,
    the activation estimate; their ``total``, the ``budget`` and ``fits``
    (total within 0.92 of it)."""
    out = {"packed": pf["packed"] // tp, "exec_cache": pf["exec_cache"] // tp,
           "fp": pf["fp"], "kv": kv_bytes // (tp * dp),
           "activations_est": act_bytes}
    out["total"] = sum(out.values())
    out["budget"] = budget
    out["fits"] = out["total"] <= 0.92 * budget
    return out


def kv_cache_bytes(num_layers: int, batch: int, s_axis: int, kv_heads: int,
                   head_dim: int, quantized: bool = True,
                   dtype_bytes: int = 2) -> int:
    """Bytes of a KV cache allocation (codes and scales when quantized)."""
    per = 2 * num_layers * batch * kv_heads * s_axis
    if quantized:
        return per * head_dim + per * 4
    return per * head_dim * dtype_bytes


def serving_act_bytes(config, max_batch: int, prefill_bucket: int,
                      steps_per_sync: int = 8) -> int:
    """The JAX package's rough bound on serving's transient memory: a
    prefill at ``prefill_bucket`` keeps a few S x max(4H, 2I) planes live,
    decode keeps B x (H + V) hidden and logits plus the chunk's KV stage.
    An estimate, not a measurement."""
    h, i, v = (config.hidden_size, config.intermediate_size,
               config.vocab_size)
    act = 2  # bf16 planes
    prefill = prefill_bucket * max(4 * h, 2 * i) * act * 2
    stage = (2 * config.num_layers * max_batch * config.num_kv_heads
             * steps_per_sync * (config.hd + 4))
    decode = max_batch * (h * act + v * 4) + stage
    return int(max(prefill, decode))


def format_footprint(fp: Dict[str, Any]) -> str:
    """A footprint table (``DecodeEngine.footprint()``) as text."""
    gib = 1024 ** 3
    lines = ["Device memory footprint:"]
    for key in ("packed", "exec_cache", "fp", "kv", "activations_est"):
        if key in fp:
            lines.append(f"  {key:<16} {fp[key] / gib:8.3f} GiB")
    lines.append(f"  {'total':<16} {fp['total'] / gib:8.3f} GiB"
                 f" / {fp['budget'] / gib:.1f} GiB"
                 f" ({'fits' if fp['fits'] else 'OVER BUDGET'})")
    return "\n".join(lines)
