"""A decode step's weight matmuls, as the configuration lays them out
(fused q/k/v and gate/up, every expert of a MoE layer, the head), and the
bytes of one 4-bit x A8 launch. ``matmul4bit_bytes`` is rewritten from the
port's ``utils/metrics.py``, with the A8 operands (int8 codes and an f32
row scale) and the f32 output in place of bf16 ones."""

from __future__ import annotations

from typing import List, Tuple


def step_shapes(cfg: dict) -> List[Tuple[int, int]]:
    """(N, K) of every weight matmul of one decode step, in layer order:
    per layer q/k/v, o, then gate/up and down (once per expert where the
    layer has experts, since the port runs every expert on every token),
    and the head last."""
    h, d = cfg["hidden_size"], cfg["head_dim"]
    nq, nkv = cfg["num_attention_heads"] * d, cfg["num_key_value_heads"] * d
    i = cfg["intermediate_size"]
    mlp = [(2 * i, h), (h, i)] * max(1, cfg["num_local_experts"])
    layer = [(nq + 2 * nkv, h), (h, nq)] + mlp
    return layer * cfg["num_hidden_layers"] + [(cfg["vocab_size"], h)]


def a8_bytes(m: int, n: int, k: int, weight_bytes: float) -> float:
    """One launch: x int8 [M, K] and its f32 row scale [M] in, the weight's
    ``weight_bytes``, f32 [M, N] out; each byte once."""
    return m * k + 4 * m + weight_bytes + 4 * m * n


def share(run, counter: str, name_re, weight_bytes) -> "float | None":
    """100 x the least time of the sub-span's decode launches of a matmul
    kernel over their device time. Every decode step launches the
    kernel once per :func:`step_shapes` entry at M = the engine's batch
    (every slot, active or not, is a row of the launch)."""
    launches = run.decode_launches(counter)
    t = sum(d for nm, _, d in run.span.records if name_re.search(nm)) / 1e9
    if launches <= 0 or t <= 0:
        return None
    shapes = step_shapes(run.cfg)
    if launches % len(shapes):
        raise ValueError(f"{counter}: {launches} launches are not whole "
                         f"steps of {len(shapes)}")
    from .peaks import least_s
    m = run.engine["max_batch"]
    per_step = sum(least_s(a8_bytes(m, n, k, weight_bytes(n, k)),
                           2.0 * m * n * k, "int8_ops_per_s",
                           run.device_kind) for n, k in shapes)
    return 100.0 * per_step * (launches // len(shapes)) / t
