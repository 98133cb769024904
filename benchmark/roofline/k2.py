"""K2, flash-decode attention over the int8 KV cache: one query per slot
and layer. Its useful work is each emitted token's keys: every position
its slot holds, inside the sliding window (not the span bucket the engine
reads up to). Per token and layer: the int8 K and V codes and their f32
scales of those keys, the bf16 query in and the f32 output out; QK and PV
are 4 * heads * head_dim FLOP per key, at the bf16 rate."""

import re

from .peaks import least_s

NAME = re.compile(r"flash_decode_kernel<")
COUNTER = "flash_decode_attention.launches"


def token_cost(cfg: dict, keys: int):
    """(bytes, FLOP) of one token's K2 launches over every layer."""
    h, hkv, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    layers = cfg["num_hidden_layers"]
    per_layer = 2 * keys * hkv * (d + 4) + h * d * 2 + h * d * 4
    return layers * per_layer, layers * 4.0 * h * d * keys


def share(run):
    if run.decode_launches(COUNTER) <= 0:
        return None
    t = sum(d for nm, _, d in run.span.records if NAME.search(nm)) / 1e9
    if t <= 0:
        return None
    least = 0.0
    for r, i in run.decode_tokens(run.chunk_ids("span")):
        b, f = token_cost(run.cfg, run.keys(r, i))
        least += least_s(b, f, "bf16_flops_per_s", run.device_kind)
    return 100.0 * least / t if least else None
