"""K3, flash-prefill attention: causal, over a prefill's true prompt
tokens (neither the padding to the bucket nor a group's duplicate rows
is work a request needs). Per request of L tokens and per layer: q, k, v
in bf16 and the bf16 output, each once; QK and PV are 4 * heads *
head_dim FLOP per (query, key) pair the causal window keeps."""

import re

from .peaks import least_s

NAME = re.compile(r"flash_prefill_kernel")
COUNTER = "flash_prefill_attention.launches"


def pairs(n: int, window) -> int:
    """(query, key) pairs of a causal prefill of n tokens: query q sees
    min(q + 1, window) keys."""
    if window is None or window >= n:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def request_cost(cfg: dict, n: int):
    """(bytes, FLOP) of one request's K3 work over every layer."""
    h, hkv, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    layers = cfg["num_hidden_layers"]
    per_layer_bytes = n * (h + 2 * hkv) * d * 2 + n * h * d * 2
    per_layer_flop = 4.0 * h * d * pairs(n, cfg.get("sliding_window"))
    return layers * per_layer_bytes, layers * per_layer_flop


def share(run):
    t = sum(d for nm, _, d in run.span.records if NAME.search(nm)) / 1e9
    least = 0.0
    for p in run.prefills("span"):
        if p["launches"].get(COUNTER, 0) <= 0:
            continue
        for n in p["lens"]:
            b, f = request_cost(run.cfg, n)
            least += least_s(b, f, "bf16_flops_per_s", run.device_kind)
    if least <= 0 or t <= 0:
        return None
    return 100.0 * least / t
