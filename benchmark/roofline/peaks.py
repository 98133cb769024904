"""Published dense peaks of the H100 SXM (NVIDIA's data sheet, no
sparsity), the part the cells run on, at its full power limit (700 W); a
card set below it (``nvidia-smi``'s ``power.limit``) runs slower, so every
share is stated beside the card's name and limit. Rewritten from the
smoke script's ``card_rates``."""

from __future__ import annotations

# HBM bytes/s, dense int8 ops/s, dense bf16 FLOP/s
SXM = {"hbm_bytes_per_s": 3.35e12, "int8_ops_per_s": 1979e12,
       "bf16_flops_per_s": 989e12}


def of(kind: str) -> dict:
    """The peaks of the card ``kind`` (``torch.cuda.get_device_name``)."""
    if "H100" not in kind or "PCIe" in kind:
        raise ValueError(f"no published peaks here for {kind!r}")
    return SXM


def least_s(n_bytes: float, n_ops: float, peak_ops: float,
            kind: str) -> float:
    """The least time of a launch: the larger of its bytes over the HBM
    bandwidth and its operations over ``peak_ops`` (a key of the peaks)."""
    p = of(kind)
    return max(n_bytes / p["hbm_bytes_per_s"], n_ops / p[peak_ops])
