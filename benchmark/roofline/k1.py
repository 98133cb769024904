"""K1, the int4-cache x A8 decode matmul: int4 codes [N, K/2] and an f32
scale per (row, 128-block)."""

import re

from . import matmul

NAME = re.compile(r"tc_kernel<[^,]*\bInt4,")
COUNTER = "int4_mm.launches"
BLOCK = 128


def weight_bytes(n: int, k: int) -> float:
    return n * k / 2 + 4 * n * (k / BLOCK)


def share(run):
    return matmul.share(run, COUNTER, NAME, weight_bytes)
