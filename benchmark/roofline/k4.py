"""K4, the packed NF4 x A8 decode matmul: NF4 codes [N, K/2] and an f32
absmax per 64-block, read as they are stored."""

import re

from . import matmul

NAME = re.compile(r"tc_kernel<[^,]*\bNf4,|w4a8_dp4a_kernel")
COUNTER = "w4a8_mm.launches"
BLOCK = 64


def weight_bytes(n: int, k: int) -> float:
    return n * k / 2 + 4 * n * (k / BLOCK)


def share(run):
    return matmul.share(run, COUNTER, NAME, weight_bytes)
