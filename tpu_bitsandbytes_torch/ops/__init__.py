"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1 (:mod:`.int4cache`) and K2 (:mod:`.flash_decode`)."""

from .flash_decode import flash_decode_attention
from .int4cache import dequant_int4, int4_matmul, quantize_int4

__all__ = ["flash_decode_attention", "int4_matmul", "quantize_int4",
           "dequant_int4"]
