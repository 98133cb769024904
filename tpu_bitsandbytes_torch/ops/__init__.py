"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1 (:mod:`.int4cache`), K2 (:mod:`.flash_decode`), K3
(:mod:`.flash_prefill`), K4 (:mod:`.w4a8`) and K5 (:mod:`.matmul4bit`)."""

from .flash_decode import flash_decode_attention
from .flash_prefill import flash_prefill_attention
from .int4cache import dequant_int4, int4_matmul, quantize_int4
from .matmul4bit import fused_matmul_4bit
from .w4a8 import w4a8_matmul_4bit

__all__ = ["flash_decode_attention", "flash_prefill_attention",
           "int4_matmul", "quantize_int4", "dequant_int4",
           "fused_matmul_4bit", "w4a8_matmul_4bit"]
