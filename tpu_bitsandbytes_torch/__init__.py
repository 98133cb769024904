"""tpu-bitsandbytes on PyTorch and CUDA: the port of the JAX package to an
NVIDIA H100.

It serves Llama-shaped NF4 models through the int4 runtime cache or
straight off the packed NF4 bytes: NF4 storage and the 4-bit matmul
(:mod:`.functional`), the quantized trunk (:mod:`.models`), the int8-KV
decode engine (:mod:`.engine`) and five hand-written Hopper kernels
(:mod:`.ops`): K1, the int4-cache matmul; K2, flash-decode attention; K3,
flash-prefill attention; K4, the packed-NF4 x A8 matmul; K5, the fused
4-bit dequant-matmul. CUDA tensors run the kernels; CPU tensors run their
plain PyTorch versions.
"""

__version__ = "0.1.0"


def has_cuda_kernels() -> dict:
    """Which hand-written kernel libraries are built and loaded in this
    process, by source name. Kernels build on first use (or through
    ``tpu_bitsandbytes_torch.ops._build.load_all()``)."""
    from .ops._build import loaded
    return loaded()
