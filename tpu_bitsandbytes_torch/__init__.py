"""tpu-bitsandbytes on PyTorch and CUDA: the port of the JAX package to an
NVIDIA H100.

This first slice serves Llama-shaped NF4 models through the int4 runtime
cache: NF4 storage (:mod:`.functional`), the quantized trunk
(:mod:`.models`), the int8-KV decode engine (:mod:`.engine`) and the two
hand-written Hopper kernels of its decode step (:mod:`.ops`): K1, the int4
matmul, and K2, flash-decode attention. CUDA tensors run the kernels;
CPU tensors run their plain PyTorch versions.
"""

__version__ = "0.1.0"


def has_cuda_kernels() -> dict:
    """Which hand-written kernel libraries are built and loaded in this
    process, by source name. Kernels build on first use (or through
    ``tpu_bitsandbytes_torch.ops._build.load_all()``)."""
    from .ops._build import loaded
    return loaded()
