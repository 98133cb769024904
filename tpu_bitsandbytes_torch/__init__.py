"""tpu-bitsandbytes on PyTorch and CUDA: the port of the JAX package to an
NVIDIA H100.

The bitsandbytes-style API (:mod:`.functional`: NF4/FP4, blockwise,
row-wise and col+row int8, FP8, sparse COO; :mod:`.nn`: quantized Linear
and Embedding modules; :mod:`.integration`: ``BitsAndBytesConfig`` and
``quantize_model``); NF4 serving of Llama-shaped models through an int8,
int4 or bf16 runtime cache or straight off the packed NF4 bytes: the
quantized trunk (:mod:`.models`: Llama, Qwen2, Mistral, Mixtral,
Qwen2-MoE, Gemma, Gemma2, Phi-2 and StableLM, and module-based GPT-2;
HuggingFace checkpoints load through :mod:`.utils.hf`), the int8-KV decode
engine (:mod:`.engine`, with a ring KV cache for sliding-window models) and
five hand-written Hopper kernels (:mod:`.ops`): K1,
the int4-cache matmul; K2, flash-decode attention; K3, flash-prefill
attention; K4, the packed-NF4 x A8 matmul; K5, the fused 4-bit
dequant-matmul; and QLoRA training: LoRA adapters
(:mod:`.models.lora`), the 8-bit and paged optimizers (:mod:`.optim`)
and the train step (:mod:`.parallel`). CUDA tensors run the kernels; CPU
tensors run their plain PyTorch versions. Importing the package builds
nothing and does not initialize CUDA.
"""

__version__ = "0.1.0"

import torch as _torch

from .functional import (
    QuantState,
    quantize_4bit, dequantize_4bit, matmul_4bit,
    quantize_nf4, dequantize_nf4, matmul_nf4, create_normal_map,
    NF4_CODEBOOK,
    quantize_fp4, dequantize_fp4, matmul_fp4, create_fp4_map, FP4_CODEBOOK,
    quantize_blockwise, dequantize_blockwise,
    quantize_fp8_e4m3, dequantize_fp8_e4m3, matmul_fp8_e4m3,
    quantize_fp8_e5m2, dequantize_fp8_e5m2,
    quantize_rowwise, dequantize_rowwise, matmul_int8,
    quantize_colrow, dequantize_colrow, matmul_colrow,
    double_quant, dequant_absmax,
    spmm_coo, spmm_coo_int8, sparse_coo_from_dense, quantize_sparse_coo,
)
from .nn import (
    Linear4bit, Linear8bit, LinearFP8,
    Embedding4bit, Embedding8bit, EmbeddingNF4, EmbeddingFP4,
    OutlierAwareLinear,
    SwitchBackLinear, SwitchBackLinearCallback,
    Params4bit,
)
from .optim import (
    Adam8bit, AdamW8bit, Lion8bit, SGD8bit,
    PagedAdam, PagedAdamW, PagedLion,
    quantize_state, dequantize_state,
    quantize_state_unsigned, dequantize_state_unsigned,
)
from .integration import (
    BitsAndBytesConfig,
    quantize_model,
    replace_linear_with_4bit,
    replace_linear_with_8bit,
    get_memory_footprint,
    patch_transformers,
    unpatch_transformers,
)


def is_available() -> bool:
    """True: the quantized ops run on any torch device (the CPU runs each
    kernel's plain version)."""
    return True


def has_native_kernels() -> bool:
    """True when a Hopper card (compute capability 9.0) is present, on
    which CUDA tensors run the hand-written kernels (built at first use).
    Calling it initializes CUDA; importing the package does not."""
    return (_torch.cuda.is_available()
            and _torch.cuda.get_device_capability(0) == (9, 0))


def has_cuda_kernels() -> dict:
    """Which hand-written kernel libraries are built and loaded in this
    process, by source name. Kernels build on first use (or through
    ``tpu_bitsandbytes_torch.ops._build.load_all()``)."""
    from .ops._build import loaded
    return loaded()


__all__ = [
    "__version__", "is_available", "has_native_kernels",
    "QuantState",
    "quantize_4bit", "dequantize_4bit", "matmul_4bit",
    "quantize_nf4", "dequantize_nf4", "matmul_nf4", "NF4_CODEBOOK",
    "create_normal_map",
    "quantize_fp4", "dequantize_fp4", "matmul_fp4", "FP4_CODEBOOK",
    "create_fp4_map",
    "quantize_blockwise", "dequantize_blockwise",
    "quantize_fp8_e4m3", "dequantize_fp8_e4m3", "matmul_fp8_e4m3",
    "quantize_fp8_e5m2", "dequantize_fp8_e5m2",
    "quantize_rowwise", "dequantize_rowwise", "matmul_int8",
    "quantize_colrow", "dequantize_colrow", "matmul_colrow",
    "double_quant", "dequant_absmax",
    "spmm_coo", "spmm_coo_int8", "sparse_coo_from_dense", "quantize_sparse_coo",
    "Linear4bit", "Linear8bit", "LinearFP8",
    "Embedding4bit", "Embedding8bit", "EmbeddingNF4", "EmbeddingFP4",
    "OutlierAwareLinear", "SwitchBackLinear", "SwitchBackLinearCallback",
    "Params4bit",
    "Adam8bit", "AdamW8bit", "Lion8bit", "SGD8bit",
    "PagedAdam", "PagedAdamW", "PagedLion",
    "quantize_state", "dequantize_state",
    "quantize_state_unsigned", "dequantize_state_unsigned",
    "BitsAndBytesConfig", "quantize_model",
    "replace_linear_with_4bit", "replace_linear_with_8bit",
    "get_memory_footprint", "patch_transformers", "unpatch_transformers",
]
