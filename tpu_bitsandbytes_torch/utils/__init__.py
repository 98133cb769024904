"""Utilities: checkpoints in the JAX package's format, serving metrics,
roofline and timing helpers, and HuggingFace conversion. ``native`` (the
host packer) and ``proxy`` (the perplexity gate) are imported by name."""

from .checkpoint import load_checkpoint, load_quantized, save_checkpoint
from .hf import (gpt2_params_from_state_dict, llama_config_from_hf,
                 llama_params_from_state_dict, load_llama_from_pretrained)
from .metrics import (Timer, Tracer, detect_chip, matmul4bit_bytes,
                      matmul4bit_roofline_us, trace)

__all__ = ["save_checkpoint", "load_checkpoint", "load_quantized",
           "Tracer", "detect_chip", "matmul4bit_bytes",
           "matmul4bit_roofline_us", "Timer", "trace", "llama_config_from_hf",
           "llama_params_from_state_dict", "gpt2_params_from_state_dict",
           "load_llama_from_pretrained"]
