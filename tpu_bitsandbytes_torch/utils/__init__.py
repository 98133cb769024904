"""Utilities: checkpoints in the JAX package's format, serving metrics
and HuggingFace conversion."""

from .checkpoint import load_checkpoint, load_quantized, save_checkpoint
from .hf import (gpt2_params_from_state_dict, llama_config_from_hf,
                 llama_params_from_state_dict, load_llama_from_pretrained)
from .metrics import MetricsLogger

__all__ = ["save_checkpoint", "load_checkpoint", "load_quantized",
           "MetricsLogger", "llama_config_from_hf",
           "llama_params_from_state_dict", "gpt2_params_from_state_dict",
           "load_llama_from_pretrained"]
