"""The models: the functional Llama-family trunk (the engine's substrate,
every family of the JAX package's ``LlamaConfig``), module-based GPT-2
(the ``quantize_model`` vehicle) and LoRA adapters."""

from . import gpt2, layers, llama, lora
from .gpt2 import GPT2Config, GPT2LMHeadModel
from .layers import (QLinear4, apply_rope, gqa_attention, layer_norm,
                     linear_apply, rms_norm, rope_table)
from .llama import LlamaConfig
from .lora import LoRALinear

__all__ = ["gpt2", "layers", "llama", "lora", "QLinear4", "linear_apply",
           "rms_norm", "layer_norm", "rope_table", "apply_rope",
           "gqa_attention", "LlamaConfig", "GPT2Config", "GPT2LMHeadModel",
           "LoRALinear"]
