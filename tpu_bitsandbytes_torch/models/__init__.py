from . import layers, llama, lora
from .layers import QLinear4
from .llama import LlamaConfig
from .lora import LoRALinear

__all__ = ["layers", "llama", "lora", "QLinear4", "LlamaConfig",
           "LoRALinear"]
