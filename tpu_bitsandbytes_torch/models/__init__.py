from . import layers, llama
from .layers import QLinear4
from .llama import LlamaConfig

__all__ = ["layers", "llama", "QLinear4", "LlamaConfig"]
