"""Quantized ``torch.nn.Module``s: the JAX package's ``nn/``, with its
checkpoint keys."""

from .base import Module
from .linear import Embedding, Linear, to_tensor
from .linear4bit import Linear4bit, Params4bit
from .linear8bit import Linear8bit
from .linear_fp8 import LinearFP8
from .embedding import Embedding4bit, Embedding8bit, EmbeddingFP4, EmbeddingNF4
from .outlier_aware import OutlierAwareLinear
from .switchback import (SwitchBackLinear, SwitchBackLinearCallback,
                         switchback_matmul)

__all__ = [
    "Module", "Linear", "Embedding", "to_tensor",
    "Linear4bit", "Params4bit", "Linear8bit", "LinearFP8",
    "OutlierAwareLinear", "SwitchBackLinear", "SwitchBackLinearCallback",
    "switchback_matmul",
    "Embedding4bit", "Embedding8bit", "EmbeddingNF4", "EmbeddingFP4",
]
