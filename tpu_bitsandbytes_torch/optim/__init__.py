"""8-bit and paged optimizers.

Two API styles, as in the JAX package:
* (init, update) transforms over trees of tensors
  (``transforms.adam8bit(...)``), the functional form the QLoRA train step
  uses;
* ``torch.optim.Optimizer`` classes (``Adam8bit(params, lr=...)``), whose
  ``step()`` reads ``p.grad`` and updates each parameter in place.
"""

from .state8bit import (
    quantize_state, dequantize_state,
    quantize_state_unsigned, dequantize_state_unsigned,
)
from .transforms import adam8bit, adamw8bit, lion8bit, sgd8bit
from .wrappers import Adam8bit, AdamW8bit, Lion8bit, SGD8bit, clip_by_global_norm
from .paged import PagedAdam, PagedAdamW, PagedLion

__all__ = [
    "quantize_state", "dequantize_state",
    "quantize_state_unsigned", "dequantize_state_unsigned",
    "adam8bit", "adamw8bit", "lion8bit", "sgd8bit",
    "Adam8bit", "AdamW8bit", "Lion8bit", "SGD8bit",
    "PagedAdam", "PagedAdamW", "PagedLion",
    "clip_by_global_norm",
]
