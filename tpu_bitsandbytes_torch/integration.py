"""Model quantization: ``BitsAndBytesConfig`` and model surgery.

The JAX package's ``integration.py`` for ``torch.nn.Module`` trees: every
``torch.nn.Linear`` (and the port's :class:`~.nn.Linear`) is replaced in
place by the port's :class:`~.nn.Linear4bit` or :class:`~.nn.Linear8bit`,
skipping names that contain an entry of ``modules_to_not_convert``. The
JAX package wraps its JAX layers in a torch adapter for torch trees
(``nn/torch_compat.py``); here the quantized layers are torch modules
themselves. ``bnb_4bit_use_double_quant`` is honoured.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from .functional import dtype_name
from .nn import Linear4bit, Linear8bit
from .nn.base import Module

__all__ = [
    "BitsAndBytesConfig", "quantize_model",
    "replace_linear_with_4bit", "replace_linear_with_8bit",
    "get_memory_footprint", "patch_transformers", "unpatch_transformers",
]


@dataclass
class BitsAndBytesConfig:
    """transformers' ``BitsAndBytesConfig`` fields and checks; the fields
    this package does not use are kept for drop-in compatibility."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    llm_int8_threshold: float = 6.0
    llm_int8_skip_modules: Optional[list] = None
    llm_int8_enable_fp32_cpu_offload: bool = False
    llm_int8_has_fp16_weight: bool = False
    bnb_4bit_compute_dtype: Any = torch.bfloat16
    bnb_4bit_quant_type: str = "nf4"
    bnb_4bit_use_double_quant: bool = False
    bnb_4bit_quant_storage: Any = torch.uint8

    def __post_init__(self):
        if self.load_in_4bit and self.load_in_8bit:
            raise ValueError("Cannot load in both 4-bit and 8-bit")
        if self.bnb_4bit_quant_type not in ("nf4", "fp4"):
            raise ValueError(
                f"bnb_4bit_quant_type must be 'nf4' or 'fp4', "
                f"got {self.bnb_4bit_quant_type}")
        if self.llm_int8_skip_modules is None:
            self.llm_int8_skip_modules = []

    def to_dict(self) -> Dict[str, Any]:
        return {
            "load_in_8bit": self.load_in_8bit,
            "load_in_4bit": self.load_in_4bit,
            "llm_int8_threshold": self.llm_int8_threshold,
            "llm_int8_skip_modules": self.llm_int8_skip_modules,
            "bnb_4bit_compute_dtype": dtype_name(self.bnb_4bit_compute_dtype),
            "bnb_4bit_quant_type": self.bnb_4bit_quant_type,
            "bnb_4bit_use_double_quant": self.bnb_4bit_use_double_quant,
        }

    @classmethod
    def from_dict(cls, config_dict: Dict[str, Any]) -> "BitsAndBytesConfig":
        config_dict = dict(config_dict)
        ds = config_dict.get("bnb_4bit_compute_dtype")
        if isinstance(ds, str):
            config_dict["bnb_4bit_compute_dtype"] = (
                torch.float16 if "float16" in ds and "bfloat16" not in ds
                else torch.bfloat16)
        fields = cls.__dataclass_fields__
        return cls(**{k: v for k, v in config_dict.items() if k in fields})

    @property
    def is_quantizable(self) -> bool:
        return self.load_in_4bit or self.load_in_8bit

    @property
    def quantization_method(self) -> str:
        if self.load_in_4bit:
            return "bitsandbytes_4bit"
        if self.load_in_8bit:
            return "bitsandbytes_8bit"
        return "none"


def _walk_replace(model: torch.nn.Module, convert_fn, skip: list,
                  current_key_name: Optional[str] = None) -> torch.nn.Module:
    """Replace every ``torch.nn.Linear`` below ``model`` in place."""
    for name, child in list(model.named_children()):
        full_name = f"{current_key_name}.{name}" if current_key_name else name
        if isinstance(child, torch.nn.Linear):
            if not any(s in full_name for s in skip):
                setattr(model, name, convert_fn(child))
        else:
            _walk_replace(child, convert_fn, skip, full_name)
    return model


def replace_linear_with_4bit(model: torch.nn.Module,
                             quantization_config: BitsAndBytesConfig,
                             modules_to_not_convert: Optional[list] = None,
                             current_key_name: Optional[str] = None
                             ) -> torch.nn.Module:
    """Replace every Linear with :class:`Linear4bit`, quantized where its
    weight lies."""
    qc = quantization_config

    def convert(m):
        return Linear4bit.from_linear(
            m, compute_dtype=qc.bnb_4bit_compute_dtype,
            quant_type=qc.bnb_4bit_quant_type,
            compress_statistics=qc.bnb_4bit_use_double_quant)

    return _walk_replace(model, convert, modules_to_not_convert or [],
                         current_key_name)


def replace_linear_with_8bit(model: torch.nn.Module,
                             quantization_config: BitsAndBytesConfig,
                             modules_to_not_convert: Optional[list] = None,
                             current_key_name: Optional[str] = None
                             ) -> torch.nn.Module:
    """Replace every Linear with :class:`Linear8bit`; by default skip the
    config's ``llm_int8_skip_modules``."""
    if modules_to_not_convert is None:
        modules_to_not_convert = quantization_config.llm_int8_skip_modules
    return _walk_replace(model, Linear8bit.from_linear,
                         modules_to_not_convert or [], current_key_name)


def quantize_model(model: torch.nn.Module,
                   quantization_config: Optional[BitsAndBytesConfig] = None,
                   load_in_4bit: bool = False, load_in_8bit: bool = False,
                   device=None, compute_dtype=torch.bfloat16,
                   modules_to_not_convert: Optional[list] = None
                   ) -> torch.nn.Module:
    """Quantize a model's Linears in place, by ``quantization_config`` or
    the flags. With ``device`` the model moves there first, so the
    weights are quantized on that device."""
    if quantization_config is None:
        quantization_config = BitsAndBytesConfig(
            load_in_4bit=load_in_4bit, load_in_8bit=load_in_8bit,
            bnb_4bit_compute_dtype=compute_dtype)
    if device is not None:
        model = model.to(device)
    if quantization_config.load_in_4bit:
        model = replace_linear_with_4bit(model, quantization_config,
                                         modules_to_not_convert)
    elif quantization_config.load_in_8bit:
        model = replace_linear_with_8bit(model, quantization_config,
                                         modules_to_not_convert)
    return model


def get_memory_footprint(model: torch.nn.Module) -> Dict[str, Any]:
    """Bytes and element counts over every tensor of the model: parameters,
    buffers and the quantized layers' quant states. ``fp16_size_gb``
    counts every stored element (packed bytes too) at 2 bytes, as the JAX
    package and bitsandbytes do; uint8 and int8 elements count as
    quantized."""
    tensors = []
    for m in model.modules():
        tensors += [t for t in m._parameters.values() if t is not None]
        tensors += [t for t in m._buffers.values() if t is not None]
        if isinstance(m, Module):
            tensors += list(m.extra_tensors())
    total_params = sum(t.numel() for t in tensors)
    total_bytes = sum(t.numel() * t.element_size() for t in tensors)
    quantized = sum(t.numel() for t in tensors
                    if t.dtype in (torch.uint8, torch.int8))
    fp16_size = total_params * 2 / 1e9
    actual_size = total_bytes / 1e9
    return {
        "total_params": total_params,
        "quantized_params": quantized,
        "fp16_size_gb": fp16_size,
        "actual_size_gb": actual_size,
        "savings_gb": fp16_size - actual_size,
        "savings_pct": ((1 - actual_size / fp16_size) * 100
                        if fp16_size > 0 else 0),
    }


_ORIG_FROM_PRETRAINED = None


def patch_transformers() -> bool:
    """Opt in: ``transformers.PreTrainedModel.from_pretrained`` called with
    this package's :class:`BitsAndBytesConfig` loads the checkpoint in full
    precision and quantizes it through :func:`quantize_model` (``lm_head``
    and the config's skip list stay unquantized). Returns False where
    transformers is not installed; :func:`unpatch_transformers` undoes
    it."""
    global _ORIG_FROM_PRETRAINED
    try:
        from transformers import modeling_utils
    except ImportError:
        return False
    if _ORIG_FROM_PRETRAINED is not None:
        return True
    orig = modeling_utils.PreTrainedModel.from_pretrained.__func__

    @classmethod
    def _patched(cls, *args, **kwargs):
        qc = kwargs.get("quantization_config")
        if isinstance(qc, BitsAndBytesConfig) and qc.is_quantizable:
            kwargs = dict(kwargs)
            kwargs.pop("quantization_config", None)
            kwargs.pop("device_map", None)
            model = orig(cls, *args, **kwargs)
            return quantize_model(
                model, qc, modules_to_not_convert=list(
                    qc.llm_int8_skip_modules or []) + ["lm_head"])
        return orig(cls, *args, **kwargs)

    modeling_utils.PreTrainedModel.from_pretrained = _patched
    _ORIG_FROM_PRETRAINED = orig
    return True


def unpatch_transformers() -> None:
    """Restore the original ``from_pretrained`` (nothing if not patched)."""
    global _ORIG_FROM_PRETRAINED
    if _ORIG_FROM_PRETRAINED is None:
        return
    from transformers import modeling_utils
    modeling_utils.PreTrainedModel.from_pretrained = classmethod(
        _ORIG_FROM_PRETRAINED)
    _ORIG_FROM_PRETRAINED = None
