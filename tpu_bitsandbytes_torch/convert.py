"""Move parameters and configs from the JAX package into the port.

The port cannot import JAX, so the JAX side hands its parameter tree over as
numpy arrays (bfloat16 arrays keep their ml_dtypes dtype), with each
``QLinear4`` as a dict of its fields::

    {"packed", "absmax", "absmax_q", "absmax_state", "w_cache",
     "cache_scale", "shape", "blocksize", "quant_type", "dtype", "bias"}

where ``w_cache`` holds a runtime cache: the int4 cache's codes as int8
values in [-8, 7] with a 2-D ``cache_scale`` [K/128, N_pad], the int8
cache (int8 [N, K], ``cache_scale`` [N]) or the bf16 cache (no scale);
``absmax_state`` is
``None`` or a dict ``{"absmax", "shape", "blocksize", "dtype"}``, and
``dtype`` is a dtype name such as ``"bfloat16"``. Keys whose value would be
None may be left out (a layer served off its packed bytes has no
``w_cache``). A ``LoRALinear`` comes as ``{"base", "lora_A", "lora_B",
"scaling"}`` with its base handed over the same way. Every other dict and
list crosses as it is: a MoE layer's ``{"router", "experts": [...],
"shared_expert", "shared_gate"}``, a LayerNorm's ``{"w", "b"}``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .functional import QuantState, pack_nibbles, to_tensor
from .functional import dtype_of as torch_dtype
from .models.layers import QLinear4
from .models.llama import LlamaConfig
from .models.lora import LoRALinear

__all__ = ["from_reference_arrays", "config_from_reference", "torch_dtype"]

# a QLinear4 with or without its runtime cache or packed codes
_QLINEAR_KEYS = {"shape", "blocksize", "quant_type"}
_LORA_KEYS = {"base", "lora_A", "lora_B", "scaling"}

def _opt(a, device):
    return None if a is None else to_tensor(a, device)


def _qlinear(d: Dict[str, Any], device) -> QLinear4:
    n, k = (int(s) for s in d["shape"])
    dtype = torch_dtype(d["dtype"])
    st = d.get("absmax_state")
    state = None if st is None else QuantState(
        absmax=to_tensor(st["absmax"], device), shape=tuple(st["shape"]),
        blocksize=int(st["blocksize"]), quant_type="int8",
        dtype=torch_dtype(st["dtype"]))
    w_cache = cache_scale = None
    cache, scale = d.get("w_cache"), d.get("cache_scale")
    if cache is not None and scale is not None and np.ndim(scale) == 2:
        # the int4 cache: drop its N padding; codes -> two nibbles per byte
        codes = torch.from_numpy(np.asarray(cache, np.int8)[:n].copy())
        w_cache = pack_nibbles(codes & 0x0F).to(device)
        cache_scale = to_tensor(np.asarray(scale)[:, :n], device)
    elif cache is not None:
        # the int8 cache with its row scale, or the bf16 cache: as they are
        w_cache, cache_scale = to_tensor(cache, device), _opt(scale, device)
    return QLinear4(
        packed=_opt(d.get("packed"), device), absmax=_opt(d.get("absmax"),
                                                          device),
        shape=(n, k), blocksize=int(d["blocksize"]),
        quant_type=str(d["quant_type"]), dtype=dtype,
        bias=_opt(d.get("bias"), device),
        absmax_q=_opt(d.get("absmax_q"), device), absmax_state=state,
        w_cache=w_cache, cache_scale=cache_scale)


def from_reference_arrays(tree, device):
    """The port's parameter tree, on ``device``, from the JAX package's
    tree handed over as numpy (see the module docstring)."""
    if isinstance(tree, dict):
        if _QLINEAR_KEYS <= tree.keys():
            return _qlinear(tree, device)
        if tree.keys() == _LORA_KEYS:
            return LoRALinear(from_reference_arrays(tree["base"], device),
                              to_tensor(tree["lora_A"], device),
                              to_tensor(tree["lora_B"], device),
                              float(tree["scaling"]))
        return {k: from_reference_arrays(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_reference_arrays(v, device) for v in tree]
    if tree is None:
        return None
    return to_tensor(tree, device)


def config_from_reference(fields: Dict[str, Any]) -> LlamaConfig:
    """A :class:`LlamaConfig` from the JAX ``LlamaConfig``'s fields
    (``dataclasses.asdict``, with ``dtype`` as a name): every family and
    preset of the JAX package crosses, field for field."""
    fields = dict(fields)
    fields["dtype"] = torch_dtype(fields["dtype"])
    for k in ("rope_scaling", "sliding_window_layers"):
        if fields.get(k) is not None:
            fields[k] = tuple(fields[k])
    return LlamaConfig(**fields)
