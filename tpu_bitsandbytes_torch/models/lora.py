"""LoRA adapters over (quantized) linears: the QLoRA training path.

A :class:`LoRALinear` wraps a frozen base weight leaf (a
:class:`~tpu_bitsandbytes_torch.models.layers.QLinear4`, a raw [N, K]
tensor or a ``{"w", "b"}`` dict) with trainable low-rank ``lora_A`` and
``lora_B``. Only A and B receive gradients, which the 8-bit optimizers then
update. The keys and the arithmetic are the JAX package's
(``tpu_bitsandbytes/models/lora.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from .layers import QLinear4, linear_apply

__all__ = ["LoRALinear", "DEFAULT_TARGETS", "attach_lora", "lora_trainable",
           "merge_lora_trainable"]

DEFAULT_TARGETS = ("q_proj", "v_proj")


class LoRALinear(torch.nn.Module):
    """``base(x) + scaling * ((x @ A.T) @ B.T)``, the low-rank product in
    x's dtype and added in the base output's dtype. ``lora_A`` [r, K] and
    ``lora_B`` [N, r] are :class:`torch.nn.Parameter`s (a tensor passed in
    is wrapped without a copy); ``base`` stays frozen."""

    def __init__(self, base: Any, lora_A: torch.Tensor, lora_B: torch.Tensor,
                 scaling: float = 1.0):
        super().__init__()
        self.base = base
        self.lora_A = (lora_A if isinstance(lora_A, torch.nn.Parameter)
                       else torch.nn.Parameter(lora_A))
        self.lora_B = (lora_B if isinstance(lora_B, torch.nn.Parameter)
                       else torch.nn.Parameter(lora_B))
        self.scaling = float(scaling)

    @property
    def shape(self):
        """The base weight's [N, K]."""
        return _base_shape(self.base)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = linear_apply(self.base, x)
        delta = (x @ self.lora_A.t().to(x.dtype)) @ self.lora_B.t().to(
            x.dtype)
        return y + self.scaling * delta.to(y.dtype)


def _base_shape(base):
    if isinstance(base, dict):
        return tuple(base["w"].shape)
    return tuple(base.shape)


def _base_device(base):
    if isinstance(base, QLinear4):
        return base.packed.device if base.packed is not None else (
            base.w_cache.device)
    return (base["w"] if isinstance(base, dict) else base).device


def attach_lora(params: Dict, *, generator: torch.Generator, rank: int = 8,
                alpha: float = 16.0,
                targets: Sequence[str] = DEFAULT_TARGETS,
                dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Wrap the ``targets`` projections of every layer of a Llama tree with
    LoRA adapters: A normal(0, 0.01) from ``generator`` (drawn in f32 on the
    generator's device, then cast to ``dtype`` and put beside the base),
    B zeros, scaling ``alpha / rank``. Returns a new tree; the base leaves
    are shared."""
    scaling = alpha / rank
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        nl = dict(layer)
        for name in targets:
            base = layer[name]
            n, k = _base_shape(base)
            dev = _base_device(base)
            a = (torch.randn((rank, k), generator=generator,
                             device=generator.device, dtype=torch.float32)
                 * 0.01).to(dtype=dtype, device=dev)
            b = torch.zeros((n, rank), dtype=dtype, device=dev)
            nl[name] = LoRALinear(base, a, b, scaling)
        out["layers"].append(nl)
    return out


def lora_trainable(params: Dict) -> Dict:
    """The trainable leaves, ``{"layers/{i}/{name}": {"A": ..., "B": ...}}``
    (the modules' own parameters, not copies)."""
    out = {}
    for li, layer in enumerate(params["layers"]):
        for name, w in layer.items():
            if isinstance(w, LoRALinear):
                out[f"layers/{li}/{name}"] = {"A": w.lora_A, "B": w.lora_B}
    return out


def merge_lora_trainable(params: Dict, trainable: Dict) -> Dict:
    """A new tree whose adapters take A and B from ``trainable`` (as new
    parameters over the same storage); every other leaf is shared."""
    out = dict(params)
    out["layers"] = []
    for li, layer in enumerate(params["layers"]):
        nl = dict(layer)
        for name, w in layer.items():
            key = f"layers/{li}/{name}"
            if isinstance(w, LoRALinear) and key in trainable:
                nl[name] = LoRALinear(w.base, trainable[key]["A"],
                                      trainable[key]["B"], w.scaling)
        out["layers"].append(nl)
    return out
