"""The base of the quantized modules: a ``torch.nn.Module`` whose
checkpoint keeps the JAX package's keys.

Each quantized module holds its tensors as buffers under the JAX
package's attribute names (``weight``, ``bias``, ``weight_int8``,
``weight_scales``, ...), so ``state_dict()`` gives the JAX keys, and
``load_state_dict`` runs the module's own :meth:`Module.load` on the
entries under its prefix: a JAX module's ``state_dict``, handed over as
numpy, loads as it is, and a full-precision ``weight`` is requantized on
load. Loading is lenient, as in the JAX package: keys a module does not
know are ignored, and missing ones keep their values. Tensors held outside
buffers (a :class:`~..functional.QuantState`) are listed by
:meth:`Module.extra_tensors` and moved by ``.to()``.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

FLOAT_DTYPES = (torch.float16, torch.float32, torch.bfloat16)


def compute_dtype_of(weight: torch.Tensor) -> torch.dtype:
    """A converted layer's compute dtype: the weight's if half precision,
    else bf16 (the JAX package's rule)."""
    return (weight.dtype if weight.dtype in (torch.bfloat16, torch.float16)
            else torch.bfloat16)


def full_precision(name: str, key: str, w: torch.Tensor) -> torch.Tensor:
    """``w`` if it is a float tensor, else the JAX package's error."""
    if w.dtype not in FLOAT_DTYPES:
        raise ValueError(f"{name}: '{key}' must be full-precision to "
                         f"re-quantize on load, got {w.dtype}")
    return w


def is_full_precision(v) -> bool:
    """Whether a state-dict value (tensor or array) is f16, f32 or bf16."""
    dt = v.dtype if isinstance(v, torch.Tensor) else np.asarray(v).dtype
    return str(dt).removeprefix("torch.") in ("float16", "float32",
                                              "bfloat16")


class Module(torch.nn.Module):
    """A quantized module: JAX-keyed checkpoints, lenient loading with
    ``strict=False`` and checked keys with ``strict=True``."""

    # the keys of the quantized form, all of which a full-precision
    # ``weight`` stands in for (it is requantized on load)
    QUANTIZED_KEYS: Tuple[str, ...] = ()
    # metadata: loaded where present, never required
    OPTIONAL_KEYS: Tuple[str, ...] = ()

    def load(self, state_dict: dict, prefix: str) -> None:
        """Load this module's own entries (``prefix`` + key)."""
        raise NotImplementedError

    def extra_tensors(self) -> Iterator[torch.Tensor]:
        """Tensors this module holds outside its parameters and buffers."""
        return iter(())

    def key_mismatch(self, state_dict: dict, prefix: str
                     ) -> Tuple[List[str], List[str]]:
        """The keys (with ``prefix``) this module needs and ``state_dict``
        lacks, and those under ``prefix`` it does not know."""
        present = {k[len(prefix):] for k in state_dict
                   if k.startswith(prefix) and "." not in k[len(prefix):]}
        bias = {"bias"} if getattr(self, "bias", None) is not None else set()
        need = set(self.QUANTIZED_KEYS) | bias
        if "weight" in present and is_full_precision(
                state_dict[prefix + "weight"]):
            need -= set(self.QUANTIZED_KEYS)
        known = (set(self.QUANTIZED_KEYS) | bias | {"weight"}
                 | set(self.OPTIONAL_KEYS))
        return ([prefix + k for k in sorted(need - present)],
                [prefix + k for k in sorted(present - known)])

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        if strict:
            missing, unexpected = self.key_mismatch(state_dict, prefix)
            missing_keys.extend(missing)
            unexpected_keys.extend(unexpected)
        with torch.no_grad():
            self.load(state_dict, prefix)
