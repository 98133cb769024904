"""Save and load trees of tensors in the JAX package's checkpoint format.

One ``.npz`` holds every array under ``a0``, ``a1``, ... and a JSON
structure manifest under ``__manifest__`` (``tpu_bitsandbytes/utils/
checkpoint.py``), so each package reads the other's files. Only the types
an engine snapshot holds are covered: dicts, lists, tuples, tensors (and
numpy arrays), None, scalars and strings. bfloat16 arrays are stored as
their uint16 bits with the dtype name "bfloat16", as the JAX package
stores them. Arrays load as CPU tensors.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint"]

_NONE = {"__type__": "none"}


def _encode(obj: Any, arrays: Dict[str, np.ndarray], path: str):
    if obj is None:
        return _NONE
    if isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        key = f"a{len(arrays)}"
        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu()
            if t.dtype == torch.bfloat16:
                arrays[key] = t.view(torch.int16).numpy().view(np.uint16)
                return {"__type__": "array", "key": key, "dtype": "bfloat16"}
            a = t.numpy()
        else:
            a = np.asarray(obj)
        arrays[key] = a
        return {"__type__": "array", "key": key, "dtype": str(a.dtype)}
    if isinstance(obj, dict):
        return {"__type__": "dict",
                "items": {str(k): _encode(v, arrays, f"{path}/{k}")
                          for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"__type__": "list" if isinstance(obj, list) else "tuple",
                "items": [_encode(v, arrays, f"{path}/{i}")
                          for i, v in enumerate(obj)]}
    raise TypeError(f"cannot serialize {type(obj)} at {path}")


def _decode(spec: Any, arrays) -> Any:
    if not isinstance(spec, dict) or "__type__" not in spec:
        return spec
    t = spec["__type__"]
    if t == "none":
        return None
    if t == "array":
        a = arrays[spec["key"]]
        if spec["dtype"] == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    if t == "dict":
        return {k: _decode(v, arrays) for k, v in spec["items"].items()}
    if t == "list":
        return [_decode(v, arrays) for v in spec["items"]]
    if t == "tuple":
        return tuple(_decode(v, arrays) for v in spec["items"])
    raise TypeError(f"cannot deserialize tag {t!r}")


def save_checkpoint(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path`` (``.npz`` is appended when missing)."""
    arrays: Dict[str, np.ndarray] = {}
    spec = _encode(tree, arrays, "")
    arrays["__manifest__"] = np.frombuffer(json.dumps(spec).encode(),
                                           dtype=np.uint8)
    np.savez(path, **arrays)


def load_checkpoint(path: str) -> Any:
    """Read a tree written by :func:`save_checkpoint` (either package's),
    its arrays as CPU tensors."""
    if not str(path).endswith(".npz"):
        path = str(path) + ".npz"
    with np.load(path) as data:
        spec = json.loads(bytes(data["__manifest__"]).decode())
        arrays = {k: data[k] for k in data.files if k != "__manifest__"}
    return _decode(spec, arrays)
