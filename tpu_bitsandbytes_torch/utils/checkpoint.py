"""Save and load trees of tensors in the JAX package's checkpoint format.

One ``.npz`` holds every array under ``a0``, ``a1``, ... and a JSON
structure manifest under ``__manifest__`` (``tpu_bitsandbytes/utils/
checkpoint.py``), so each package reads the other's files: dicts, lists,
tuples, tensors (and numpy arrays), None, scalars, strings and dtypes, and
the model types under the JAX package's tags: ``QuantState``,
``QLinear4`` (its packed codes, absmax or the double-quantized
``absmax_q`` with ``absmax_state``, and the bias; a runtime cache is not
stored), ``LoRALinear`` and ``Module`` (the quantized ``nn`` modules and
the GPT-2 modules of ``models/gpt2.py``, by class name). bfloat16 arrays
are stored as their uint16 bits with the dtype name "bfloat16", as the
JAX package stores them. Arrays load as CPU
tensors.
"""

from __future__ import annotations

import inspect
import json
from typing import Any, Dict

import numpy as np
import torch

from ..functional import QuantState, dtype_name, dtype_of

__all__ = ["save_checkpoint", "load_checkpoint", "load_quantized"]

_NONE = {"__type__": "none"}
# torch.nn attributes the JAX modules do not have
_TORCH_ONLY = {"training", "max_norm", "norm_type", "scale_grad_by_freq",
               "sparse"}


def _module_classes():
    from .. import nn
    classes = [nn.Linear, nn.Embedding, nn.Linear4bit, nn.Linear8bit,
               nn.LinearFP8, nn.OutlierAwareLinear, nn.SwitchBackLinear,
               nn.Embedding4bit, nn.Embedding8bit, nn.EmbeddingNF4,
               nn.EmbeddingFP4]
    return {c.__name__: c for c in classes + _gpt2_classes()}


def _gpt2_classes():
    from ..models import gpt2
    return [gpt2.GPT2LMHeadModel, gpt2.GPT2Block, gpt2.GPT2Attention,
            gpt2.GPT2MLP, gpt2.LayerNorm]


def _module_fields(obj: torch.nn.Module) -> Dict[str, Any]:
    """A port module's attributes under the JAX module's names: its
    configuration, buffers, parameters and submodules (a ``ModuleList``
    as a list), and a ``_weight_cache``."""
    fields = {k: v for k, v in vars(obj).items()
              if not k.startswith("_") and k not in _TORCH_ONLY}
    fields.update(obj._buffers)
    fields.update({k: v.detach() if v is not None else None
                   for k, v in obj._parameters.items()})
    fields.update({k: list(m) if isinstance(m, torch.nn.ModuleList) else m
                   for k, m in obj._modules.items()})
    if "_weight_cache" in vars(obj):
        fields["_weight_cache"] = None
    return fields


def _encode(obj: Any, arrays: Dict[str, np.ndarray], path: str):
    from ..models.layers import QLinear4
    from ..models.lora import LoRALinear

    if obj is None:
        return _NONE
    if isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, torch.dtype):
        return {"__type__": "dtype", "name": dtype_name(obj)}
    if isinstance(obj, QuantState):
        return {"__type__": "QuantState",
                "absmax": _encode(obj.absmax, arrays, path),
                "shape": list(obj.shape), "blocksize": obj.blocksize,
                "quant_type": obj.quant_type, "dtype": dtype_name(obj.dtype),
                "offset": _encode(obj.offset, arrays, path),
                "state2": _encode(obj.state2, arrays, path)}
    if isinstance(obj, QLinear4):
        if obj.packed is None:
            raise TypeError(
                f"cannot checkpoint {path}: packed codes were dropped "
                "(with_runtime_cache(drop_packed=True) is serving-only)")
        return {"__type__": "QLinear4",
                "packed": _encode(obj.packed, arrays, path),
                "absmax": _encode(obj.absmax, arrays, path),
                "shape": list(obj.shape), "blocksize": obj.blocksize,
                "quant_type": obj.quant_type, "dtype": dtype_name(obj.dtype),
                "bias": _encode(obj.bias, arrays, path),
                "absmax_q": _encode(obj.absmax_q, arrays, path),
                "absmax_state": _encode(obj.absmax_state, arrays, path)}
    if isinstance(obj, LoRALinear):
        return {"__type__": "LoRALinear",
                "base": _encode(obj.base, arrays, path),
                "lora_A": _encode(obj.lora_A, arrays, path),
                "lora_B": _encode(obj.lora_B, arrays, path),
                "scaling": obj.scaling}
    if isinstance(obj, torch.nn.Module) and not isinstance(obj,
                                                           torch.Tensor):
        name = type(obj).__name__
        if name not in _module_classes():
            raise TypeError(f"cannot serialize module {name} at {path}")
        return {"__type__": "Module", "class": name,
                "fields": {k: _encode(v, arrays, f"{path}/{k}")
                           for k, v in _module_fields(obj).items()}}
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


def _module(name: str, fields: Dict[str, Any]) -> torch.nn.Module:
    """A port module from the JAX module's fields: built from those that
    name its constructor's arguments (``bias`` as whether there is one;
    Linear and Embedding take the weight's dtype), then loaded from the
    tensors under the JAX keys, as its ``load_state_dict`` takes them. A
    GPT-2 module takes its fields as they are: submodules (a list as a
    ``ModuleList``), tensors as parameters, and its configuration."""
    cls = _module_classes().get(name)
    if cls is None:
        raise TypeError(f"checkpoint: unknown module class {name!r}")
    if cls in _gpt2_classes():
        module = cls.__new__(cls)
        torch.nn.Module.__init__(module)
        for k, v in fields.items():
            if isinstance(v, list):
                v = torch.nn.ModuleList(v)
            elif isinstance(v, torch.Tensor):
                v = torch.nn.Parameter(v, requires_grad=v.is_floating_point())
            setattr(module, k, v)
        return module
    params = inspect.signature(cls.__init__).parameters
    kwargs = {k: v for k, v in fields.items()
              if k in params and k != "bias"}
    if "bias" in params:
        kwargs["bias"] = fields.get("bias") is not None
    if "dtype" in params and "dtype" not in fields:
        kwargs["dtype"] = fields["weight"].dtype
    module = cls(**kwargs)
    state = {k: v.as_dict() if isinstance(v, QuantState) else v
             for k, v in fields.items()
             if isinstance(v, (torch.Tensor, QuantState))}
    module.load_state_dict(state, strict=False)
    return module


def _decode(spec: Any, arrays) -> Any:
    from ..models.layers import QLinear4
    from ..models.lora import LoRALinear

    if not isinstance(spec, dict) or "__type__" not in spec:
        return spec
    t = spec["__type__"]
    if t == "none":
        return None
    if t == "dtype":
        return dtype_of(spec["name"])
    if t == "array":
        a = arrays[spec["key"]]
        if spec["dtype"] == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    if t == "QuantState":
        return QuantState(
            absmax=_decode(spec["absmax"], arrays),
            shape=tuple(spec["shape"]), blocksize=spec["blocksize"],
            quant_type=spec["quant_type"], dtype=dtype_of(spec["dtype"]),
            offset=_decode(spec.get("offset", _NONE), arrays),
            state2=_decode(spec["state2"], arrays))
    if t == "QLinear4":
        return QLinear4(
            packed=_decode(spec["packed"], arrays),
            absmax=_decode(spec["absmax"], arrays),
            shape=tuple(spec["shape"]), blocksize=spec["blocksize"],
            quant_type=spec["quant_type"], dtype=dtype_of(spec["dtype"]),
            bias=_decode(spec["bias"], arrays),
            absmax_q=_decode(spec["absmax_q"], arrays),
            absmax_state=_decode(spec["absmax_state"], arrays))
    if t == "LoRALinear":
        return LoRALinear(_decode(spec["base"], arrays),
                          _decode(spec["lora_A"], arrays),
                          _decode(spec["lora_B"], arrays), spec["scaling"])
    if t == "Module":
        return _module(spec.get("class"),
                       {k: _decode(v, arrays)
                        for k, v in spec["fields"].items()})
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


def load_quantized(path: str, blocksize: int = 64, quant_type: str = "nf4",
                   compress_statistics: bool = False):
    """Load a Llama-family checkpoint; a tree whose layers hold
    full-precision linears is quantized on load through
    :func:`~tpu_bitsandbytes_torch.models.llama.quantize_params` (the JAX
    package's defaults: bf16 compute, no fused projections)."""
    from ..models import llama
    tree = load_checkpoint(path)
    if not (isinstance(tree, dict) and "layers" in tree):
        return tree
    if any(not hasattr(layer.get("q_proj"), "packed")
           for layer in tree["layers"]):
        tree = llama.quantize_params(
            tree, blocksize=blocksize, quant_type=quant_type,
            compress_statistics=compress_statistics)
    return tree
