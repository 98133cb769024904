"""``torch.optim.Optimizer`` classes over the 8-bit transforms.

The JAX package's torch-like wrappers (``tpu_bitsandbytes/optim/
wrappers.py``): the same constructor validation and messages, the same
``max_grad_norm`` global-norm clipping, and the same update, added to the
parameter in f32 and cast back to its dtype. The API is torch's:
``step()`` reads each parameter's ``.grad`` and updates the parameter in
place (JAX's ``step(grads)`` returns new params). Each parameter's state,
the transform's state for that one leaf (``step``, int8/uint8 codes and
their absmax/max), lives in ``self.state[p]`` and round-trips through
``state_dict()`` / ``load_state_dict()`` with its dtypes kept.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import transforms

__all__ = ["Adam8bit", "AdamW8bit", "Lion8bit", "SGD8bit",
           "clip_by_global_norm"]


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """Scale ``grads`` by ``min(1, max_norm / max(||grads||, 1e-6))``, the
    norm taken in f32 over all of them (torch's ``clip_grad_norm_``
    semantics); each comes back in its own dtype."""
    total = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in grads))
    scale = torch.clamp(torch.full_like(total, max_norm)
                        / torch.clamp(total, min=1e-6), max=1.0)
    return [(g * scale).to(g.dtype) for g in grads]


class _Optimizer8bit(torch.optim.Optimizer):
    """Runs :attr:`_tx` (a transform of the group's hyperparameters) one
    parameter at a time over ``self.state[p]``, which holds that leaf's
    transform state under the state NamedTuple's field names ("count" is
    kept as "step")."""

    _state_cls = None

    def __init__(self, params, defaults, max_grad_norm=None):
        super().__init__(params, defaults)
        self.max_grad_norm = max_grad_norm

    def _tx(self, group) -> transforms.GradientTransformation:
        raise NotImplementedError

    def _leaf_state(self, p, tx):
        st = self.state[p]
        if not st:
            for name, v in zip(self._state_cls._fields, tx.init([p])):
                st["step" if name == "count" else name] = (
                    v[0] if isinstance(v, list) else v)
        return self._state_cls(*(
            st["step"] if name == "count"
            else None if st[name] is None else [st[name]]
            for name in self._state_cls._fields))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        work = [(group, p) for group in self.param_groups
                for p in group["params"] if p.grad is not None]
        grads = [p.grad for _, p in work]
        if self.max_grad_norm is not None and grads:
            grads = clip_by_global_norm(grads, self.max_grad_norm)
        txs = {}
        for (group, p), g in zip(work, grads):
            tx = txs.get(id(group)) or txs.setdefault(id(group),
                                                      self._tx(group))
            upd, new = tx.update([g], self._leaf_state(p, tx), [p])
            for name, v in zip(self._state_cls._fields, new):
                self.state[p]["step" if name == "count" else name] = (
                    v[0] if isinstance(v, list) else v)
            p.copy_((p.to(torch.float32) + upd[0].to(torch.float32)
                     ).to(p.dtype))
        return loss

    def load_state_dict(self, state_dict) -> None:
        """torch's load, but each state tensor keeps its dtype (torch casts
        floating state to the parameter's dtype, which would turn the int8
        codes into floats) and moves to its parameter's device."""
        saved = state_dict["state"]
        super().load_state_dict({**state_dict, "state": {}})
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        for i, p in zip(ids, params):
            if i in saved:
                self.state[p] = {k: self._place(p, k, v)
                                 for k, v in saved[i].items()}

    def _place(self, p, key, v):
        return v.to(p.device) if isinstance(v, torch.Tensor) else v


def _validate_adam(lr, betas, eps, weight_decay, max_grad_norm):
    if lr < 0.0:
        raise ValueError(f"Invalid learning rate: {lr}")
    if eps < 0.0:
        raise ValueError(f"Invalid epsilon: {eps}")
    if not 0.0 <= betas[0] < 1.0:
        raise ValueError(f"Invalid beta1: {betas[0]}")
    if not 0.0 <= betas[1] < 1.0:
        raise ValueError(f"Invalid beta2: {betas[1]}")
    if weight_decay < 0.0:
        raise ValueError(f"Invalid weight_decay: {weight_decay}")
    if max_grad_norm is not None and max_grad_norm <= 0.0:
        raise ValueError(f"Invalid max_grad_norm: {max_grad_norm}")


class Adam8bit(_Optimizer8bit):
    """8-bit Adam: int8 m, sqrt-compressed uint8 v, L2 weight decay on
    the gradient."""

    _state_cls = transforms.Adam8bitState
    _is_adamw = False

    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, block_size: int = 256,
                 max_grad_norm: Optional[float] = None):
        _validate_adam(lr, betas, eps, weight_decay, max_grad_norm)
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      block_size=block_size), max_grad_norm)

    def _tx(self, group):
        return transforms.adam8bit(
            group["lr"], group["betas"][0], group["betas"][1], group["eps"],
            group["weight_decay"], group["block_size"],
            is_adamw=self._is_adamw)


class AdamW8bit(Adam8bit):
    """8-bit AdamW (decoupled weight decay)."""

    _is_adamw = True

    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, block_size: int = 256,
                 max_grad_norm: Optional[float] = None):
        super().__init__(params, lr, betas, eps, weight_decay, block_size,
                         max_grad_norm)


class Lion8bit(_Optimizer8bit):
    """8-bit Lion (sign update, one int8 momentum)."""

    _state_cls = transforms.Lion8bitState

    def __init__(self, params, lr: float = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 0.0, block_size: int = 256):
        if lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        if not 0.0 <= betas[0] < 1.0:
            raise ValueError(f"Invalid beta1: {betas[0]}")
        if not 0.0 <= betas[1] < 1.0:
            raise ValueError(f"Invalid beta2: {betas[1]}")
        if weight_decay < 0.0:
            raise ValueError(f"Invalid weight_decay: {weight_decay}")
        super().__init__(params, dict(lr=lr, betas=betas,
                                      weight_decay=weight_decay,
                                      block_size=block_size))

    def _tx(self, group):
        return transforms.lion8bit(group["lr"], group["betas"][0],
                                   group["betas"][1], group["weight_decay"],
                                   group["block_size"])


class SGD8bit(_Optimizer8bit):
    """SGD with an int8 momentum buffer."""

    _state_cls = transforms.SGD8bitState

    def __init__(self, params, lr: float = 1e-2, momentum: float = 0.9,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, block_size: int = 256):
        if lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        if momentum < 0.0:
            raise ValueError(f"Invalid momentum: {momentum}")
        if weight_decay < 0.0:
            raise ValueError(f"Invalid weight_decay: {weight_decay}")
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      dampening=dampening,
                                      weight_decay=weight_decay,
                                      nesterov=nesterov,
                                      block_size=block_size))

    def _tx(self, group):
        return transforms.sgd8bit(group["lr"], group["momentum"],
                                  group["dampening"], group["weight_decay"],
                                  group["nesterov"], group["block_size"])
