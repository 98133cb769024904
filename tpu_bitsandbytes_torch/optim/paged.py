"""Paged optimizers: f32 optimizer states kept in pinned host memory.

The JAX package's paged optimizers (``tpu_bitsandbytes/optim/paged.py``)
as ``torch.optim.Optimizer`` classes. A parameter on a CUDA device with at
least 32,768 elements keeps its f32 states in pinned host memory; at
``step()`` they are paged onto the card one parameter at a time, updated
beside the parameter, and paged out again by a non-blocking copy on a side
stream (``synchronize()`` waits for the copies). Smaller parameters, and
parameters on the CPU, keep their states beside them. Nothing prefetches
the next parameter's states: the JAX package measured the lookahead as
slower than paging each one in at use.

The update is the JAX package's jitted leaf step, whose hyperparameters
are traced f32 scalars: every scalar here is an f32 tensor, so ``1 - b1``
and ``lr * weight_decay`` round in f32 as they do there.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..functional import sqrt_exact

__all__ = ["PagedAdamW", "PagedAdam", "PagedLion"]

_SMALL_PARAM_NUMEL = 32768


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


class _PagedBase(torch.optim.Optimizer):
    _names: Tuple[str, ...] = ()

    def __init__(self, params, defaults, page_to_cpu: bool = True):
        super().__init__(params, defaults)
        self.page_to_cpu = page_to_cpu
        self._side = {}

    def _paged(self, p) -> bool:
        return (self.page_to_cpu and p.is_cuda
                and p.numel() >= _SMALL_PARAM_NUMEL)

    def _side_stream(self, device):
        s = self._side.get(device)
        if s is None:
            s = self._side[device] = torch.cuda.Stream(device)
        return s

    def _init_state(self, p):
        st = self.state[p]
        if not st:
            st["step"] = 0
            for name in self._names:
                if self._paged(p):
                    st[name] = torch.zeros(p.shape, dtype=torch.float32,
                                           pin_memory=True)
                else:
                    st[name] = torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)
        return st

    def _page_in(self, p, st):
        if not self._paged(p):
            return [st[n] for n in self._names]
        # the last page-out of these buffers runs on the side stream
        torch.cuda.current_stream(p.device).wait_stream(
            self._side_stream(p.device))
        return [st[n].to(p.device, non_blocking=True) for n in self._names]

    def _page_out(self, p, st, values):
        if not self._paged(p):
            for n, v in zip(self._names, values):
                st[n] = v
            return
        side = self._side_stream(p.device)
        side.wait_stream(torch.cuda.current_stream(p.device))
        with torch.cuda.stream(side):
            for n, v in zip(self._names, values):
                st[n].copy_(v, non_blocking=True)
                v.record_stream(side)

    def synchronize(self) -> None:
        """Wait until every page-out copy has landed in host memory."""
        for s in self._side.values():
            s.synchronize()

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self._init_state(p)
                st["step"] += 1
                new = self._leaf_step(p, p.grad, self._page_in(p, st),
                                      group, st["step"])
                p.copy_(new[0])
                self._page_out(p, st, new[1:])
        return loss

    def load_state_dict(self, state_dict) -> None:
        """torch's load, with each f32 state put back where :meth:`step`
        keeps it (pinned host memory for a paged parameter)."""
        saved = state_dict["state"]
        super().load_state_dict({**state_dict, "state": {}})
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        for i, p in zip(ids, params):
            if i not in saved:
                continue
            st = {"step": saved[i]["step"]}
            for n in self._names:
                v = saved[i][n].to(torch.float32)
                st[n] = (v.cpu().pin_memory() if self._paged(p)
                         else v.to(p.device))
            self.state[p] = st


class PagedAdamW(_PagedBase):
    """AdamW with host-paged f32 ``exp_avg`` and ``exp_avg_sq``."""

    _is_adamw = True
    _names = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, page_to_cpu: bool = True):
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
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay),
                         page_to_cpu)

    def _leaf_step(self, p, g, states, group, step):
        dev = p.device
        lr, wd, eps = (_f32(group[k], dev) for k in ("lr", "weight_decay",
                                                     "eps"))
        b1, b2 = (_f32(b, dev) for b in group["betas"])
        m, v = states
        g32 = g.to(torch.float32)
        p32 = p.to(torch.float32)
        if self._is_adamw:
            p32 = p32 * (1.0 - lr * wd)
        else:
            g32 = g32 + wd * p32
        m = b1 * m + (1.0 - b1) * g32
        v = b2 * v + (1.0 - b2) * g32 * g32
        t = _f32(float(step), dev)
        bc1 = 1.0 - (b1.double() ** t.double()).to(torch.float32)
        bc2 = 1.0 - (b2.double() ** t.double()).to(torch.float32)
        denom = sqrt_exact(v) / sqrt_exact(bc2) + eps
        p32 = p32 - (lr / bc1) * m / denom
        return p32.to(p.dtype), m, v


class PagedAdam(PagedAdamW):
    """Paged Adam: L2 weight decay on the gradient, not decoupled."""

    _is_adamw = False

    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, page_to_cpu: bool = True):
        super().__init__(params, lr, betas, eps, weight_decay, page_to_cpu)


class PagedLion(_PagedBase):
    """Paged Lion with a host-paged f32 momentum."""

    _names = ("exp_avg",)

    def __init__(self, params, lr: float = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 0.0, page_to_cpu: bool = True):
        if lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        if not 0.0 <= betas[0] < 1.0:
            raise ValueError(f"Invalid beta1: {betas[0]}")
        if not 0.0 <= betas[1] < 1.0:
            raise ValueError(f"Invalid beta2: {betas[1]}")
        if weight_decay < 0.0:
            raise ValueError(f"Invalid weight_decay: {weight_decay}")
        super().__init__(params, dict(lr=lr, betas=betas,
                                      weight_decay=weight_decay),
                         page_to_cpu)

    def _leaf_step(self, p, g, states, group, step):
        dev = p.device
        lr, wd = _f32(group["lr"], dev), _f32(group["weight_decay"], dev)
        b1, b2 = (_f32(b, dev) for b in group["betas"])
        (m,) = states
        g32 = g.to(torch.float32)
        p32 = p.to(torch.float32) * (1.0 - lr * wd)
        update = torch.sign(b1 * m + (1.0 - b1) * g32)
        p32 = p32 - lr * update
        m = b2 * m + (1.0 - b2) * g32
        return p32.to(p.dtype), m
