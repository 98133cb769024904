"""8-bit optimizers as (init, update) pairs over trees of tensors.

The JAX package's optax-style transforms (``tpu_bitsandbytes/optim/
transforms.py``), with the same state NamedTuples: the state holds the
quantized moments (int8 momentum and its per-block absmax, uint8
sqrt-compressed second moment and its per-block max), each a tree shaped
like the parameters. ``init(params)`` builds the state; ``update(grads,
state, params)`` returns ``(updates, new_state)``, the updates in each
parameter's dtype, as JAX computes them: every hyperparameter is an f32
constant, the bias corrections ``1 - b ** step`` are f32, and the moments
round-trip through :mod:`.state8bit` every step.

Trees are dicts (flattened in sorted key order, as JAX flattens them),
lists, tuples and None, with tensors at the leaves.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple

import torch

from ..functional import sqrt_exact
from .state8bit import (dequantize_state, dequantize_state_unsigned,
                        quantize_state, quantize_state_unsigned)

__all__ = ["GradientTransformation", "Adam8bitState", "Lion8bitState",
           "SGD8bitState", "adam8bit", "adamw8bit", "lion8bit", "sgd8bit",
           "apply_updates", "tree_leaves", "tree_unflatten", "tree_map"]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def tree_leaves(tree) -> List[Any]:
    """The tensor leaves of ``tree`` in JAX's order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(tree)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat = [tree_leaves(t) for t in (tree,) + rest]
    return tree_unflatten(tree, [fn(*ls) for ls in zip(*flat)])


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf in each parameter's dtype, as
    ``optax.apply_updates`` adds them."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _bias_correction(b: float, step: torch.Tensor) -> torch.Tensor:
    """``1 - b ** step`` in f32 as XLA computes it: the f32 power, which
    the f64 power of f32(b) rounded to f32 reproduces (PyTorch's f32
    ``pow`` is off by an ulp from step 6 on for some b)."""
    b32 = torch.tensor(b, dtype=torch.float32, device=step.device)
    return 1.0 - (b32.double() ** step.double()).to(torch.float32)


class Adam8bitState(NamedTuple):
    count: torch.Tensor
    exp_avg_int8: Any
    exp_avg_absmax: Any
    exp_avg_sq_uint8: Any
    exp_avg_sq_max: Any


class Lion8bitState(NamedTuple):
    exp_avg_int8: Any
    exp_avg_absmax: Any


class SGD8bitState(NamedTuple):
    momentum_int8: Any
    momentum_absmax: Any


def _q_zero_like(p, block_size):
    return quantize_state(torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), block_size)


def _qu_zero_like(p, block_size):
    return quantize_state_unsigned(torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), block_size)


def _split(params, results, i):
    return tree_unflatten(params, [r[i] for r in results])


def adam8bit(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8, weight_decay: float = 0.0,
             block_size: int = 256, is_adamw: bool = False
             ) -> GradientTransformation:
    """Adam (L2 weight decay on the gradient) or, with ``is_adamw``, AdamW
    (decoupled weight decay), with int8/uint8 blockwise moments."""

    def init_fn(params):
        flat = tree_leaves(params)
        mq = [_q_zero_like(p, block_size) for p in flat]
        vq = [_qu_zero_like(p, block_size) for p in flat]
        device = flat[0].device if flat else None
        return Adam8bitState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            exp_avg_int8=_split(params, mq, 0),
            exp_avg_absmax=_split(params, mq, 1),
            exp_avg_sq_uint8=_split(params, vq, 0),
            exp_avg_sq_max=_split(params, vq, 1))

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError("adam8bit requires params for weight decay / "
                             "updates")
        count = state.count + 1
        step = count.to(torch.float32)
        bc1 = _bias_correction(b1, step)
        sqrt_bc2 = sqrt_exact(_bias_correction(b2, step))
        # a Python scalar over a tensor is a reciprocal times the scalar in
        # PyTorch; JAX divides
        lr_bc1 = -(torch.full_like(bc1, learning_rate) / bc1)

        def leaf_update(g, p, m_q, m_ax, v_q, v_mx):
            g32 = g.to(torch.float32)
            p32 = p.to(torch.float32)
            if not is_adamw and weight_decay != 0.0:
                g32 = g32 + weight_decay * p32
            m = dequantize_state(m_q, m_ax, block_size)
            v = dequantize_state_unsigned(v_q, v_mx, block_size)
            m = b1 * m + (1.0 - b1) * g32
            v = b2 * v + (1.0 - b2) * g32 * g32
            denom = sqrt_exact(v) / sqrt_bc2 + eps
            upd = lr_bc1 * (m / denom)
            if is_adamw and weight_decay != 0.0:
                upd = upd - learning_rate * weight_decay * p32
            m_q2, m_ax2 = quantize_state(m, block_size)
            v_q2, v_mx2 = quantize_state_unsigned(v, block_size)
            return upd.to(p.dtype), m_q2, m_ax2, v_q2, v_mx2

        flat = [tree_leaves(t) for t in (
            grads, params, state.exp_avg_int8, state.exp_avg_absmax,
            state.exp_avg_sq_uint8, state.exp_avg_sq_max)]
        results = [leaf_update(*leaf) for leaf in zip(*flat)]
        return _split(grads, results, 0), Adam8bitState(
            count=count,
            exp_avg_int8=_split(grads, results, 1),
            exp_avg_absmax=_split(grads, results, 2),
            exp_avg_sq_uint8=_split(grads, results, 3),
            exp_avg_sq_max=_split(grads, results, 4))

    return GradientTransformation(init_fn, update_fn)


def adamw8bit(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, weight_decay: float = 1e-2,
              block_size: int = 256) -> GradientTransformation:
    """:func:`adam8bit` with decoupled weight decay."""
    return adam8bit(learning_rate, b1, b2, eps, weight_decay, block_size,
                    is_adamw=True)


def lion8bit(learning_rate: float = 1e-4, b1: float = 0.9, b2: float = 0.99,
             weight_decay: float = 0.0, block_size: int = 256
             ) -> GradientTransformation:
    """Lion with one int8 momentum."""

    def init_fn(params):
        mq = [_q_zero_like(p, block_size) for p in tree_leaves(params)]
        return Lion8bitState(exp_avg_int8=_split(params, mq, 0),
                             exp_avg_absmax=_split(params, mq, 1))

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError("lion8bit requires params")

        def leaf_update(g, p, m_q, m_ax):
            g32 = g.to(torch.float32)
            p32 = p.to(torch.float32)
            m = dequantize_state(m_q, m_ax, block_size)
            upd = torch.sign(b1 * m + (1.0 - b1) * g32) * (-learning_rate)
            if weight_decay != 0.0:
                upd = upd - learning_rate * weight_decay * p32
            m = b2 * m + (1.0 - b2) * g32
            m_q2, m_ax2 = quantize_state(m, block_size)
            return upd.to(p.dtype), m_q2, m_ax2

        flat = [tree_leaves(t) for t in (grads, params, state.exp_avg_int8,
                                         state.exp_avg_absmax)]
        results = [leaf_update(*leaf) for leaf in zip(*flat)]
        return _split(grads, results, 0), Lion8bitState(
            exp_avg_int8=_split(grads, results, 1),
            exp_avg_absmax=_split(grads, results, 2))

    return GradientTransformation(init_fn, update_fn)


def sgd8bit(learning_rate: float = 1e-2, momentum: float = 0.9,
            dampening: float = 0.0, weight_decay: float = 0.0,
            nesterov: bool = False, block_size: int = 256
            ) -> GradientTransformation:
    """SGD with an int8 momentum buffer (none when ``momentum`` is 0)."""

    def init_fn(params):
        if momentum == 0:
            return SGD8bitState(momentum_int8=None, momentum_absmax=None)
        mq = [_q_zero_like(p, block_size) for p in tree_leaves(params)]
        return SGD8bitState(momentum_int8=_split(params, mq, 0),
                            momentum_absmax=_split(params, mq, 1))

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError("sgd8bit requires params")

        def leaf_update(g, p, m_q, m_ax):
            g32 = g.to(torch.float32)
            if weight_decay != 0.0:
                g32 = g32 + weight_decay * p.to(torch.float32)
            if momentum != 0:
                buf = dequantize_state(m_q, m_ax, block_size)
                buf = momentum * buf + (1.0 - dampening) * g32
                d = g32 + momentum * buf if nesterov else buf
                m_q2, m_ax2 = quantize_state(buf, block_size)
            else:
                d, m_q2, m_ax2 = g32, None, None
            return (-learning_rate * d).to(p.dtype), m_q2, m_ax2

        gl, pl = tree_leaves(grads), tree_leaves(params)
        if momentum != 0:
            mql = tree_leaves(state.momentum_int8)
            mal = tree_leaves(state.momentum_absmax)
        else:
            mql = mal = [None] * len(gl)
        results = [leaf_update(*leaf) for leaf in zip(gl, pl, mql, mal)]
        upds = _split(grads, results, 0)
        if momentum == 0:
            return upds, state
        return upds, SGD8bitState(momentum_int8=_split(grads, results, 1),
                                  momentum_absmax=_split(grads, results, 2))

    return GradientTransformation(init_fn, update_fn)
