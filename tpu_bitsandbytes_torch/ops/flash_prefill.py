"""Causal GQA attention for aligned half-precision prefill (kernel K3).

What the JAX package's tiled Pallas flash-prefill kernel computes, for every
query block and every key block from the window's first block up to the
causal diagonal: ``lg = dot(q, k) * scale`` in f32 (bf16 operands), the
optional softcap, masked logits set to -1e30 (keep ``kpos <= qpos``,
``kpos < s_real`` and the optional window), the online softmax
``m_new = max(m, rowmax)``, ``p = exp(lg - m_new)``,
``alpha = exp(m - m_new)``, with ``m`` starting at -1e30, ``p`` cast to the
operands' dtype before the PV dot, and ``acc / max(l, 1e-38)`` at the end.

Where ``p`` is rounded depends on the key tile, so the plain version takes
the tile (``block_k``): 512 as the TPU kernel (what the tests hold against
the JAX package), or the CUDA kernel's tile for the head dim
(``KEY_TILE``: 128 keys at d = 64 and 128, 64 at d = 256; what CPU tensors
run, so the CPU computes what the card does).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build

__all__ = ["flash_prefill_attention", "flash_prefill_plain",
           "tiled_attention", "kept_pairs", "KEY_TILE", "HEAD_DIMS"]

# the CUDA kernel's key tile for each head dim it takes (its query tile is
# 128 rows at every d; where p rounds depends on the key tile alone)
KEY_TILE = {64: 128, 128: 128, 256: 64}
HEAD_DIMS = tuple(KEY_TILE)
_NEG = -1e30


def tiled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    s_real: int, scale: float, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    block_k: int = 512) -> torch.Tensor:
    """The online softmax above over ``block_k`` x ``block_k`` tiles, in
    torch ops. q [B, S, H, D], k/v [B, S, H_kv, D] in one dtype -> [B, S,
    H, D] in q's dtype. Half precision: what K3 computes. f32: the JAX
    package's scan route off its kernel (its -inf masking with p set to 0
    gives the same f32 numbers: a masked p is exp(-1e30 - m) = 0, and a
    tile wholly masked for a row is wiped by alpha = 0 at the row's first
    kept key)."""
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    rep = h // h_kv
    bk = block_k
    s_pad = -(-s // bk) * bk
    f32 = torch.float32

    def heads(t, n):        # [B, S, n, D] -> [B, H_kv, n/H_kv, S_pad, D] f32
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, s_pad - s))
        return t.to(f32).reshape(b, s_pad, h_kv, n // h_kv, d).permute(
            0, 2, 3, 1, 4)

    qh, kh, vh = heads(q, h), heads(k, h_kv), heads(v, h_kv)
    ar = torch.arange(bk, device=q.device)
    outs = []
    for qi in range(s_pad // bk):
        qb = qh[:, :, :, qi * bk:(qi + 1) * bk]
        qpos = qi * bk + ar
        m = torch.full((b, h_kv, rep, bk), _NEG, dtype=f32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h_kv, rep, bk, d), dtype=f32, device=q.device)
        kb_lo = 0 if window is None else max(0, (qi * bk - window + 1) // bk)
        for ki in range(kb_lo, qi + 1):
            kb = kh[:, :, :, ki * bk:(ki + 1) * bk]
            vb = vh[:, :, :, ki * bk:(ki + 1) * bk]
            lg = (qb @ kb.transpose(-1, -2)) * scale
            if softcap is not None:
                lg = torch.tanh(lg / softcap) * softcap
            kpos = ki * bk + ar
            keep = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < s_real)
            if window is not None:
                keep &= kpos[None, :] > qpos[:, None] - window
            lg = torch.where(keep, lg, torch.full_like(lg, _NEG))
            m_new = torch.maximum(m, lg.amax(dim=-1))
            p = torch.exp(lg - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = p.to(v.dtype).to(f32) @ vb
            acc = acc * alpha[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-38)[..., None])
    out = torch.cat(outs, dim=3)                  # [B, H_kv, rep, S_pad, D]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s_pad, h, d)[:, :s]
    return out.to(q.dtype)


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        s_real: int, scale: float,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        block_k: int = 512) -> torch.Tensor:
    """Plain PyTorch version of K3: :func:`tiled_attention` on half-precision
    q/k/v. Counts its calls on CUDA tensors in
    ``flash_prefill_plain.cuda_calls``."""
    if q.is_cuda:
        flash_prefill_plain.cuda_calls += 1
    return tiled_attention(q, k, v, s_real=s_real, scale=scale, window=window,
                           softcap=softcap, block_k=block_k)


_build.counter(flash_prefill_plain, "cuda_calls")


def kept_pairs(s: int, s_real: int, window: Optional[int] = None) -> int:
    """(query, key) pairs the masks keep over S queries: the work K3 must
    do per (batch row, head)."""
    qpos = np.arange(s)
    hi = np.minimum(qpos, s_real - 1)
    lo = np.zeros_like(qpos) if window is None else np.maximum(
        0, qpos - window + 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _launcher():
    fn = _build.library("flash_prefill").tbnb_flash_prefill
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _kernel(q, k, v, *, s_real, scale, window, softcap):
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    if (q.dtype not in (torch.bfloat16, torch.float16) or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError("flash_prefill: q, k and v must share one half "
                        "dtype (bf16 or f16)")
    if (k.shape != (b, s, h_kv, d) or v.shape != k.shape or h_kv < 1
            or h % h_kv):
        raise ValueError(f"flash_prefill: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"flash_prefill: head_dim {d} (the kernel "
                                  f"takes {HEAD_DIMS})")
    if not all(t.is_cuda and t.device == q.device and t.is_contiguous()
               for t in (q, k, v)):
        raise ValueError("flash_prefill: q, k and v must be contiguous "
                         "tensors on one CUDA device")
    out = torch.empty_like(q)
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, s, h, h_kv, d, int(s_real),
                      0 if window is None else int(window),
                      0 if window is None else 1,
                      1 if q.dtype == torch.float16 else 0, float(scale),
                      0.0 if softcap is None else float(softcap),
                      torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill")
    flash_prefill_attention.launches += 1
    return out


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, s_real: int, scale: float,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """Causal GQA prefill attention. q [B, S, H, D]; k/v [B, S, H_kv, D]
    token-major, bf16 or f16; keys at positions >= ``s_real`` are masked (query
    rows past it are padding for the caller to drop). Returns [B, S, H, D]
    in q's dtype.

    CUDA tensors launch kernel K3 (counted in
    ``flash_prefill_attention.launches``); CPU tensors take
    :func:`flash_prefill_plain` at the kernel's key tile for the head dim
    (``KEY_TILE``). Neither has a backward pass, as the TPU kernel has
    none: with grad mode on, an input that requires grad raises.
    """
    _build.refuse_grad("flash_prefill_attention", q, k, v)
    if not q.is_cuda:
        d = q.shape[3]
        if d not in KEY_TILE:
            raise NotImplementedError(f"flash_prefill: head_dim {d} (the "
                                      f"kernel takes {HEAD_DIMS})")
        return flash_prefill_plain(q, k, v, s_real=s_real, scale=scale,
                                   window=window, softcap=softcap,
                                   block_k=KEY_TILE[d])
    return _kernel(q, k, v, s_real=s_real, scale=scale, window=window,
                   softcap=softcap)


_build.counter(flash_prefill_attention, "launches")
