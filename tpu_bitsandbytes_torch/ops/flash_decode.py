"""Single-token GQA attention over int8 KV codes (kernel K2).

The port's decode attention for half-precision configs: one launch per layer
in place of the dozen-odd launches of the staged chain
(:func:`~tpu_bitsandbytes_torch.models.layers.gqa_attention_kv_quant`). It
computes what the JAX package's Pallas flash-decode kernel computes: q and
the v-scale-folded probabilities are quantized to int8 per row, both
contractions are exact int32 dots, and the chunk's staged KV block joins
the main span under one shared softmax (see ``csrc/flash_decode.cu``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["flash_decode_attention", "flash_decode_plain", "cluster_size",
           "SMEM_LIMIT"]

SMEM_LIMIT = 232448          # bytes of shared memory one CTA may use
_DUMMY_C = 8                 # staged keys the unstaged call masks out
_MAX_KEYS = (2 ** 31 - 1) // (127 * 127)   # keys an int32 PV sum holds


def _127_over(t: torch.Tensor) -> torch.Tensor:
    """127 / t as one f32 division (``127.0 / t`` in PyTorch multiplies
    by the reciprocal, which can round differently)."""
    return torch.full_like(t, 127.0) / t


def flash_decode_plain(q, k_q, k_scale, v_q, v_scale, off, st_k, st_ks, st_v,
                       st_vs, step: int, *, scale: float,
                       window: Optional[int], kpos_start: int,
                       softcap: Optional[float]) -> torch.Tensor:
    """Plain PyTorch version of K2, step for step the TPU kernel's
    arithmetic; returns f32 [B, H, D]. The dots run in float64, where they
    are exact for any cache length. Counts its calls on CUDA tensors in
    ``flash_decode_plain.cuda_calls``."""
    if q.is_cuda:
        flash_decode_plain.cuda_calls += 1
    b, h, d = q.shape
    h_kv, t = k_q.shape[1], k_q.shape[2]
    c = st_k.shape[2]
    rep = h // h_kv
    dev = q.device
    qf = q.to(torch.float32).reshape(b, h_kv, rep, d)
    q_s = qf.abs().amax(dim=-1, keepdim=True) + 1e-9
    q_i8 = torch.clamp(torch.round(qf * _127_over(q_s)), -127, 127)
    lg_scale = q_s * (scale / (127.0 * 127.0))

    def qk(kq):
        return torch.einsum("bhrd,bhtd->bhrt", q_i8.double(),
                            kq.double()).to(torch.float32)

    lg = qk(k_q) * lg_scale * k_scale[:, :, None, :]
    if softcap is not None:
        lg = torch.tanh(lg / softcap) * softcap
    kpos = kpos_start + torch.arange(t, device=dev)[None, :]
    keep = kpos <= off[:, None] - step - 1                     # [B, T]
    if window is not None:
        keep &= kpos > off[:, None] - window
    lg = torch.where(keep[:, None, None, :], lg, torch.full_like(lg, -1e30))

    lg_st = qk(st_k) * lg_scale * st_ks[:, :, None, :]
    if softcap is not None:
        lg_st = torch.tanh(lg_st / softcap) * softcap
    jst = torch.arange(c, device=dev)
    keep_st = jst <= step
    if window is not None:
        keep_st &= jst > step - window
    lg_st = torch.where(keep_st, lg_st, torch.full_like(lg_st, -1e30))

    m = torch.maximum(lg.amax(dim=-1, keepdim=True),
                      lg_st.amax(dim=-1, keepdim=True))
    p = torch.exp(lg - m)
    p_st = torch.exp(lg_st - m)
    l = p.sum(dim=-1, keepdim=True) + p_st.sum(dim=-1, keepdim=True)

    def pv_codes(pp, vs):
        pv = pp * vs[:, :, None, :]
        s_p = pv.amax(dim=-1, keepdim=True) + 1e-30
        return torch.clamp(torch.round(pv * _127_over(s_p)), 0, 127), s_p

    pv_i8, s_p = pv_codes(p, v_scale)
    pvs_i8, s_ps = pv_codes(p_st, st_vs)

    def pv_dot(codes, vq):
        return torch.einsum("bhrt,bhtd->bhrd", codes.double(),
                            vq.double()).to(torch.float32)

    out = pv_dot(pv_i8, v_q) * s_p
    out = out + pv_dot(pvs_i8, st_v) * s_ps
    out = out / (l * (127.0 * 127.0))
    return out.reshape(b, h, d)


_build.counter(flash_decode_plain, "cuda_calls")


_LIB = {}


def _launcher():
    if not _LIB:
        lib = _build.library("flash_decode")
        fn = lib.tbnb_flash_decode
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.tbnb_flash_decode_smem.argtypes = [ctypes.c_int] * 5
        lib.tbnb_flash_decode_smem.restype = ctypes.c_longlong
        lib.tbnb_flash_decode_plan.argtypes = [ctypes.c_int] * 6
        lib.tbnb_flash_decode_plan.restype = ctypes.c_int
        _LIB.update(launch=fn, smem=lib.tbnb_flash_decode_smem,
                    plan=lib.tbnb_flash_decode_plan)
    return _LIB["launch"], _LIB["smem"], _LIB["plan"]


# (rep, T, C, D, B, H_kv, device) -> CTAs per cluster
_CLUSTER = {}


def cluster_size(rep: int, t: int, c: int, d: int, b: int, h_kv: int,
                 device) -> int:
    """CTAs per (slot, kv head) for this shape on ``device`` (the kernel's
    ``tbnb_flash_decode_plan``): up to one per 256 keys of the span, at most
    8, as long as all B x H_kv clusters fit on the card at once. A function
    of the shape alone, so the host reads nothing back and one CUDA graph
    serves every step."""
    key = (rep, t, c, d, b, h_kv, device)
    s = _CLUSTER.get(key)
    if s is None:
        with torch.cuda.device(device):
            s = _CLUSTER[key] = _launcher()[2](rep, t, c, d, b, h_kv)
    return s


def _check_kv(codes, scales, what):
    if codes.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"flash_decode: {what} codes must be int8 and "
                        "scales f32")
    if codes.stride(3) != 1 or codes.data_ptr() % 16 or any(
            s % 16 for s in codes.stride()[:3]):
        raise ValueError(f"flash_decode: {what} codes need a contiguous, "
                         "16-byte aligned last axis and 16-byte strides")


_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _kernel(q, k_q, k_scale, v_q, v_scale, off, st_k, st_ks, st_v, st_vs,
            step: int, *, scale, window, kpos_start, softcap):
    b, h, d = q.shape
    h_kv, t = k_q.shape[1], k_q.shape[2]
    c = st_k.shape[2]
    rep = h // h_kv
    if h % h_kv or not 1 <= rep <= 8:
        raise NotImplementedError(f"flash_decode: {h} heads over {h_kv} kv "
                                  "heads (rep 1..8 supported)")
    if d < 16 or d > 512 or d & (d - 1):
        raise NotImplementedError(f"flash_decode: head_dim {d} (powers of "
                                  "two in [16, 512] supported)")
    if max(t, c) > _MAX_KEYS:
        raise NotImplementedError(f"flash_decode: {max(t, c)} keys in a "
                                  f"block overflow its int32 PV sums (at "
                                  f"most {_MAX_KEYS})")
    dev = q.device
    tensors = (k_q, k_scale, v_q, v_scale, off, st_k, st_ks, st_v, st_vs)
    if not all(x.is_cuda and x.device == dev for x in tensors):
        raise ValueError("flash_decode: all operands must be on q's device")
    _check_kv(k_q, k_scale, "main")
    _check_kv(st_k, st_ks, "staged")
    if (v_q.stride() != k_q.stride() or v_scale.stride() != k_scale.stride()
            or st_v.stride() != st_k.stride()
            or st_vs.stride() != st_ks.stride()
            or v_q.shape != k_q.shape or st_v.shape != st_k.shape):
        raise ValueError("flash_decode: k and v must share shapes and strides")
    if off.dtype != torch.int32 or off.shape != (b,):
        raise TypeError("flash_decode: off must be int32 [B]")
    fn, smem_fn, _ = _launcher()
    s = cluster_size(rep, t, c, d, b, h_kv, dev)
    smem = smem_fn(rep, t, c, d, s)
    if smem > SMEM_LIMIT:
        raise NotImplementedError(
            f"flash_decode: {t + c} keys x {rep} heads over {s} CTAs need "
            f"{smem} bytes of shared memory per CTA (limit {SMEM_LIMIT})")
    if q.dtype not in _Q_DTYPES:
        q = q.to(torch.float32)
    if q.stride(2) != 1:
        q = q.contiguous()
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    err = fn(q.data_ptr(), q.stride(0), q.stride(1), _Q_DTYPES[q.dtype],
             k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
             v_scale.data_ptr(), st_k.data_ptr(), st_ks.data_ptr(),
             st_v.data_ptr(), st_vs.data_ptr(), off.data_ptr(),
             out.data_ptr(), b, h_kv, rep, t, c, d, s,
             *k_q.stride()[:3], *k_scale.stride(), *st_k.stride()[:3],
             *st_ks.stride(), int(step), int(kpos_start),
             0 if window is None else int(window),
             0.0 if softcap is None else float(softcap),
             scale / (127.0 * 127.0),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_decode")
    flash_decode_attention.launches += 1
    return out


# (device, B, H_kv, D) -> the fully masked staged block of the unstaged call
_DUMMY = {}


def _dummy_stage(b: int, h_kv: int, d: int, device):
    key = (device, b, h_kv, d)
    blk = _DUMMY.get(key)
    if blk is None:
        stk = torch.zeros((b, h_kv, _DUMMY_C, d), dtype=torch.int8,
                          device=device)
        stks = torch.ones((b, h_kv, _DUMMY_C), dtype=torch.float32,
                          device=device)
        blk = _DUMMY[key] = (stk, stks, stk, stks, -1)
    return blk


def flash_decode_attention(q, k_q, k_scale, v_q, v_scale, off, *,
                           staged=None, scale: Optional[float] = None,
                           window: Optional[int] = None, kpos_start: int = 0,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Fused single-token attention over int8 KV.

    q [B, H, D] (any float dtype); k_q/v_q int8 [B, H_kv, T, D] (any
    strides with a contiguous last axis, such as the cache's span view);
    k_scale/v_scale f32 [B, H_kv, T] absmax scales; ``off`` int32 [B], each
    slot's query position. ``staged``: ``(st_k, st_ks, st_v, st_vs, step)``
    from ``KVCache.read_stage`` with ``step`` a Python int, or None for the
    plain decode step (``step = -1`` over a fully masked dummy block, as in
    the TPU kernel). Returns f32 [B, H, D].

    CUDA tensors launch kernel K2 (counted in
    ``flash_decode_attention.launches``); CPU tensors take
    :func:`flash_decode_plain`. Neither has a backward pass, as the TPU
    kernel has none: with grad mode on, a q that requires grad raises.
    """
    _build.refuse_grad("flash_decode_attention", q)
    b, _, d = q.shape
    h_kv = k_q.shape[1]
    if scale is None:
        scale = 1.0 / d ** 0.5
    if staged is None:
        staged = _dummy_stage(b, h_kv, d, q.device)
    st_k, st_ks, st_v, st_vs, step = staged
    fn = _kernel if q.is_cuda else flash_decode_plain
    return fn(q, k_q, k_scale, v_q, v_scale, off, st_k, st_ks, st_v, st_vs,
              int(step), scale=float(scale), window=window,
              kpos_start=kpos_start, softcap=softcap)


_build.counter(flash_decode_attention, "launches")
