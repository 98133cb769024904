"""Single-token GQA attention over int8 KV codes (kernel K2).

The port's decode attention for half-precision configs: one launch per layer
in place of the dozen-odd launches of the staged chain
(:func:`~tpu_bitsandbytes_torch.models.layers.gqa_attention_kv_quant`),
computing that chain's arithmetic (the JAX package's default decode
attention): f32 logits of q against the int8 codes, one softmax over the
main span and the chunk's staged block, the v-scale-folded probabilities
rounded to q's dtype for the PV product, f32 sums (see
``csrc/flash_decode.cu``). It takes the place of the JAX package's Pallas
flash-decode kernel, whose int8 probability codes lose the softmax's tail
at long context.
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
_HALF = (torch.bfloat16, torch.float16)


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as one f32 division per element (``t / 127.0`` in PyTorch's
    CUDA kernels multiplies by the reciprocal, which can round
    differently)."""
    return t / torch.full_like(t, 127.0)


def flash_decode_plain(q, k_q, k_scale, v_q, v_scale, off, st_k, st_ks, st_v,
                       st_vs, step: int, *, scale: float,
                       window: Optional[int], kpos_start: int,
                       softcap: Optional[float]) -> torch.Tensor:
    """Plain PyTorch version of K2: the staged chain's arithmetic in f32,
    the PV operand rounded to q's dtype when q is half precision; an
    unstaged call (``step`` -1 over a fully masked staged block) divides p
    by l before the rounding, as the chain's unstaged softmax does.
    Returns f32 [B, H, D]. Counts its calls on CUDA tensors in
    ``flash_decode_plain.cuda_calls``."""
    if q.is_cuda:
        flash_decode_plain.cuda_calls += 1
    f32 = torch.float32
    b, h, d = q.shape
    h_kv, t = k_q.shape[1], k_q.shape[2]
    c = st_k.shape[2]
    rep = h // h_kv
    dev = q.device
    qf = q.to(f32).reshape(b, h_kv, rep, d)

    def logits(kq, ks):
        lg = torch.einsum("bhrd,bhtd->bhrt", qf, kq.to(f32))
        lg = lg * (ks * (scale / 127.0))[:, :, None, :]
        return lg if softcap is None else torch.tanh(lg / softcap) * softcap

    kpos = kpos_start + torch.arange(t, device=dev)[None, :]
    keep = kpos <= off[:, None] - step - 1                     # [B, T]
    if window is not None:
        keep &= kpos > off[:, None] - window
    neg = torch.full((), -1e30, dtype=f32, device=dev)
    lg = torch.where(keep[:, None, None, :], logits(k_q, k_scale), neg)
    jst = torch.arange(c, device=dev)
    keep_st = jst <= step
    if window is not None:
        keep_st &= jst > step - window
    lg_st = torch.where(keep_st, logits(st_k, st_ks), neg)

    m = torch.maximum(lg.amax(dim=-1, keepdim=True),
                      lg_st.amax(dim=-1, keepdim=True))
    p = torch.exp(lg - m)
    p_st = torch.exp(lg_st - m)
    l = p.sum(dim=-1, keepdim=True) + p_st.sum(dim=-1, keepdim=True)

    norm = step < 0

    def pv(pp, vs, vq):
        x = (pp / l if norm else pp) * _div127(vs)[:, :, None, :]
        if q.dtype in _HALF:
            x = x.to(q.dtype).to(f32)
        return torch.einsum("bhrt,bhtd->bhrd", x, vq.to(f32))

    out = pv(p, v_scale, v_q) + pv(p_st, st_vs, st_v)
    return (out if norm else out / l).reshape(b, h, d)


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
             scale / 127.0,
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
