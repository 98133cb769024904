"""Packed NF4 x A8 matmul at decode-sized M (kernel K4).

Serves a :class:`~tpu_bitsandbytes_torch.models.layers.QLinear4` that has no
runtime cache straight off its packed NF4 bytes, as the JAX package's W4A8
path does: the activations are quantized per row to int8 (A8), each 4-bit
code decodes to the int8 codebook ``round(NF4 * 127)`` (:data:`NF4_I8`), the
products inside one absmax block sum exactly in int32, each block sum is
scaled by ``absmax * (1/127)`` in f32, and the row scale multiplies last.

The branch rule is the JAX package's (:func:`takes_w4a8`): where it leaves
its kernel, ``QLinear4`` goes on to :func:`~tpu_bitsandbytes_torch.functional.matmul_4bit`,
which gives different numbers (no A8, the exact codebook). Gradients
flow to x through :class:`W4A8Fn`, the JAX package's straight-through
rule: the A8 quantization stays inside the boundary and d_x is the f32
cotangent times the weight the kernel decodes (int8 codebook / 127 times
absmax).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..functional import (NF4_VALUES, QuantState, _pad_k, div_exact,
                          dequantize_blockwise)
from . import _build
from .matmul4bit import dequant_weight

__all__ = ["NF4_I8", "W4A8Fn", "takes_w4a8", "quantize_a8",
           "w4a8_matmul_4bit", "w4a8_mm", "w4a8_mm_plain"]

# round(NF4 * 127) in f32, half to even: exact at the +-1 endpoints, the
# interior entries within 0.5/127 of the block absmax
NF4_I8 = tuple(int(v) for v in np.round(
    np.asarray(NF4_VALUES, np.float32) * 127.0))

_MAX_M = 64
_MAX_K2 = 8192


def takes_w4a8(m: int, n: int, k_pad: int, blocksize: int,
               quant_type: str) -> bool:
    """True where the JAX package's ``w4a8_matmul_4bit`` runs its kernel
    for an [M, K_pad] activation against a 2-D ``quant_type`` weight of N
    rows: NF4, M at most 64, and ``k2 = K_pad/2`` a multiple of 128 and of
    ``blocksize/2`` (at least 2), at most 8192, with N a multiple of 128.
    4-bit blocksizes are powers of two (``quantize_4bit``), so those it
    admits are multiples of 4, which K4 needs."""
    bs2 = blocksize // 2
    k2 = k_pad // 2
    return (quant_type == "nf4" and m <= _MAX_M and bs2 >= 2
            and k2 % bs2 == 0 and k2 <= _MAX_K2 and k2 % 128 == 0
            and n % 128 == 0)


def _table(device) -> torch.Tensor:
    return torch.tensor(NF4_I8, dtype=torch.float32, device=device)


def w4a8_mm_plain(xq: torch.Tensor, packed: torch.Tensor,
                  absmax: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4, in the TPU kernel's order: even/odd
    K planes, exact block dots (f32 while the block sum stays below 2**24,
    else f64), then ``acc += f32(pe + po) * (absmax * (1/127))`` block by
    block and ``* s_x`` last. Counts its calls on CUDA tensors in
    ``w4a8_mm_plain.cuda_calls``."""
    if xq.is_cuda:
        w4a8_mm_plain.cuda_calls += 1
    m, kp = xq.shape
    n, nb = absmax.shape
    bs2 = kp // nb // 2
    dot = torch.float32 if bs2 * 127 * 127 < 2 ** 24 else torch.float64
    table = _table(xq.device).to(dot)
    lo = table[(packed & 0x0F).long()].reshape(n, nb, bs2)
    hi = table[(packed >> 4).long()].reshape(n, nb, bs2)
    xe = xq[:, 0::2].to(dot).reshape(m, nb, bs2)
    xo = xq[:, 1::2].to(dot).reshape(m, nb, bs2)
    blk = (torch.einsum("mbk,nbk->bmn", xe, lo)
           + torch.einsum("mbk,nbk->bmn", xo, hi)).to(torch.float32)
    am = absmax.t().to(torch.float32) * (1.0 / 127.0)   # f32(1/127)
    acc = torch.zeros((m, n), dtype=torch.float32, device=xq.device)
    for b in range(nb):
        acc = acc + blk[b] * am[b][None, :]
    return acc * s_x[:, None]


_build.counter(w4a8_mm_plain, "cuda_calls")


_LIB = {}


def _launcher():
    if not _LIB:
        lib = _build.library("w4a8_matmul")
        fn, plan = lib.tbnb_w4a8_matmul, lib.tbnb_w4a8_plan
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_uint32] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        plan.restype = None
        _LIB.update(launch=fn, plan=plan)
    return _LIB["launch"], _LIB["plan"]


def _table_words():
    """NF4_I8 as four little-endian int8x4 words (entries 0-3, 4-7, ...)."""
    b = np.asarray(NF4_I8, np.int8).tobytes()
    return [int.from_bytes(b[i:i + 4], "little") for i in range(0, 16, 4)]


_TABLE_WORDS = _table_words()


def w4a8_mm(xq: torch.Tensor, packed: torch.Tensor, absmax: torch.Tensor,
            s_x: torch.Tensor) -> torch.Tensor:
    """K4: xq int8 [M, K_pad], packed uint8 [N, K_pad/2] (element 2j in the
    low nibble), absmax f32 [N, nb], s_x f32 [M] -> f32 [M, N]. CUDA
    tensors launch the kernel (counted in ``w4a8_mm.launches``); CPU
    tensors take :func:`w4a8_mm_plain`."""
    _build.refuse_grad("w4a8_mm", xq, s_x)
    if not xq.is_cuda:
        return w4a8_mm_plain(xq, packed, absmax, s_x)
    m, kp = xq.shape
    n, nb = absmax.shape
    bs = kp // max(nb, 1)
    if not (xq.dtype == torch.int8 and packed.dtype == torch.uint8
            and absmax.dtype == torch.float32 and s_x.dtype == torch.float32):
        raise TypeError("w4a8_mm: expected int8 x, uint8 packed, f32 "
                        "absmax/s_x")
    if (packed.shape != (n, kp // 2) or s_x.shape != (m,) or nb * bs != kp
            or kp % 32 or bs % 4):
        raise ValueError(f"w4a8_mm: bad shapes x {tuple(xq.shape)} packed "
                         f"{tuple(packed.shape)} absmax {tuple(absmax.shape)}"
                         " (K_pad must be a multiple of 32 and the block of "
                         "4)")
    if not all(t.is_cuda and t.device == xq.device and t.is_contiguous()
               for t in (xq, packed, absmax, s_x)):
        raise ValueError("w4a8_mm: all operands must be contiguous tensors "
                         "on one CUDA device")
    if xq.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("w4a8_mm: x and the packed codes must start on a "
                         "16-byte boundary (the kernel copies 16 bytes at "
                         "a time)")
    launch, plan = _launcher()
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    cps, part, counts, stream = _build.split_plan(plan, m, n, kp, bs,
                                                  xq.device)
    err = launch(xq.data_ptr(), packed.data_ptr(), absmax.data_ptr(),
                 s_x.data_ptr(), out.data_ptr(), part.data_ptr(),
                 counts.data_ptr(), m, n, kp, bs, cps, *_TABLE_WORDS, stream)
    _build.check(err, "w4a8_matmul")
    w4a8_mm.launches += 1
    return out


_build.counter(w4a8_mm, "launches")


def quantize_a8(x: torch.Tensor, k_pad: int, group=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A8 as the JAX package quantizes: ``s_x = max(rowmax|x| / 127,
    1e-12)`` (a true division), codes ``round(x / s_x)`` half to even,
    clipped to +-127. x [M, K] -> int8 codes [M, k_pad] (K zero-padded)
    and f32 s_x [M]. ``group``: a process group whose ranks each hold a
    slice of the rows' K (a row-parallel shard); ``rowmax|x| / 127`` is
    all-reduced to its maximum over it (the JAX package's ``pmax``), so
    every slice's codes are the unsharded row's."""
    x32 = x.to(torch.float32)
    if k_pad != x32.shape[1]:
        x32 = torch.nn.functional.pad(x32, (0, k_pad - x32.shape[1]))
    s_x = div_exact(x32.abs().amax(dim=1, keepdim=True), 127.0)
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(s_x, op=dist.ReduceOp.MAX, group=group)
    s_x = s_x.clamp(min=1e-12)
    xq = torch.clamp(torch.round(x32 / s_x), -127, 127).to(torch.int8)
    return xq, s_x[:, 0].contiguous()


def _a8_w4a8_mm(x, packed, absmax):
    """x [M, K] -> f32 [M, N]: :func:`quantize_a8`, then K4."""
    xq, s_x = quantize_a8(x, packed.shape[1] * 2)
    return w4a8_mm(xq, packed, absmax, s_x)


class W4A8Fn(torch.autograd.Function):
    """x [M, K] -> f32 [M, N] through :func:`quantize_a8` and
    :func:`w4a8_mm`, with the JAX package's backward rule
    (``ops/w4a8.py:_make_w4a8``): ``d_x = (g in f32) @ W`` with W the
    kernel's weight, ``NF4_I8 / 127`` (an f32 division) times absmax,
    cast to x's dtype; the codes and absmax get no gradient."""

    @staticmethod
    def forward(ctx, x, packed, absmax):
        ctx.save_for_backward(packed, absmax)
        ctx.x_dtype, ctx.k = x.dtype, x.shape[1]
        return _a8_w4a8_mm(x, packed, absmax)

    @staticmethod
    def backward(ctx, g):
        packed, absmax = ctx.saved_tensors
        w = dequant_weight(packed, absmax,
                           div_exact(_table(packed.device), 127.0))
        d_x = g.to(torch.float32) @ w[:, :ctx.k]
        return d_x.to(ctx.x_dtype), None, None


def w4a8_matmul_4bit(x: torch.Tensor, packed_flat: torch.Tensor,
                     quant_state: QuantState, *,
                     bias: Optional[torch.Tensor] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [M, K] @ dequant(W [N, K]).T`` off the packed NF4 bytes.

    The activations go through :func:`quantize_a8`. Double-quantized absmax
    is dequantized here, outside the kernel.
    Raises NotImplementedError where :func:`takes_w4a8` does not hold.
    """
    st = quant_state
    if len(st.shape) != 2:
        raise NotImplementedError("w4a8 path requires a 2-D quant state")
    n, k = st.shape
    kp = _pad_k(k, st.blocksize)
    m = x.shape[0]
    if not takes_w4a8(m, n, kp, st.blocksize, st.quant_type):
        raise NotImplementedError(
            f"no w4a8 kernel for M={m} N={n} K_pad={kp} "
            f"blocksize={st.blocksize} {st.quant_type}")
    absmax = st.absmax
    if st.state2 is not None:
        absmax = dequantize_blockwise(absmax, st.state2)
    absmax = absmax.reshape(n, kp // st.blocksize).to(torch.float32)
    args = (x, packed_flat.reshape(n, kp // 2), absmax.contiguous())
    out = (W4A8Fn.apply(*args) if _build.records_grad(x)
           else _a8_w4a8_mm(*args))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.to(out_dtype or st.dtype)
