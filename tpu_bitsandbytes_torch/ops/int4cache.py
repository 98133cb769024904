"""int4 runtime execution cache and its decode matmul (kernel K1).

The int4 cache requantizes a dequantized NF4 weight to symmetric int4 per
(row, 128-block): ``w ~= q * scale`` with q in [-7, 7]. Torch has no int4
dtype, so the cache is two's-complement nibbles, two per byte with element
2j in the low nibble: ``[N, K_pad/2]`` uint8, and f32 scales ``[nb, N]``.
Unlike the JAX package's cache it carries no N padding.

:func:`int4_matmul` keeps the JAX package's arithmetic: decode-shaped calls
quantize the activations to int8 per row (A8) and run kernel K1
(``csrc/int4_matmul.cu``); every other call dequantizes the weight to x's
dtype and runs one f32-accumulated product. The two branches give different
numbers (the second does no A8 quantization), so the port takes the branch
the JAX package takes for every shape (:func:`takes_kernel`). The kernel
branch differentiates in x through :class:`Int4MatmulFn`, the JAX package's
straight-through rule: the A8 quantization stays inside the boundary and
d_x is the f32 cotangent times the dequantized weight.

In the second branch a bf16 x on a card that records no gradient takes the
tensor cores: :func:`dequant_int4_bf16` (``csrc/int4_dequant.cu``) decodes
the cache to bf16 and :func:`~.dot.dot_f32` runs one bf16 GEMM that
writes f32, the JAX package's bf16 x bf16 dot with f32 accumulation. Every other input
(CPU tensors, an f32 or f16 x, an x that records a gradient) widens both
operands to f32, which for a bf16 x computes the same exact products: a
product of two bf16 values is exact in f32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..functional import div_exact, pack_nibbles, unpack_nibbles
from . import _build
from .dot import dot_f32
from .w4a8 import quantize_a8

__all__ = ["INT4_BLOCK", "Int4MatmulFn", "quantize_int4", "dequant_int4",
           "dequant_int4_bf16", "unpack_int4", "int4_matmul", "int4_mm",
           "int4_mm_plain", "takes_kernel"]

INT4_BLOCK = 128
_MAX_M = 64


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def quantize_int4(w: torch.Tensor, blocksize: int = INT4_BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [N, K] float -> (packed codes uint8 [N, K_pad/2], scales f32
    [K_pad/blocksize, N]). K pads with zeros, whose codes contribute
    nothing."""
    n, k = w.shape
    kp = _round_up(k, blocksize)
    w32 = w.to(torch.float32)
    if kp != k:
        w32 = torch.nn.functional.pad(w32, (0, kp - k))
    wb = w32.reshape(n, kp // blocksize, blocksize)
    amax = wb.abs().amax(dim=-1)
    s = div_exact(amax.clamp(min=1e-8), 7.0)
    q = torch.clamp(torch.round(wb / s[:, :, None]), -7, 7).to(torch.int8)
    return pack_nibbles(q.reshape(n, kp) & 0x0F), s.t().contiguous()


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[N, K_pad/2] nibble pairs -> int8 codes [N, K_pad]."""
    u = unpack_nibbles(packed).to(torch.int8)
    return torch.where(u > 7, u - 16, u)


def dequant_int4(packed: torch.Tensor, scales: torch.Tensor,
                 blocksize: Optional[int] = None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[N, K_pad/2] packed + [nb, N] scales -> [N, K_pad] ``dtype``."""
    n = packed.shape[0]
    kp = packed.shape[1] * 2
    nb = scales.shape[0]
    if blocksize is not None and kp // blocksize != nb:
        raise ValueError(f"blocksize {blocksize} does not match {nb} scale "
                         f"blocks over K_pad {kp}")
    w = unpack_int4(packed).to(torch.float32).reshape(n, nb, kp // nb)
    return (w * scales.t()[:, :, None]).reshape(n, kp).to(dtype)


def _jax_tile(kp: int) -> int:
    """The grid tile the JAX package pads N to (its TPU VMEM sizing).
    Kept only because it decides which branch the JAX package takes."""
    t = min(2048, max(128, (12 * 2 ** 20) // max(1, (kp * 3) // 2)))
    return (t // 128) * 128


def takes_kernel(m: int, n: int, kp: int, blocksize: int) -> bool:
    """True where the JAX package's ``int4_matmul`` runs its A8 kernel for
    an int4 cache of N rows (before its N padding) and K_pad columns: M at
    most 64, K_pad a multiple of the block and of 128, and N either a
    multiple of 128 or at least the tile it pads N to."""
    return (m <= _MAX_M and kp % blocksize == 0 and kp % 128 == 0
            and (n % 128 == 0 or n >= _jax_tile(kp)))


def int4_mm_plain(xq: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
                  s_x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: ``s_x[m] * sum_b scale[b, n] *
    dot(xq[m, blk b], w[n, blk b])``. The block dots are exact in f32
    (|sum| <= 127 * 7 * 1024 < 2**24 for blocks up to 1024); the f32 block
    sum runs in the TPU kernel's order. Counts its calls on CUDA tensors in
    ``int4_mm_plain.cuda_calls``."""
    if xq.is_cuda:
        int4_mm_plain.cuda_calls += 1
    m, kp = xq.shape
    n = w.shape[0]
    nb = scales.shape[0]
    bs = kp // nb
    xb = xq.to(torch.float32).reshape(m, nb, bs)
    wb = unpack_int4(w).to(torch.float32).reshape(n, nb, bs)
    p = torch.einsum("mbk,nbk->bmn", xb, wb)
    acc = torch.zeros((m, n), dtype=torch.float32, device=xq.device)
    for b in range(nb):
        acc = acc + p[b] * scales[b][None, :]
    return acc * s_x[:, None]


_build.counter(int4_mm_plain, "cuda_calls")


_LIB = {}


def _launcher():
    if "launch" not in _LIB:
        lib = _build.library("int4_matmul")
        fn, plan = lib.tbnb_int4_matmul, lib.tbnb_int4_plan
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        plan.restype = None
        _LIB.update(launch=fn, plan=plan)
    return _LIB["launch"], _LIB["plan"]


def int4_mm(xq: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
            s_x: torch.Tensor) -> torch.Tensor:
    """K1: xq int8 [M, K_pad], w packed [N, K_pad/2], scales f32 [nb, N],
    s_x f32 [M] -> f32 [M, N]. CUDA tensors launch the kernel (counted in
    ``int4_mm.launches``); CPU tensors take :func:`int4_mm_plain`."""
    _build.refuse_grad("int4_mm", xq, s_x)
    if not xq.is_cuda:
        return int4_mm_plain(xq, w, scales, s_x)
    m, kp = xq.shape
    n = w.shape[0]
    nb = scales.shape[0]
    bs = kp // nb
    if not (xq.dtype == torch.int8 and w.dtype == torch.uint8
            and scales.dtype == torch.float32 and s_x.dtype == torch.float32):
        raise TypeError("int4_mm: expected int8 x, uint8 w, f32 scales/s_x")
    if (w.shape != (n, kp // 2) or scales.shape != (nb, n)
            or s_x.shape != (m,) or nb * bs != kp
            or bs < 32 or bs > 1024 or bs & (bs - 1)):
        raise ValueError(f"int4_mm: bad shapes x {tuple(xq.shape)} w "
                         f"{tuple(w.shape)} scales {tuple(scales.shape)}")
    if not all(t.is_cuda and t.device == xq.device and t.is_contiguous()
               for t in (xq, w, scales, s_x)):
        raise ValueError("int4_mm: all operands must be contiguous tensors "
                         "on one CUDA device")
    if xq.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("int4_mm: x and the packed codes must start on a "
                         "16-byte boundary (the kernel copies 16 bytes at a "
                         "time)")
    launch, plan = _launcher()
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    cps, part, counts, stream = _build.split_plan(plan, m, n, kp, bs,
                                                  xq.device)
    err = launch(xq.data_ptr(), w.data_ptr(), scales.data_ptr(),
                 s_x.data_ptr(), out.data_ptr(), part.data_ptr(),
                 counts.data_ptr(), m, n, kp, bs, cps, stream)
    _build.check(err, "int4_matmul")
    int4_mm.launches += 1
    return out


_build.counter(int4_mm, "launches")


def dequant_int4_bf16(packed: torch.Tensor, scales: torch.Tensor
                      ) -> torch.Tensor:
    """[N, K_pad/2] packed + [nb, N] scales -> bf16 [N, K_pad], bit for bit
    ``dequant_int4(packed, scales, dtype=torch.bfloat16)``. CUDA tensors
    launch ``csrc/int4_dequant.cu`` (counted in
    ``dequant_int4_bf16.launches``; the block K_pad / nb a multiple of 8);
    CPU tensors take :func:`dequant_int4`."""
    if not packed.is_cuda:
        return dequant_int4(packed, scales, dtype=torch.bfloat16)
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError("dequant_int4_bf16: expected uint8 codes and f32 "
                        "scales")
    if packed.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"dequant_int4_bf16: bad ranks codes "
                         f"{tuple(packed.shape)} scales {tuple(scales.shape)}")
    (n, half), nb = packed.shape, scales.shape[0]
    kp = half * 2
    if (scales.shape != (nb, n) or nb < 1 or kp % nb or (kp // nb) % 8):
        raise ValueError(f"dequant_int4_bf16: bad shapes codes "
                         f"{tuple(packed.shape)} scales {tuple(scales.shape)}")
    if not (scales.is_cuda and scales.device == packed.device
            and packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequant_int4_bf16: codes and scales must be "
                         "contiguous tensors on one CUDA device")
    if packed.data_ptr() % 4:
        raise ValueError("dequant_int4_bf16: the codes must start on a "
                         "4-byte boundary (the kernel loads 4 bytes at a "
                         "time)")
    if "dequant" not in _LIB:
        fn = _build.library("int4_dequant").tbnb_int4_dequant_bf16
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB["dequant"] = fn
    out = torch.empty((n, kp), dtype=torch.bfloat16, device=packed.device)
    err = _LIB["dequant"](packed.data_ptr(), scales.data_ptr(),
                          out.data_ptr(), n, kp, kp // nb,
                          torch.cuda.current_stream(packed.device).cuda_stream)
    _build.check(err, "int4_dequant")
    dequant_int4_bf16.launches += 1
    return out


_build.counter(dequant_int4_bf16, "launches")


def _a8_int4_mm(x, w, scales, group=None):
    """x [M, K_pad] -> f32 [M, N]: A8 (:func:`~.w4a8.quantize_a8`, its row
    scale all-reduced over ``group`` on a row-parallel shard), then K1."""
    xq, s_x = quantize_a8(x, x.shape[1], group)
    return int4_mm(xq, w, scales, s_x)


class Int4MatmulFn(torch.autograd.Function):
    """x [M, K_pad] -> f32 [M, N] through A8 and :func:`int4_mm`, with the
    JAX package's backward rule (``ops/int4cache.py:_make_int4_mm``):
    ``d_x = (g in f32) @ dequant_int4(codes, scales)``, in x's dtype; the
    codes and scales get no gradient."""

    @staticmethod
    def forward(ctx, x, w, scales, blocksize):
        ctx.save_for_backward(w, scales)
        ctx.x_dtype, ctx.blocksize = x.dtype, blocksize
        return _a8_int4_mm(x, w, scales)

    @staticmethod
    def backward(ctx, g):
        w, scales = ctx.saved_tensors
        d_x = g.to(torch.float32) @ dequant_int4(w, scales, ctx.blocksize)
        return d_x.to(ctx.x_dtype), None, None, None


def int4_matmul(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor, *,
                blocksize: Optional[int] = None,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.bfloat16,
                n_out: Optional[int] = None,
                xmax_group=None) -> torch.Tensor:
    """``x [M, K] @ (codes * scales).T`` over the packed int4 cache.

    Where the JAX package runs its kernel (:func:`takes_kernel`), x is
    quantized per row to int8 (``s_x = rowmax|x| / 127``, round half to
    even, clip to +-127) and K1 computes the product; elsewhere the weight
    is dequantized to x's dtype and multiplied with f32 accumulation: for
    a bf16 x on a card that records no gradient, :func:`dequant_int4_bf16`
    and one bf16 GEMM with an f32 output on the tensor cores; for every
    other x (on the CPU, f32 or f16, or recording a gradient), both
    operands widened to f32.
    ``blocksize`` defaults to what the scales' shape implies; ``n_out``
    keeps the first ``n_out`` output columns. ``xmax_group``: on a
    row-parallel shard, the tensor-parallel group over which the A8 row
    scale is all-reduced to its maximum (the JAX package's
    ``xmax_axis``), so the shard's int8 codes are the unsharded row's.
    """
    m, k = x.shape
    n = w.shape[0]
    kp = w.shape[1] * 2
    if blocksize is None:
        blocksize = kp // scales.shape[0]
    if kp != k:
        x = torch.nn.functional.pad(x, (0, kp - k))
    if takes_kernel(m, n, kp, blocksize):
        if _build.records_grad(x):
            if xmax_group is not None:
                raise NotImplementedError(
                    "int4_matmul: no backward on a row-parallel shard")
            out = Int4MatmulFn.apply(x, w, scales, blocksize)
        else:
            out = _a8_int4_mm(x, w, scales, xmax_group)
    elif (x.is_cuda and x.dtype == torch.bfloat16
          and not _build.records_grad(x)):
        # bf16 products are exact in f32: the widened product's numbers,
        # on the tensor cores (dot_f32's GEMM has no derivative)
        out = dot_f32(x, dequant_int4_bf16(w, scales))
    else:
        wd = dequant_int4(w, scales, blocksize, dtype=x.dtype)
        out = x.to(torch.float32) @ wd.to(torch.float32).t()
    if n_out is not None and n_out != n:
        out = out[:, :n_out]
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.to(out_dtype)
