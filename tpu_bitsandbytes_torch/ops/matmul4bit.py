"""Fused NF4/FP4 dequant-matmul for M up to 256 (kernel K5).

What the JAX package's fused Pallas matmul computes: each 4-bit code
dequantizes to ``codebook[code] * absmax[n, k // blocksize]`` in f32; in
bf16 mode that weight is rounded to bf16 and x goes to bf16, in f32 mode
both stay f32; the products accumulate in f32 and the result is cast to the
state's dtype. The dequantized weight never reaches device memory.

The TPU kernel broadcasts absmax across its lanes with a 0/1 matmul (a
lane-layout workaround); the port multiplies by absmax directly, which is
what that matmul computes. Gradients flow to x only, through
:class:`Fused4bitFn`, by the JAX package's backward rule: d_x is the
f32 cotangent times the dequantized f32 weight, in x's dtype; the codes
and absmax are frozen.

On the card, bf16 mode at the shapes :func:`takes_wgmma` admits (every
Llama width) runs the wgmma kernel, which decodes each code once per CTA
whatever M is; the other bf16 shapes run the 64 x 64-tile ``mma.sync``
kernel, and f32 mode its own kernel (:func:`kernel_of`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..functional import QuantState, _pad_k, codebook, dequantize_blockwise
from . import _build

__all__ = ["Fused4bitFn", "dequant_weight", "fused_matmul_4bit",
           "kernel_of", "matmul4bit_mm", "matmul4bit_plain", "takes_wgmma"]

MODES = ("bf16", "f32")
_WGMMA_MAX_M = 256


def takes_wgmma(m: int, n: int, k_pad: int, blocksize: int) -> bool:
    """True where bf16 mode runs the wgmma kernel: 1 <= M <= 256 (the
    tokens are one wgmma's N), ``K_pad / 2`` a multiple of 16 bytes (the
    stride of the codes' TMA map) and one absmax per row and 16-code slice
    (``blocksize % 16 == 0``). Every Llama-2 7B/13B matmul meets it. On
    the card the kernel's plan (``tbnb_matmul4bit_plan``) routes; this is
    the same rule, stated where the CPU can test it."""
    return (1 <= m <= _WGMMA_MAX_M and n >= 1 and k_pad % 32 == 0
            and blocksize >= 16 and blocksize % 16 == 0
            and k_pad % blocksize == 0)


def kernel_of(m: int, n: int, k_pad: int, blocksize: int, mode: str) -> str:
    """The kernel a CUDA call of :func:`matmul4bit_mm` launches: "wgmma"
    (bf16 where :func:`takes_wgmma` holds), "bf16" (the other bf16 shapes)
    or "f32"."""
    if mode == "f32":
        return "f32"
    return "wgmma" if takes_wgmma(m, n, k_pad, blocksize) else "bf16"


@functools.lru_cache(maxsize=None)
def _book(quant_type: str, device: torch.device) -> torch.Tensor:
    return codebook(quant_type, device)


def matmul4bit_plain(x: torch.Tensor, packed: torch.Tensor,
                     absmax: torch.Tensor, book: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """Plain PyTorch version of K5: ``x_even @ vlo.T + x_odd @ vhi.T`` in
    f32 over the dequantized even/odd planes (rounded to bf16 in bf16
    mode, with x in bf16). Returns f32 [M, N]. Counts its calls on CUDA
    tensors in ``matmul4bit_plain.cuda_calls``."""
    if x.is_cuda:
        matmul4bit_plain.cuda_calls += 1
    n, nb = absmax.shape
    bs2 = packed.shape[1] // nb
    scale = absmax.to(torch.float32).repeat_interleave(bs2, dim=1)
    vlo = book[(packed & 0x0F).long()] * scale
    vhi = book[(packed >> 4).long()] * scale
    xf = x
    if mode == "bf16":
        vlo, vhi = vlo.to(torch.bfloat16), vhi.to(torch.bfloat16)
        xf = x.to(torch.bfloat16)
    f32 = torch.float32
    return (xf[:, 0::2].to(f32) @ vlo.to(f32).t()
            + xf[:, 1::2].to(f32) @ vhi.to(f32).t())


_build.counter(matmul4bit_plain, "cuda_calls")


_LIB = {}


def _launchers():
    """(the 64 x 64-tile launch, the wgmma launch, the wgmma plan)."""
    if not _LIB:
        lib = _build.library("matmul4bit")
        tile, wgmma, plan = (lib.tbnb_matmul4bit, lib.tbnb_matmul4bit_wgmma,
                             lib.tbnb_matmul4bit_plan)
        tile.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
        tile.restype = ctypes.c_int
        wgmma.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                          + [ctypes.c_void_p])
        wgmma.restype = ctypes.c_int
        plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        plan.restype = None
        _LIB.update(tile=tile, wgmma=wgmma, plan=plan)
    return _LIB["tile"], _LIB["wgmma"], _LIB["plan"]


def matmul4bit_mm(x: torch.Tensor, packed: torch.Tensor,
                  absmax: torch.Tensor, book: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """K5: x [M, K_pad] (bf16 in "bf16" mode, f32 in "f32" mode), packed
    uint8 [N, K_pad/2] (element 2j in the low nibble), absmax f32 [N, nb],
    book f32 [16] -> f32 [M, N]. CUDA tensors launch the kernel
    :func:`kernel_of` names (counted in ``matmul4bit_mm.launches``, the
    wgmma kernel's also in ``matmul4bit_mm.wgmma_launches``); CPU tensors
    take :func:`matmul4bit_plain`."""
    if mode not in MODES:
        raise ValueError(f"matmul4bit_mm: mode must be one of {MODES}")
    _build.refuse_grad("matmul4bit_mm", x)
    if not x.is_cuda:
        return matmul4bit_plain(x, packed, absmax, book, mode)
    m, kp = x.shape
    n, nb = absmax.shape
    bs = kp // max(nb, 1)
    want = torch.bfloat16 if mode == "bf16" else torch.float32
    if not (x.dtype == want and packed.dtype == torch.uint8
            and absmax.dtype == torch.float32 and book.dtype == torch.float32):
        raise TypeError(f"matmul4bit_mm: expected {want} x in {mode} mode, "
                        "uint8 packed, f32 absmax and codebook")
    if (packed.shape != (n, kp // 2) or nb * bs != kp or bs < 2 or bs % 2
            or book.shape != (16,)):
        raise ValueError(f"matmul4bit_mm: bad shapes x {tuple(x.shape)} "
                         f"packed {tuple(packed.shape)} absmax "
                         f"{tuple(absmax.shape)}")
    if not all(t.is_cuda and t.device == x.device and t.is_contiguous()
               for t in (x, packed, absmax, book)):
        raise ValueError("matmul4bit_mm: all operands must be contiguous "
                         "tensors on one CUDA device")
    tile, wgmma, plan = _launchers()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    # the wgmma kernel's own rule routes: its plan has no stages per split
    # for a shape it does not take (takes_wgmma states the same rule)
    on_wgmma = mode == "bf16" and _build.plan_of(plan, m, n, kp, bs,
                                                 x.device)[0] > 0
    if on_wgmma:
        if x.data_ptr() % 16 or packed.data_ptr() % 16:
            raise ValueError("matmul4bit_mm: x and the packed codes must "
                             "start on a 16-byte boundary (the kernel reads "
                             "them by TMA)")
        cps, part, counts, stream = _build.split_plan(plan, m, n, kp, bs,
                                                      x.device)
        err = wgmma(x.data_ptr(), packed.data_ptr(), absmax.data_ptr(),
                    book.data_ptr(), out.data_ptr(), part.data_ptr(),
                    counts.data_ptr(), m, n, kp, bs, cps, stream)
    else:
        err = tile(x.data_ptr(), packed.data_ptr(), absmax.data_ptr(),
                   book.data_ptr(), out.data_ptr(), m, n, kp, bs,
                   1 if mode == "bf16" else 0,
                   torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "matmul4bit")
    matmul4bit_mm.launches += 1
    matmul4bit_mm.wgmma_launches += on_wgmma
    return out


_build.counter(matmul4bit_mm, "launches", "wgmma_launches")


def dequant_weight(packed: torch.Tensor, absmax: torch.Tensor,
                   book: torch.Tensor) -> torch.Tensor:
    """The f32 weight [N, K_pad] the codes stand for: ``book[code] *
    absmax[n, k // blocksize]`` (element 2j in the low nibble)."""
    n, nb = absmax.shape
    scale = absmax.to(torch.float32).repeat_interleave(
        packed.shape[1] // nb, dim=1)
    vlo = book[(packed & 0x0F).long()] * scale
    vhi = book[(packed >> 4).long()] * scale
    return torch.stack([vlo, vhi], dim=-1).reshape(n, -1)


class Fused4bitFn(torch.autograd.Function):
    """:func:`matmul4bit_mm` with the JAX package's backward rule
    (``ops/matmul4bit.py:_make_fused_aligned``): ``d_x = (g in f32) @ W``
    with W the dequantized f32 weight, cast to x's dtype; the packed codes,
    absmax and codebook get no gradient."""

    @staticmethod
    def forward(ctx, x, packed, absmax, book, mode):
        ctx.save_for_backward(packed, absmax, book)
        ctx.x_dtype = x.dtype
        return matmul4bit_mm(x, packed, absmax, book, mode)

    @staticmethod
    def backward(ctx, g):
        packed, absmax, book = ctx.saved_tensors
        d_x = g.to(torch.float32) @ dequant_weight(packed, absmax, book)
        return d_x.to(ctx.x_dtype), None, None, None, None


def fused_matmul_4bit(x: torch.Tensor, packed_flat: torch.Tensor,
                      quant_state: QuantState, *,
                      mxu_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x [M, K] @ dequant(W [N, K]).T`` with W packed 4-bit (flat uint8).

    ``mxu_dtype`` bf16 rounds the dequantized weight and x to bf16; f32
    keeps both exact. Double-quantized absmax is dequantized here. Returns
    ``quant_state.dtype``. Raises NotImplementedError for what the JAX
    package's kernel does not take: a state that is not 2-D, or an odd
    blocksize.
    """
    st = quant_state
    if len(st.shape) != 2:
        raise NotImplementedError("fused path requires a 2-D quant state")
    if st.blocksize < 2 or st.blocksize % 2:
        raise NotImplementedError("fused path requires an even blocksize "
                                  ">= 2")
    n, k = st.shape
    kp = _pad_k(k, st.blocksize)
    absmax = st.absmax
    if st.state2 is not None:
        absmax = dequantize_blockwise(absmax, st.state2)
    absmax = absmax.reshape(n, kp // st.blocksize).to(torch.float32)
    mode = "f32" if mxu_dtype == torch.float32 else "bf16"
    x = x.to(torch.float32 if mode == "f32" else torch.bfloat16)
    if kp != k:
        x = torch.nn.functional.pad(x, (0, kp - k))
    args = (x.contiguous(), packed_flat.reshape(n, kp // 2),
            absmax.contiguous(), _book(st.quant_type, x.device), mode)
    out = (Fused4bitFn.apply(*args) if _build.records_grad(x)
           else matmul4bit_mm(*args))
    return out.to(st.dtype)
