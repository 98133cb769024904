"""NF4/FP4 storage primitives and the 4-bit matmul in PyTorch.

The subset of the JAX package's ``functional.py`` that NF4 serving needs:
the codebooks, :class:`QuantState`, nibble packing, row-wise blockwise
4-bit quantization, the blockwise int8 quantizer used for double-quantized
absmax, and :func:`matmul_4bit`. Packed bytes and absmax follow the JAX package bit
for bit (same codebooks, same nearest-code tie-breaking, same padding rule),
so NF4 checkpoints move between the two packages unchanged.

Every function keeps its input's device. Only :func:`matmul_4bit` reaches
a hand kernel (K5, through ``ops/matmul4bit.py``); the rest run once, when
weights are built.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = [
    "NF4_VALUES", "FP4_VALUES", "QuantState", "codebook",
    "pack_nibbles", "unpack_nibbles",
    "quantize_4bit", "dequantize_4bit",
    "quantize_blockwise", "dequantize_blockwise", "matmul_4bit",
]

# 16 quantiles of N(0, 1) normalized to [-1, 1]; must stay bit-identical to
# the JAX package's codebook so packed checkpoints round-trip.
NF4_VALUES = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)

FP4_VALUES = (
    0.0, 0.0625, 0.125, 0.25, 0.375, 0.5, 0.75, 1.0,
    -0.0, -0.0625, -0.125, -0.25, -0.375, -0.5, -0.75, -1.0,
)


def codebook(quant_type: str, device) -> torch.Tensor:
    """The 16-entry f32 codebook of ``quant_type`` ("nf4" or "fp4")."""
    if quant_type == "nf4":
        values = NF4_VALUES
    elif quant_type == "fp4":
        values = FP4_VALUES
    else:
        raise ValueError(f"quant_type must be 'nf4' or 'fp4', got {quant_type}")
    return torch.tensor(values, dtype=torch.float32, device=device)


@dataclasses.dataclass
class QuantState:
    """What dequantizing a packed tensor needs: the per-block ``absmax``
    (or its int8 codes when ``state2`` holds the nested scales), the logical
    ``shape``, ``blocksize``, ``quant_type`` and the output ``dtype``."""

    absmax: torch.Tensor
    shape: Tuple[int, ...]
    blocksize: int = 64
    quant_type: str = "nf4"
    dtype: torch.dtype = torch.bfloat16
    state2: Optional["QuantState"] = None

    def __post_init__(self):
        self.shape = tuple(int(s) for s in self.shape)


def div_exact(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as one IEEE f32 division per element on every device.
    PyTorch's CUDA kernels multiply by the reciprocal of a Python-scalar
    divisor, which can differ from the quotient in the last bit and move a
    rounded code against the CPU and the JAX package."""
    return t / torch.full_like(t, c)


def _pad_k(k: int, blocksize: int) -> int:
    """K rounded up to a multiple of ``blocksize``, plus one block if that
    is odd (only possible for blocksize 1) so nibbles always pair up."""
    k_padded = ((k + blocksize - 1) // blocksize) * blocksize
    if k_padded % 2 != 0:
        k_padded += blocksize
    return k_padded


def _pad_flat(numel: int, blocksize: int) -> int:
    padded = ((numel + blocksize - 1) // blocksize) * blocksize
    if padded % 2 != 0:
        padded += blocksize
    return padded


def _validate_blocksize(blocksize: int, power_of_two: bool) -> None:
    if blocksize <= 0:
        raise ValueError(f"blocksize must be positive, got {blocksize}")
    if blocksize > 65536:
        raise ValueError(f"blocksize too large ({blocksize}), max is 65536")
    if power_of_two and (blocksize & (blocksize - 1)) != 0:
        raise ValueError(f"blocksize must be a power of 2, got {blocksize}")


def _nearest_code(x_norm: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    """Index of the nearest codebook entry; ties go to the lower index."""
    best_idx = torch.zeros(x_norm.shape, dtype=torch.uint8,
                           device=x_norm.device)
    best_diff = (x_norm - book[0]).abs()
    for i in range(1, book.shape[0]):
        diff = (x_norm - book[i]).abs()
        take = diff < best_diff
        best_idx = torch.where(take, torch.full_like(best_idx, i), best_idx)
        best_diff = torch.where(take, diff, best_diff)
    return best_idx


def pack_nibbles(idx: torch.Tensor) -> torch.Tensor:
    """Pack 4-bit codes along the last axis: element ``2j`` in the low
    nibble and ``2j+1`` in the high nibble of byte ``j``."""
    if idx.shape[-1] % 2 != 0:
        raise ValueError("last axis must be even to pack nibbles")
    pairs = idx.to(torch.uint8).reshape(*idx.shape[:-1], idx.shape[-1] // 2, 2)
    return pairs[..., 0] | (pairs[..., 1] << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles` (codes in 0..15, uint8)."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)


def quantize_4bit(A: torch.Tensor, blocksize: int = 64,
                  compress_statistics: bool = False,
                  quant_type: str = "nf4"
                  ) -> Tuple[torch.Tensor, QuantState]:
    """Blockwise NF4/FP4 quantization. 2D inputs quantize each row in its
    own blocks (K padded per :func:`_pad_k`); other ranks use one flat
    block sequence. Returns ``(packed uint8 [numel_padded/2], state)``;
    ``compress_statistics`` double-quantizes absmax in blocks of 256."""
    book = codebook(quant_type, A.device)
    _validate_blocksize(blocksize, power_of_two=True)
    a = A.to(torch.float32)
    if A.dim() == 2:
        n, k = A.shape
        kp = _pad_k(k, blocksize)
        padded = torch.zeros((n, kp), dtype=torch.float32, device=A.device)
        padded[:, :k] = a
        blocked = padded.reshape(n, kp // blocksize, blocksize)
        absmax = blocked.abs().amax(dim=2).clamp(min=1e-8)
        idx = _nearest_code(blocked / absmax[:, :, None], book)
        packed = pack_nibbles(idx.reshape(n, kp)).reshape(-1)
        absmax = absmax.reshape(-1)
    else:
        flat = a.reshape(-1)
        padded_numel = _pad_flat(flat.numel(), blocksize)
        padded = torch.zeros((padded_numel,), dtype=torch.float32,
                             device=A.device)
        padded[:flat.numel()] = flat
        blocked = padded.reshape(-1, blocksize)
        absmax = blocked.abs().amax(dim=1).clamp(min=1e-8)
        idx = _nearest_code(blocked / absmax[:, None], book)
        packed = pack_nibbles(idx.reshape(1, padded_numel)).reshape(-1)
    state2 = None
    if compress_statistics:
        absmax, state2 = quantize_blockwise(absmax, blocksize=256)
    return packed, QuantState(absmax=absmax, shape=tuple(A.shape),
                              blocksize=blocksize, quant_type=quant_type,
                              dtype=A.dtype, state2=state2)


def dequantize_4bit(A: torch.Tensor, quant_state: QuantState) -> torch.Tensor:
    """Packed 4-bit codes back to ``quant_state.dtype`` values."""
    st = quant_state
    absmax = st.absmax
    if st.state2 is not None:
        absmax = dequantize_blockwise(absmax, st.state2)
    book = codebook(st.quant_type, A.device)
    absmax = absmax.to(torch.float32)
    if len(st.shape) == 2:
        n, k = st.shape
        kp = _pad_k(k, st.blocksize)
        idx = unpack_nibbles(A.reshape(n, kp // 2))
        values = book[idx.long()].reshape(n, kp // st.blocksize, st.blocksize)
        values = values * absmax.reshape(n, -1)[:, :, None]
        return values.reshape(n, kp)[:, :k].to(st.dtype)
    numel = 1
    for s in st.shape:
        numel *= s
    idx = unpack_nibbles(A.reshape(1, -1)).reshape(-1)
    nblocks = absmax.numel()
    idx = idx[:nblocks * st.blocksize].reshape(nblocks, st.blocksize)
    values = book[idx.long()] * absmax[:, None]
    return values.reshape(-1)[:numel].reshape(st.shape).to(st.dtype)


def quantize_blockwise(A: torch.Tensor, blocksize: int = 4096
                       ) -> Tuple[torch.Tensor, QuantState]:
    """Blockwise symmetric int8 over the flattened tensor: codes
    ``round(a * 127 / absmax)`` and one f32 absmax per block."""
    _validate_blocksize(blocksize, power_of_two=False)
    flat = A.reshape(-1).to(torch.float32)
    numel = flat.numel()
    padded = torch.zeros((-(-numel // blocksize) * blocksize,),
                         dtype=torch.float32, device=A.device)
    padded[:numel] = flat
    blocked = padded.reshape(-1, blocksize)
    absmax = blocked.abs().amax(dim=1).clamp(min=1e-8)
    scale = torch.full_like(absmax, 127.0)[:, None] / absmax[:, None]
    q = torch.clamp(torch.round(blocked * scale), -127, 127).to(torch.int8)
    return q.reshape(-1)[:numel].reshape(A.shape), QuantState(
        absmax=absmax, shape=tuple(A.shape), blocksize=blocksize,
        quant_type="int8", dtype=A.dtype)


def dequantize_blockwise(A: torch.Tensor, quant_state: QuantState
                         ) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`."""
    st = quant_state
    flat = A.reshape(-1).to(torch.float32)
    numel = flat.numel()
    padded = torch.zeros((-(-numel // st.blocksize) * st.blocksize,),
                         dtype=torch.float32, device=A.device)
    padded[:numel] = flat
    blocked = padded.reshape(-1, st.blocksize)
    deq = blocked * div_exact(st.absmax.to(torch.float32)[:, None], 127.0)
    return deq.reshape(-1)[:numel].reshape(st.shape).to(st.dtype)


# M up to which the JAX package runs its fused kernel; above it, dequantize
# and one product
_FUSED_M_CROSSOVER = 256


def matmul_4bit(A: torch.Tensor, B: torch.Tensor, quant_state: QuantState,
                bias: Optional[torch.Tensor] = None,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``A @ dequant(B).T`` with B the packed flat uint8 of a 4-bit weight.

    The JAX package's dispatch: a 2-D state with an even blocksize at
    M <= 256 runs the fused dequant-matmul (kernel K5), in bf16 for half-precision
    ``compute_dtype`` and exact f32 otherwise; anything else dequantizes
    the weight to the state's dtype and multiplies. A is 1-D, 2-D, or of
    higher rank (flattened to rows and back). Returns ``compute_dtype``
    (default A's dtype).
    """
    from .ops.matmul4bit import fused_matmul_4bit  # it imports this module
    if compute_dtype is None:
        compute_dtype = A.dtype
    orig_shape = A.shape
    A2 = A.reshape(-1, A.shape[-1])
    bs = quant_state.blocksize
    if (len(quant_state.shape) == 2 and bs >= 2 and bs % 2 == 0
            and A2.shape[0] <= _FUSED_M_CROSSOVER):
        mxu = (torch.bfloat16 if compute_dtype in (torch.bfloat16,
                                                   torch.float16)
               else torch.float32)
        out = fused_matmul_4bit(A2, B, quant_state, mxu_dtype=mxu)
    else:
        weight = dequantize_4bit(B, quant_state)
        out = A2.to(weight.dtype) @ weight.t()
    if bias is not None:
        out = out + bias.to(out.dtype)
    if A.dim() > 2:
        out = out.reshape(*orig_shape[:-1], out.shape[-1])
    elif A.dim() == 1:
        out = out.reshape(out.shape[-1])
    return out.to(compute_dtype)
