"""The bitsandbytes-style functional API in PyTorch.

The JAX package's ``functional.py``: the NF4/FP4 codebooks,
:class:`QuantState`, nibble packing, row-wise blockwise 4-bit quantization
and :func:`matmul_4bit`; blockwise, row-wise and col+row int8 with the
int8 x int8 product; FP8 E4M3/E5M2; ``double_quant``; sparse COO. Codes
follow the JAX package bit for bit (same codebooks, same nearest-code
tie-breaking, same padding rule, every division an IEEE division), so
checkpoints move between the two packages unchanged.

Every function keeps its input's device. Only :func:`matmul_4bit` (and
its aliases) reaches a hand kernel (K5, through ``ops/matmul4bit.py``);
the JAX package leaves everything else to XLA, and here it is plain torch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "NF4_VALUES", "FP4_VALUES", "NF4_CODEBOOK", "FP4_CODEBOOK",
    "create_normal_map", "create_fp4_map", "QuantState", "codebook",
    "pack_nibbles", "unpack_nibbles", "div_exact", "mul_recip",
    "quantize_4bit", "dequantize_4bit", "matmul_4bit",
    "quantize_nf4", "dequantize_nf4", "matmul_nf4",
    "quantize_fp4", "dequantize_fp4", "matmul_fp4",
    "quantize_blockwise", "dequantize_blockwise",
    "quantize_rowwise", "dequantize_rowwise", "matmul_int8", "int8_dot",
    "quantize_fp8_e4m3", "dequantize_fp8_e4m3", "matmul_fp8_e4m3",
    "quantize_fp8_e5m2", "dequantize_fp8_e5m2",
    "double_quant", "dequant_absmax",
    "quantize_colrow", "dequantize_colrow", "matmul_colrow",
    "spmm_coo", "spmm_coo_int8", "sparse_coo_from_dense",
    "quantize_sparse_coo",
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


# CPU copies of the codebooks (the JAX package's NF4_CODEBOOK/FP4_CODEBOOK)
NF4_CODEBOOK = torch.tensor(NF4_VALUES, dtype=torch.float32)
FP4_CODEBOOK = torch.tensor(FP4_VALUES, dtype=torch.float32)


def create_normal_map(offset: float = 0.9677083, use_extra_value: bool = True
                      ) -> torch.Tensor:
    """The NF4 codebook (bitsandbytes' name; the arguments are ignored, as
    in the JAX package)."""
    return NF4_CODEBOOK.clone()


def create_fp4_map(signed: bool = True) -> torch.Tensor:
    """The FP4 codebook (bitsandbytes' name)."""
    return FP4_CODEBOOK.clone()


def codebook(quant_type: str, device) -> torch.Tensor:
    """The 16-entry f32 codebook of ``quant_type`` ("nf4" or "fp4")."""
    if quant_type not in ("nf4", "fp4"):
        raise ValueError(f"quant_type must be 'nf4' or 'fp4', got {quant_type}")
    book = NF4_CODEBOOK if quant_type == "nf4" else FP4_CODEBOOK
    return book.to(device, copy=True)


@dataclasses.dataclass
class QuantState:
    """What dequantizing a packed tensor needs: the per-block ``absmax``
    (or its int8 codes when ``state2`` holds the nested scales), the logical
    ``shape``, the ``code`` book (the CPU codebook of an nf4/fp4 state, as
    the JAX package keeps a host copy; None for int8), ``blocksize``,
    ``quant_type``, the output ``dtype`` and an ``offset`` (bitsandbytes'
    name; nothing here sets it, and a checkpoint carries it)."""

    absmax: torch.Tensor
    shape: Tuple[int, ...]
    code: Optional[torch.Tensor] = None
    blocksize: int = 64
    quant_type: str = "nf4"
    dtype: torch.dtype = torch.bfloat16
    offset: Optional[torch.Tensor] = None
    state2: Optional["QuantState"] = None

    def __post_init__(self):
        self.shape = tuple(int(s) for s in self.shape)
        if self.code is None and self.quant_type in ("nf4", "fp4"):
            self.code = (NF4_CODEBOOK if self.quant_type == "nf4"
                         else FP4_CODEBOOK)

    def as_dict(self) -> dict:
        """A serializable dict with the JAX package's keys."""
        return {
            "absmax": self.absmax, "shape": tuple(self.shape),
            "blocksize": self.blocksize, "quant_type": self.quant_type,
            "dtype": dtype_name(self.dtype),
            "state2": None if self.state2 is None else self.state2.as_dict(),
        }

    @classmethod
    def from_dict(cls, state_dict: dict, device=None) -> "QuantState":
        """Inverse of :meth:`as_dict`; also takes the JAX package's dict,
        with numpy arrays (bf16 ones in ml_dtypes' dtype)."""
        state2 = None
        if state_dict.get("state2") is not None:
            state2 = cls.from_dict(state_dict["state2"], device)
        return cls(absmax=to_tensor(state_dict["absmax"], device),
                   shape=tuple(state_dict["shape"]),
                   blocksize=int(state_dict.get("blocksize", 64)),
                   quant_type=state_dict.get("quant_type", "nf4"),
                   dtype=dtype_of(state_dict.get("dtype", "bfloat16")),
                   state2=state2)

    def to(self, device) -> "QuantState":
        """A copy with ``absmax``, ``offset`` and ``state2`` on ``device``
        (the code book stays the host copy, as in the JAX package)."""
        return dataclasses.replace(
            self, absmax=self.absmax.to(device),
            offset=None if self.offset is None else self.offset.to(device),
            state2=None if self.state2 is None else self.state2.to(device))


_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "float64": torch.float64,
           "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32,
           "int64": torch.int64, "bool": torch.bool}


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's numpy-style name ("bfloat16")."""
    return str(dtype).replace("torch.", "")


def dtype_of(name) -> torch.dtype:
    """A torch dtype from a torch dtype or a name such as "bfloat16"."""
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


def to_tensor(x, device=None, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """A torch tensor from a tensor, a numpy array (bf16 in ml_dtypes'
    dtype) or a list; on ``device`` if given, else where it is (numpy on
    the CPU)."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            x = torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            x = torch.from_numpy(np.array(a))
    if device is not None:
        x = x.to(device)
    return x if dtype is None else x.to(dtype)


def div_exact(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as one IEEE f32 division per element on every device.
    PyTorch's CUDA kernels multiply by the reciprocal of a Python-scalar
    divisor, which can differ from the quotient in the last bit and move a
    rounded code against the CPU and the JAX package."""
    return t / torch.full_like(t, c)


def mul_recip(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as the JAX package's jitted functions compute it: XLA
    rewrites a division by a constant into a product with the constant's
    f32 reciprocal (a Python float multiplies an f32 tensor as f32)."""
    return t * (1.0 / c)


def sqrt_exact(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root on every device (PyTorch's
    vectorized CPU ``sqrt`` is off by one ulp in about 0.7% of values;
    the f64 root rounded to f32 is exact)."""
    return torch.sqrt(t.to(torch.float64)).to(torch.float32)


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


def _into(out: Optional[torch.Tensor], result: torch.Tensor
          ) -> torch.Tensor:
    """``result``, copied into ``out`` (and returned as it) when given."""
    if out is None:
        return result
    return out.copy_(result.reshape(out.shape))


def quantize_4bit(A: torch.Tensor, absmax: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None, blocksize: int = 64,
                  compress_statistics: bool = False, quant_type: str = "nf4",
                  quant_storage: torch.dtype = torch.uint8
                  ) -> Tuple[torch.Tensor, QuantState]:
    """Blockwise NF4/FP4 quantization. 2D inputs quantize each row in its
    own blocks (K padded per :func:`_pad_k`); other ranks use one flat
    block sequence. Returns ``(packed uint8 [numel_padded/2], state)``;
    ``compress_statistics`` double-quantizes absmax in blocks of 256.

    The bitsandbytes keywords, as the JAX package takes them: ``absmax``
    (one f32 per block of that layout) replaces the computed statistics;
    ``out`` receives the packed bytes; ``quant_storage`` reinterprets them
    (``Tensor.view``) as another dtype."""
    book = codebook(quant_type, A.device)
    _validate_blocksize(blocksize, power_of_two=True)
    a = A.to(torch.float32)
    if A.dim() == 2:
        n, k = A.shape
        kp = _pad_k(k, blocksize)
        padded = torch.zeros((n, kp), dtype=torch.float32, device=A.device)
        padded[:, :k] = a
        blocked = padded.reshape(n, kp // blocksize, blocksize)
        am = (blocked.abs().amax(dim=2).clamp(min=1e-8) if absmax is None
              else absmax.to(torch.float32).reshape(n, kp // blocksize))
        idx = _nearest_code(blocked / am[:, :, None], book)
        packed = pack_nibbles(idx.reshape(n, kp)).reshape(-1)
    else:
        flat = a.reshape(-1)
        padded_numel = _pad_flat(flat.numel(), blocksize)
        padded = torch.zeros((padded_numel,), dtype=torch.float32,
                             device=A.device)
        padded[:flat.numel()] = flat
        blocked = padded.reshape(-1, blocksize)
        am = (blocked.abs().amax(dim=1).clamp(min=1e-8) if absmax is None
              else absmax.to(torch.float32).reshape(-1))
        idx = _nearest_code(blocked / am.reshape(-1, 1), book)
        packed = pack_nibbles(idx.reshape(1, padded_numel)).reshape(-1)
    am = am.reshape(-1)
    state2 = None
    if compress_statistics:
        am, state2 = quantize_blockwise(am, blocksize=256)
    if quant_storage != torch.uint8:
        packed = packed.view(quant_storage)
    return _into(out, packed), QuantState(
        absmax=am, shape=tuple(A.shape), blocksize=blocksize,
        quant_type=quant_type, dtype=A.dtype, state2=state2)


def dequantize_4bit(A: torch.Tensor,
                    quant_state: Optional[QuantState] = None,
                    absmax: Optional[torch.Tensor] = None,
                    out: Optional[torch.Tensor] = None, blocksize: int = 64,
                    quant_type: str = "nf4") -> torch.Tensor:
    """Packed 4-bit codes back to ``quant_state.dtype`` values.

    Without a state, as the JAX package does: ``absmax`` (one per block),
    ``blocksize`` and ``quant_type`` describe flat codes, two values per
    byte of A, returned flat in bf16. ``out`` receives the values."""
    if quant_state is None:
        if absmax is None:
            raise ValueError("Either quant_state or absmax must be provided")
        quant_state = QuantState(absmax=absmax, shape=(A.numel() * 2,),
                                 blocksize=blocksize, quant_type=quant_type,
                                 dtype=torch.bfloat16)
        shape = None
    else:
        shape = quant_state.shape
    st = quant_state
    absmax = st.absmax
    if st.state2 is not None:
        absmax = dequantize_blockwise(absmax, st.state2)
    book = codebook(st.quant_type, A.device)
    absmax = absmax.to(torch.float32)
    if shape is not None and len(shape) == 2:
        n, k = st.shape
        kp = _pad_k(k, st.blocksize)
        idx = unpack_nibbles(A.reshape(n, kp // 2))
        values = book[idx.long()].reshape(n, kp // st.blocksize, st.blocksize)
        values = values * absmax.reshape(n, -1)[:, :, None]
        return _into(out, values.reshape(n, kp)[:, :k].to(st.dtype))
    numel = 1
    for s in st.shape:
        numel *= s
    idx = unpack_nibbles(A.reshape(1, -1)).reshape(-1)
    nblocks = absmax.numel()
    idx = idx[:nblocks * st.blocksize].reshape(nblocks, st.blocksize)
    values = (book[idx.long()] * absmax.reshape(-1, 1)).reshape(-1)[:numel]
    if shape is not None:
        values = values.reshape(shape)
    return _into(out, values.to(st.dtype))


def quantize_blockwise(A: torch.Tensor, code: Optional[torch.Tensor] = None,
                       absmax: Optional[torch.Tensor] = None,
                       out: Optional[torch.Tensor] = None,
                       blocksize: int = 4096, nested: bool = False
                       ) -> Tuple[torch.Tensor, QuantState]:
    """Blockwise symmetric int8 over the flattened tensor: codes
    ``round(a * 127 / absmax)`` and one f32 absmax per block. ``nested``
    double-quantizes the absmax in blocks of 256 (``state.state2``);
    ``out`` receives the codes. ``code`` and ``absmax`` are accepted for
    the bitsandbytes signature and not used: the statistics are computed,
    as in the JAX package."""
    _validate_blocksize(blocksize, power_of_two=False)
    flat = A.reshape(-1).to(torch.float32)
    numel = flat.numel()
    padded = torch.zeros((-(-numel // blocksize) * blocksize,),
                         dtype=torch.float32, device=A.device)
    padded[:numel] = flat
    blocked = padded.reshape(-1, blocksize)
    am = blocked.abs().amax(dim=1).clamp(min=1e-8)
    scale = _over(127.0, am)[:, None]
    q = torch.clamp(torch.round(blocked * scale), -127, 127).to(torch.int8)
    state2 = None
    if nested:
        am, state2 = quantize_blockwise(am, blocksize=256)
    return _into(out, q.reshape(-1)[:numel].reshape(A.shape)), QuantState(
        absmax=am, shape=tuple(A.shape), blocksize=blocksize,
        quant_type="int8", dtype=A.dtype, state2=state2)


def dequantize_blockwise(A: torch.Tensor,
                         quant_state: Optional[QuantState] = None,
                         absmax: Optional[torch.Tensor] = None,
                         code: Optional[torch.Tensor] = None,
                         out: Optional[torch.Tensor] = None,
                         blocksize: int = 4096, nested: bool = False
                         ) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` (``absmax / 127`` as the JAX
    package's jitted version computes it, :func:`mul_recip`); a nested
    state's absmax is dequantized first. Without a state, ``absmax`` and
    ``blocksize`` describe A's blocks and the values come back in A's shape
    in bf16, as in the JAX package (``code`` and ``nested`` unused).
    ``out`` receives the values."""
    if quant_state is not None:
        absmax = quant_state.absmax
        blocksize = quant_state.blocksize
        shape, dtype = tuple(quant_state.shape), quant_state.dtype
        if quant_state.state2 is not None:
            absmax = dequantize_blockwise(absmax, quant_state.state2)
    elif absmax is None:
        raise ValueError("Either quant_state or absmax must be provided")
    else:
        shape, dtype = tuple(A.shape), torch.bfloat16
    flat = A.reshape(-1).to(torch.float32)
    numel = flat.numel()
    padded = torch.zeros((-(-numel // blocksize) * blocksize,),
                         dtype=torch.float32, device=A.device)
    padded[:numel] = flat
    blocked = padded.reshape(-1, blocksize)
    deq = blocked * mul_recip(absmax.to(torch.float32)[:, None], 127.0)
    return _into(out, deq.reshape(-1)[:numel].reshape(shape).to(dtype))


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
        # frozen: autograd differentiates this product in A only
        weight = dequantize_4bit(B, quant_state).detach()
        out = A2.to(weight.dtype) @ weight.t()
    if bias is not None:
        out = out + bias.to(out.dtype)
    if A.dim() > 2:
        out = out.reshape(*orig_shape[:-1], out.shape[-1])
    elif A.dim() == 1:
        out = out.reshape(out.shape[-1])
    return out.to(compute_dtype)


def quantize_nf4(A: torch.Tensor, absmax: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None, blocksize: int = 64,
                 compress_statistics: bool = False,
                 quant_storage: torch.dtype = torch.uint8
                 ) -> Tuple[torch.Tensor, QuantState]:
    """:func:`quantize_4bit` with quant_type "nf4"."""
    return quantize_4bit(A, absmax, out, blocksize, compress_statistics,
                         "nf4", quant_storage)


def dequantize_nf4(A: torch.Tensor, quant_state: Optional[QuantState] = None,
                   absmax: Optional[torch.Tensor] = None,
                   out: Optional[torch.Tensor] = None,
                   blocksize: int = 64) -> torch.Tensor:
    """:func:`dequantize_4bit` of NF4 codes."""
    return dequantize_4bit(A, quant_state, absmax, out, blocksize, "nf4")


def quantize_fp4(A: torch.Tensor, absmax: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None, blocksize: int = 64,
                 compress_statistics: bool = False,
                 quant_storage: torch.dtype = torch.uint8
                 ) -> Tuple[torch.Tensor, QuantState]:
    """:func:`quantize_4bit` with quant_type "fp4"."""
    return quantize_4bit(A, absmax, out, blocksize, compress_statistics,
                         "fp4", quant_storage)


def dequantize_fp4(A: torch.Tensor, quant_state: Optional[QuantState] = None,
                   absmax: Optional[torch.Tensor] = None,
                   out: Optional[torch.Tensor] = None,
                   blocksize: int = 64) -> torch.Tensor:
    """:func:`dequantize_4bit` of FP4 codes."""
    return dequantize_4bit(A, quant_state, absmax, out, blocksize, "fp4")


def matmul_nf4(input, weight_packed, weight_state: QuantState, bias=None):
    """:func:`matmul_4bit` with NF4 weights."""
    return matmul_4bit(input, weight_packed, weight_state, bias)


def matmul_fp4(input, weight_packed, weight_state: QuantState, bias=None):
    """:func:`matmul_4bit` with FP4 weights."""
    return matmul_4bit(input, weight_packed, weight_state, bias)


# -- row-wise int8 and the exact int8 product --------------------------------

def _round_int8(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(t), -127, 127).to(torch.int8)


def _over(c: float, t: torch.Tensor) -> torch.Tensor:
    """``c / t`` as an IEEE division (``c / t`` with a Python scalar c is
    ``t.reciprocal() * c`` in PyTorch)."""
    return torch.full_like(t, c) / t


def quantize_rowwise(tensor: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per last-axis row: codes ``round(a * (127 / s))``
    and the f32 row absmax ``s`` (at least 1e-8), one per row of the
    tensor flattened to 2-D."""
    a = tensor.reshape(-1, tensor.shape[-1]).to(torch.float32)
    scales = a.abs().amax(dim=-1).clamp(min=1e-8)
    q = _round_int8(a * _over(127.0, scales)[:, None])
    return q.reshape(tensor.shape), scales


def dequantize_rowwise(quantized: torch.Tensor, scales: torch.Tensor,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_rowwise`."""
    q2 = quantized.reshape(-1, quantized.shape[-1]).to(torch.float32)
    s = scales.reshape(-1).to(torch.float32)
    return (q2 * div_exact(s, 127.0)[:, None]).to(dtype).reshape(
        quantized.shape)


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, cols - t.shape[1],
                                       0, rows - t.shape[0]))


# torch._int_mm's shape rule on CUDA: more than 16 rows, K and N multiples
# of 8
_INT_MM_MIN_M = 17
_INT_MM_ALIGN = 8


def int_mm_shape(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """The (M, K, N) that :func:`int8_dot` pads an int8 product to on a
    card, for ``torch._int_mm``: M to at least 17, K and N up to
    multiples of 8 (zeros, so the sums do not change)."""
    up = lambda v: -(-v // _INT_MM_ALIGN) * _INT_MM_ALIGN  # noqa: E731
    return max(m, _INT_MM_MIN_M), up(k), up(n)


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [N, K].T`` for int8 operands as exact int32 sums
    (the JAX package's ``dot_general(..., preferred_element_type=int32)``;
    never through f32, which is inexact past 2^24, i.e. from K = 1041 on
    at full-scale codes). On the CPU an int32 product; on a card
    ``torch._int_mm`` (a library call: the JAX package leaves this product
    to XLA, no Pallas kernel), padded to its shape rule."""
    m, k = a.shape
    n = b.shape[0]
    if not a.is_cuda:
        return a.to(torch.int32) @ b.to(torch.int32).t()
    mp, kp, np_ = int_mm_shape(m, k, n)
    if (mp, kp, np_) != (m, k, n):
        a, b = _pad_to(a, mp, kp), _pad_to(b, np_, kp)
    out = torch._int_mm(a.contiguous(), b.t().contiguous())
    return out[:m, :n]


def matmul_int8(A: torch.Tensor, B: torch.Tensor, A_scales: torch.Tensor,
                B_scales: torch.Tensor, dtype: torch.dtype = torch.bfloat16
                ) -> torch.Tensor:
    """int8 x int8 with row-wise scales: A [..., K] row-quantized, B [K, N]
    column-quantized (``B_scales`` per column). Exact int32 sums
    (:func:`int8_dot`), then ``acc * (a_s / 127) * (b_s / 127)``."""
    lead = A.shape[:-1]
    acc = int8_dot(A.reshape(-1, A.shape[-1]), B.t()).to(torch.float32)
    a_s = div_exact(A_scales.to(torch.float32), 127.0).reshape(-1)
    b_s = div_exact(B_scales.to(torch.float32), 127.0)
    out = acc * a_s[:, None] * b_s[None, :]
    return out.to(dtype).reshape(*lead, B.shape[1])


# -- FP8 E4M3 / E5M2 ----------------------------------------------------------

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
_E4M3_NAN = 0x7F     # the JAX package's (ml_dtypes') codes for a NaN
_E5M2_NAN = 0x7E


def _encode_fp8_e4m3(values: torch.Tensor) -> torch.Tensor:
    """f32 -> E4M3 bits (uint8): clipped to +-448 and rounded to nearest
    even by the ``float8_e4m3fn`` conversion; NaN -> 0x7F, as the JAX
    package encodes it."""
    v = torch.clamp(values.to(torch.float32), -E4M3_MAX, E4M3_MAX)
    bits = v.to(torch.float8_e4m3fn).view(torch.uint8)
    return torch.where(torch.isnan(values), torch.full_like(bits, _E4M3_NAN),
                       bits)


def _decode_fp8(bits: torch.Tensor, fp8: torch.dtype) -> torch.Tensor:
    return bits.to(torch.uint8).view(fp8).to(torch.float32)


def _row_fp8_scale(a: torch.Tensor, fmax: float) -> torch.Tensor:
    return mul_recip(a.abs().amax(dim=1), fmax).clamp(min=1e-12)


def quantize_fp8_e4m3(tensor: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-scaled FP8 E4M3: bits uint8 [N, K] of ``a / s`` with the f32
    row scale ``s = max|a| / 448`` (at least 1e-12; :func:`mul_recip`, as
    JAX's jitted version divides)."""
    if tensor.dim() != 2:
        raise ValueError("Input must be 2D")
    a = tensor.to(torch.float32)
    scales = _row_fp8_scale(a, E4M3_MAX)
    normalized = torch.clamp(a / scales[:, None], -E4M3_MAX, E4M3_MAX)
    return _encode_fp8_e4m3(normalized), scales


def dequantize_fp8_e4m3(quantized: torch.Tensor, scales: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_fp8_e4m3`."""
    vals = _decode_fp8(quantized, torch.float8_e4m3fn)
    return (vals * scales.to(torch.float32)[:, None]).to(dtype)


def matmul_fp8_e4m3(input: torch.Tensor, weight: torch.Tensor,
                    weight_scales: torch.Tensor, bias=None,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x @ decode(W).T`` with E4M3 weight bits [N, K]: the decoded weight
    in ``dtype``, an f32 product, the f32 row scale on the output, cast to
    ``dtype``, then the bias in ``dtype`` (the JAX package's order)."""
    from .ops.dot import dot_f32   # ops imports this module
    x = input[None, :] if input.dim() == 1 else input
    lead = x.shape[:-1]
    w = _decode_fp8(weight, torch.float8_e4m3fn).to(dtype)
    out = dot_f32(x.reshape(-1, x.shape[-1]).to(dtype), w)
    out = (out * weight_scales.to(torch.float32)[None, :]).to(dtype)
    out = out.reshape(*lead, -1)
    if bias is not None:
        out = out + bias.to(dtype)
    return out[0] if input.dim() == 1 else out


def quantize_fp8_e5m2(tensor: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-scaled FP8 E5M2: bits uint8 of ``a / s``, clipped to +-57344,
    with ``s = max|a| / 57344`` (at least 1e-12)."""
    if tensor.dim() != 2:
        raise ValueError("Input must be 2D")
    a = tensor.to(torch.float32)
    scales = _row_fp8_scale(a, E5M2_MAX)
    normalized = torch.clamp(a / scales[:, None], -E5M2_MAX, E5M2_MAX)
    bits = normalized.to(torch.float8_e5m2).view(torch.uint8)
    # a NaN keeps its sign over the JAX package's (ml_dtypes') payload 0x7E
    # (PyTorch's conversion gives 0x7F)
    nan_bits = (bits & 0x80) | _E5M2_NAN
    return torch.where(torch.isnan(normalized), nan_bits, bits), scales


def dequantize_fp8_e5m2(quantized: torch.Tensor, scales: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_fp8_e5m2`."""
    vals = _decode_fp8(quantized, torch.float8_e5m2)
    return (vals * scales.to(torch.float32)[:, None]).to(dtype)


# -- double quantization and col+row int8 -------------------------------------

def double_quant(A: torch.Tensor, col_stats=None, row_stats=None,
                 out_col=None, out_row=None, threshold: float = 0.0):
    """LLM.int8()-style row and column statistics and int8 codes: returns
    ``(col_quantized, row_quantized, col_stats, row_stats, None)``."""
    if A.dim() != 2:
        raise ValueError("Input must be 2D")
    a = A.to(torch.float32)
    if row_stats is None:
        row_stats = a.abs().amax(dim=1).clamp(min=1e-8)
    if col_stats is None:
        col_stats = a.abs().amax(dim=0).clamp(min=1e-8)
    if out_row is None:
        out_row = _round_int8(a * _over(127.0, row_stats)[:, None])
    if out_col is None:
        out_col = _round_int8(a * _over(127.0, col_stats)[None, :])
    return out_col, out_row, col_stats, row_stats, None


def dequant_absmax(absmax_quant: torch.Tensor, absmax_scales,
                   blocksize: int = 256) -> torch.Tensor:
    """Double-quantized absmax back to f32: by its nested
    :class:`QuantState`, or by one scale per ``blocksize`` codes (rows of
    a 2-D input each with their own scales)."""
    if isinstance(absmax_scales, QuantState):
        return dequantize_blockwise(absmax_quant, absmax_scales)
    aq, sc = absmax_quant, absmax_scales.to(torch.float32)
    squeeze = aq.dim() == 1
    if squeeze:
        aq, sc = aq[None, :], sc[None, :]
    rows, num_blocks = aq.shape
    padded = sc.shape[1] * blocksize
    a_p = _pad_to(aq.to(torch.float32), rows, padded)
    out = (a_p.reshape(rows, -1, blocksize) * sc[:, :, None]).reshape(
        rows, padded)[:, :num_blocks]
    return out[0] if squeeze else out


def _colrow_scale(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    return sqrt_exact(row.to(torch.float32)[:, None]
                      * col.to(torch.float32)[None, :])


def quantize_colrow(tensor: torch.Tensor):
    """int8 codes against the geometric mean of each element's row and
    column absmax: returns ``(codes, row_absmax, col_absmax)``."""
    if tensor.dim() != 2:
        raise ValueError("Input must be 2D")
    a = tensor.to(torch.float32)
    row = a.abs().amax(dim=1).clamp(min=1e-8)
    col = a.abs().amax(dim=0).clamp(min=1e-8)
    return _round_int8(a * _over(127.0, _colrow_scale(row, col))), row, col


def dequantize_colrow(quantized: torch.Tensor, row_scales: torch.Tensor,
                      col_scales: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_colrow`."""
    scale = div_exact(_colrow_scale(row_scales, col_scales), 127.0)
    return (quantized.to(torch.float32) * scale).to(dtype)


def matmul_colrow(input: torch.Tensor, weight_int8: torch.Tensor,
                  weight_row_scales: torch.Tensor,
                  weight_col_scales: torch.Tensor, bias=None,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x @ W.T`` with W col+row quantized, dequantized to ``dtype``."""
    w = dequantize_colrow(weight_int8, weight_row_scales, weight_col_scales,
                          dtype)
    out = input.to(dtype) @ w.t()
    if bias is not None:
        out = out + bias.to(dtype)
    return out


# -- sparse COO ----------------------------------------------------------------

def spmm_coo(row_indices: torch.Tensor, col_indices: torch.Tensor,
             values: torch.Tensor, dense: torch.Tensor, sparse_rows: int,
             sparse_cols: int) -> torch.Tensor:
    """COO sparse [sparse_rows, sparse_cols] x dense: the rows
    ``values * dense[col]`` added into their output rows (``index_add_``;
    on a card its atomic adds run in no fixed order, so sums of several
    entries into one row may differ from the CPU's in the last bits)."""
    gathered = values[:, None].to(dense.dtype) * dense[col_indices.long()]
    out = torch.zeros((sparse_rows, dense.shape[1]), dtype=dense.dtype,
                      device=dense.device)
    return out.index_add_(0, row_indices.long(), gathered)


def spmm_coo_int8(row_indices, col_indices, values_int8, values_scale,
                  dense, sparse_rows: int, sparse_cols: int,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`spmm_coo` with int8 values times one f32 scale."""
    values = (values_int8.to(torch.float32)
              * values_scale.to(torch.float32).reshape(()))
    return spmm_coo(row_indices, col_indices, values.to(dtype),
                    dense.to(dtype), sparse_rows, sparse_cols)


def sparse_coo_from_dense(tensor: torch.Tensor, threshold: float = 0.0):
    """Dense [rows, cols] -> ``(row_indices, col_indices, values, rows,
    cols)`` in row-major order, int32 indices; with ``threshold`` > 0 only
    entries with ``|a| >= threshold`` are kept. A setup op: the number of
    entries is read back to the host."""
    rows, cols = tensor.shape
    keep = tensor != 0
    if threshold > 0:
        keep &= tensor.abs() >= threshold
    r, c = keep.nonzero(as_tuple=True)
    return (r.to(torch.int32), c.to(torch.int32), tensor[r, c], rows, cols)


def quantize_sparse_coo(row_indices, col_indices, values: torch.Tensor):
    """COO values to int8 against one global scale ``max|v| / 127``:
    returns ``(row_indices, col_indices, codes, scale [1])``."""
    v = values.to(torch.float32)
    scale = div_exact(v.abs().amax().clamp(min=1e-8), 127.0)
    return row_indices, col_indices, _round_int8(v / scale), scale.reshape(1)
