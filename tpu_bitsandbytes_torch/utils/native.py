"""The native host library: NF4/FP4 quantize-and-pack and row-wise int8 of
f32 weights on CPU threads, for converting a checkpoint without a trip
through the device.

``csrc/host_pack.cpp`` (a plain C ABI) is compiled at first use with the
host C++ compiler (``$CXX``, else ``g++``) into ``build/host/`` beside the
package, under a name that hashes the source, the flags and the host's CPU,
and loaded with ctypes. Each build writes a file of its own and renames it
into place, so processes that build at once (test workers) never load a
half-written library. A failed build or load raises: nothing falls back to numpy. The
numpy functions ``*_plain`` compute the same codes and are the plain
versions the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..functional import FP4_VALUES, NF4_VALUES, _pad_k

__all__ = ["has_native_host", "quantize_4bit_host", "dequantize_4bit_host",
           "quantize_rowwise_host", "quantize_4bit_host_plain",
           "dequantize_4bit_host_plain", "quantize_rowwise_host_plain",
           "library_path"]

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host_pack.cpp"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_F32 = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I8 = ctypes.POINTER(ctypes.c_int8)


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _host_cpu() -> bytes:
    """What ``-march=native`` compiles for: this host's CPU model and
    flags (a build directory copied to another host is not reused)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(lines[:2])
    except OSError:
        return b""


def library_path() -> Path:
    """Where this tree's build of the library lives (built or not): the
    name hashes the source, the compiler and flags, and the host's CPU."""
    h = hashlib.sha256(" ".join((_cxx(),) + CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    h.update(_host_cpu())
    return _BUILD / f"libtbnb_host_{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    """The loaded library, built first if this tree has no build of it.
    Raises RuntimeError with the compiler's output if the build fails, and
    OSError if the library does not load."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}."
                                f"{threading.get_ident()}.tmp")
            try:
                proc = subprocess.run(
                    [_cxx(), *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                    capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"host library build failed: cannot run "
                                   f"{_cxx()!r}: {e}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"host library build failed ({_cxx()} exit "
                    f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        i64, cint = ctypes.c_int64, ctypes.c_int
        for fn, args in (
                ("tbnb_quantize_4bit_2d",
                 (_F32, i64, i64, i64, cint, _U8, _F32, cint)),
                ("tbnb_dequantize_4bit_2d",
                 (_U8, _F32, i64, i64, i64, cint, _F32, cint)),
                ("tbnb_quantize_rowwise", (_F32, i64, i64, _I8, _F32, cint))):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = cint
        _lib = lib
        return _lib


def has_native_host() -> bool:
    """True once the host library is loaded; builds it at the first call.
    A failed build or load raises (the port does not fall back)."""
    return _load() is not None


def _threads(num_threads: Optional[int]) -> int:
    return num_threads or min(os.cpu_count() or 1, 16)


def _quant_code(quant_type: str) -> int:
    if quant_type not in ("nf4", "fp4"):
        raise ValueError(f"quant_type must be 'nf4' or 'fp4', got "
                         f"{quant_type}")
    return 0 if quant_type == "nf4" else 1


def quantize_4bit_host(w: np.ndarray, blocksize: int = 64,
                       quant_type: str = "nf4",
                       num_threads: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """f32 [N, K] -> (packed [N, K_pad / 2] uint8, absmax [N, blocks] f32)
    on ``num_threads`` host threads (default: the cores, at most 16): the
    bytes and absmax of ``functional.quantize_4bit``'s 2-D path."""
    lib = _load()
    qt = _quant_code(quant_type)
    w = np.ascontiguousarray(w, dtype=np.float32)
    n, k = w.shape
    kp = _pad_k(k, blocksize)
    packed = np.empty((n, kp // 2), np.uint8)
    absmax = np.empty((n, kp // blocksize), np.float32)
    rc = lib.tbnb_quantize_4bit_2d(
        w.ctypes.data_as(_F32), n, k, blocksize, qt,
        packed.ctypes.data_as(_U8), absmax.ctypes.data_as(_F32),
        _threads(num_threads))
    if rc != 0:
        raise ValueError(f"tbnb_quantize_4bit_2d failed (rc={rc}): blocksize "
                         f"{blocksize} must be a power of 2 up to 65536")
    return packed, absmax


def dequantize_4bit_host(packed: np.ndarray, absmax: np.ndarray, n: int,
                         k: int, blocksize: int = 64, quant_type: str = "nf4",
                         num_threads: Optional[int] = None) -> np.ndarray:
    """The inverse: f32 [N, K], each code's value times its block's
    absmax."""
    lib = _load()
    qt = _quant_code(quant_type)
    packed = np.ascontiguousarray(packed, np.uint8)
    absmax = np.ascontiguousarray(absmax, np.float32)
    kp = _pad_k(k, blocksize)
    if packed.size != n * kp // 2 or absmax.size != n * kp // blocksize:
        raise ValueError(f"packed ({packed.size} bytes) and absmax "
                         f"({absmax.size}) do not fit a [{n}, {k}] weight "
                         f"at blocksize {blocksize}")
    out = np.empty((n, k), np.float32)
    rc = lib.tbnb_dequantize_4bit_2d(
        packed.ctypes.data_as(_U8), absmax.ctypes.data_as(_F32), n, k,
        blocksize, qt, out.ctypes.data_as(_F32), _threads(num_threads))
    if rc != 0:
        raise ValueError(f"tbnb_dequantize_4bit_2d failed (rc={rc})")
    return out


def quantize_rowwise_host(w: np.ndarray, num_threads: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """f32 [N, K] -> (int8 [N, K], f32 row absmax [N]):
    ``functional.quantize_rowwise``'s codes (round half to even)."""
    lib = _load()
    w = np.ascontiguousarray(w, dtype=np.float32)
    n, k = w.shape
    out = np.empty((n, k), np.int8)
    scales = np.empty((n,), np.float32)
    rc = lib.tbnb_quantize_rowwise(
        w.ctypes.data_as(_F32), n, k, out.ctypes.data_as(_I8),
        scales.ctypes.data_as(_F32), _threads(num_threads))
    if rc != 0:
        raise ValueError(f"tbnb_quantize_rowwise failed (rc={rc})")
    return out, scales


# -- the plain versions (numpy) ------------------------------------------

def _book(quant_type: str) -> np.ndarray:
    _quant_code(quant_type)
    return np.asarray(NF4_VALUES if quant_type == "nf4" else FP4_VALUES,
                      np.float32)


def quantize_4bit_host_plain(w: np.ndarray, blocksize: int = 64,
                             quant_type: str = "nf4"
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`quantize_4bit_host` in numpy."""
    book = _book(quant_type)
    w = np.asarray(w, np.float32)
    n, k = w.shape
    kp = _pad_k(k, blocksize)
    wp = np.zeros((n, kp), np.float32)
    wp[:, :k] = w
    blocks = wp.reshape(n, kp // blocksize, blocksize)
    am = np.maximum(np.abs(blocks).max(axis=2), np.float32(1e-8))
    norm = blocks / am[:, :, None]
    idx = np.abs(norm[..., None] - book).argmin(axis=-1).astype(np.uint8)
    flat = idx.reshape(n, kp)
    return flat[:, 0::2] | (flat[:, 1::2] << 4), am.astype(np.float32)


def dequantize_4bit_host_plain(packed: np.ndarray, absmax: np.ndarray,
                               n: int, k: int, blocksize: int = 64,
                               quant_type: str = "nf4") -> np.ndarray:
    """:func:`dequantize_4bit_host` in numpy."""
    book = _book(quant_type)
    kp = _pad_k(k, blocksize)
    p = np.asarray(packed, np.uint8).reshape(n, kp // 2)
    codes = np.empty((n, kp), np.uint8)
    codes[:, 0::2] = p & 0x0F
    codes[:, 1::2] = p >> 4
    vals = book[codes] * np.repeat(np.asarray(absmax, np.float32).reshape(
        n, -1), blocksize, axis=1)
    return vals[:, :k].astype(np.float32)


def quantize_rowwise_host_plain(w: np.ndarray
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`quantize_rowwise_host` in numpy."""
    w = np.asarray(w, np.float32)
    am = np.maximum(np.abs(w).max(axis=1), np.float32(1e-8))
    q = np.clip(np.round(w * (np.float32(127.0) / am[:, None])), -127, 127)
    return q.astype(np.int8), am.astype(np.float32)
