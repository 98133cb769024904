"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled, on first use and all sources at once
(one nvcc process each, started together), into
``build/kernels/lib<name>_<hash>.so`` beside the package; the hash covers
the sources, the shared headers and the flags, so an edit rebuilds and an
unchanged tree reuses its libraries. The libraries export plain C launch
functions that return ``cudaGetLastError()`` after the launch; callers pass
the code to :func:`check`.

No PyTorch headers are compiled in: a source that includes
``torch/extension.h`` takes minutes to build, a plain C interface seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources():
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (CUDA_HOME unset and no "
                           "nvcc on PATH): cannot build the CUDA kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src] + sorted(_CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(src: Path) -> Path:
    return _BUILD / f"lib{src.stem}_{_digest(src)}.so"


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas=-v``: registers, shared memory, spills) for
    the current build of kernel source ``name``, or "" if not built here."""
    src = _CSRC / f"{name}.cu"
    log = _lib_path(src).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library. Raises if any
    source fails to compile."""
    with _lock:
        if _libs:
            return _libs
        _BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for src in sources():
            out = _lib_path(src)
            if out.exists():
                continue
            tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
            log = open(out.with_suffix(".log"), "w")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
                 str(src)],
                stdout=log, stderr=subprocess.STDOUT)
            jobs.append((src, out, tmp, log, proc))
        failed = []
        for src, out, tmp, log, proc in jobs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(f"{src.name} (nvcc exit {rc}):\n"
                              + out.with_suffix(".log").read_text())
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        for src in sources():
            _libs[src.stem] = ctypes.CDLL(str(_lib_path(src)))
        return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    return load_all()[name]


def loaded() -> Dict[str, bool]:
    """Which kernel libraries are loaded in this process (builds nothing)."""
    return {src.stem: src.stem in _libs for src in sources()}


# Every kernel wrapper's launch counts and every plain version's count of
# its calls on CUDA tensors, as (function, attribute). A wrapper counts
# where it launches, so a CUDA graph's kernels count once, at capture: a
# graph's holder (engine.ChunkGraphs) adds each replay's share through this
# list.
COUNTERS = []


def counter(fn, *attrs) -> None:
    """Register ``fn``'s count attributes ``attrs`` in :data:`COUNTERS`,
    each set to 0."""
    for attr in attrs:
        setattr(fn, attr, 0)
        COUNTERS.append((fn, attr))


# (plan export, M, N, K_pad, blocksize, device) -> (chunks per K split, f32
# partials, counts): the launch plan of K1 and K4 (csrc/a8_tc.cuh) and of
# K5's wgmma path (csrc/matmul4bit.cu), made once per shape
_PLANS = {}
# (device, stream) -> the split-K partials and the counts the kernels read
# as 0 and leave 0. Launches on one stream run in order and share one pair;
# a launch on another stream gets its own, so two launches never meet in a
# count. A CUDA-graph capture uses its stream's pair, which must exist
# before the capture (it is allocated and zeroed eagerly): a capture that
# needs a larger one raises. The graph's launches keep the pair's
# pointers, so a later growth on that stream keeps the captured pair
# alive in _HELD instead of freeing it.
_SCRATCH = {}
_CAPTURED = set()
_HELD = {}


def plan_of(plan_fn, m: int, n: int, kp: int, bs: int, device):
    """The launch plan ``plan_fn`` (``tbnb_w4a8_plan``, ``tbnb_int4_plan``
    or ``tbnb_matmul4bit_plan``) gives this shape: (chunks per split, f32
    partials, counts), chunks 0 where its kernel does not take the shape."""
    key = (plan_fn.__name__, m, n, kp, bs, device)
    plan = _PLANS.get(key)
    if plan is None:
        cps, n_part, n_count = (ctypes.c_int(0), ctypes.c_longlong(0),
                                ctypes.c_int(0))
        plan_fn(m, n, kp, bs, ctypes.byref(cps), ctypes.byref(n_part),
                ctypes.byref(n_count))
        plan = _PLANS[key] = (cps.value, n_part.value, n_count.value)
    return plan


def split_plan(plan_fn, m: int, n: int, kp: int, bs: int, device):
    """:func:`plan_of` this shape and the split-K scratch it needs on the
    current stream (grown on demand, outside a capture): (chunks per
    split, partials, counts, stream handle)."""
    plan = plan_of(plan_fn, m, n, kp, bs, device)
    stream = torch.cuda.current_stream(device)
    skey = (device, stream.cuda_stream)
    capturing = torch.cuda.is_current_stream_capturing()
    part, counts = _SCRATCH.get(skey, (None, None))
    if part is None or part.numel() < plan[1] or counts.numel() < plan[2]:
        if capturing:
            raise RuntimeError(
                "split-K scratch: this shape needs more than the capture "
                "stream holds; run the captured calls once on the capture "
                "stream before capturing them")
        if skey in _CAPTURED:
            _HELD.setdefault(skey, []).append((part, counts))
            _CAPTURED.discard(skey)
        part = torch.empty((max(plan[1], 1 << 20),), dtype=torch.float32,
                           device=device)
        counts = torch.zeros((max(plan[2], 1024),), dtype=torch.int32,
                             device=device)
        _SCRATCH[skey] = (part, counts)
    if capturing:
        _CAPTURED.add(skey)
    return plan[0], part, counts, stream.cuda_stream


def release_held(stream) -> None:
    """Free the split-K scratch kept for graphs captured on ``stream``
    (a ``torch.cuda.Stream``) before its last growth. Call it only once
    those graphs are gone."""
    for skey in [k for k in _HELD if k[1] == stream.cuda_stream]:
        del _HELD[skey]


def scratch_bytes() -> Dict[int, int]:
    """Bytes of split-K scratch (partials and counts) held per stream
    handle: memory that stays allocated once a stream has run a split
    launch, with the pairs kept for graphs captured before a growth."""
    return {skey[1]: sum(part.nbytes + counts.nbytes
                         for part, counts in [pair] + _HELD.get(skey, []))
            for skey, pair in _SCRATCH.items()}


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def records_grad(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x``: only then do K1, K4 and K5
    go through their ``torch.autograd.Function``, whose ``apply`` adds
    host time to every call of an eager decode step."""
    return torch.is_grad_enabled() and x.requires_grad


def refuse_grad(what: str, *tensors) -> None:
    """Raise if autograd would have to differentiate through a kernel call
    here: grad mode on and an input that requires grad. A ctypes launch
    returns a tensor without a ``grad_fn``, so the gradient would vanish
    without an error. K1, K4 and K5 take gradients through their
    ``torch.autograd.Function`` (whose forward runs without grad mode); K2
    and K3 have no backward, as their TPU kernels have none."""
    if any(t is not None and records_grad(t) for t in tensors):
        raise RuntimeError(
            f"{what}: no backward pass here (a kernel launch has no "
            "autograd graph); call it under torch.no_grad(), or detach its "
            "inputs")
