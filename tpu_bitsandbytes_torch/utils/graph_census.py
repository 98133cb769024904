"""The kernels a captured CUDA graph launches, read from the graph itself.

A graph's kernel nodes are what each of its replays launches, one launch
per node, so their names count a replay's kernels exactly. (The profiler's
kernel records of a replay are not an exact count: on the H100 a record is
now and then missing from a chunk of tens of thousands of kernels.) The
graph must have been captured with ``torch.cuda.CUDAGraph(keep_graph=True)``;
its ``raw_cuda_graph()`` is walked through the CUDA driver API.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Counter

_KERNEL_NODE = 0          # CU_GRAPH_NODE_TYPE_KERNEL


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of ``cuda.h``."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid_dim", ctypes.c_uint * 3),
                ("block_dim", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def _cxx():
    lib = ctypes.CDLL("libstdc++.so.6")
    f = lib.__cxa_demangle
    f.restype = ctypes.c_void_p
    f.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.POINTER(ctypes.c_int)]
    libc = ctypes.CDLL("libc.so.6")
    libc.free.argtypes = [ctypes.c_void_p]
    return f, libc.free


def demangle(name: str) -> str:
    """``name`` as the profiler shows it: demangled where it is a mangled
    C++ name, else as it is (an ``extern "C"`` kernel)."""
    f, free = _cxx()
    status = ctypes.c_int(0)
    out = f(name.encode(), None, None, ctypes.byref(status))
    if status.value != 0 or not out:
        return name
    try:
        return ctypes.string_at(out).decode()
    finally:
        free(out)


@functools.lru_cache(maxsize=None)
def _driver():
    return ctypes.CDLL("libcuda.so.1")


def _call(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUresult {rc}")


def kernel_names(raw_graph: int) -> Counter[str]:
    """The demangled names of the kernel nodes of the ``CUgraph`` whose
    handle is ``raw_graph``, with the number of nodes of each."""
    cu = _driver()
    graph = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    _call(cu.cuGraphGetNodes, graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _call(cu.cuGraphGetNodes, graph, nodes, ctypes.byref(n))
    names: Counter[str] = collections.Counter()
    kind = ctypes.c_int(-1)
    params = _KernelNodeParams()
    name = ctypes.c_char_p()
    for node in nodes[:n.value]:
        node = ctypes.c_void_p(node)
        _call(cu.cuGraphNodeGetType, node, ctypes.byref(kind))
        if kind.value != _KERNEL_NODE:
            continue
        _call(cu.cuGraphKernelNodeGetParams_v2, node, ctypes.byref(params))
        if params.func:
            _call(cu.cuFuncGetName, ctypes.byref(name),
                  ctypes.c_void_p(params.func))
        else:
            _call(cu.cuKernelGetName, ctypes.byref(name),
                  ctypes.c_void_p(params.kern))
        names[demangle(name.value.decode())] += 1
    return names


# CUgraphNodeType of cuda.h, by value
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
              4: "graph", 5: "empty", 6: "wait_event", 7: "event_record",
              8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def node_types(raw_graph: int) -> Counter[str]:
    """The nodes of the ``CUgraph`` whose handle is ``raw_graph``, by
    type (kernel, memcpy, memset, event_record, ...)."""
    cu = _driver()
    graph = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    _call(cu.cuGraphGetNodes, graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _call(cu.cuGraphGetNodes, graph, nodes, ctypes.byref(n))
    out: Counter[str] = collections.Counter()
    kind = ctypes.c_int(-1)
    for node in nodes[:n.value]:
        _call(cu.cuGraphNodeGetType, ctypes.c_void_p(node),
              ctypes.byref(kind))
        out[NODE_TYPES.get(kind.value, str(kind.value))] += 1
    return out
