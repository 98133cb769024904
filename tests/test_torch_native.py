"""PyTorch port vs JAX package: the native host library (``utils/native.py``).

The port builds its own copy of the host packer (``tpu_bitsandbytes_torch/
csrc/host_pack.cpp``) with the host compiler at first use, and loads it
through ctypes. The same numpy inputs go through the library, its numpy
plain versions, and the JAX package's jnp quantizers (``F.quantize_4bit``,
``F.dequantize_4bit``, ``F.quantize_rowwise``), which are its oracle:
codes, scales and dequantized values bit for bit, at 1 and 4 threads.
A failed build raises; nothing falls back to numpy.
"""

import ctypes

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import tpu_bitsandbytes.functional as F
from tpu_bitsandbytes_torch import functional as T
from tpu_bitsandbytes_torch.utils import native as N

SHAPES = [(64, 128), (33, 100), (8, 64)]


def _w(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_matches_jax(shape, quant_type, threads):
    """Packed bytes and absmax equal to JAX's ``quantize_4bit`` (K padded
    to the block at K = 100), and to the numpy plain version."""
    w = _w(shape, seed=sum(shape))
    packed, absmax = N.quantize_4bit_host(w, 64, quant_type, threads)
    jp, js = F.quantize_4bit(jnp.asarray(w), blocksize=64,
                             quant_type=quant_type)
    assert packed.shape == (shape[0], T._pad_k(shape[1], 64) // 2)
    np.testing.assert_array_equal(packed.reshape(-1), np.asarray(jp))
    np.testing.assert_array_equal(absmax.reshape(-1), np.asarray(js.absmax))
    pp, pa = N.quantize_4bit_host_plain(w, 64, quant_type)
    np.testing.assert_array_equal(packed, pp)
    np.testing.assert_array_equal(absmax, pa)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("shape", SHAPES)
def test_dequantize_matches_jax(shape, quant_type, threads):
    """The library's f32 values from its own codes equal JAX's
    ``dequantize_4bit`` of JAX's codes (the same codes, above), and the
    numpy plain version's."""
    w = _w(shape, seed=sum(shape) + 1)
    packed, absmax = N.quantize_4bit_host(w, 64, quant_type, threads)
    got = N.dequantize_4bit_host(packed, absmax, *shape, 64, quant_type,
                                 threads)
    jp, js = F.quantize_4bit(jnp.asarray(w, jnp.float32), blocksize=64,
                             quant_type=quant_type)
    ref = np.asarray(F.dequantize_4bit(jp, js), np.float32)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, N.dequantize_4bit_host_plain(packed, absmax, *shape, 64,
                                          quant_type))


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_rowwise_matches_jax(shape, threads):
    """int8 codes (round half to even in both) and row scales equal to
    JAX's ``quantize_rowwise``; an all-zero row takes the 1e-8 floor."""
    w = _w(shape, seed=sum(shape) + 2) * 3
    w[1] = 0.0
    q, s = N.quantize_rowwise_host(w, threads)
    jq, js = F.quantize_rowwise(jnp.asarray(w))
    np.testing.assert_array_equal(q, np.asarray(jq))
    np.testing.assert_array_equal(s, np.asarray(js))
    pq, ps = N.quantize_rowwise_host_plain(w)
    np.testing.assert_array_equal(q, pq)
    np.testing.assert_array_equal(s, ps)


def test_divides_by_the_absmax_as_quantize_4bit_does():
    """Rows of a seeded 2048 x 4096 normal weight where multiplying by the
    reciprocal of a block's absmax (the JAX package's C++ copy) rounds a
    normalized value across a codebook midpoint: the port's library
    divides, so its codes equal JAX's jnp ``quantize_4bit`` and the port's
    ``quantize_4bit`` there too."""
    w = _w((2048, 4096))[[756, 902, 1138]]
    for qt in ("nf4", "fp4"):
        packed, absmax = N.quantize_4bit_host(w, 64, qt)
        jp, _ = F.quantize_4bit(jnp.asarray(w), blocksize=64, quant_type=qt)
        tp, _ = T.quantize_4bit(torch.from_numpy(w), blocksize=64,
                                quant_type=qt)
        np.testing.assert_array_equal(packed.reshape(-1), np.asarray(jp))
        np.testing.assert_array_equal(packed.reshape(-1), tp.numpy())
    # the reciprocal's codes differ somewhere in these rows
    book = np.asarray(T.NF4_VALUES, np.float32)
    blocks = w.reshape(3, 64, 64)
    am = np.abs(blocks).max(axis=2)
    recip = blocks * (np.float32(1.0) / am)[:, :, None]
    div = blocks / am[:, :, None]
    idx = [np.abs(v[..., None] - book).argmin(-1) for v in (recip, div)]
    assert (idx[0] != idx[1]).any()


def test_arguments_are_validated():
    """A blocksize the C code refuses, an unknown quant type, and packed
    bytes or absmax that do not fit the shape (the C code would read past
    them) raise ValueError."""
    with pytest.raises(ValueError, match="power of 2"):
        N.quantize_4bit_host(_w((4, 96)), blocksize=48)
    with pytest.raises(ValueError, match="quant_type"):
        N.quantize_4bit_host(_w((4, 64)), quant_type="int4")
    packed, absmax = N.quantize_4bit_host(_w((4, 128)))
    with pytest.raises(ValueError, match="do not fit"):
        N.dequantize_4bit_host(packed, absmax, 8, 128)
    with pytest.raises(ValueError, match="do not fit"):
        N.dequantize_4bit_host(packed, absmax[:, :1], 4, 128)


def test_library_is_built_and_loaded():
    """``has_native_host`` builds the library at first use into the
    gitignored ``build/host/`` and loads it; its path hashes the source,
    the flags and the host's CPU."""
    assert N.has_native_host()
    path = N.library_path()
    assert path.exists() and path.parent.name == "host"
    assert path.parent.parent.name == "build"
    assert isinstance(N._load(), ctypes.CDLL)


@pytest.mark.parametrize("cxx", ["false", "/nonexistent/c++"])
def test_failed_build_raises(monkeypatch, tmp_path, cxx):
    """A compiler that fails, or cannot run, raises RuntimeError; no numpy
    fallback is taken and no library is left behind."""
    monkeypatch.setattr(N, "_BUILD", tmp_path)
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match="host library build failed"):
        N.quantize_4bit_host(_w((4, 64)))
    with pytest.raises(RuntimeError, match="host library build failed"):
        N.has_native_host()
    assert not list(tmp_path.iterdir())
