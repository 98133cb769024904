"""PyTorch port vs JAX package: NF4/FP4 storage primitives.

The same numpy inputs go through both packages. Packed NF4/FP4 bytes must
be identical (same codebook, same nearest-code tie-breaking); absmax is a
max of |w| and must agree to f32 rounding (<= 1e-6 relative).

This file also holds the helpers the other ``test_torch_*`` files share:
JAX trees to numpy for ``convert.from_reference_arrays``.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpu_bitsandbytes import functional as F
from tpu_bitsandbytes.models.layers import QLinear4 as JQLinear4
from tpu_bitsandbytes_torch import functional as TF


# --------------------------------------------------------------------------
# helpers shared by the test_torch_* files
# --------------------------------------------------------------------------

def to_np(x):
    """A JAX array as numpy (int4 as int8; bf16 keeps its dtype)."""
    if x is None:
        return None
    if x.dtype == jnp.int4:
        x = x.astype(jnp.int8)
    return np.asarray(x)


def qlinear_arrays(q: JQLinear4) -> dict:
    """A JAX QLinear4 as the dict convert.from_reference_arrays takes."""
    st = q.absmax_state
    return {
        "packed": to_np(q.packed), "absmax": to_np(q.absmax),
        "absmax_q": to_np(q.absmax_q),
        "absmax_state": None if st is None else {
            "absmax": to_np(st.absmax), "shape": tuple(st.shape),
            "blocksize": st.blocksize, "dtype": jnp.dtype(st.dtype).name},
        "w_cache": to_np(q.w_cache), "cache_scale": to_np(q.cache_scale),
        "shape": tuple(q.shape), "blocksize": q.blocksize,
        "quant_type": q.quant_type, "dtype": jnp.dtype(q.dtype).name,
        "bias": to_np(q.bias)}


def reference_arrays(tree):
    """A JAX parameter tree as nested dicts/lists of numpy arrays."""
    if isinstance(tree, JQLinear4):
        return qlinear_arrays(tree)
    if isinstance(tree, dict):
        return {k: reference_arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [reference_arrays(v) for v in tree]
    return to_np(tree)


def config_fields(cfg) -> dict:
    """A JAX LlamaConfig's fields for convert.config_from_reference."""
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = jnp.dtype(cfg.dtype).name
    return fields


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| in f32."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def t32(x) -> np.ndarray:
    """A torch tensor as f32 numpy."""
    return x.detach().to(torch.float32).cpu().numpy()


# --------------------------------------------------------------------------

def _weights(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("shape,blocksize", [((64, 256), 64),
                                             ((33, 200), 64),
                                             ((16, 384), 128),
                                             ((1000,), 64)])
def test_quantize_4bit_bytes_match(quant_type, shape, blocksize):
    w = _weights(shape, seed=sum(shape) + blocksize)
    jp, js = F.quantize_4bit(jnp.asarray(w), blocksize=blocksize,
                             quant_type=quant_type)
    tp, ts = TF.quantize_4bit(torch.from_numpy(w), blocksize=blocksize,
                              quant_type=quant_type)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert rel_err(t32(ts.absmax), np.asarray(js.absmax)) <= 1e-6
    # dequantize from the same bytes: codebook lookup times absmax, exact
    jd = F.dequantize_4bit(jp, js)
    td = TF.dequantize_4bit(tp, ts)
    assert rel_err(t32(td), np.asarray(jd, np.float32)) <= 1e-6


def test_nibble_layout():
    idx = torch.arange(16, dtype=torch.uint8).repeat(3).reshape(3, 16)
    packed = TF.pack_nibbles(idx)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(F.pack_nibbles(jnp.asarray(idx.numpy()))))
    assert int(packed[0, 0]) == 0x10     # element 0 low, element 1 high
    np.testing.assert_array_equal(TF.unpack_nibbles(packed).numpy(),
                                  idx.numpy())


def test_double_quant_round_trip():
    """compress_statistics: absmax int8-quantized in blocks of 256. Codes
    must match JAX exactly; the round trip is within the int8 step."""
    w = _weights((64, 1024), seed=5)
    jp, js = F.quantize_4bit(jnp.asarray(w), compress_statistics=True)
    tp, ts = TF.quantize_4bit(torch.from_numpy(w), compress_statistics=True)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.absmax.numpy(), np.asarray(js.absmax))
    assert rel_err(t32(ts.state2.absmax),
                   np.asarray(js.state2.absmax)) <= 1e-6
    am = TF.dequantize_blockwise(ts.absmax, ts.state2)
    am_j = F.dequantize_blockwise(js.absmax, js.state2)
    assert rel_err(t32(am), np.asarray(am_j)) <= 1e-6
    _, plain = TF.quantize_4bit(torch.from_numpy(w))
    # int8 blockwise: |err| <= absmax_block / 254
    bound = plain.absmax.reshape(-1, 256).abs().amax(1, keepdim=True) / 254
    assert ((am - plain.absmax).abs().reshape(-1, 256)
            <= bound + 1e-7).all()
    assert rel_err(t32(TF.dequantize_4bit(tp, ts)),
                   np.asarray(F.dequantize_4bit(jp, js), np.float32)) <= 1e-6


def test_qlinear_compressed_statistics_match():
    """QLinear4's row-aligned double quant (one int8 block per row)."""
    from tpu_bitsandbytes_torch.models.layers import QLinear4
    w = _weights((48, 320), seed=9)
    jq = JQLinear4.quantize(jnp.asarray(w), compress_statistics=True)
    tq = QLinear4.quantize(torch.from_numpy(w), compress_statistics=True)
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
    np.testing.assert_array_equal(tq.absmax_q.numpy(),
                                  np.asarray(jq.absmax_q))
    assert rel_err(t32(tq.materialize_absmax()),
                   np.asarray(jq.materialize_absmax())) <= 1e-6
