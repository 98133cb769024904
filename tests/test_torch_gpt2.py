"""PyTorch port vs JAX package: GPT-2.

The JAX package's GPT-2 (tiny, from a PRNG key) hands its weights to the
port's through ``state_dict``; the same token ids then go through both.
f32 logits agree within 1e-5 of max|ref| (another f32 sum order), as do
the perplexities; greedy generation gives the same ids. Quantized through
each package's ``quantize_model`` (NF4, double-quantized statistics) in
bf16, the logits agree within 2e-2 of max|ref| (bf16 rounds at other
places in XLA's CPU fusions than in eager PyTorch, as in the module
tests), differ from the dense model's and keep its cosine above 0.95.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_bitsandbytes import integration as JI
from tpu_bitsandbytes.models import gpt2 as JG
from tpu_bitsandbytes_torch import integration as TI
from tpu_bitsandbytes_torch import nn as TN
from tpu_bitsandbytes_torch.functional import to_tensor
from tpu_bitsandbytes_torch.models import gpt2 as TG

from test_torch_functional import rel_err, t32

F32_TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: the test workers share
    the host's cores, and many threads per worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype):
    """(JAX GPT-2, the port's GPT-2 with its weights), tiny, in ``dtype``
    (a JAX dtype)."""
    jcfg = dataclasses.replace(JG.GPT2Config.tiny(), dtype=dtype)
    jm = JG.GPT2LMHeadModel(jcfg, jax.random.PRNGKey(7))
    tcfg = dataclasses.replace(TG.GPT2Config.tiny(),
                               dtype=to_tensor(np.zeros(1, dtype)).dtype)
    tm = TG.GPT2LMHeadModel(tcfg, seed=7)
    sd = {k: to_tensor(np.asarray(v)) for k, v in jm.state_dict().items()}
    missing, _ = tm.load_state_dict(sd, strict=False)
    assert not missing
    return jm, tm


def _ids(seed, shape=(2, 24)):
    return np.random.default_rng(seed).integers(0, 256, shape)


def test_f32_logits_match_jax():
    jm, tm = _pair(jnp.float32)
    ids = _ids(1)
    ref = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        got = t32(tm(torch.from_numpy(ids)))
    assert got.shape == ref.shape == (2, 24, 256)
    assert rel_err(got, ref) <= F32_TOL


def test_perplexity_and_greedy_match_jax():
    jm, tm = _pair(jnp.float32)
    batches = [_ids(2), _ids(3, (1, 40))]
    ref = JG.perplexity(jm, batches)
    got = TG.perplexity(tm, [torch.from_numpy(b) for b in batches])
    assert abs(got - ref) <= F32_TOL * ref
    start = _ids(4, (1, 6))
    want = np.asarray(jm.generate_greedy(jnp.asarray(start), 8))
    got = tm.generate_greedy(torch.from_numpy(start), 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantized_logits_match_jax():
    """Both packages' ``quantize_model`` (NF4, double quantization) of the
    same bf16 GPT-2: every linear converted, the logits within 2e-2 of the
    JAX model's, changed from the dense model's and close to it."""
    jm, tm = _pair(jnp.bfloat16)
    ids = _ids(5)
    with torch.no_grad():
        dense = tm(torch.from_numpy(ids))
    kw = dict(load_in_4bit=True, bnb_4bit_use_double_quant=True)
    jq = JI.quantize_model(jm, JI.BitsAndBytesConfig(**kw))
    tq = TI.quantize_model(tm, TI.BitsAndBytesConfig(**kw))
    assert isinstance(tq.h[0].attn.c_attn, TN.Linear4bit)
    assert isinstance(tq.lm_head, TN.Linear4bit)
    ref = np.asarray(jq(jnp.asarray(ids)), np.float32)
    with torch.no_grad():
        got = tq(torch.from_numpy(ids))
    assert rel_err(t32(got), ref) <= BF16_TOL
    assert not torch.allclose(got, dense)
    a, b = t32(got).reshape(-1), t32(dense).reshape(-1)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.95
