"""PyTorch port vs JAX package: the perplexity proxy (``utils/proxy.py``)
and its gate.

* ``make_corpus`` and ``eval_batches`` are numpy in both packages: equal
  bit for bit.
* Parameters trained by JAX's ``train_proxy_lm`` (a few steps: any trained
  weights show the evaluators' equality) are carried across; the port's
  ``teacher_forced_ppl`` and ``decode_ppl`` (float and int8 KV) on them,
  dense and under every quantization of the gate (NF4 with and without
  double quantization, FP4, the int8 and int4 runtime caches), are within
  1e-5 (relative) of JAX's: the same f32 products summed in other orders.
* One AdamW step: the loss on a fixed window batch within 1e-5 of JAX's
  and the gradients within 2e-5 of each leaf's max, and
  ``torch.optim.AdamW`` fed JAX's gradients within 1e-6 of
  ``optax.adamw(lr, weight_decay=0.01)``'s parameters (only the order of
  their f32 operations differs).
* The port's own ``train_proxy_lm`` (its trajectory is its own: its window
  draws come from a torch generator) learns, and passes the six gates of
  ``tests/test_ppl_gate.py`` at 2%.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from tpu_bitsandbytes.models import llama as JL
from tpu_bitsandbytes.utils import proxy as JP
from tpu_bitsandbytes_torch.convert import (config_from_reference,
                                            from_reference_arrays)
from tpu_bitsandbytes_torch.models import llama as TL
from tpu_bitsandbytes_torch.utils import proxy as TP

from test_torch_functional import config_fields, reference_arrays, rel_err

GATE_REL = 0.02     # the reference's 0.1 / 5.68, about 1.8% relative
PPL_TOL = 1e-5      # port vs JAX on the same parameters, f32
# gradients of the f32 loss, each leaf as a share of its max|ref|: f32 sums
# in other orders through two layers and a softmax (7.7e-6 measured)
GRAD_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return JL.LlamaConfig(vocab_size=256, hidden_size=192,
                          intermediate_size=384, num_layers=2, num_heads=4,
                          num_kv_heads=4, max_seq_len=128, dtype=jnp.float32)


CFG = _cfg()
TCFG = config_from_reference(config_fields(CFG))


@pytest.mark.parametrize("seed,length", [(0, 24000), (7, 3001)])
def test_corpus_and_eval_batches_match_jax(seed, length):
    c = TP.make_corpus(seed, 256, length)
    ref = JP.make_corpus(seed, 256, length)
    assert c.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(c, ref)
    for batch, seq, off in ((8, 48, 0), (3, 100, 17)):
        np.testing.assert_array_equal(TP.eval_batches(c, batch, seq, off),
                                      JP.eval_batches(ref, batch, seq, off))


@pytest.fixture(scope="module")
def jax_proxy():
    corpus = JP.make_corpus(0, CFG.vocab_size, 24000)
    params, _ = JP.train_proxy_lm(CFG, corpus[:20000], steps=20, batch=16,
                                  seq=48)
    ev = JP.eval_batches(corpus[20000:], batch=8, seq=48)
    return params, ev


@pytest.fixture(scope="module")
def variants(jax_proxy):
    """The gate's quantizations of JAX's f32 tree, by name: (JAX's tree,
    the port's copy of it)."""
    params, _ = jax_proxy
    q = JL.quantize_params(params, blocksize=64, dtype=jnp.float32)
    trees = {
        "dense": params,
        "nf4": q,
        "nf4_dq": JL.quantize_params(params, blocksize=64, dtype=jnp.float32,
                                     compress_statistics=True),
        "fp4": JL.quantize_params(params, blocksize=64, dtype=jnp.float32,
                                  quant_type="fp4"),
        "int8_cache": JL.build_runtime_cache(q, "int8"),
        "int4_cache": JL.build_runtime_cache(q, "int4"),
    }
    return {k: (v, from_reference_arrays(reference_arrays(v), "cpu"))
            for k, v in trees.items()}


@pytest.mark.parametrize("name", ["dense", "nf4", "nf4_dq", "fp4",
                                  "int8_cache", "int4_cache"])
def test_teacher_forced_ppl_matches_jax(jax_proxy, variants, name):
    """The same (quantized) parameters, carried across: teacher-forced
    perplexity within ``PPL_TOL`` of JAX's, at M = 8 x 49 rows (both
    packages take the dequantized product)."""
    _, ev = jax_proxy
    jtree, ttree = variants[name]
    ref = JP.teacher_forced_ppl(jtree, CFG, ev)
    got = TP.teacher_forced_ppl(ttree, TCFG, ev)
    assert abs(got / ref - 1) <= PPL_TOL, (got, ref)


@pytest.mark.parametrize("name", ["dense", "nf4", "nf4_dq", "fp4",
                                  "int8_cache", "int4_cache"])
@pytest.mark.parametrize("quantized_kv", [False, True])
def test_decode_ppl_matches_jax(jax_proxy, variants, name, quantized_kv):
    """Decode-path perplexity over 32 steps (M = 8 rows) through a float
    or int8 KV cache (the gate's last check), within ``PPL_TOL`` of
    JAX's, for every weight format."""
    _, ev = jax_proxy
    jtree, ttree = variants[name]
    ref = JP.decode_ppl(jtree, CFG, ev[:, :33], quantized_kv=quantized_kv)
    got = TP.decode_ppl(ttree, TCFG, ev[:, :33], quantized_kv=quantized_kv)
    assert abs(got / ref - 1) <= PPL_TOL, (got, ref)


def test_adamw_step_matches_optax(jax_proxy):
    """From JAX's trained parameters, one step on a fixed window batch:
    the port's loss within 1e-5 (relative) and gradients within
    ``GRAD_TOL`` of max|ref| per leaf; ``torch.optim.AdamW`` as
    ``train_proxy_lm`` builds it, fed JAX's gradients, leaves the
    parameters within 1e-6 of ``optax.adamw``'s."""
    params, ev = jax_proxy
    corpus = JP.make_corpus(3, CFG.vocab_size, 2000)
    toks = JP.eval_batches(corpus, batch=16, seq=48)
    loss, grads = jax.jit(lambda p, t: jax.value_and_grad(JP._loss_fn)(
        p, t, CFG))(params, jnp.asarray(toks))
    lr = 1e-3
    opt = optax.adamw(lr, weight_decay=0.01)
    upd, _ = opt.update(grads, opt.init(params), params)
    new = optax.apply_updates(params, upd)

    tparams = from_reference_arrays(reference_arrays(params), "cpu")
    leaves = _leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    with torch.enable_grad():
        tl = TP.proxy_loss(tparams, torch.from_numpy(toks), TCFG)
        tg = torch.autograd.grad(tl, leaves)
    assert abs(float(tl) / float(loss) - 1) <= 1e-5
    ref_grads = _leaves(from_reference_arrays(reference_arrays(grads),
                                              "cpu"))
    assert len(ref_grads) == len(tg)
    errs = [rel_err(got.numpy(), ref.numpy())
            for got, ref in zip(tg, ref_grads)]
    assert max(errs) <= GRAD_TOL
    topt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)
    for t, g in zip(leaves, ref_grads):
        t.grad = g.clone()
    topt.step()
    want = _leaves(from_reference_arrays(reference_arrays(new), "cpu"))
    for got, ref in zip(leaves, want):
        assert float((got.detach() - ref).abs().max()) <= 1e-6


def _leaves(tree):
    """A tree's distinct float tensors, in ``train_proxy_lm``'s order."""
    return list({id(t): t for t in TP._float_leaves(tree)}.values())


@pytest.fixture(scope="module")
def port_proxy():
    """The port's own proxy: JAX's gate configuration and schedule (250
    steps, batch 16, seq 48) on the CPU."""
    corpus = TP.make_corpus(0, TCFG.vocab_size, 24000)
    params, _ = TP.train_proxy_lm(TCFG, corpus[:20000], steps=250, batch=16,
                                  seq=48, device="cpu")
    ev = TP.eval_batches(corpus[20000:], batch=8, seq=48)
    return params, ev, TP.teacher_forced_ppl(params, TCFG, ev)


def test_port_proxy_learned(port_proxy):
    _, _, ppl_fp = port_proxy
    assert ppl_fp < TCFG.vocab_size / 5, ppl_fp


@pytest.mark.parametrize("gate", ["nf4", "nf4_dq", "fp4", "int8_cache",
                                  "int4_cache", "int8_kv_decode"])
def test_port_proxy_passes_the_gate(port_proxy, gate):
    """The six gates of ``tests/test_ppl_gate.py`` on the port's own
    trained proxy, each at ``GATE_REL``."""
    params, ev, ppl_fp = port_proxy
    q = TL.quantize_params(params, blocksize=64, dtype=torch.float32)
    if gate == "int8_kv_decode":
        ppl_fp = TP.decode_ppl(q, TCFG, ev[:, :33], quantized_kv=False)
        ppl_q = TP.decode_ppl(q, TCFG, ev[:, :33], quantized_kv=True)
    else:
        tree = {"nf4": lambda: q,
                "nf4_dq": lambda: TL.quantize_params(
                    params, blocksize=64, dtype=torch.float32,
                    compress_statistics=True),
                "fp4": lambda: TL.quantize_params(
                    params, blocksize=64, dtype=torch.float32,
                    quant_type="fp4"),
                "int8_cache": lambda: TL.build_runtime_cache(q, "int8"),
                "int4_cache": lambda: TL.build_runtime_cache(q, "int4"),
                }[gate]()
        ppl_q = TP.teacher_forced_ppl(tree, TCFG, ev)
    assert abs(ppl_q / ppl_fp - 1) <= GATE_REL, (ppl_fp, ppl_q)


def test_train_proxy_lm_defaults_to_the_card():
    """The entry point builds on the card unless the caller passes a CPU
    device: without CUDA, the default raises instead of running on the
    CPU."""
    import inspect
    assert inspect.signature(TP.train_proxy_lm).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            TP.train_proxy_lm(dataclasses.replace(TCFG, num_layers=1),
                              np.zeros(100, np.int32), steps=1, batch=1,
                              seq=8)
