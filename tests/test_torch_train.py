"""PyTorch port vs JAX package: LoRA, the backward passes, the QLoRA step.

The same seeded numpy inputs (and JAX's own weights and adapters, carried
across by ``convert.from_reference_arrays``) go through both packages.
Tolerances, as shares of max|ref| unless said otherwise:

* d_x of the K1/K4/K5 autograd Functions against ``jax.vjp`` of JAX's
  wrappers (their Pallas kernels in interpret mode): f32 1e-5 (the same
  f32 products, only the sum order over N differs); bf16 one bf16 ulp
  (2^-8: the f32 sums are rounded once, to bf16, in both).
* The QLoRA step in f32 on a 2-layer tiny Llama, 3 steps against JAX's
  jitted ``make_qlora_train_step``: the loss to 1e-5 relative, the LoRA
  gradients to 5e-4 (f32 sums in other orders through two layers and a
  softmax; 7e-5 measured), the 8-bit codes within one step of each other
  with at least 99% equal, and the parameters within a quarter of the
  learning rate elementwise: Adam divides each gradient by its own RMS, so
  an element whose gradient is near zero moves its update by far more
  than its gradient's f32 error (0.025 lr measured), and XLA's jit
  contracts the moments' multiply-adds into FMAs.
* ``remat=True`` against ``remat=False`` in the port: identical.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_bitsandbytes.models import layers as JLay
from tpu_bitsandbytes.models import llama as JL
from tpu_bitsandbytes.models import lora as JLo
from tpu_bitsandbytes.ops import int4cache as JI
from tpu_bitsandbytes.ops import matmul4bit as JM
from tpu_bitsandbytes.ops import w4a8 as JW
from tpu_bitsandbytes.parallel import train as JTr
from tpu_bitsandbytes_torch.convert import (config_from_reference,
                                            from_reference_arrays)
from tpu_bitsandbytes_torch.models import layers as TLay
from tpu_bitsandbytes_torch.models import llama as TL
from tpu_bitsandbytes_torch.models import lora as TLo
from tpu_bitsandbytes_torch.ops import flash_decode as TFD
from tpu_bitsandbytes_torch.ops import flash_prefill as TFP
from tpu_bitsandbytes_torch.ops import int4cache as TI
from tpu_bitsandbytes_torch.ops import matmul4bit as TM
from tpu_bitsandbytes_torch.ops import w4a8 as TW
from tpu_bitsandbytes_torch.optim import transforms as TT
from tpu_bitsandbytes_torch.parallel import train as TTr

from test_torch_functional import (config_fields, qlinear_arrays, rel_err,
                                   t32, to_np)
from test_torch_w4a8 import _case


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lora_arrays(tree):
    """A JAX tree with LoRALinear and QLinear4 leaves as numpy, the form
    ``convert.from_reference_arrays`` takes."""
    if isinstance(tree, JLo.LoRALinear):
        return {"base": lora_arrays(tree.base), "lora_A": to_np(tree.lora_A),
                "lora_B": to_np(tree.lora_B), "scaling": tree.scaling}
    if isinstance(tree, JLay.QLinear4):
        return qlinear_arrays(tree)
    if isinstance(tree, dict):
        return {k: lora_arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lora_arrays(v) for v in tree]
    return to_np(tree)


BF16_ULP = 2.0 ** -8


def _vjp_both(jfn, tfn, x, g, dtype):
    """d_x of JAX's function (``jax.vjp``) and of the port's (autograd),
    both fed x and the cotangent g in ``dtype``."""
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jout, vjp = jax.vjp(jfn, jnp.asarray(x, jd))
    (jdx,) = vjp(jnp.asarray(g, jout.dtype))
    tx = torch.from_numpy(x).to(td).requires_grad_()
    tout = tfn(tx)
    assert tout.grad_fn is not None
    tout.backward(torch.from_numpy(g).to(tout.dtype))
    assert tx.grad.dtype == td
    return t32(tx.grad), np.asarray(jdx, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 64, 256])
def test_fused_4bit_backward_matches_jax(dtype, m):
    """K5's Function: d_x against JAX's ``fused_matmul_4bit`` custom VJP,
    N and K odd-sized (K padded to the block)."""
    x, jpk, js, tpk, ts = _case(m, 200, 500, 64, seed=m, dtype=dtype)
    g = np.random.default_rng(m + 1).standard_normal((m, 200)).astype(
        np.float32)
    jd = jnp.dtype(dtype)
    got, ref = _vjp_both(
        lambda a: JM.fused_matmul_4bit(a, jpk, js, mxu_dtype=jd),
        lambda a: TM.fused_matmul_4bit(a, tpk, ts,
                                       mxu_dtype=getattr(torch, dtype)),
        x, g, dtype)
    assert rel_err(got, ref) <= (1e-5 if dtype == "float32" else BF16_ULP)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_backward_matches_jax(dtype):
    """K1's Function (M = 8, the A8 kernel branch): d_x against JAX's
    ``int4_matmul`` custom VJP, K padded."""
    w = (np.random.default_rng(3).standard_normal((256, 200)) * 0.05
         ).astype(np.float32)
    jq, jsc = JI.quantize_int4(jnp.asarray(w))
    tq, tsc = TI.quantize_int4(torch.from_numpy(w))
    x = np.random.default_rng(4).standard_normal((8, 200)).astype(np.float32)
    g = np.random.default_rng(5).standard_normal((8, 256)).astype(np.float32)
    assert TI.takes_kernel(8, 256, 256, TI.INT4_BLOCK)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    got, ref = _vjp_both(
        lambda a: JI.int4_matmul(a, jq, jsc, out_dtype=jd),
        lambda a: TI.int4_matmul(a, tq, tsc, out_dtype=td), x, g, dtype)
    assert rel_err(got, ref) <= (1e-5 if dtype == "float32" else BF16_ULP)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w4a8_backward_matches_jax(dtype):
    """K4's Function (M = 8): d_x against JAX's ``w4a8_matmul_4bit``
    custom VJP (the int8 codebook's weight), K padded."""
    x, jpk, js, tpk, ts = _case(8, 256, 500, 64, seed=9, dtype=dtype)
    g = np.random.default_rng(10).standard_normal((8, 256)).astype(
        np.float32)
    got, ref = _vjp_both(
        lambda a: JW.w4a8_matmul_4bit(a, jpk, js),
        lambda a: TW.w4a8_matmul_4bit(a, tpk, ts), x, g, dtype)
    assert rel_err(got, ref) <= (1e-5 if dtype == "float32" else BF16_ULP)


@pytest.mark.parametrize("route,m", [
    ("int4", 8), ("int4", 80), ("int8", 8), ("bf16", 8), ("packed", 8),
    ("packed", 100), ("packed", 300)])
def test_qlinear4_differentiates_on_every_route(monkeypatch, route, m):
    """``QLinear4.__call__`` in f32 with a bias: d_x against ``jax.vjp`` of
    JAX's ``QLinear4`` on each route (int4 cache: K1, or its dequant
    product past M = 64; int8 and bf16 caches: the XLA dot; packed: K4 to
    M = 64, K5 to 256, the dequant product above), JAX's kernels in
    interpret mode."""
    monkeypatch.setenv("TBNB_W4A8_INTERPRET", "1")
    monkeypatch.setenv("TBNB_FUSED_INTERPRET", "1")
    rng = np.random.default_rng(m)
    w = (rng.standard_normal((256, 256)) * 0.05).astype(np.float32)
    bias = rng.standard_normal(256).astype(np.float32)
    jq = JLay.QLinear4.quantize(jnp.asarray(w), dtype=jnp.float32,
                                bias=jnp.asarray(bias))
    if route != "packed":
        jq = jq.with_runtime_cache(route)
    tq = from_reference_arrays(qlinear_arrays(jq), "cpu")
    x = rng.standard_normal((m, 256)).astype(np.float32)
    g = rng.standard_normal((m, 256)).astype(np.float32)
    got, ref = _vjp_both(jq, tq, x, g, "float32")
    assert rel_err(got, ref) <= 1e-5


def test_lora_linear_matches_jax():
    """A JAX ``LoRALinear`` over a packed bf16 base, carried across: the
    forward output within one bf16 ulp and, with B made non-zero, d_x and
    the gradients of A and B (the port's Parameters) within 1e-2 (bf16
    products rounded at other places by XLA's CPU fusions)."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    base = JLay.QLinear4.quantize(jnp.asarray(w), dtype=jnp.bfloat16)
    a = jnp.asarray(rng.standard_normal((8, 128)) * 0.01, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((256, 8)) * 0.01, jnp.bfloat16)
    jl = JLo.LoRALinear(base=base, lora_A=a, lora_B=b, scaling=2.0)
    tl = from_reference_arrays(lora_arrays({"l": jl}), "cpu")["l"]
    assert isinstance(tl, TLo.LoRALinear) and tl.scaling == 2.0
    assert isinstance(tl.lora_A, torch.nn.Parameter)
    assert tl.shape == (256, 128)
    x = rng.standard_normal((100, 128)).astype(np.float32)
    g = rng.standard_normal((100, 256)).astype(np.float32)

    def jfn(xa, aa, bb):
        return JLo.LoRALinear(base=base, lora_A=aa, lora_B=bb,
                              scaling=2.0)(xa)
    jout, vjp = jax.vjp(jfn, jnp.asarray(x, jnp.bfloat16), a, b)
    jdx, jda, jdb = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tout = tl(tx)
    assert tout.dtype == torch.bfloat16
    assert rel_err(t32(tout), np.asarray(jout, np.float32)) <= BF16_ULP
    tout.backward(torch.from_numpy(g).to(torch.bfloat16))
    for got, ref in ((tx.grad, jdx), (tl.lora_A.grad, jda),
                     (tl.lora_B.grad, jdb)):
        assert got.dtype == torch.bfloat16
        assert rel_err(t32(got), np.asarray(ref, np.float32)) <= 1e-2


def test_attach_lora_keys_and_init():
    """``attach_lora`` from an explicit generator: JAX's targets, keys,
    shapes, dtypes and scaling; A normal(0, 0.01), B zero (so the adapted
    model computes the base model's logits); ``merge_lora_trainable``
    writes new leaves over the same storage."""
    cfg = dataclasses.replace(JL.LlamaConfig.tiny(), dtype=jnp.float32)
    jp = JLo.attach_lora(JL.quantize_params(
        JL.init_params(jax.random.PRNGKey(0), cfg), dtype=cfg.dtype),
        jax.random.PRNGKey(1))
    tcfg = config_from_reference(config_fields(cfg))
    base = TL.quantize_params(TL.init_params(
        tcfg, generator=torch.Generator().manual_seed(0), device="cpu"),
        dtype=tcfg.dtype)
    tp = TLo.attach_lora(base, generator=torch.Generator().manual_seed(1))
    jt, tt = JLo.lora_trainable(jp), TLo.lora_trainable(tp)
    assert list(tt) == list(jt)
    for k in jt:
        for ab in "AB":
            assert tuple(tt[k][ab].shape) == jt[k][ab].shape
            assert tt[k][ab].dtype == torch.bfloat16
        assert not tt[k]["B"].any()
        assert 0.007 < float(tt[k]["A"].detach().float().std()) < 0.013
    assert tp["layers"][0]["q_proj"].scaling == 2.0
    assert tp["layers"][0]["k_proj"] is base["layers"][0]["k_proj"]
    tokens = torch.randint(0, cfg.vocab_size, (1, 12),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(TL.forward(tp, tokens, tcfg),
                           TL.forward(base, tokens, tcfg))
    new = {k: {"A": v["A"] * 2, "B": v["B"] + 1} for k, v in tt.items()}
    merged = TLo.merge_lora_trainable(tp, new)
    mt = TLo.lora_trainable(merged)
    for k in new:
        assert mt[k]["A"].data_ptr() == new[k]["A"].data_ptr()
        assert torch.equal(mt[k]["B"], new[k]["B"])
    assert tp["layers"][0]["q_proj"].lora_B.sum() == 0


def test_attention_kernels_refuse_grad():
    """K2 and K3 have no backward (neither has JAX's Pallas kernel): with
    grad mode on an input that requires grad raises, on the CPU's plain
    versions as on the card; under ``no_grad`` they run. So does a bf16
    prefill of 1024 tokens, where training stops as in JAX; the raw K5,
    K1 and K4 launch wrappers refuse outside their Functions."""
    q = torch.zeros((1, 1024, 2, 128), dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        TFP.flash_prefill_attention(q, q, q, s_real=1024, scale=0.1)
    with pytest.raises(RuntimeError, match="no backward pass"):
        TLay.gqa_attention(q, q, q)
    with torch.no_grad():
        assert TFP.flash_prefill_attention(q[:, :128], q[:, :128],
                                           q[:, :128], s_real=128,
                                           scale=0.1).shape == (1, 128, 2, 128)
    kq = torch.zeros((1, 1, 16, 64), dtype=torch.int8)
    ks = torch.ones((1, 1, 16))
    qd = torch.zeros((1, 2, 64), requires_grad=True)
    off = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward pass"):
        TFD.flash_decode_attention(qd, kq, ks, kq, ks, off)
    with torch.no_grad():
        TFD.flash_decode_attention(qd, kq, ks, kq, ks, off)
    x = torch.zeros((2, 64), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        TM.matmul4bit_mm(x, torch.zeros((8, 32), dtype=torch.uint8),
                         torch.ones((8, 1)), torch.ones(16), "f32")
    xq = torch.zeros((2, 256), dtype=torch.int8)
    sx = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        TI.int4_mm(xq, torch.zeros((8, 128), dtype=torch.uint8),
                   torch.ones((2, 8)), sx)
    with pytest.raises(RuntimeError, match="no backward pass"):
        TW.w4a8_mm(xq, torch.zeros((8, 128), dtype=torch.uint8),
                   torch.ones((8, 4)), sx)


def _tiny_pair(seed=0):
    cfg = dataclasses.replace(JL.LlamaConfig.tiny(), dtype=jnp.float32)
    jp = JLo.attach_lora(JL.quantize_params(
        JL.init_params(jax.random.PRNGKey(seed), cfg), dtype=cfg.dtype),
        jax.random.PRNGKey(seed + 1), dtype=jnp.float32)
    tp = from_reference_arrays(lora_arrays(jp), "cpu")
    return cfg, jp, config_from_reference(config_fields(cfg)), tp


def _jax_loss(cfg):
    def loss(trainable, frozen, tokens):
        params = JLo.merge_lora_trainable(frozen, trainable)
        logits = JL.forward(params, tokens[:, :-1], cfg)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, tokens[:, 1:, None], axis=-1)
        return jnp.mean(nll)
    return jax.jit(jax.value_and_grad(loss))


def _port_grads(tcfg, trainable, frozen, tokens, remat=False):
    return TTr.qlora_loss_and_grads(tcfg, trainable, frozen, tokens, remat)


def test_train_steps_match_jax():
    """Three steps of ``make_qlora_train_step`` (adam8bit(1e-4)) on a
    2-layer tiny Llama in f32, B = 2, 48 positions (M = 96: K5 in the
    port, the dequant product in JAX on the CPU, equal products in f32),
    against JAX's jitted step from the same weights and adapters, within
    the tolerances in the module docstring. The gradients are taken
    before each step from the same trainable leaves in both."""
    cfg, jp, tcfg, tp = _tiny_pair()
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 49)).astype(np.int32)
    jinit, jstep = JTr.make_qlora_train_step(cfg)
    tinit, tstep = TTr.make_qlora_train_step(tcfg)
    jtr, ttr = JLo.lora_trainable(jp), TLo.lora_trainable(tp)
    jst, tst = jinit(jtr), tinit(ttr)
    jgrad = _jax_loss(cfg)
    lr = 1e-4
    for step in range(3):
        jl, jg = jgrad(jtr, jp, jnp.asarray(tokens))
        tl, tg = _port_grads(tcfg, ttr, tp, torch.from_numpy(tokens))
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
        for k in jg:
            for ab in "AB":
                ref = np.asarray(jg[k][ab])
                if step == 0 and ab == "A":      # B = 0: no gradient for A
                    assert not ref.any() and not tg[k][ab].any()
                else:
                    assert rel_err(t32(tg[k][ab]), ref) <= 5e-4, (step, k)
        jtr, jst, jl2 = jstep(jtr, jst, jp, jnp.asarray(tokens))
        ttr, tst, tl2 = tstep(ttr, tst, tp, torch.from_numpy(tokens))
        assert float(tl2) == float(tl)
        assert abs(float(tl2) - float(jl2)) <= 1e-5 * abs(float(jl2))
        assert int(tst.count) == int(jst.count) == step + 1
        for k in jtr:
            for ab in "AB":
                got, ref = t32(ttr[k][ab]), np.asarray(jtr[k][ab])
                assert np.abs(got - ref).max() <= 0.25 * lr, (step, k, ab)
        for field in ("exp_avg_int8", "exp_avg_sq_uint8"):
            got = np.concatenate([t32(c).ravel() for c in TT.tree_leaves(
                getattr(tst, field))])
            ref = np.concatenate([np.asarray(c, np.float32).ravel()
                                  for c in jax.tree_util.tree_leaves(
                                      getattr(jst, field))])
            assert np.abs(got - ref).max() <= 1
            assert (got == ref).mean() >= 0.99


def test_remat_equals_plain(monkeypatch):
    """``remat=True`` recomputes each layer's forward in the backward pass
    (K5 runs again for the layers' seven linears; the head once) and gives
    the same loss and gradients bit for bit; one train step from the same
    start gives the same leaves."""
    cfg, jp, tcfg, tp = _tiny_pair(seed=3)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 41)).astype(np.int32))
    ttr = TLo.lora_trainable(tp)
    # B non-zero, so A has gradients too
    ttr = {k: {"A": v["A"], "B": torch.full_like(v["B"], 0.01)}
           for k, v in ttr.items()}
    calls = []
    mm = TM.matmul4bit_mm
    monkeypatch.setattr(TM, "matmul4bit_mm",
                        lambda *a: calls.append(1) or mm(*a))
    out = {}
    for remat in (False, True):
        calls.clear()
        out[remat] = _port_grads(tcfg, ttr, tp, tokens, remat=remat)
        out[remat] += (len(calls),)
    per_forward = 7 * tcfg.num_layers + 1
    assert out[False][2] == per_forward
    assert out[True][2] == per_forward + 7 * tcfg.num_layers
    assert torch.equal(out[False][0], out[True][0])
    for k in ttr:
        for ab in "AB":
            assert torch.equal(out[False][1][k][ab], out[True][1][k][ab])
    steps = [TTr.make_qlora_train_step(tcfg, remat=r) for r in (False, True)]
    res = [step(ttr, init(ttr), tp, tokens) for init, step in steps]
    assert torch.equal(res[0][2], res[1][2])
    for k in ttr:
        for ab in "AB":
            assert torch.equal(res[0][0][k][ab], res[1][0][k][ab])
