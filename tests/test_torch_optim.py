"""PyTorch port vs JAX package: the 8-bit and paged optimizers.

The same seeded numpy parameters and gradients go through both packages.
The state codecs are bit for bit (the port computes what XLA compiles the
jitted JAX functions to). The transforms and the wrappers are bit for bit
too, codes, absmax, updates and parameters, over 5 steps: every operation
is elementwise f32 with the same constants and order, and the bias
corrections reproduce XLA's f32 power. The transforms are held to JAX's
update run eagerly (a jit contracts multiply-adds into FMAs, see the
train-step tests). The one exception is
``max_grad_norm``: the global norm is an f32 sum whose order differs
between XLA and PyTorch, so the clipped gradients may differ by a few f32
ulps, and the parameters are held to 1e-6 of max|ref| (f32) or one bf16
ulp (bf16) after 5 steps.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpu_bitsandbytes import optim as JO
from tpu_bitsandbytes.optim import transforms as JT
from tpu_bitsandbytes_torch import optim as TO
from tpu_bitsandbytes_torch.optim import transforms as TT

from test_torch_functional import rel_err, t32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _same(got, ref):
    """Bit-equal tensors (bf16 compared by value through f32)."""
    got = got.detach()
    if got.dtype == torch.bfloat16:
        got = got.to(torch.float32)
    np.testing.assert_array_equal(got.numpy(), _np(ref))


@pytest.mark.parametrize("n", [1, 255, 257, 4097])
def test_state_codecs_match_jax(n):
    """quantize/dequantize, signed and unsigned (with the negative-value
    warning), bit for bit, over magnitudes from 1e-6 to 30."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n)
         * rng.choice([1e-6, 1e-3, 1.0, 30.0], n)).astype(np.float32)
    jq, jax_ = JO.quantize_state(jnp.asarray(x))
    tq, tax = TO.quantize_state(torch.from_numpy(x))
    _same(tq, jq), _same(tax, jax_)
    _same(TO.dequantize_state(tq, tax), JO.dequantize_state(jq, jax_))
    v = x * x
    v[::7] *= -1
    with pytest.warns(UserWarning, match="negative values clamped"):
        tu, tmx = TO.quantize_state_unsigned(torch.from_numpy(v),
                                             warn_on_negative=True)
    ju, jmx = JO.quantize_state_unsigned(jnp.asarray(v))
    _same(tu, ju), _same(tmx, jmx)
    assert tu.dtype == torch.uint8 and tq.dtype == torch.int8
    _same(TO.dequantize_state_unsigned(tu, tmx),
          JO.dequantize_state_unsigned(ju, jmx))
    # a 2-D state keeps its shape; bf16 output
    x2 = x[: (n // 3) * 3].reshape(3, -1) if n >= 3 else x.reshape(1, 1)
    jq2, ja2 = JO.quantize_state(jnp.asarray(x2), block_size=64)
    tq2, ta2 = TO.quantize_state(torch.from_numpy(x2), block_size=64)
    _same(tq2, jq2), _same(ta2, ja2)
    _same(TO.dequantize_state(tq2, ta2, 64, dtype=torch.bfloat16),
          JO.dequantize_state(jq2, ja2, 64, dtype=jnp.bfloat16))


def _tree(seed, dtype="float32"):
    """Two leaves of odd sizes under a nested dict (sorted-key order
    differs from insertion order)."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (37, 19), "b": (300,)}
    return {"z": {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in shapes.items()},
            "a": rng.standard_normal((5,)).astype(np.float32)}


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    return fn(tree)


def _grads(step, seed=1):
    return _tree(seed * 100 + step)


TRANSFORMS = {
    "adam": (lambda m: m.adam8bit(1e-2, weight_decay=0.05), True),
    "adamw": (lambda m: m.adamw8bit(1e-2, weight_decay=0.05), True),
    "lion": (lambda m: m.lion8bit(1e-3, weight_decay=0.1), False),
    "sgd": (lambda m: m.sgd8bit(1e-2, momentum=0.9, weight_decay=0.01,
                                nesterov=True), False),
    "sgd_plain": (lambda m: m.sgd8bit(1e-2, momentum=0.0, dampening=0.0),
                  False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name, dtype):
    """Five updates of each transform, weight decay in both Adam modes,
    applied as ``optax.apply_updates`` does: the updates, every state leaf
    and the parameters bit for bit with JAX's update run eagerly (as its
    wrappers run it). Inside a jit, XLA contracts ``a * b + c`` into fused
    multiply-adds (weight decay, the moments), which PyTorch's separate
    elementwise kernels do not: the train-step test holds that path to a
    tolerance."""
    import jax
    import optax
    make, _ = TRANSFORMS[name]
    jtx, ttx = make(JT), make(TT)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    p0 = _tree(0)
    jp = _as(p0, lambda a: jnp.asarray(a, jd))
    tp = _as(p0, lambda a: torch.from_numpy(a).to(td))
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(5):
        g = _grads(step)
        ju, js = jtx.update(_as(g, lambda a: jnp.asarray(a, jd)), js, jp)
        tu, ts = ttx.update(_as(g, lambda a: torch.from_numpy(a).to(td)),
                            ts, tp)
        jp = optax.apply_updates(jp, ju)
        tp = TT.apply_updates(tp, tu)
        for got, ref in zip(TT.tree_leaves(tu), jax.tree_util.tree_leaves(ju)):
            assert got.dtype == td
            _same(got, ref)
        for got, ref in zip(TT.tree_leaves(list(ts)),
                            jax.tree_util.tree_leaves(list(js))):
            _same(got, ref)
    for got, ref in zip(TT.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        _same(got, ref)


WRAPPERS = {
    "Adam8bit": dict(lr=1e-2, weight_decay=0.05),
    "AdamW8bit": dict(lr=1e-2, betas=(0.8, 0.99), max_grad_norm=0.5),
    "Lion8bit": dict(lr=1e-3, weight_decay=0.1),
    "SGD8bit": dict(lr=1e-2, momentum=0.9, weight_decay=0.01),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_matches_jax(name, dtype):
    """Five ``step()``s of each ``torch.optim`` wrapper, reading ``.grad``,
    against JAX's wrapper's ``step(grads)``: the parameters (added in f32
    and cast back in both) bit for bit, and with ``max_grad_norm`` within
    the bound in the module docstring; the state's dtypes and its step."""
    import jax
    kw = WRAPPERS[name]
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    p0 = _tree(3)
    leaves = jax.tree_util.tree_leaves(p0)
    jopt = getattr(JO, name)(_as(p0, lambda a: jnp.asarray(a, jd)), **kw)
    # copies: step() writes the parameters in place, and JAX's arrays may
    # share the numpy buffers
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(td))
               for a in leaves]
    topt = getattr(TO, name)(tparams, **kw)
    for step in range(5):
        g = _grads(step, seed=2)
        ref = jopt.step(_as(g, lambda a: jnp.asarray(a, jd)))
        for p, a in zip(tparams, jax.tree_util.tree_leaves(g)):
            p.grad = torch.from_numpy(a).to(td)
        topt.step()
    for p, r in zip(tparams, jax.tree_util.tree_leaves(ref)):
        if "max_grad_norm" in kw:
            tol = 1e-6 if dtype == "float32" else 2 ** -7
            assert rel_err(t32(p), _np(r)) <= tol
        else:
            _same(p, r)
    st = topt.state[tparams[0]]
    if name.startswith("Adam"):
        assert int(st["step"]) == 5
        assert st["exp_avg_int8"].dtype == torch.int8
        assert st["exp_avg_sq_uint8"].dtype == torch.uint8
    else:
        codes = st["exp_avg_int8" if name == "Lion8bit" else "momentum_int8"]
        assert codes.dtype == torch.int8


def test_wrapper_validation_matches_jax():
    """The constructors refuse what JAX's refuse, with its messages."""
    p = [torch.nn.Parameter(torch.zeros(3))]
    for cls, kw, msg in [
            ("Adam8bit", dict(lr=-1.0), "Invalid learning rate"),
            ("AdamW8bit", dict(eps=-1.0), "Invalid epsilon"),
            ("Adam8bit", dict(betas=(1.0, 0.9)), "Invalid beta1"),
            ("Adam8bit", dict(max_grad_norm=0.0), "Invalid max_grad_norm"),
            ("Lion8bit", dict(betas=(0.9, 1.5)), "Invalid beta2"),
            ("SGD8bit", dict(nesterov=True, momentum=0.0),
             "Nesterov momentum"),
            ("PagedAdamW", dict(weight_decay=-1.0), "Invalid weight_decay"),
            ("PagedLion", dict(lr=-1.0), "Invalid learning rate")]:
        with pytest.raises(ValueError, match=msg):
            getattr(TO, cls)(p, **kw)
        with pytest.raises(ValueError, match=msg):
            getattr(JO, cls)({"a": jnp.zeros(3)}, **kw)


@pytest.mark.parametrize("name,kw", [
    ("PagedAdamW", dict(lr=1e-2, weight_decay=0.05)),
    ("PagedAdam", dict(lr=1e-2, weight_decay=0.05)),
    ("PagedLion", dict(lr=1e-3, weight_decay=0.1)),
])
def test_paged_matches_jax(name, kw):
    """Five steps of each paged optimizer, one leaf past the 32,768-element
    split and two below it, f32 and bf16 leaves (on the CPU the states stay
    beside the parameters, as in JAX without an accelerator). JAX's leaf
    step is jitted, and XLA contracts its multiply-adds into FMAs, which
    the port's separate elementwise ops round twice: f32 parameters and the
    f32 states are held to 1e-6 of max|ref| (a few f32 ulps), bf16
    parameters to one bf16 ulp at max|ref|."""
    import jax
    rng = np.random.default_rng(7)
    shapes = [(256, 160), (300,), (4, 5)]
    dts = ["float32", "bfloat16", "float32"]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jopt = getattr(JO, name)(
        [jnp.asarray(a, jnp.dtype(d)) for a, d in zip(p0, dts)], **kw)
    tparams = [torch.nn.Parameter(
        torch.from_numpy(a.copy()).to(getattr(torch, d)))
        for a, d in zip(p0, dts)]
    topt = getattr(TO, name)(tparams, **kw)
    for step in range(5):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        ref = jopt.step([jnp.asarray(a, jnp.dtype(d))
                         for a, d in zip(g, dts)])
        for p, a in zip(tparams, g):
            p.grad = torch.from_numpy(a).to(p.dtype)
        topt.step()
    topt.synchronize()
    for p, r, d in zip(tparams, ref, dts):
        assert p.dtype == getattr(torch, d)
        assert rel_err(t32(p), _np(r)) <= (1e-6 if d == "float32"
                                           else 2 ** -8)
    for p, js in zip(tparams, jopt.state):
        assert set(topt.state[p]) == set(js) | {"step"}
        for key, v in js.items():
            assert topt.state[p][key].dtype == torch.float32
            assert rel_err(t32(topt.state[p][key]), _np(v)) <= 1e-6


@pytest.mark.parametrize("name", ["Adam8bit", "Lion8bit", "PagedAdamW"])
def test_state_dict_round_trip(name):
    """``state_dict()`` into a fresh optimizer over copies of the
    parameters: the state keeps its dtypes (int8/uint8 codes stay
    integers), and the next steps of both are identical."""
    def make():
        torch.manual_seed(0)
        ps = [torch.nn.Parameter(torch.randn(40, 30)),
              torch.nn.Parameter(torch.randn(7).to(torch.bfloat16))]
        return ps, getattr(TO, name)(ps, lr=1e-2)

    ps, opt = make()
    for step in range(2):
        for p in ps:
            p.grad = torch.full_like(p, 0.1 * (step + 1))
        opt.step()
    sd = opt.state_dict()
    qs, opt2 = make()
    with torch.no_grad():
        for q, p in zip(qs, ps):
            q.copy_(p)
    opt2.load_state_dict(sd)
    for p, q in zip(ps, qs):
        for k, v in opt.state[p].items():
            w = opt2.state[q][k]
            if isinstance(v, torch.Tensor):
                assert w.dtype == v.dtype and torch.equal(w, v), k
            else:
                assert w == v
    for o, params in ((opt, ps), (opt2, qs)):
        for p in params:
            p.grad = torch.full_like(p, -0.3)
        o.step()
    for p, q in zip(ps, qs):
        assert torch.equal(p, q)


def test_clip_by_global_norm_matches_jax():
    """The clipped gradients within a few f32 ulps of JAX's (the norm's
    sum order differs), each in its own dtype; below the limit unchanged."""
    rng = np.random.default_rng(5)
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((33, 7), (90,))]
    for max_norm in (0.5, 1e3):
        ref = JO.clip_by_global_norm([jnp.asarray(g) for g in gs], max_norm)
        got = TO.clip_by_global_norm([torch.from_numpy(g) for g in gs],
                                     max_norm)
        for a, b in zip(got, ref):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-7,
                                       atol=0)
    got = TO.clip_by_global_norm([torch.ones(4, dtype=torch.bfloat16)], 1.0)
    assert got[0].dtype == torch.bfloat16
