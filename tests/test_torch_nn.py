"""PyTorch port vs JAX package: the quantized modules and model surgery.

Each module is built from the same numpy weight in both packages, by
``from_linear`` (or ``from_embedding``) and by loading the JAX module's
``state_dict`` handed over as numpy; both must hold the same codes and
compute the same outputs. Tolerances, of max|ref|: 1e-5 for f32 products
(another sum order); 2e-2 for bf16 outputs, where XLA's CPU fusions and
eager PyTorch round products and bias additions to bf16 at different
places (one bf16 ulp is 2^-8 of a value, and a few such steps stack);
embeddings are gathers and elementwise decodes, so they are identical.
"""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpu_bitsandbytes as J
from tpu_bitsandbytes import functional as JF
import tpu_bitsandbytes_torch as P
from tpu_bitsandbytes_torch import integration as PI
from tpu_bitsandbytes_torch import nn as PN

from test_torch_functional import rel_err, t32, to_np

F32_TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Src:
    """A Linear-like source both packages convert from."""

    def __init__(self, weight, bias=None, padding_idx=None):
        self.weight, self.bias = weight, bias
        self.padding_idx = padding_idx


def _w(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np_tree(d):
    """A JAX state_dict as numpy (nested dicts kept; bf16 stays bf16)."""
    if isinstance(d, dict):
        return {k: _np_tree(v) for k, v in d.items()}
    if isinstance(d, (jax.Array, np.ndarray)):
        return to_np(d)
    return d


def _src(seed, n=48, k=128, dtype="f32", bias=True):
    w, b = _w((n, k), seed), _w((n,), seed + 1)
    if dtype == "bf16":
        jw = np.asarray(jnp.asarray(w).astype(jnp.bfloat16))
        jb = np.asarray(jnp.asarray(b).astype(jnp.bfloat16))
        return _Src(jw, jb if bias else None)
    return _Src(w, b if bias else None)


def _close(got, ref, dtype):
    assert got.shape == ref.shape
    assert rel_err(t32(got), np.asarray(ref, np.float32)) <= (
        F32_TOL if dtype == "f32" else BF16_TOL)


def _x(shape, seed, dtype):
    x = _w(shape, seed)
    return (jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16"
                                  else jnp.float32),
            torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16"
                                   else torch.float32))


LIN4 = [("nf4", False, "f32"), ("fp4", True, "f32"), ("nf4", True, "bf16")]


@pytest.mark.parametrize("qt,dq,dtype", LIN4)
def test_linear4bit_matches_jax(qt, dq, dtype):
    """Linear4bit from the same weight: identical packed bytes and absmax
    (codes of the nested state too); outputs at M = 6 (K5's plain version
    here) and M = 300 (the dequantized product) against JAX; JAX's
    ``state_dict`` loads into the port; the port's round-trips."""
    src = _src(0, dtype=dtype)
    kw = dict(quant_type=qt, compress_statistics=dq,
              compute_dtype=jnp.float32 if dtype == "f32" else None)
    jl = J.Linear4bit.from_linear(src, **kw)
    kw["compute_dtype"] = torch.float32 if dtype == "f32" else None
    pl = P.Linear4bit.from_linear(src, **kw)
    np.testing.assert_array_equal(pl.weight.numpy(), to_np(jl.weight))
    np.testing.assert_array_equal(pl.weight_quant_state.absmax.numpy(),
                                  to_np(jl.weight_quant_state.absmax))
    for m in (6, 300):
        jx, px = _x((m, 128), m, dtype)
        _close(pl(px), np.asarray(jl(jx).astype(jnp.float32)), dtype)
    jx, px = _x((2, 3, 128), 2, dtype)
    ref = np.asarray(jl(jx).astype(jnp.float32))
    loaded = P.Linear4bit(128, 48, quant_type=qt, compress_statistics=dq,
                          compute_dtype=pl.compute_dtype)
    loaded.load_state_dict(_np_tree(jl.state_dict()))
    _close(loaded(px), ref, dtype)
    sd = pl.state_dict()
    assert list(sd) == list(jl.state_dict())
    again = P.Linear4bit(128, 48, quant_type=qt,
                         compute_dtype=pl.compute_dtype)
    again.load_state_dict(sd)
    assert torch.equal(again(px), pl(px))
    assert tuple(P.Params4bit(pl.weight, quant_state=pl.quant_state
                              ).shape) == (48, 128)


def test_linear4bit_requantizes_and_warns_as_jax():
    """A float checkpoint is quantized on load (the same bytes as JAX's);
    a checkpoint of another blocksize or quant_type warns and wins."""
    w = _w((32, 128), 3)
    jl = J.Linear4bit(128, 32, bias=False)
    jl.load_state_dict({"weight": w})
    pl = P.Linear4bit(128, 32, bias=False)
    pl.load_state_dict({"weight": w})
    np.testing.assert_array_equal(pl.weight.numpy(), to_np(jl.weight))
    other = P.Linear4bit.from_linear(_Src(w), quant_type="fp4",
                                     blocksize=128)
    with pytest.warns(UserWarning, match="blocksize mismatch"), \
            pytest.warns(UserWarning, match="quant_type mismatch"):
        pl.load_state_dict(other.state_dict())
    assert (pl.blocksize, pl.quant_type) == (128, "fp4")
    x = torch.from_numpy(_w((3, 128), 4))
    assert torch.equal(pl(x), other(x))
    with pytest.raises(RuntimeError, match="not quantized"):
        P.Linear4bit(128, 32)(x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_cache", [False, True])
def test_linear8bit_matches_jax(dtype, use_cache):
    src = _src(5, dtype=dtype)
    cd = {"f32": (jnp.float32, torch.float32), "bf16": (None, None)}[dtype]
    jl = J.Linear8bit.from_linear(src, use_cache=use_cache,
                                  compute_dtype=cd[0])
    pl = P.Linear8bit.from_linear(src, use_cache=use_cache,
                                  compute_dtype=cd[1])
    np.testing.assert_array_equal(pl.weight_int8.numpy(),
                                  to_np(jl.weight_int8))
    np.testing.assert_array_equal(pl.weight_scales.numpy(),
                                  to_np(jl.weight_scales))
    jx, px = _x((2, 7, 128), 6, dtype)
    ref = np.asarray(jl(jx).astype(jnp.float32))
    _close(pl(px), ref, dtype)
    loaded = P.Linear8bit(128, 48, compute_dtype=pl.compute_dtype)
    loaded.load_state_dict(_np_tree(jl.state_dict()))
    _close(loaded(px), ref, dtype)
    requant = P.Linear8bit(128, 48, compute_dtype=pl.compute_dtype)
    requant.load_state_dict({"weight": src.weight, "bias": src.bias})
    assert torch.equal(requant.weight_int8, pl.weight_int8)
    with pytest.raises(ValueError, match="full-precision"):
        requant.load_state_dict({"weight": np.zeros((48, 128), np.int8)})


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_linear_fp8_matches_jax(dtype):
    src = _src(7, dtype=dtype)
    cd = {"f32": (jnp.float32, torch.float32), "bf16": (None, None)}[dtype]
    jl = J.LinearFP8.from_linear(src, compute_dtype=cd[0])
    pl = P.LinearFP8.from_linear(src, compute_dtype=cd[1])
    np.testing.assert_array_equal(pl.weight_fp8.numpy(),
                                  to_np(jl.weight_fp8))
    jx, px = _x((2, 4, 128), 8, dtype)
    ref = np.asarray(jl(jx).astype(jnp.float32))
    _close(pl(px), ref, dtype)
    loaded = P.LinearFP8(128, 48, compute_dtype=pl.compute_dtype)
    loaded.load_state_dict(_np_tree(jl.state_dict()))
    _close(loaded(px), ref, dtype)
    np.testing.assert_array_equal(t32(pl.dequantize()),
                                  np.asarray(jl.dequantize(), np.float32))


@pytest.mark.parametrize("kind", ["nf4", "fp4", "int8"])
def test_embeddings_match_jax(kind):
    """A table of odd width (stored padded) with a padding index: lookups
    identical to JAX's, from ``from_embedding`` and from JAX's state."""
    table = np.asarray(jnp.asarray(_w((50, 67 if kind != "int8" else 64),
                                      9)).astype(jnp.bfloat16))
    src = _Src(table, padding_idx=3)
    if kind == "int8":
        jl = J.Embedding8bit.from_embedding(src)
        pl = P.Embedding8bit.from_embedding(src)
        fresh = P.Embedding8bit(50, 64, padding_idx=3)
    else:
        cls = {"nf4": (J.EmbeddingNF4, P.EmbeddingNF4),
               "fp4": (J.EmbeddingFP4, P.EmbeddingFP4)}[kind]
        jl, pl = cls[0].from_embedding(src), cls[1].from_embedding(src)
        fresh = cls[1](50, 68, padding_idx=3)
        assert pl.logical_dim == 67 and pl.quant_type == kind
    ids = np.array([[0, 3, 49], [7, 3, 11]], np.int64)
    ref = np.asarray(jl(jnp.asarray(ids)).astype(jnp.float32))
    got = pl(torch.from_numpy(ids))
    np.testing.assert_array_equal(t32(got), ref)
    assert not got[0, 1].any()
    fresh.load_state_dict(_np_tree(jl.state_dict()))
    np.testing.assert_array_equal(t32(fresh(torch.from_numpy(ids))), ref)


def test_embedding4bit_requantizes_and_warns():
    w = _w((20, 64), 10)
    jl = J.Embedding4bit(20, 64)
    jl.load_state_dict({"weight": w})
    pl = P.Embedding4bit(20, 64)
    pl.load_state_dict({"weight": w})
    np.testing.assert_array_equal(pl.weight_packed.numpy(),
                                  to_np(jl.weight_packed))
    other = P.Embedding4bit.from_embedding(_Src(w), quant_type="fp4",
                                           blocksize=32)
    with pytest.warns(UserWarning, match="blocksize mismatch"):
        pl.load_state_dict(other.state_dict())
    ids = torch.tensor([1, 2, 19])
    assert torch.equal(pl(ids), other(ids))


def test_outlier_aware_matches_jax():
    """Planted outlier columns: the same columns found (on numpy, JAX's
    rule), identical int8 codes, and the output of the exact int8 product
    plus the kept columns' product."""
    w = _w((40, 96), 11, 0.1)
    w[:, [5, 60]] *= 200.0
    src = _Src(np.asarray(jnp.asarray(w).astype(jnp.bfloat16)),
               np.asarray(jnp.asarray(_w((40,), 12)).astype(jnp.bfloat16)))
    jl = J.OutlierAwareLinear.from_linear(src)
    pl = P.OutlierAwareLinear.from_linear(src)
    assert pl.outlier_indices.tolist() == [5, 60] == to_np(
        jl.outlier_indices).tolist()
    np.testing.assert_array_equal(pl.weight_int8.numpy(),
                                  to_np(jl.weight_int8))
    jx, px = _x((3, 5, 96), 13, "bf16")
    ref = np.asarray(jl(jx).astype(jnp.float32))
    _close(pl(px), ref, "bf16")
    loaded = P.OutlierAwareLinear(96, 40, threshold=4.0)
    with pytest.warns(UserWarning, match="threshold mismatch"):
        loaded.load_state_dict(_np_tree(jl.state_dict()))
    assert loaded.num_outliers == 2
    _close(loaded(px), ref, "bf16")
    plain = P.OutlierAwareLinear.from_linear(_Src(_w((16, 64), 14)))
    assert plain.num_outliers == 0
    jplain = J.OutlierAwareLinear.from_linear(_Src(_w((16, 64), 14)))
    jx, px = _x((4, 64), 15, "bf16")
    _close(plain(px), np.asarray(jplain(jx).astype(jnp.float32)), "bf16")


def test_switchback_grads_match_jax():
    """The forward against the int8 weight, and the gradients of x, the
    master weight and the bias against JAX's ``custom_vjp`` (f32, 1e-5);
    they equal a dense torch Linear's whose weight is the master weight."""
    w, b = _w((24, 64), 16), _w((24,), 17)
    x, g = _w((2, 5, 64), 18), _w((2, 5, 24), 19)
    jl = J.SwitchBackLinear(64, 24, compute_dtype=jnp.float32)
    jl.load_state_dict({"weight": w, "bias": b})
    pl = P.SwitchBackLinear(64, 24, compute_dtype=torch.float32)
    pl.load_state_dict({"weight": w, "bias": b})
    np.testing.assert_array_equal(pl.weight_int8.numpy(),
                                  to_np(jl.weight_int8))

    def loss(wfp, bias, xx):
        m = copy.copy(jl)
        m.weight_fp, m.bias = wfp, bias
        return jnp.sum(m(xx) * jnp.asarray(g))

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(
        jl.weight_fp, jl.bias, jnp.asarray(x))
    px = torch.from_numpy(x).requires_grad_(True)
    out = pl(px)
    _close(out.detach(), np.asarray(jl(jnp.asarray(x))), "f32")
    (out * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((pl.weight_fp.grad, pl.bias.grad, px.grad),
                        jgrads):
        _close(got, np.asarray(ref), "f32")
    dense = torch.nn.Linear(64, 24)
    with torch.no_grad():
        dense.weight.copy_(pl.weight_fp)
        dense.bias.copy_(pl.bias)
    dx = torch.from_numpy(x).requires_grad_(True)
    (dense(dx) * torch.from_numpy(g)).sum().backward()
    assert torch.equal(dx.grad, px.grad)
    assert torch.equal(dense.weight.grad, pl.weight_fp.grad)
    assert torch.equal(dense.bias.grad, pl.bias.grad)
    # an optimizer step moves the master; sync requantizes the int8 copy
    with torch.no_grad():
        pl.weight_fp -= 0.5 * pl.weight_fp.grad
    before = pl.weight_int8.clone()
    P.SwitchBackLinearCallback(torch.nn.Sequential(pl)).sync()
    assert not torch.equal(before, pl.weight_int8)
    jl.weight_fp = jl.weight_fp - 0.5 * jgrads[0]
    jl.sync_weights()
    assert (np.abs(pl.weight_int8.numpy().astype(int)
                   - to_np(jl.weight_int8).astype(int)) <= 1).all()
    assert list(pl.state_dict()) == list(jl.state_dict())


# (name, the module built from a weight, an empty one of the same shape)
STRICT = {
    "Linear4bit": (lambda: P.Linear4bit.from_linear(_src(30)),
                   lambda: P.Linear4bit(128, 48)),
    "Linear8bit": (lambda: P.Linear8bit.from_linear(_src(31)),
                   lambda: P.Linear8bit(128, 48)),
    "LinearFP8": (lambda: P.LinearFP8.from_linear(_src(32)),
                  lambda: P.LinearFP8(128, 48)),
    "OutlierAwareLinear": (
        lambda: P.OutlierAwareLinear.from_linear(_src(33)),
        lambda: P.OutlierAwareLinear(128, 48)),
    "SwitchBackLinear": (lambda: P.SwitchBackLinear.from_linear(_src(34)),
                         lambda: P.SwitchBackLinear(128, 48)),
    "Embedding4bit": (
        lambda: P.Embedding4bit.from_embedding(_Src(_w((50, 64), 35))),
        lambda: P.Embedding4bit(50, 64)),
    "Embedding8bit": (
        lambda: P.Embedding8bit.from_embedding(_Src(_w((50, 64), 36))),
        lambda: P.Embedding8bit(50, 64)),
}


def _tensors(module):
    return {k: v for k, v in module.state_dict().items()
            if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("name", list(STRICT))
def test_strict_load_reports_missing_and_unexpected_keys(name):
    """torch's ``strict=True``: a quantized key under another name raises
    (the needed key missing, the misnamed one unexpected), as does a
    missing bias beside a full-precision weight; ``strict=False`` loads
    what it knows, as the JAX package does, and the misnamed tensor keeps
    the empty module's value (the keys are returned, as torch returns
    them). The full state dict loads strictly."""
    build, empty = STRICT[name]
    src = build()
    sd = src.state_dict()
    key = type(src).QUANTIZED_KEYS[-1]
    bad = {("misnamed_" + k if k == key else k): v for k, v in sd.items()}
    with pytest.raises(RuntimeError) as err:
        empty().load_state_dict(bad)
    assert f'Missing key(s) in state_dict: "{key}"' in str(err.value)
    assert f'Unexpected key(s) in state_dict: "misnamed_{key}"' in str(
        err.value)
    lenient, blank = empty(), _tensors(empty())
    keys = lenient.load_state_dict(bad, strict=False)
    assert keys.missing_keys == [key]
    assert keys.unexpected_keys == ["misnamed_" + key]
    got, want = _tensors(lenient), _tensors(src)
    for k in want:
        assert torch.equal(got[k], blank[k] if k == key else want[k]), k
    if name == "Linear4bit":
        assert lenient.weight_quant_state is None
    strict = empty()
    strict.load_state_dict(sd)
    for k, v in _tensors(src).items():
        assert torch.equal(_tensors(strict)[k], v), k
    if getattr(src, "bias", None) is not None:
        w = _w((48, 128), 37)
        with pytest.raises(RuntimeError, match='Missing.*"bias"'):
            empty().load_state_dict({"weight": w})
        empty().load_state_dict({"weight": w, "bias": _w((48,), 38)})


def test_strict_load_of_a_quantized_tree_checks_prefixes():
    """A ``quantize_model`` tree's state dict loads strictly into a tree of
    the same shape (the same output); under a wrong prefix it raises with
    ``strict=True`` and loads nothing of the quantized layer with
    ``strict=False``."""
    cfg = P.BitsAndBytesConfig(load_in_4bit=True)
    q = P.quantize_model(_mlp(20), cfg)
    other = P.quantize_model(_mlp(21), cfg)
    x = torch.from_numpy(_w((4, 128), 22)).to(torch.bfloat16)
    sd = q.state_dict()
    other.load_state_dict(sd)
    assert torch.equal(other(x), q(x))
    moved = {k.replace("2.0.", "2.9.", 1): v for k, v in sd.items()}
    with pytest.raises(RuntimeError, match=r'Missing key.*"2\.0\.weight'
                                           r'_quant_state"'):
        P.quantize_model(_mlp(21), cfg).load_state_dict(moved)
    lenient = P.quantize_model(_mlp(21), cfg)
    before = lenient[2][0].weight.clone()
    lenient.load_state_dict(moved, strict=False)
    assert torch.equal(lenient[2][0].weight, before)
    assert torch.equal(lenient[0].weight, q[0].weight)


# -- model surgery -------------------------------------------------------------

def _mlp(seed=20):
    torch.manual_seed(seed)
    return torch.nn.Sequential(
        torch.nn.Linear(128, 256), torch.nn.ReLU(),
        torch.nn.Sequential(torch.nn.Linear(256, 256), torch.nn.ReLU()),
        torch.nn.Linear(256, 64)).to(torch.bfloat16)


def _cos(a, b):
    a, b = a.float().reshape(-1), b.float().reshape(-1)
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_model_converts_a_torch_mlp(bits):
    """``quantize_model`` on a torch MLP: every Linear converted in place
    but the skipped one, the output changed (not a silent no-op) and
    within cosine 0.95 of the dense model's, and equal to the JAX
    package's quantize_model on the same torch model (within 2e-2)."""
    x = torch.from_numpy(_w((4, 128), 21)).to(torch.bfloat16)
    dense = _mlp()
    ref = dense(x)
    cfg = P.BitsAndBytesConfig(load_in_4bit=bits == 4,
                               load_in_8bit=bits == 8,
                               bnb_4bit_use_double_quant=True)
    jcfg = J.BitsAndBytesConfig(load_in_4bit=bits == 4,
                                load_in_8bit=bits == 8,
                                bnb_4bit_use_double_quant=True)
    jq = J.quantize_model(copy.deepcopy(dense), jcfg,
                          modules_to_not_convert=["3"])
    q = P.quantize_model(copy.deepcopy(dense), cfg,
                         modules_to_not_convert=["3"])
    cls = P.Linear4bit if bits == 4 else P.Linear8bit
    assert isinstance(q[0], cls) and isinstance(q[2][0], cls)
    assert type(q[3]) is torch.nn.Linear
    if bits == 4:
        assert q[0].weight_quant_state.state2 is not None
    out = q(x)
    assert not torch.allclose(out, ref)
    assert _cos(out, ref) > 0.95
    assert rel_err(t32(out), t32(jq(x))) <= BF16_TOL
    fp = P.get_memory_footprint(q)
    dfp = P.get_memory_footprint(dense)
    assert fp["quantized_params"] > 0 == dfp["quantized_params"]
    assert fp["actual_size_gb"] < dfp["actual_size_gb"]
    assert dfp["total_params"] == sum(p.numel() for p in dense.parameters())


def test_replace_linear_walks_and_skips():
    """``replace_linear_with_8bit`` skips the config's
    ``llm_int8_skip_modules`` by default; the port's own ``nn.Linear``
    converts like a torch one."""
    model = torch.nn.Module()
    model.proj = PN.Linear(64, 32, dtype=torch.float32)
    model.head = torch.nn.Linear(32, 8)
    cfg = P.BitsAndBytesConfig(load_in_8bit=True,
                               llm_int8_skip_modules=["head"])
    P.replace_linear_with_8bit(model, cfg)
    assert isinstance(model.proj, P.Linear8bit)
    assert type(model.head) is torch.nn.Linear
    P.replace_linear_with_4bit(model, P.BitsAndBytesConfig(load_in_4bit=True))
    assert isinstance(model.head, P.Linear4bit)
    assert isinstance(model.proj, P.Linear8bit)


def test_bnb_config_matches_jax():
    for kw in ({}, {"load_in_4bit": True, "bnb_4bit_quant_type": "fp4"},
               {"load_in_8bit": True, "llm_int8_skip_modules": ["lm_head"]}):
        c, jc = P.BitsAndBytesConfig(**kw), J.BitsAndBytesConfig(**kw)
        assert c.to_dict() == jc.to_dict()
        assert c.quantization_method == jc.quantization_method
        assert P.BitsAndBytesConfig.from_dict(c.to_dict()) == c
    f16 = P.BitsAndBytesConfig.from_dict(
        {"load_in_4bit": True, "bnb_4bit_compute_dtype": "float16"})
    assert f16.bnb_4bit_compute_dtype == torch.float16
    with pytest.raises(ValueError, match="both"):
        P.BitsAndBytesConfig(load_in_4bit=True, load_in_8bit=True)
    with pytest.raises(ValueError, match="nf4"):
        P.BitsAndBytesConfig(bnb_4bit_quant_type="int4")


def test_linear_and_embedding_defaults():
    """The plain modules: x cast to the weight's dtype, zero bias, the
    padding row zeroed on lookup, a seed for the weights."""
    lin = PN.Linear(16, 8)
    assert lin.weight.dtype == torch.bfloat16 and not lin.bias.any()
    assert lin(torch.ones(2, 16)).dtype == torch.bfloat16
    assert torch.equal(PN.Linear(16, 8).weight, lin.weight)
    emb = PN.Embedding(10, 4, padding_idx=2)
    with torch.no_grad():
        emb.weight.fill_(1.0)
    assert not emb(torch.tensor([2]))[0].any()
    assert PN.to_tensor(np.ones(3, np.float32)).dtype == torch.float32


def test_patch_transformers():
    """``patch_transformers``: a tiny HF Llama saved and loaded through
    ``from_pretrained`` with this package's config comes back with
    Linear4bit projections and a dense ``lm_head``; unpatching restores
    the original loader."""
    transformers = pytest.importorskip("transformers")
    import tempfile
    hf_cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=64, intermediate_size=128,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg)
    orig = transformers.modeling_utils.PreTrainedModel.from_pretrained
    with tempfile.TemporaryDirectory() as d:
        model.save_pretrained(d)
        assert P.patch_transformers()
        try:
            q = transformers.LlamaForCausalLM.from_pretrained(
                d, quantization_config=P.BitsAndBytesConfig(
                    load_in_4bit=True))
        finally:
            P.unpatch_transformers()
    attn = q.model.layers[0].self_attn
    assert isinstance(attn.q_proj, P.Linear4bit)
    assert type(q.lm_head) is torch.nn.Linear
    ids = torch.tensor([[1, 2, 3]])
    assert q(ids).logits.shape == (1, 3, 64)
    assert (transformers.modeling_utils.PreTrainedModel.from_pretrained
            .__func__ is orig.__func__)
    assert PI._ORIG_FROM_PRETRAINED is None
