"""PyTorch port vs JAX package: model checkpoints, both ways.

Each package writes the JAX package's ``.npz`` format and reads the
other's. Tiny Llamas in f32 (B = 2, S = 40: M = 80 rows, where the port
runs K5 and JAX on the CPU the dequantized product, equal f32 products):
the logits of the loaded tree agree with the saving package's within
1e-6 of max|ref| (f32 sums in another order). Packed codes, absmax and
adapters load bit for bit; the ``nn`` modules load with their buffers
bit for bit and give the same outputs as the same module loaded through
``load_state_dict``.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpu_bitsandbytes.nn as JN
from tpu_bitsandbytes.models import gpt2 as JG
from tpu_bitsandbytes.models import llama as JL
from tpu_bitsandbytes.models import lora as JLo
from tpu_bitsandbytes.models.layers import QLinear4 as JQLinear4
from tpu_bitsandbytes.utils import checkpoint as JC
import tpu_bitsandbytes_torch.nn as TN
from tpu_bitsandbytes_torch.convert import config_from_reference
from tpu_bitsandbytes_torch.models import llama as TL
from tpu_bitsandbytes_torch.models import lora as TLo
from tpu_bitsandbytes_torch.models.layers import QLinear4
from tpu_bitsandbytes_torch.utils import checkpoint as TC

from test_torch_functional import config_fields, rel_err, t32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dataclasses.replace(JL.LlamaConfig.tiny(), dtype=jnp.float32)
TOKENS = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 40))


def _jax_tree(double_quant=False, lora=False):
    p = JL.init_params(jax.random.PRNGKey(0), CFG)
    q = JL.quantize_params(p, dtype=CFG.dtype,
                           compress_statistics=double_quant)
    if lora:
        q = JLo.attach_lora(q, jax.random.PRNGKey(1), dtype=jnp.float32)
        t = {k: {"A": v["A"], "B": v["B"] + 0.01}
             for k, v in JLo.lora_trainable(q).items()}
        q = JLo.merge_lora_trainable(q, t)
    return q


def _jax_logits(tree):
    return np.asarray(JL.forward(tree, jnp.asarray(TOKENS, jnp.int32), CFG))


def _port_logits(tree):
    tcfg = config_from_reference(config_fields(CFG))
    with torch.no_grad():
        return t32(TL.forward(tree, torch.from_numpy(TOKENS), tcfg))


@pytest.mark.parametrize("double_quant,lora", [
    (False, False), (True, False), (False, True)])
def test_jax_checkpoint_loads_in_port(tmp_path, double_quant, lora):
    """A JAX ``save_checkpoint`` of a quantized tiny Llama (with double
    quantization, or with LoRA adapters) loads in the port with its types
    and codes and gives JAX's logits."""
    jt = _jax_tree(double_quant, lora)
    JC.save_checkpoint(str(tmp_path / "m"), jt)
    tt = TC.load_checkpoint(str(tmp_path / "m"))
    jl0, tl0 = jt["layers"][0], tt["layers"][0]
    q = tl0["k_proj"]
    assert isinstance(q, QLinear4) and q.dtype == torch.float32
    np.testing.assert_array_equal(q.packed.numpy(),
                                  np.asarray(jl0["k_proj"].packed))
    if double_quant:
        assert q.absmax is None and q.absmax_state is not None
        np.testing.assert_array_equal(q.absmax_q.numpy(),
                                      np.asarray(jl0["k_proj"].absmax_q))
    if lora:
        a = tl0["q_proj"]
        assert isinstance(a, TLo.LoRALinear) and a.scaling == 2.0
        np.testing.assert_array_equal(
            a.lora_B.detach().numpy(), np.asarray(jl0["q_proj"].lora_B))
    ref = _jax_logits(jt)
    assert rel_err(_port_logits(tt), ref) <= 1e-6


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port's ``save_checkpoint`` of a LoRA-attached, double-quantized
    tree (from JAX's weights) loads in JAX as its own types and gives the
    port's logits; an engine-snapshot-like tree round-trips in the port."""
    jt = _jax_tree(double_quant=True, lora=True)
    JC.save_checkpoint(str(tmp_path / "j"), jt)
    tt = TC.load_checkpoint(str(tmp_path / "j"))
    TC.save_checkpoint(str(tmp_path / "t"), tt)
    back = JC.load_checkpoint(str(tmp_path / "t"))
    assert isinstance(back["layers"][0]["q_proj"], JLo.LoRALinear)
    assert isinstance(back["layers"][0]["k_proj"], JQLinear4)
    assert back["layers"][0]["k_proj"].dtype == jnp.float32
    assert rel_err(_jax_logits(back), _port_logits(tt)) <= 1e-6
    snap = {"lengths": torch.arange(3, dtype=torch.int32),
            "kv": [torch.ones(2, 2, dtype=torch.bfloat16)],
            "meta": ("x", 1, 2.5, None, True), "dtype": torch.bfloat16}
    TC.save_checkpoint(str(tmp_path / "s"), snap)
    got = TC.load_checkpoint(str(tmp_path / "s"))
    assert got["meta"] == snap["meta"] and got["dtype"] == torch.bfloat16
    assert torch.equal(got["kv"][0], snap["kv"][0])
    assert JC.load_checkpoint(str(tmp_path / "s"))["dtype"] == jnp.bfloat16


def _jax_modules():
    rng = np.random.default_rng(3)
    lin = JN.Linear(128, 64)
    emb = JN.Embedding(100, 32)
    return {
        "lin": lin, "emb": emb,
        "fc4": JN.Linear4bit.from_linear(lin, compress_statistics=True),
        "fc8": JN.Linear8bit.from_linear(lin),
        "fp8": JN.LinearFP8.from_linear(lin),
        "out": JN.OutlierAwareLinear.from_linear(lin),
        "sb": JN.SwitchBackLinear.from_linear(lin),
        "e4": JN.EmbeddingNF4.from_embedding(emb),
        "e8": JN.Embedding8bit.from_embedding(emb),
    }, rng.standard_normal((6, 128)).astype(np.float32)


def test_module_tree_round_trips(tmp_path):
    """A JAX tree of ``nn`` modules loads in the port as the port's
    classes, buffers bit for bit, each giving the output of the same JAX
    module handed over through ``load_state_dict`` (which the module tests
    hold against JAX); saved again by the port, it
    loads in JAX and gives JAX's outputs. A JAX GPT-2 loads as the port's
    GPT-2 and gives JAX's f32 logits within 1e-5 of max|ref|; a QLinear4
    without its packed codes is refused, as in JAX."""
    jm, x = _jax_modules()
    JC.save_checkpoint(str(tmp_path / "m"), jm)
    tm = TC.load_checkpoint(str(tmp_path / "m"))
    ids = torch.tensor([[1, 5, 99]])
    for name, mod in tm.items():
        assert type(mod).__name__ == type(jm[name]).__name__
        twin = type(mod)(**({"num_embeddings": 100, "embedding_dim": 32}
                            if name.startswith("e") else
                            {"in_features": 128, "out_features": 64}))
        twin.load_state_dict({k: v if isinstance(v, dict) else
                              TN.to_tensor(np.asarray(v)) for k, v in
                              jm[name].state_dict().items()}, strict=False)
        inp = ids if name.startswith("e") else torch.from_numpy(x)
        with torch.no_grad():
            assert torch.equal(mod(inp), twin(inp)), name
    TC.save_checkpoint(str(tmp_path / "t"), tm)
    back = JC.load_checkpoint(str(tmp_path / "t"))
    for name, mod in back.items():
        assert type(mod) is type(jm[name])
        inp = jnp.asarray(ids) if name.startswith("e") else jnp.asarray(x)
        np.testing.assert_array_equal(np.asarray(mod(inp), np.float32),
                                      np.asarray(jm[name](inp), np.float32))
    gcfg = dataclasses.replace(JG.GPT2Config.tiny(), dtype=jnp.float32)
    jg = JG.GPT2LMHeadModel(gcfg, jax.random.PRNGKey(0))
    JC.save_checkpoint(str(tmp_path / "g"), jg)
    tg = TC.load_checkpoint(str(tmp_path / "g"))
    assert type(tg).__name__ == "GPT2LMHeadModel"
    tok = np.random.default_rng(4).integers(0, gcfg.vocab_size, (2, 12))
    ref = np.asarray(jg(jnp.asarray(tok)))
    with torch.no_grad():
        got = tg(torch.from_numpy(tok)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    q = QLinear4.quantize(torch.randn(64, 64)).with_runtime_cache(
        "int8", drop_packed=True)
    with pytest.raises(TypeError, match="packed codes were dropped"):
        TC.save_checkpoint(str(tmp_path / "d"), {"q": q})


def test_load_quantized_requantizes_as_jax(tmp_path):
    """A full-precision tree saved by JAX: the port's ``load_quantized``
    quantizes it on load with JAX's defaults (NF4, blocksize 64, bf16
    compute), codes and absmax bit for bit with JAX's ``load_quantized``
    of the same file; a quantized tree loads as it is."""
    p = JL.init_params(jax.random.PRNGKey(5), CFG)
    JC.save_checkpoint(str(tmp_path / "fp"), p)
    jq = JC.load_quantized(str(tmp_path / "fp"))
    tq = TC.load_quantized(str(tmp_path / "fp"))
    for name in ("q_proj", "down_proj"):
        a, b = tq["layers"][1][name], jq["layers"][1][name]
        assert isinstance(a, QLinear4) and a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.packed.numpy(), np.asarray(b.packed))
        np.testing.assert_array_equal(a.absmax.numpy(), np.asarray(b.absmax))
    np.testing.assert_array_equal(tq["lm_head"].packed.numpy(),
                                  np.asarray(jq["lm_head"].packed))
    JC.save_checkpoint(str(tmp_path / "q"), jq)
    again = TC.load_quantized(str(tmp_path / "q"))
    np.testing.assert_array_equal(again["layers"][0]["v_proj"].packed,
                                  np.asarray(jq["layers"][0]["v_proj"].packed))
