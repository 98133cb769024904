"""The port's HuggingFace loading against ``transformers`` itself.

Each family of the JAX package's ``tests/test_hf_differential.py`` (Llama,
Llama-3.1 rope scaling, Qwen2 with and without per-layer windows, Mistral,
Mixtral, Qwen2-MoE with a dense layer, Gemma, Gemma2, Phi-3, Phi-2 and
StableLM) is built from its config class with random weights; its state
dict goes through ``utils.hf`` into the port, whose f32 logits must agree
with HF's own forward within the JAX tests' tolerances (2e-4 of max|ref|,
3e-4 for Gemma2, Mixtral and Qwen2-MoE), and whose config mapping must
equal the JAX package's field by field. GPT-2 likewise. Skips without
``transformers``; no weights, config or dataset is downloaded.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

transformers = pytest.importorskip("transformers")

from tpu_bitsandbytes.utils import hf as JH
from tpu_bitsandbytes_torch.convert import config_from_reference
from tpu_bitsandbytes_torch.engine.engine import DecodeEngine
from tpu_bitsandbytes_torch.engine.sampler import SamplingParams
from tpu_bitsandbytes_torch.models import gpt2 as TG
from tpu_bitsandbytes_torch.models import llama as TL
from tpu_bitsandbytes_torch.models.layers import QLinear4
from tpu_bitsandbytes_torch.utils import hf as TH

from test_torch_functional import config_fields

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=112,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)
EAGER = dict(attn_implementation="eager")

# name -> (seed, model class, config class, config kwargs, tokens, tolerance)
FAMILIES = {
    "llama": (0, "LlamaForCausalLM", "LlamaConfig",
              dict(SMALL, rms_norm_eps=1e-5, tie_word_embeddings=False),
              (2, 9), 2e-4),
    "llama3_rope": (5, "LlamaForCausalLM", "LlamaConfig",
                    dict(SMALL, rope_scaling={
                        "rope_type": "llama3", "factor": 4.0,
                        "low_freq_factor": 1.0, "high_freq_factor": 2.0,
                        "original_max_position_embeddings": 16},
                         tie_word_embeddings=False), (1, 40), 2e-4),
    "qwen2": (1, "Qwen2ForCausalLM", "Qwen2Config",
              dict(SMALL, rms_norm_eps=1e-6, rope_theta=1e6,
                   tie_word_embeddings=True), (2, 11), 2e-4),
    "qwen2_windowed": (11, "Qwen2ForCausalLM", "Qwen2Config",
                       dict(SMALL, num_hidden_layers=4, rms_norm_eps=1e-6,
                            use_sliding_window=True, sliding_window=8,
                            max_window_layers=2, tie_word_embeddings=True,
                            **EAGER), (1, 24), 2e-4),
    "mistral": (3, "MistralForCausalLM", "MistralConfig",
                dict(SMALL, sliding_window=8, tie_word_embeddings=False,
                     **EAGER), (2, 24), 2e-4),
    "mixtral": (8, "MixtralForCausalLM", "MixtralConfig",
                dict(SMALL, num_local_experts=4, num_experts_per_tok=2,
                     sliding_window=None, tie_word_embeddings=False,
                     **EAGER), (2, 10), 3e-4),
    "qwen2_moe": (12, "Qwen2MoeForCausalLM", "Qwen2MoeConfig",
                  dict(SMALL, num_hidden_layers=3, rms_norm_eps=1e-6,
                       num_experts=4, num_experts_per_tok=2,
                       moe_intermediate_size=48,
                       shared_expert_intermediate_size=80,
                       norm_topk_prob=False, decoder_sparse_step=1,
                       mlp_only_layers=[1], tie_word_embeddings=False,
                       **EAGER), (2, 10), 3e-4),
    "gemma": (4, "GemmaForCausalLM", "GemmaConfig",
              dict(SMALL, num_key_value_heads=1, head_dim=24,
                   rms_norm_eps=1e-6, hidden_activation="gelu_pytorch_tanh",
                   attention_bias=False), (2, 13), 2e-4),
    "gemma2": (6, "Gemma2ForCausalLM", "Gemma2Config",
               dict(SMALL, num_hidden_layers=4, head_dim=24,
                    rms_norm_eps=1e-6, hidden_activation="gelu_pytorch_tanh",
                    attn_logit_softcapping=20.0, final_logit_softcapping=10.0,
                    query_pre_attn_scalar=16, sliding_window=8, **EAGER),
               (2, 24), 3e-4),
    "phi3": (9, "Phi3ForCausalLM", "Phi3Config",
             dict(SMALL, pad_token_id=0, tie_word_embeddings=False, **EAGER),
             (2, 10), 2e-4),
    "phi2": (14, "PhiForCausalLM", "PhiConfig",
             dict(SMALL, intermediate_size=256, num_key_value_heads=4,
                  partial_rotary_factor=0.5, hidden_act="gelu_new",
                  tie_word_embeddings=False, **EAGER), (2, 11), 2e-4),
    "stablelm": (15, "StableLmForCausalLM", "StableLmConfig",
                 dict(SMALL, partial_rotary_factor=0.25, use_qkv_bias=True,
                      tie_word_embeddings=False, **EAGER), (2, 12), 2e-4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: the test workers share
    the host's cores, and many threads per worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def hf_model(name):
    """(HF model in f32, eval mode, its config), built once per module."""
    if name not in _MODELS:
        seed, model_cls, cfg_cls, kw, _, _ = FAMILIES[name]
        torch.manual_seed(seed)
        config = getattr(transformers, cfg_cls)(**kw)
        model = getattr(transformers, model_cls)(config).float().eval()
        _MODELS[name] = (model, config)
    return _MODELS[name]


def _port(model, config, quantize=False):
    cfg = dataclasses.replace(TH.llama_config_from_hf(config),
                              dtype=torch.float32)
    params = TH.llama_params_from_state_dict(
        model.state_dict(), cfg, dtype=torch.float32, quantize=quantize)
    return cfg, params


def _agree(got, ref, tol):
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("name", list(FAMILIES))
def test_logits_match_hf(name):
    model, config = hf_model(name)
    tokens = np.random.default_rng(FAMILIES[name][0]).integers(
        0, config.vocab_size, FAMILIES[name][4])
    cfg, params = _port(model, config)
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens)).logits.float().numpy()
        got = TL.forward(params, torch.from_numpy(tokens), cfg).numpy()
    _agree(got, ref, FAMILIES[name][5])


@pytest.mark.parametrize("name", list(FAMILIES))
def test_config_mapping_matches_jax(name):
    """``llama_config_from_hf`` equals the JAX package's mapping of the
    same HF config, field by field (the dict form too)."""
    _, config = hf_model(name)
    want = config_from_reference(config_fields(JH.llama_config_from_hf(
        config)))
    assert TH.llama_config_from_hf(config) == want
    assert TH.llama_config_from_hf(config.to_dict()) == want


@pytest.mark.parametrize("name", ["mistral", "mixtral", "gemma2", "phi2"])
def test_engine_decode_matches_hf_generate(name):
    """The port's engine (f32, unquantized KV) gives HF's greedy tokens
    (up to HF's EOS, where both stop); Mistral's and Gemma2's decode
    crosses the window of 8."""
    model, config = hf_model(name)
    cfg, params = _port(model, config)
    prompt = np.random.default_rng(20).integers(
        0, config.vocab_size, 6).tolist()
    with torch.no_grad():
        out = model.generate(torch.tensor([prompt]), max_new_tokens=12,
                             do_sample=False, pad_token_id=0)
    eng = DecodeEngine(params, cfg, max_batch=1, max_seq=64,
                       quantized_kv=False, device="cpu")
    eos = config.eos_token_id        # HF stops at its EOS; so does the port
    got = eng.generate([prompt], SamplingParams(
        max_new_tokens=12, eos_token_id=eos))[0]
    assert got == out[0, len(prompt):].tolist()


def test_load_from_a_model_object_quantizes_as_jax():
    """``load_llama_from_pretrained`` given a Mixtral model object:
    NF4 leaves (experts included) with the JAX loader's packed bytes and
    absmax, the routers in f32, and logits that still track HF's."""
    model, _ = hf_model("mixtral")
    cfg, params = TH.load_llama_from_pretrained(model, dtype=torch.float32)
    jcfg, jparams = JH.load_llama_from_pretrained(model, dtype=jnp.float32)
    assert cfg == config_from_reference(config_fields(jcfg))
    for a, b in ((params["layers"][1]["moe"]["experts"][3]["down_proj"],
                  jparams["layers"][1]["moe"]["experts"][3]["down_proj"]),
                 (params["lm_head"], jparams["lm_head"])):
        assert isinstance(a, QLinear4)
        np.testing.assert_array_equal(a.packed.numpy(), np.asarray(b.packed))
        np.testing.assert_array_equal(a.absmax.numpy(), np.asarray(b.absmax))
    assert params["layers"][0]["moe"]["router"].dtype == torch.float32
    tokens = torch.tensor([[3, 17, 99, 5, 64, 2, 31]])
    with torch.no_grad():
        ref = model(tokens).logits.float().numpy()
    got = TL.forward(params, tokens, cfg).numpy()
    cos = (got.ravel() @ ref.ravel()
           / (np.linalg.norm(got) * np.linalg.norm(ref)))
    assert cos > 0.95 and not np.allclose(got, ref, atol=1e-4)


def test_gpt2_matches_hf():
    """An HF GPT-2 (Conv1D weights transposed on load, the tied lm_head)
    gives HF's f32 logits within 2e-4 of max|ref|."""
    torch.manual_seed(16)
    config = transformers.GPT2Config(vocab_size=128, n_positions=64,
                                     n_embd=64, n_layer=2, n_head=4)
    model = transformers.GPT2LMHeadModel(config).float().eval()
    ours = TH.gpt2_params_from_state_dict(
        model.state_dict(), TG.GPT2Config(vocab_size=128, n_positions=64,
                                          n_embd=64, n_layer=2, n_head=4),
        dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(16).integers(
        0, 128, (2, 20)))
    with torch.no_grad():
        ref = model(tokens).logits.float().numpy()
        got = ours(tokens).numpy()
    _agree(got, ref, 2e-4)
