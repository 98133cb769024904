"""PyTorch port vs JAX package: the Llama trunk and the decode engine.

JAX builds the model (init_params -> quantize_params -> int4 runtime
cache) and hands it over through ``convert.from_reference_arrays``; the
same prompts then run through both engines. In f32 both sides compute the
same arithmetic up to f32 sum order, so greedy tokens must be identical.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_bitsandbytes.engine import engine as JE
from tpu_bitsandbytes.engine.kvcache import KVCache as JKV
from tpu_bitsandbytes.engine.sampler import SamplingParams as JSP
from tpu_bitsandbytes.models import llama as JL
from tpu_bitsandbytes_torch.convert import (config_from_reference,
                                            from_reference_arrays)
from tpu_bitsandbytes_torch.engine import engine as TE
from tpu_bitsandbytes_torch.engine.kvcache import KVCache as TKV
from tpu_bitsandbytes_torch.engine.sampler import SamplingParams as TSP
from tpu_bitsandbytes_torch.models import llama as TL

from test_torch_functional import config_fields, reference_arrays, t32

REPO = Path(__file__).resolve().parents[1]


def _model(cfg, seed=0):
    """JAX params with the int4 cache, and the port's copy of them."""
    p = JL.init_params(jax.random.PRNGKey(seed), cfg)
    q = JL.quantize_params(p, dtype=cfg.dtype, fuse_projections=True)
    jp = JL.build_runtime_cache(q, "int4")
    return jp, from_reference_arrays(reference_arrays(jp), "cpu")


def _prompts(lengths, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


def test_greedy_tokens_match_jax_engine():
    cfg = dataclasses.replace(JL.LlamaConfig.tiny(), dtype=jnp.float32)
    jp, tp = _model(cfg)
    prompts = _prompts([5, 17, 30], cfg.vocab_size, seed=0)
    je = JE.DecodeEngine(jp, cfg, max_batch=4, steps_per_sync=4)
    ref = je.generate(prompts, JSP(max_new_tokens=12), pipeline_depth=1)
    te = TE.DecodeEngine(tp, config_from_reference(config_fields(cfg)),
                         max_batch=4, steps_per_sync=4, device="cpu")
    got = te.generate(prompts, TSP(max_new_tokens=12))
    assert got == ref
    assert all(len(g) == 12 for g in got)
    assert te.stats["finished"] == 3


def test_bf16_decode_logits_match_jax_flash_branch(monkeypatch):
    """bf16: JAX's opt-in flash-decode branch (interpret mode) against the
    port's plain K2, through prefill and a staged chunk of decode steps
    fed the same tokens. Tolerance 3e-2 of max|ref|: bf16 rounds at other
    places in XLA's CPU fusions than in eager PyTorch."""
    monkeypatch.setenv("TBNB_FLASH_DECODE", "1")
    monkeypatch.setenv("TBNB_FUSED_INTERPRET", "1")
    # a config of its own, so no decode step traced without the flash
    # branch (same static config) is reused from the jit cache
    cfg = dataclasses.replace(JL.LlamaConfig.tiny(), max_seq_len=96)
    tcfg = config_from_reference(config_fields(cfg))
    jp, tp = _model(cfg, seed=1)
    prompts = _prompts([7, 12], cfg.vocab_size, seed=1)
    jc = JKV.create(cfg.num_layers, 2, 96, cfg.num_kv_heads, cfg.hd,
                    dtype=cfg.dtype)
    tc = TKV.create(cfg.num_layers, 2, 96, cfg.num_kv_heads, cfg.hd,
                    device="cpu")
    toks = []
    for slot, pr in enumerate(prompts):
        padded = np.zeros((1, 16), np.int32)
        padded[0, :len(pr)] = pr
        jl, jc = JE.prefill_step(jp, jc, jnp.asarray(padded),
                                 jnp.int32(slot), jnp.int32(len(pr)), cfg)
        tl, tc = TE.prefill_step(tp, tc, torch.from_numpy(padded), slot,
                                 len(pr), tcfg)
        assert np.abs(t32(tl) - np.asarray(jl)).max() <= 3e-2 * np.abs(
            np.asarray(jl)).max()
        toks.append(int(np.argmax(np.asarray(jl))))
    jc = jc.begin_stage(4, window=False)
    tc = tc.begin_stage(4, window=False)
    # decode_step's own jit donates the cache, whose stage shares the
    # lengths buffer (len0); the same step, jitted without donation
    j_step = jax.jit(JE._decode_step_impl,
                     static_argnames=("config", "attn_span"))
    active = np.ones((2,), bool)
    for _ in range(4):
        t_in = np.asarray(toks, np.int32)
        jl, jc = j_step(jp, jc, jnp.asarray(t_in), jnp.asarray(active),
                        config=cfg, attn_span=96)
        tl, tc = TE.decode_step(tp, tc, torch.from_numpy(t_in),
                                torch.from_numpy(active), tcfg, attn_span=96)
        ref = np.asarray(jl)
        assert np.abs(t32(tl) - ref).max() <= 3e-2 * np.abs(ref).max()
        toks = list(np.argmax(ref, axis=-1))
    jc, tc = jc.flush_stage(), tc.flush_stage()
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def test_sampling_arrays_refill_only_when_the_active_set_changes(
        monkeypatch):
    """The chunk's sampling arrays are tensors that live as long as the
    engine: refilled in place when the active set's (slot, SamplingParams)
    change, by value, and left alone otherwise, as the JAX engine caches
    its ``_samp_arrays``; they hold what a fresh build holds."""
    te = TE.DecodeEngine({}, TL.LlamaConfig.tiny(), max_batch=4,
                         device="cpu")
    builds = []
    build = TE.SamplingArrays.build
    monkeypatch.setattr(TE.SamplingArrays, "build", lambda *a, **kw:
                        builds.append(1) or build(*a, **kw))
    hot = TSP(temperature=0.7, top_k=20, top_p=0.9, eos_token_id=5)

    def check(per_slot, n_builds):
        got = te._samp_arrays()
        assert len(builds) == n_builds
        assert got is te._samp_static
        want = build(per_slot, 4, device="cpu")
        for g, w in zip(got.tensors(), want.tensors()):
            assert torch.equal(g, w)
        return [t.data_ptr() for t in got.tensors()]

    te.active = {0: TE.Request(1, [1], TSP()), 2: TE.Request(2, [1], hot)}
    ptrs = check({0: TSP(), 2: hot}, 1)
    assert check({0: TSP(), 2: hot}, 1) == ptrs
    # another request with equal parameters: the same key, no refill
    te.active[2] = TE.Request(3, [4, 5], TSP(temperature=0.7, top_k=20,
                                             top_p=0.9, eos_token_id=5))
    assert check({0: TSP(), 2: hot}, 1) == ptrs
    te.active[1] = TE.Request(4, [1], TSP(eos_token_id=9))
    assert check({0: TSP(), 1: TSP(eos_token_id=9), 2: hot}, 2) == ptrs
    del te.active[0]
    assert check({1: TSP(eos_token_id=9), 2: hot}, 3) == ptrs


def test_sample_batched_draws_what_multinomial_draws():
    """The sampler's draw, argmax(p / q) with q ~ Exp(1) from the
    generator, is what ``torch.multinomial(p, 1)`` computes from the same
    generator state (without its read back to the host); greedy rows stay
    argmaxes."""
    from tpu_bitsandbytes_torch.engine.sampler import (SamplingArrays,
                                                       filter_logits,
                                                       sample_batched)
    logits = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (6, 300)).astype(np.float32) * 3)
    samp = SamplingArrays.build(
        {i: TSP(temperature=t, top_k=k, top_p=p) for i, (t, k, p) in
         enumerate([(1.0, 0, 1.0), (0.5, 10, 1.0), (2.0, 0, 0.8),
                    (0.0, 0, 1.0), (1.3, 50, 0.95), (0.9, 1, 1.0)])}, 6,
        device="cpu")
    got = sample_batched(logits, torch.Generator().manual_seed(11), samp)
    probs = torch.softmax(filter_logits(logits, samp.temperature, samp.top_k,
                                        samp.top_p), dim=-1)
    want = torch.multinomial(probs, 1, generator=torch.Generator()
                             .manual_seed(11))[:, 0].to(torch.int32)
    want[3] = logits[3].argmax()
    assert torch.equal(got, want)
    assert got[5] == logits[5].argmax()     # top-k 1 keeps the argmax


def test_every_kernel_counter_is_registered():
    """The counters a CUDA graph's replay advances
    (``ops._build.COUNTERS``) hold every kernel wrapper's launches and
    every plain version's calls on CUDA tensors, so a plain call inside a
    replayed chunk counts at each replay."""
    from tpu_bitsandbytes_torch.ops import (_build, flash_decode,
                                            flash_prefill, int4cache,
                                            matmul4bit, w4a8)
    want = {(int4cache.int4_mm, "launches"),
            (int4cache.int4_mm_plain, "cuda_calls"),
            (int4cache.dequant_int4_bf16, "launches"),
            (flash_decode.flash_decode_attention, "launches"),
            (flash_decode.flash_decode_plain, "cuda_calls"),
            (flash_prefill.flash_prefill_attention, "launches"),
            (flash_prefill.flash_prefill_plain, "cuda_calls"),
            (w4a8.w4a8_mm, "launches"), (w4a8.w4a8_mm_plain, "cuda_calls"),
            (matmul4bit.matmul4bit_mm, "launches"),
            (matmul4bit.matmul4bit_mm, "wgmma_launches"),
            (matmul4bit.matmul4bit_plain, "cuda_calls")}
    assert want <= set(_build.COUNTERS)


@pytest.mark.parametrize("mangled, name", [
    ("_Z19flash_decode_kernelILi128ELi8EEvPKaPf",
     "void flash_decode_kernel<128, 8>(signed char const*, float*)"),
    ("_Z9tc_kernelI4Int4Li8EEvPKaPf",
     "void tc_kernel<Int4, 8>(signed char const*, float*)"),
    ("w4a8_dp4a_kernel", "w4a8_dp4a_kernel"),
    ("_Z24int4_dequant_bf16_kernelPKjPKfP5uint4xiii",
     "int4_dequant_bf16_kernel(unsigned int const*, float const*, uint4*, "
     "long long, int, int, int)")])
def test_graph_census_names_kernels_as_the_profiler_does(mangled, name):
    """A graph's kernel nodes are counted by demangled name, the form the
    profiler's records and ``chip_smoke.KERNEL_RE`` use; an ``extern "C"``
    name stays as it is."""
    from tpu_bitsandbytes_torch.utils.graph_census import demangle
    assert demangle(mangled) == name


def test_chip_smoke_counts_every_kernel_launch():
    """``chip_smoke.py`` resets and reads every registered launch counter
    on each of its paths, and finds each counter's kernels in a graph by
    name: its counters are the registry's launch counters, with one name
    pattern each, and the decode of the int4 cache to bf16 matches its own
    pattern alone (not K1's, which the benchmark's K1 roofline reads)."""
    import chip_smoke
    from tpu_bitsandbytes_torch.ops import _build
    from tpu_bitsandbytes_torch.utils.graph_census import demangle
    counters = chip_smoke.kernel_counters()
    assert ({id(f) for f, attr in _build.COUNTERS if attr == "launches"}
            == {id(f) for f in counters.values()})
    assert chip_smoke.KERNEL_RE.keys() == counters.keys()
    name = demangle("_Z24int4_dequant_bf16_kernelPKjPKfP5uint4xiii")
    assert [k for k, rx in chip_smoke.KERNEL_RE.items()
            if re.search(rx, name)] == ["int4_dequant_bf16"]
    assert chip_smoke.launches_want(K2_flash_decode=3) == {
        k: 3 if k == "K2_flash_decode" else 0 for k in counters}


def test_forward_logits_match_f32():
    cfg = dataclasses.replace(JL.LlamaConfig.tiny(), dtype=jnp.float32)
    jp, tp = _model(cfg, seed=2)
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9))
    ref = np.asarray(JL.forward(jp, jnp.asarray(tok), cfg))
    got = t32(TL.forward(tp, torch.from_numpy(tok),
                         config_from_reference(config_fields(cfg))))
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("name", ["tiny_mistral", "tiny_mixtral",
                                  "tiny_gemma", "tiny_phi2"])
def test_unported_families_raise(name):
    """These families were refused before the port had them; they now
    cross as the port's presets of the same name."""
    cfg = config_from_reference(config_fields(getattr(JL.LlamaConfig, name)()))
    assert cfg == getattr(TL.LlamaConfig, name)()


def test_port_never_imports_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the JAX
    package (``tpu_bitsandbytes`` not followed by ``_torch``)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|tpu_bitsandbytes(?!_torch))",
                     re.M)
    files = sorted((REPO / "tpu_bitsandbytes_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f


def test_to_device_moves_every_tensor():
    """llama.to_device reaches the tensors inside QLinear4 leaves and their
    nested double-quant state, and keeps every other field."""
    cfg = TL.LlamaConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    params = TL.build_runtime_cache(TL.quantize_params(
        TL.init_params(cfg, generator=gen, device="cpu"),
        compress_statistics=True, fuse_projections=True), "int4")
    moved = TL.to_device(params, "meta")

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            yield tree
        elif isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, list):
            for v in tree:
                yield from leaves(v)
        elif dataclasses.is_dataclass(tree):
            for f in dataclasses.fields(tree):
                yield from leaves(getattr(tree, f.name))

    src, dst = list(leaves(params)), list(leaves(moved))
    assert len(src) == len(dst) > 4 * cfg.num_layers
    assert all(t.is_meta for t in dst)
    assert [t.shape for t in src] == [t.shape for t in dst]
    qkv = moved["layers"][0]["qkv_proj"]
    assert qkv.shape == params["layers"][0]["qkv_proj"].shape
    assert qkv.absmax_state.absmax.is_meta


# a config on which every no-cache branch is reachable: K4 needs
# K_pad/2 % 128 == 0 (hidden 256), prompts of 1024+ tokens need max_seq 2048
def _packed_cfg(dtype):
    return JL.LlamaConfig(vocab_size=512, hidden_size=256,
                          intermediate_size=512, num_layers=2, num_heads=2,
                          num_kv_heads=1, max_seq_len=2048, dtype=dtype)


def _packed_model(cfg, seed):
    """JAX params served off the packed NF4 bytes (no runtime cache), and
    the port's copy of them."""
    p = JL.init_params(jax.random.PRNGKey(seed), cfg)
    jp = JL.quantize_params(p, dtype=cfg.dtype, fuse_projections=True)
    return jp, from_reference_arrays(reference_arrays(jp), "cpu")


def test_no_cache_greedy_tokens_match_jax_engine(monkeypatch):
    """f32, no runtime cache: prompts of 5, 70 and 1,100 tokens reach K4
    (decode and the 16-token bucket), K5 (bucket 128), the dequant product
    and the flash route (bucket 2048) in both engines, JAX's kernels in
    interpret mode. K4 and K5 compute the same f32 arithmetic in both up to
    sum order, so greedy tokens are identical."""
    monkeypatch.setenv("TBNB_W4A8_INTERPRET", "1")
    monkeypatch.setenv("TBNB_FUSED_INTERPRET", "1")
    cfg = _packed_cfg(jnp.float32)
    jp, tp = _packed_model(cfg, seed=3)
    assert tp["layers"][0]["qkv_proj"].w_cache is None
    prompts = _prompts([5, 70, 1100], cfg.vocab_size, seed=3)
    je = JE.DecodeEngine(jp, cfg, max_batch=4, steps_per_sync=4)
    ref = je.generate(prompts, JSP(max_new_tokens=8), pipeline_depth=1)
    te = TE.DecodeEngine(tp, config_from_reference(config_fields(cfg)),
                         max_batch=4, steps_per_sync=4, device="cpu")
    from tpu_bitsandbytes_torch.ops import matmul4bit, w4a8
    calls = {"K4": 0, "K5": 0}
    k4, k5 = w4a8.w4a8_mm, matmul4bit.matmul4bit_mm

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(w4a8, "w4a8_mm", count("K4", k4))
    monkeypatch.setattr(matmul4bit, "matmul4bit_mm", count("K5", k5))
    got = te.generate(prompts, TSP(max_new_tokens=8))
    assert got == ref
    assert all(len(g) == 8 for g in got)
    assert calls["K4"] > 0 and calls["K5"] > 0


def test_no_cache_bf16_long_prefill_logits_match_jax():
    """bf16, no cache, one 1,100-token prompt (bucket 2048: the dequant
    product and K3's plain version at the 512 tile; JAX on the CPU takes
    its f32 scan). Tolerance 3e-2 of max|ref|: bf16 rounds at other places
    in XLA's CPU fusions than in eager PyTorch, as in the other bf16 tests."""
    cfg = _packed_cfg(jnp.bfloat16)
    tcfg = config_from_reference(config_fields(cfg))
    jp, tp = _packed_model(cfg, seed=4)
    prompt = _prompts([1100], cfg.vocab_size, seed=4)[0]
    padded = np.zeros((1, 2048), np.int32)
    padded[0, :len(prompt)] = prompt
    jc = JKV.create(cfg.num_layers, 1, 2048, cfg.num_kv_heads, cfg.hd,
                    dtype=cfg.dtype)
    tc = TKV.create(cfg.num_layers, 1, 2048, cfg.num_kv_heads, cfg.hd,
                    device="cpu")
    jl, _ = JE.prefill_step(jp, jc, jnp.asarray(padded), jnp.int32(0),
                            jnp.int32(len(prompt)), cfg)
    tl, _ = TE.prefill_step(tp, tc, torch.from_numpy(padded), 0, len(prompt),
                            tcfg)
    ref = np.asarray(jl)
    assert np.abs(t32(tl) - ref).max() <= 3e-2 * np.abs(ref).max()


def test_llama2_13b_config_matches_jax():
    fields = config_fields(JL.LlamaConfig.llama2_13b())
    assert config_from_reference(fields) == TL.LlamaConfig.llama2_13b()
