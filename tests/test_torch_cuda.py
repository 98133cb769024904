"""The port's CUDA kernels on the card, each against its plain version.

These tests need a CUDA card and nvcc, and skip without them. On the card,
from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which these tests do not
use.) Inputs come from numpy seeds; the same tensors run the plain version
on the CPU and the kernel on the card.

Tolerances, as shares of max|ref|: K1 1e-5 (the int32 block dots are exact,
only the f32 sum order differs); K2 1e-3 (an exp that rounds differently on
the card can flip one p code); bf16 model logits 3e-2 (bf16 rounds at other
places in the card's kernels than in the CPU's).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_bitsandbytes_torch.engine import engine as E
from tpu_bitsandbytes_torch.engine.kvcache import KVCache
from tpu_bitsandbytes_torch.engine.sampler import SamplingParams
from tpu_bitsandbytes_torch.models import llama
from tpu_bitsandbytes_torch.ops import flash_decode as K2
from tpu_bitsandbytes_torch.ops import int4cache as K1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def rel_err(got, ref) -> float:
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()


# ---------------------------------------------------------------------------
# K1: int4-cache matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [
    (8, 12288, 4096), (1, 4096, 4096), (64, 4096, 4096), (3, 4099, 384),
    (8, 2053, 11008), (13, 127, 384)])
def test_int4_mm_matches_plain(cuda, m, n, k):
    rng = np.random.default_rng(m * n + k)
    kp = -(-k // 128) * 128
    xq = torch.from_numpy(rng.integers(-127, 128, (m, kp), dtype=np.int8))
    w = torch.from_numpy(rng.integers(0, 256, (n, kp // 2), dtype=np.uint8))
    sc = torch.from_numpy(
        rng.uniform(1e-3, 1e-2, (kp // 128, n)).astype(np.float32))
    sx = torch.from_numpy(rng.uniform(1e-3, 5e-2, (m,)).astype(np.float32))
    ref = K1.int4_mm(xq, w, sc, sx)
    before = K1.int4_mm.launches
    got = K1.int4_mm(*(t.to(cuda) for t in (xq, w, sc, sx)))
    torch.cuda.synchronize()
    assert K1.int4_mm.launches == before + 1
    assert torch.isfinite(got).all()
    assert rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("m", [1, 8, 64, 65])
def test_int4_matmul_card_matches_cpu(cuda, m):
    """The cache build and the wrapper's A8 row quantization give the
    CPU's codes on the card; M = 65 takes the dequant branch."""
    rng = np.random.default_rng(m)
    w = torch.from_numpy(
        (rng.standard_normal((640, 384)) * 0.05).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, 384)).astype(np.float32))
    q, s = K1.quantize_int4(w)
    q_c, s_c = K1.quantize_int4(w.to(cuda))
    assert torch.equal(q_c.cpu(), q) and torch.equal(s_c.cpu(), s)
    ref = K1.int4_matmul(x, q, s, out_dtype=torch.float32)
    before = K1.int4_mm.launches
    got = K1.int4_matmul(x.to(cuda), q_c, s_c, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert K1.int4_mm.launches == before + (m <= 64)
    assert rel_err(got, ref) <= 1e-5


def test_int4_mm_rejects_bad_operands(cuda):
    xq = torch.zeros((2, 256), dtype=torch.int8, device=cuda)
    w = torch.zeros((128, 128), dtype=torch.uint8, device=cuda)
    sc = torch.ones((2, 128), device=cuda)
    sx = torch.ones((2,), device=cuda)
    with pytest.raises(TypeError):
        K1.int4_mm(xq.float(), w, sc, sx)
    with pytest.raises(ValueError):
        K1.int4_mm(xq, w[:, :64], sc, sx)
    strided = torch.zeros((128, 256), dtype=torch.uint8, device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        K1.int4_mm(xq, strided, sc, sx)


# ---------------------------------------------------------------------------
# K2: flash-decode attention over int8 KV
# ---------------------------------------------------------------------------

def _k2_inputs(seed, b, h, h_kv, d, s, c):
    """q bf16 [B,H,D]; cache-shaped KV codes/scales [B,H_kv,S(,D)]; a
    staged block of C keys; all on the CPU."""
    rng = np.random.default_rng(seed)

    def codes(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))

    def scales(*shape):
        return torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32))

    q = torch.from_numpy(
        (rng.standard_normal((b, h, d)) * 0.3).astype(np.float32))
    cache = [codes(b, h_kv, s, d), scales(b, h_kv, s),
             codes(b, h_kv, s, d), scales(b, h_kv, s)]
    stage = [codes(b, h_kv, c, d), scales(b, h_kv, c),
             codes(b, h_kv, c, d), scales(b, h_kv, c)]
    return q.to(torch.bfloat16), cache, stage, rng


def _k2_run(dev, q, cache, stage, off, start, span, step, opts):
    """Attention over the span view [start, span) of the cache, as the
    engine reads it (strided, not copied)."""
    kv = [t.to(dev)[:, :, start:span] for t in cache]
    staged = (None if step is None
              else (*(t.to(dev) for t in stage), step))
    return K2.flash_decode_attention(q.to(dev), *kv, off.to(dev),
                                     staged=staged, **opts)


@pytest.mark.parametrize("b,h,h_kv,d,s,start,span,c,step,opts", [
    (4, 8, 8, 128, 256, 0, 192, 16, None, {}),
    (4, 8, 8, 128, 256, 0, 192, 16, 15, {}),
    (3, 32, 8, 128, 512, 0, 384, 32, 0, {}),
    (2, 16, 2, 128, 256, 0, 256, 8, 7, {}),
    (2, 16, 8, 64, 128, 0, 128, 8, 3, {"window": 40, "softcap": 30.0}),
    (2, 8, 4, 128, 512, 128, 512, 8, 3, {"kpos_start": 128}),
])
def test_flash_decode_matches_plain(cuda, b, h, h_kv, d, s, start, span, c,
                                    step, opts):
    q, cache, stage, rng = _k2_inputs(b * h + span, b, h, h_kv, d, s, c)
    len0 = rng.integers(max(start, span // 3), span - c, (b,))
    off = torch.from_numpy((len0 + (step or 0)).astype(np.int32))
    ref = _k2_run("cpu", q, cache, stage, off, start, span, step, opts)
    before = K2.flash_decode_attention.launches
    got = _k2_run(cuda, q, cache, stage, off, start, span, step, opts)
    torch.cuda.synchronize()
    assert K2.flash_decode_attention.launches == before + 1
    assert torch.isfinite(got).all()
    assert rel_err(got, ref) <= 1e-3


def test_flash_decode_fully_masked_row(cuda):
    """A fresh slot (off = 0) read from kpos_start = 8: every key is masked,
    p is uniform over all keys and the output stays finite."""
    q, cache, stage, _ = _k2_inputs(9, 2, 4, 4, 64, 64, 8)
    off = torch.zeros((2,), dtype=torch.int32)
    opts = {"kpos_start": 8}
    ref = _k2_run("cpu", q, cache, stage, off, 8, 64, None, opts)
    got = _k2_run(cuda, q, cache, stage, off, 8, 64, None, opts)
    assert torch.isfinite(got).all()
    assert rel_err(got, ref) <= 1e-3


def test_flash_decode_raises_past_shared_memory(cuda):
    q = torch.zeros((1, 8, 128), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 1, 8192, 128), dtype=torch.int8, device=cuda)
    sc = torch.ones((1, 1, 8192), device=cuda)
    off = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="shared memory"):
        K2.flash_decode_attention(q, k, sc, k, sc, off)


# ---------------------------------------------------------------------------
# the tiny model on the card against the CPU
# ---------------------------------------------------------------------------

def _tiny(dtype):
    """LlamaConfig.tiny() in ``dtype`` with int4-cached NF4 params, built
    on the CPU from a seed."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    params = llama.quantize_params(
        llama.init_params(cfg, generator=gen, device="cpu"), dtype=dtype,
        fuse_projections=True)
    return cfg, llama.build_runtime_cache(params, "int4")


def _prompts(lengths, vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


def test_engine_f32_tokens_card_match_cpu(cuda):
    """f32: K1 on the card differs from the CPU only in f32 sum order, so
    greedy tokens are identical."""
    cfg, params = _tiny(torch.float32)
    prompts = _prompts([5, 17, 30], cfg.vocab_size)
    sp = SamplingParams(max_new_tokens=12)
    ref = E.DecodeEngine(params, cfg, max_batch=4, steps_per_sync=4,
                         device="cpu").generate(prompts, sp)
    before = K1.int4_mm.launches
    got = E.DecodeEngine(llama.to_device(params, cuda), cfg, max_batch=4,
                         steps_per_sync=4, device=cuda).generate(prompts, sp)
    assert K1.int4_mm.launches > before
    assert got == ref


def _prefill_decode(params, cfg, dev, prompts, fed=None):
    """Prefill each prompt into its slot, then a staged chunk of 4 decode
    steps fed ``fed`` (greedy tokens when None). Returns the prefill and
    decode logits, the tokens fed, and each step's (K1, K2) launches."""
    p = llama.to_device(params, dev)
    cache = KVCache.create(cfg.num_layers, len(prompts), 64,
                           cfg.num_kv_heads, cfg.hd, device=dev)
    logits = []
    for slot, pr in enumerate(prompts):
        toks = torch.zeros((1, 16), dtype=torch.int32)
        toks[0, :len(pr)] = torch.tensor(pr, dtype=torch.int32)
        lg, cache = E.prefill_step(p, cache, toks.to(dev), slot, len(pr), cfg)
        logits.append(lg)
    toks = torch.stack(logits).argmax(-1).to(torch.int32).cpu()
    active = torch.ones((len(prompts),), dtype=torch.bool, device=dev)
    cache.begin_stage(4)
    fed_out, launches = [], []
    for i in range(4):
        t_in = toks if fed is None else fed[i]
        fed_out.append(t_in)
        k1, k2 = K1.int4_mm.launches, K2.flash_decode_attention.launches
        lg, cache = E.decode_step(p, cache, t_in.to(dev), active, cfg,
                                  attn_span=64)
        launches.append((K1.int4_mm.launches - k1,
                         K2.flash_decode_attention.launches - k2))
        logits.append(lg)
        toks = lg.argmax(-1).to(torch.int32).cpu()
    cache.flush_stage()
    return [lg.float().cpu() for lg in logits], fed_out, launches


def test_bf16_decode_logits_card_match_cpu(cuda):
    """bf16: each decode step launches K1 four times per layer plus the
    head and K2 once per layer, and its logits match the CPU's."""
    cfg, params = _tiny(torch.bfloat16)
    prompts = _prompts([7, 12], cfg.vocab_size)
    ref, fed, _ = _prefill_decode(params, cfg, "cpu", prompts)
    got, _, launches = _prefill_decode(params, cfg, cuda, prompts, fed)
    assert launches == [(4 * cfg.num_layers + 1, cfg.num_layers)] * 4
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert rel_err(g, r) <= 3e-2
