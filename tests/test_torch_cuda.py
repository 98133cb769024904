"""The port's CUDA kernels on the card, each against its plain version.

These tests need a CUDA card and nvcc, and skip without them. On the card,
from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which these tests do not
use.) Inputs come from numpy seeds; the same tensors run the plain version
on the CPU and the kernel on the card.

Tolerances, as shares of max|ref|: K1 and K4 1e-5 (the int32 block dots
are exact, only the f32 sum order differs), and the int4 cache's bf16
product above K1's M too (exact bf16 products, f32 sums in another order;
its decode to bf16 is bit-identical); K2 1e-3 (f32 sums in
another order, a probability whose bf16 rounding flips); K5 1e-5 in f32 (exact
products, f32 sums in another order) and 1e-4 in bf16 (the same bf16
operands, each weight rounded once, f32 sums in another order: a weight
rounded twice or to f16 would miss it);
K3 1e-2 of each query row's own max|ref| against its plain version at the
kernel's key tile, 128 keys (64 at d = 256) (one bf16 ulp of the output is at most 2^-7 of its
row's max; a long row's outputs are far below the first rows', so a share
of the whole tensor's max would not see them); bf16 model logits 3e-2 (bf16
rounds at other places in the card's kernels than in the CPU's).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from tpu_bitsandbytes_torch.engine import engine as E
from tpu_bitsandbytes_torch.engine.kvcache import KVCache
from tpu_bitsandbytes_torch.engine.sampler import SamplingParams
from tpu_bitsandbytes_torch.models import llama
from tpu_bitsandbytes_torch import functional as TF
from tpu_bitsandbytes_torch.ops import _build
from tpu_bitsandbytes_torch.ops import flash_decode as K2
from tpu_bitsandbytes_torch.ops import flash_prefill as K3
from tpu_bitsandbytes_torch.ops import int4cache as K1
from tpu_bitsandbytes_torch.ops import matmul4bit as K5
from tpu_bitsandbytes_torch.ops import w4a8 as K4

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


def rel_err(got, ref) -> float:
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()


def row_rel_err(got, ref) -> float:
    """Worst |got - ref| over each row of the last axis, as a share of that
    row's max|ref|."""
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).abs().amax(-1)
            / ref.abs().amax(-1).clamp(min=1e-30)).max().item()


# ---------------------------------------------------------------------------
# K1: int4-cache matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [
    (8, 12288, 4096), (1, 4096, 4096), (64, 4096, 4096), (3, 4099, 384),
    (8, 2053, 11008), (13, 127, 384),
    # a speculative verify step at B=8, gamma=4: M = 40
    (40, 12288, 4096), (40, 4096, 11008)])
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


@pytest.mark.parametrize("m,dtype", [
    (1, "float32"), (8, "float32"), (64, "float32"), (65, "float32"),
    (65, "bfloat16"), (512, "bfloat16"), (2048, "bfloat16")])
def test_int4_matmul_card_matches_cpu(cuda, m, dtype):
    """The cache build and the wrapper's A8 row quantization give the
    CPU's codes on the card; M = 65 takes the dequant branch, in f32 the
    widened product, in bf16 the decode kernel (once) and a bf16 GEMM with
    an f32 output, against the CPU's widened product: the same exact
    products, f32 sums in another order."""
    rng = np.random.default_rng(m)
    w = torch.from_numpy(
        (rng.standard_normal((640, 384)) * 0.05).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, 384)).astype(np.float32)
                         ).to(getattr(torch, dtype))
    q, s = K1.quantize_int4(w)
    q_c, s_c = K1.quantize_int4(w.to(cuda))
    assert torch.equal(q_c.cpu(), q) and torch.equal(s_c.cpu(), s)
    ref = K1.int4_matmul(x, q, s, out_dtype=torch.float32)
    before = K1.int4_mm.launches, K1.dequant_int4_bf16.launches
    got = K1.int4_matmul(x.to(cuda), q_c, s_c, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (K1.int4_mm.launches, K1.dequant_int4_bf16.launches) == (
        before[0] + (m <= 64), before[1] + (dtype == "bfloat16"))
    assert rel_err(got, ref) <= 1e-5


# (N, K): Mistral-7B's int4-cache linears (fused q/k/v, o, fused gate/up,
# down, the head), a padded K (200 -> 256) and an N off every tile
DEQUANT_SHAPES = [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336),
                  (32000, 4096), (512, 200), (200, 384)]


@pytest.mark.parametrize("n,k", DEQUANT_SHAPES)
def test_dequant_int4_bf16_matches_plain(cuda, n, k):
    """The decode kernel gives ``dequant_int4(..., dtype=bfloat16)``'s bits
    on every code (all 16 nibbles, -8 included) and a scale per (block,
    row), one launch a call."""
    rng = np.random.default_rng(n + k)
    kp = -(-k // 128) * 128
    q = torch.from_numpy(rng.integers(0, 256, (n, kp // 2), dtype=np.uint8))
    s = torch.from_numpy(
        rng.uniform(1e-4, 1e-1, (kp // 128, n)).astype(np.float32))
    ref = K1.dequant_int4(q, s, dtype=torch.bfloat16)
    before = K1.dequant_int4_bf16.launches
    got = K1.dequant_int4_bf16(q.to(cuda), s.to(cuda))
    torch.cuda.synchronize()
    assert K1.dequant_int4_bf16.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (n, kp)
    assert torch.equal(got.cpu(), ref)


def test_dequant_int4_bf16_rejects_bad_operands(cuda):
    q = torch.zeros((128, 128), dtype=torch.uint8, device=cuda)
    s = torch.ones((2, 128), device=cuda)
    with pytest.raises(TypeError):
        K1.dequant_int4_bf16(q.to(torch.int8), s)
    with pytest.raises(TypeError):
        K1.dequant_int4_bf16(q, s.double())
    with pytest.raises(ValueError):
        K1.dequant_int4_bf16(q, s[:, :64])
    with pytest.raises(ValueError):
        K1.dequant_int4_bf16(q, torch.ones((3, 128), device=cuda))
    strided = torch.zeros((128, 256), dtype=torch.uint8, device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        K1.dequant_int4_bf16(strided, s)
    with pytest.raises(ValueError):
        K1.dequant_int4_bf16(q, s.t().contiguous().t())
    shifted = torch.zeros((128 * 64 + 1,), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="4-byte"):
        K1.dequant_int4_bf16(shifted[1:].view(128, 64), s[:1])


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


def _int4_case(m, n, kp, bs, seed):
    """Random K1 operands on the CPU: x codes, packed codes, K-major scales
    [kp/bs, N], row scales."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(-127, 128, (m, kp), dtype=np.int8)),
            torch.from_numpy(rng.integers(0, 256, (n, kp // 2), dtype=np.uint8)),
            torch.from_numpy(rng.uniform(1e-3, 1e-2, (kp // bs, n))
                             .astype(np.float32)),
            torch.from_numpy(rng.uniform(1e-3, 5e-2, (m,)).astype(np.float32)))


def _int4_check(cuda, m, n, kp, bs):
    args = [t.to(cuda) for t in _int4_case(m, n, kp, bs, m * 7 + n + kp + bs)]
    before = K1.int4_mm.launches
    got = K1.int4_mm(*args)
    torch.cuda.synchronize()
    assert K1.int4_mm.launches == before + 1
    assert torch.isfinite(got).all()
    assert rel_err(got, K1.int4_mm_plain(*args)) <= 1e-5


@pytest.mark.parametrize("bs", [64, 128, 256])
@pytest.mark.parametrize("m", [1, 3, 8, 9, 32, 33, 64])
def test_int4_mm_tile_edges(cuda, m, bs):
    """M at and past the n8 tiles of the tensor-core path (1-64), blocks
    shorter than and as long as its 256-code chunk, at N=4096 (split along
    K)."""
    _int4_check(cuda, m, 4096, 6144, bs)


@pytest.mark.parametrize("m,n,kp,bs", [
    (8, 4099, 4096, 128), (3, 1013, 384, 128), (65, 384, 512, 128),
    (9, 1000, 4032, 32), (8, 512, 4096, 1024), (5, 22016, 4096, 512)])
def test_int4_mm_odd_shapes(cuda, m, n, kp, bs):
    """Odd N (a partial row tile; scales not 16-byte aligned per block row),
    M past 64 (two M groups), K_pad not a multiple of the chunk (4032),
    blocks longer than a chunk (512, 1024)."""
    _int4_check(cuda, m, n, kp, bs)


def test_int4_mm_operand_alignment(cuda):
    """x and the codes must start on a 16-byte boundary, or the wrapper
    raises."""
    xq, w, sc, sx = (t.to(cuda) for t in _int4_case(8, 4096, 4096, 128, 3))
    x_off = torch.empty((8 * 4096 + 4,), dtype=torch.int8,
                        device=cuda)[4:].view(8, 4096)
    x_off.copy_(xq)
    with pytest.raises(ValueError, match="16-byte"):
        K1.int4_mm(x_off, w, sc, sx)


def test_int4_mm_two_streams(cuda):
    """Two split-K shapes with the same row tiles, launched on two streams
    at once: each stream has its own partials and counts, so every result
    equals the plain version."""
    cases = [[t.to(cuda) for t in _int4_case(8, 4096, kp, 128, kp)]
             for kp in (4096, 11008)]
    refs = [K1.int4_mm_plain(*args) for args in cases]
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    torch.cuda.synchronize()
    outs = [[] for _ in cases]
    for _ in range(20):
        for st, args, got in zip(streams, cases, outs):
            with torch.cuda.stream(st):
                got.append(K1.int4_mm(*args))
    torch.cuda.synchronize()
    for ref, got in zip(refs, outs):
        assert max(rel_err(g, ref) for g in got) <= 1e-5


def _capture(fn, stream=None):
    """(graph, stream, outputs): ``fn`` captured in a CUDA graph on
    ``stream`` (a new one by default) after one eager call there, which
    allocates the stream's split-K scratch (a capture may not)."""
    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    return graph, stream, out


def test_int4_mm_graph_replay(cuda):
    """K1 captured in a CUDA graph (split-K scratch of the capture stream)
    and replayed on new inputs copied into the captured ones."""
    x1, w, sc, sx = (t.to(cuda) for t in _int4_case(8, 4096, 11008, 128, 4))
    graph, _, got = _capture(lambda: K1.int4_mm(x1, w, sc, sx))
    for seed in (5, 6):
        x2 = _int4_case(8, 4096, 11008, 128, seed)[0].to(cuda)
        x1.copy_(x2)
        graph.replay()
        torch.cuda.synchronize()
        assert rel_err(got, K1.int4_mm_plain(x2, w, sc, sx)) <= 1e-5


def _big_plan(m, n, kp, bs, cps, part, counts):
    """A plan export's signature, asking for ``m`` floats of split-K
    partials: more than any kernel's shape here needs."""
    cps._obj.value, part._obj.value, counts._obj.value = 1, m, 4096


def test_split_scratch_is_not_allocated_in_a_capture(cuda):
    """A capture whose launch needs more split-K scratch than its stream
    holds raises: the scratch is allocated and zeroed eagerly, never
    recorded into a graph."""
    stream = torch.cuda.Stream()
    held = _build.scratch_bytes().get(stream.cuda_stream)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture stream"):
        with torch.cuda.graph(graph, stream=stream):
            _build.split_plan(_big_plan, 1 << 27, 1, 1, 1, cuda)
    assert _build.scratch_bytes().get(stream.cuda_stream) == held


def test_graph_keeps_its_split_scratch(cuda):
    """A launch that grows its stream's split-K scratch after a graph was
    captured there leaves the graph's pair allocated: the replay, after
    the device memory was handed out again, still matches the plain
    version."""
    x1, w, sc, sx = (t.to(cuda) for t in _int4_case(8, 4096, 11008, 128, 4))
    graph, stream, got = _capture(lambda: K1.int4_mm(x1, w, sc, sx))
    held = _build.scratch_bytes()[stream.cuda_stream]
    with torch.cuda.stream(stream):
        _build.split_plan(_big_plan, 1 << 25, 1, 1, 1, cuda)
    assert (_build.scratch_bytes()[stream.cuda_stream]
            == held + 4 * (1 << 25) + 4 * 4096)
    junk = torch.full((1 << 24,), -1, dtype=torch.int32, device=cuda)
    x2 = _int4_case(8, 4096, 11008, 128, 5)[0].to(cuda)
    x1.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert rel_err(got, K1.int4_mm_plain(x2, w, sc, sx)) <= 1e-5
    del junk, graph
    _build.release_held(stream)
    assert (_build.scratch_bytes()[stream.cuda_stream]
            == 4 * (1 << 25) + 4 * 4096)


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
    # the 13B path's last step, and rep 8 over a 600-key span
    (8, 40, 40, 128, 2048, 0, 1920, 32, 31, {}),
    (2, 32, 4, 128, 1024, 0, 600, 16, 5, {}),
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
    """Eight CTAs share a slot's logits: rep 8 over 65,536 keys needs 8 x
    8,193 floats per CTA, past the 232,448 bytes one may use."""
    q = torch.zeros((1, 8, 128), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 1, 65536, 128), dtype=torch.int8, device=cuda)
    sc = torch.ones((1, 1, 65536), device=cuda)
    off = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="shared memory"):
        K2.flash_decode_attention(q, k, sc, k, sc, off)


@pytest.mark.parametrize("t", [6900, 8192])
def test_flash_decode_past_the_old_limit(cuda, t):
    """rep 8, D 128: 6,900 keys sat just under the single-block limit and
    8,192 past it (it raised); both run now, unstaged, and match."""
    q, cache, stage, rng = _k2_inputs(t, 1, 8, 1, 128, t, 8)
    off = torch.from_numpy(rng.integers(t // 2, t, (1,)).astype(np.int32))
    ref = _k2_run("cpu", q, cache, stage, off, 0, t, None, {})
    got = _k2_run(cuda, q, cache, stage, off, 0, t, None, {})
    torch.cuda.synchronize()
    assert rel_err(got, ref) <= 1e-3


def test_flash_decode_all_masked_slot_beside_live_ones(cuda):
    """Slot 0 reads from kpos_start = 128 at off = 5, unstaged: every key
    masked, p uniform over the whole span and the dummy block; slots 1-2
    keep part of the span. S = 3 CTAs per slot."""
    q, cache, stage, _ = _k2_inputs(21, 3, 16, 8, 128, 768, 8)
    off = torch.tensor([5, 300, 700], dtype=torch.int32)
    opts = {"kpos_start": 128}
    ref = _k2_run("cpu", q, cache, stage, off, 128, 768, None, opts)
    got = _k2_run(cuda, q, cache, stage, off, 128, 768, None, opts)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert rel_err(got, ref) <= 1e-3


@pytest.mark.parametrize("t", [4200, 8192])
def test_flash_decode_matches_chain_at_long_span(cuda, t):
    """K2 computes the staged chain ``gqa_attention_kv_quant`` (the JAX
    package's default decode attention): at 4,200 and 8,192 keys, rep 4,
    with q sharp enough that most probabilities are far below the row's
    max (where int8 probability codes lose their mass), K2's f32 output
    rounded to bf16 is within one bf16 ulp of the largest output of the
    chain's bf16 output on the card (2^-7 of max|ref|)."""
    from tpu_bitsandbytes_torch.models import layers
    q, cache, stage, rng = _k2_inputs(t + 1, 2, 16, 4, 128, t, 16)
    q = (q.float() * 12.0).to(torch.bfloat16).to(cuda)
    kv = [x.to(cuda) for x in cache]
    st = (*(x.to(cuda) for x in stage), 5)
    off = torch.tensor([t - 11, t // 2 + 5], dtype=torch.int32, device=cuda)
    got = K2.flash_decode_attention(q, *kv, off, staged=st)
    ref = layers.gqa_attention_kv_quant(q[:, None], *kv,
                                        causal_offset=off[:, None],
                                        staged=st)[:, 0]
    torch.cuda.synchronize()
    assert rel_err(got.to(torch.bfloat16), ref) <= 2.0 ** -7


def test_flash_decode_cluster_plan(cuda):
    """The CTAs per cluster come from the shape and the card: a 128-key
    span takes one, the 7B and 13B decode steps (B=8, span 384 / 1920)
    split each slot over at least two, and a span whose logits overflow one
    CTA's shared memory takes enough CTAs to fit."""
    assert K2.cluster_size(1, 128, 32, 128, 8, 40, cuda) == 1
    assert K2.cluster_size(1, 384, 32, 128, 8, 32, cuda) >= 2
    assert K2.cluster_size(1, 1920, 32, 128, 8, 40, cuda) >= 2
    assert K2.cluster_size(8, 8192, 8, 128, 64, 8, cuda) >= 2


def test_flash_decode_graph_replay(cuda):
    """K2 captured in a CUDA graph and replayed with new positions written
    into the captured ``off``: the kept range comes from the device, so
    each replay matches the plain version at its positions."""
    q, cache, stage, _ = _k2_inputs(23, 8, 32, 32, 128, 512, 32)
    dev_q = q.to(cuda)
    kv = [t.to(cuda)[:, :, :384] for t in cache]
    st = [t.to(cuda) for t in stage]
    off = torch.full((8,), 200, dtype=torch.int32, device=cuda)
    K2.flash_decode_attention(dev_q, *kv, off, staged=(*st, 31))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = K2.flash_decode_attention(dev_q, *kv, off, staged=(*st, 31))
    for pos in ([40, 100, 150, 200, 250, 300, 350, 383],
                [383, 31, 64, 90, 128, 256, 300, 33]):
        off.copy_(torch.tensor(pos, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        ref = _k2_run("cpu", q, cache, stage, off.cpu(), 0, 384, 31, {})
        assert rel_err(got, ref) <= 1e-3


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


def _prefill_decode(params, cfg, dev, prompts, fed=None, max_seq=64):
    """Prefill each prompt into its slot, then a staged chunk of 4 decode
    steps fed ``fed`` (greedy tokens when None). Returns the prefill and
    decode logits, the tokens fed, and each step's (K1, K2) launches."""
    p = llama.to_device(params, dev)
    cache = KVCache.create(cfg.num_layers, len(prompts), max_seq,
                           cfg.num_kv_heads, cfg.hd, device=dev)
    logits = []
    for slot, pr in enumerate(prompts):
        toks = torch.zeros((1, E._bucket(len(pr), max_seq)),
                           dtype=torch.int32)
        toks[0, :len(pr)] = torch.tensor(pr, dtype=torch.int32)
        lg, cache = E.prefill_step(p, cache, toks.to(dev), slot, len(pr), cfg)
        logits.append(lg)
    toks = torch.stack(logits).argmax(-1).to(torch.int32).cpu()
    active = torch.ones((len(prompts),), dtype=torch.bool, device=dev)
    cache.begin_stage(4, window=False)
    fed_out, launches = [], []
    for i in range(4):
        t_in = toks if fed is None else fed[i]
        fed_out.append(t_in)
        k1, k2 = K1.int4_mm.launches, K2.flash_decode_attention.launches
        lg, cache = E.decode_step(p, cache, t_in.to(dev), active, cfg,
                                  attn_span=max_seq)
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


# ---------------------------------------------------------------------------
# the decode chunk as CUDA graphs
# ---------------------------------------------------------------------------

def _graph_model(packed: bool):
    """A tiny bf16 model with max_seq 512 (two span buckets within reach):
    int4-cached weights at hidden 128 (K1), or the packed bytes at hidden
    256, where decode takes K4."""
    if packed:
        cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                                intermediate_size=512, num_layers=2,
                                num_heads=2, num_kv_heads=1, max_seq_len=512)
    else:
        cfg = dataclasses.replace(llama.LlamaConfig.tiny(), max_seq_len=512)
    gen = torch.Generator().manual_seed(7)
    params = llama.quantize_params(
        llama.init_params(cfg, generator=gen, device="cpu"),
        fuse_projections=True)
    if not packed:
        params = llama.build_runtime_cache(params, "int4")
    return cfg, params


def _engine(cfg, params, dev, graphs):
    return E.DecodeEngine(llama.to_device(params, dev), cfg, max_batch=4,
                          steps_per_sync=8, device=dev, cuda_graphs=graphs)


def _launches():
    return {"K1": K1.int4_mm.launches, "K2": K2.flash_decode_attention.launches,
            "K4": K4.w4a8_mm.launches}


def _mid_chunk_eos(outs):
    """(request, token) whose first emission falls inside an 8-step chunk
    (not at its first or last step; the first token comes from prefill),
    from a request other than the first, whose long prompt must run to
    the second span bucket."""
    for r, toks in list(enumerate(outs))[1:]:
        for i, tok in enumerate(toks):
            if (i - 1) % 8 in range(1, 7) and tok not in toks[:i]:
                return r, tok
    raise AssertionError(f"no token first emitted mid-chunk in {outs}")


@pytest.mark.parametrize("packed", [False, True])
def test_graphed_chunks_match_eager(cuda, packed):
    """Greedy tokens of graphed chunks equal the eager chunks', request by
    request, through the int4 cache (K1) and off the packed bytes (K4),
    across two span buckets (128 and 256) and with one request stopping
    at an EOS in the middle of a chunk; the launch counters agree too."""
    cfg, params = _graph_model(packed)
    prompts = _prompts([100, 20, 60], cfg.vocab_size)
    sp = SamplingParams(max_new_tokens=40)
    first = _engine(cfg, params, cuda, False).generate(prompts, sp)
    r, eos = _mid_chunk_eos(first)
    sps = [sp] * 3
    sps[r] = SamplingParams(max_new_tokens=40, eos_token_id=eos)
    outs, counts = {}, {}
    for graphs in (False, True):
        eng = _engine(cfg, params, cuda, graphs)
        before = _launches()
        outs[graphs] = eng.generate(prompts, sps)
        counts[graphs] = {k: v - before[k] for k, v in _launches().items()}
        if graphs:
            stats = eng.graph_stats()
            assert stats["graphs"] == 2 and stats["pool_bytes"] > 0
    assert outs[True] == outs[False]
    assert outs[True][r][-1] == eos and len(outs[True][r]) < 40
    assert counts[True] == counts[False]
    assert counts[True]["K4" if packed else "K1"] > 0


def test_graphed_chunk_reads_nothing_back(cuda):
    """No host sync inside a chunk: with the synchronizing-operation check
    set to raise, an eager chunk runs, and so does a graphed one, staging
    its inputs and replaying (after a first chunk that captures: a capture
    synchronizes the device before it begins)."""
    cfg, params = _graph_model(False)
    prompts = _prompts([30, 9, 50], cfg.vocab_size)
    toks = np.array([5, 6, 7, 0], np.int32)
    active = np.array([True, True, True, False])
    for graphs in (False, True):
        eng = _engine(cfg, params, cuda, graphs)
        eng.generate(prompts, SamplingParams(max_new_tokens=4))
        eng.run_chunk(toks, active, all_greedy=True, attn_span=128)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = eng.run_chunk(toks, active, all_greedy=True, attn_span=128)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert out[0].shape == (8, 4)
        assert eng.graph_stats()["graphs"] == (1 if graphs else 0)


def test_sampled_replays_draw_fresh_numbers(cuda):
    """A sampling chunk's graph draws from the engine's generator: two
    replays from one cache state differ, and reseeding the generator
    reproduces a replay, and the eager chunk it was captured from."""
    cfg, params = _graph_model(False)
    eng = _engine(cfg, params, cuda, True)
    eng.generate(_prompts([30, 9, 50, 12], cfg.vocab_size),
                 SamplingParams(max_new_tokens=2))
    hot = SamplingParams(temperature=1.0)
    eng.active = {s: E.Request(s, [1], hot) for s in range(4)}
    c = eng.cache
    saved = [t.clone() for t in (c.k, c.v, c.k_scale, c.v_scale, c.lengths)]
    toks = np.array([5, 6, 7, 8], np.int32)
    active = np.ones((4,), bool)

    def chunk(seed=None):
        for t, v in zip((c.k, c.v, c.k_scale, c.v_scale, c.lengths), saved):
            t.copy_(v)
        if seed is not None:
            eng.generator.manual_seed(seed)
        out = eng.run_chunk(toks, active, all_greedy=False, attn_span=128)
        return out[0].cpu()

    graphs = eng.graph_stats()["graphs"]
    eager = chunk(5)            # captured after this chunk
    a, b, a2 = chunk(5), chunk(), chunk(5)
    assert eng.graph_stats()["graphs"] == graphs + 1
    assert not torch.equal(a, b)
    assert torch.equal(a, a2)
    assert torch.equal(a, eager)


def test_graph_replays_count_their_launches(cuda):
    """After k replays the launch counters have moved by k times what one
    eager chunk of the same key launches."""
    cfg, params = _graph_model(False)
    prompts = _prompts([30, 9, 50], cfg.vocab_size)
    toks = np.array([5, 6, 7, 0], np.int32)
    active = np.array([True, True, True, False])
    per_chunk = {}
    for graphs in (False, True):
        eng = _engine(cfg, params, cuda, graphs)
        eng.generate(prompts, SamplingParams(max_new_tokens=4))
        eng.run_chunk(toks, active, all_greedy=True, attn_span=256)
        before = _launches()
        for _ in range(3):
            eng.run_chunk(toks, active, all_greedy=True, attn_span=256)
        torch.cuda.synchronize()
        per_chunk[graphs] = {k: v - before[k] for k, v in _launches().items()}
    assert per_chunk[False]["K1"] == 3 * 8 * (4 * cfg.num_layers + 1)
    assert per_chunk[False]["K2"] == 3 * 8 * cfg.num_layers
    assert per_chunk[True] == per_chunk[False]
    # the kernels of one replay, by the kernel nodes of its graph
    names = eng.graph_kernel_names(256)
    nodes = {k: sum(c for nm, c in names.items() if re.search(rx, nm))
             for k, rx in (("K1", r"tc_kernel<[^,]*\bInt4,"),
                           ("K2", r"flash_decode_kernel<"),
                           ("K4", r"tc_kernel<[^,]*\bNf4,"))}
    assert {k: 3 * n for k, n in nodes.items()} == per_chunk[True]


def test_chunk_graphs_advance_every_registered_counter(cuda):
    """A replay adds what its capture counted to every counter in
    ``ops._build.COUNTERS``, the plain versions' calls on CUDA tensors as
    well as the kernels' launches: a counter registered the same way
    counts the eager first run once and each replay once."""
    def doubled(x):
        doubled.calls += 1
        return x * 2

    _build.counter(doubled, "calls")
    try:
        graphs = E.ChunkGraphs(cuda)
        x = torch.arange(4.0, device=cuda)
        for _ in range(3):
            out = graphs.run("key", lambda: doubled(x))
        torch.cuda.synchronize()
        assert doubled.calls == 3 and len(graphs) == 1
        assert torch.equal(out, 2 * x)
    finally:
        _build.COUNTERS.remove((doubled, "calls"))


def test_two_graphed_engines_share_a_stream(cuda):
    """Graphed engines of two widths on one capture stream (the stream
    pool hands one stream to more than one caller), that stream's split-K
    scratch grown between their chunks: each engine's graphed greedy
    tokens equal its eager ones, chunk after chunk."""
    models = [_graph_model(False), _graph_model(True)]
    prompts = _prompts([30, 9, 50], 512)
    sp = SamplingParams(max_new_tokens=20)
    want = [_engine(cfg, params, cuda, False).generate(prompts, sp)
            for cfg, params in models]
    engines = [_engine(cfg, params, cuda, True) for cfg, params in models]
    stream = engines[0]._graphs.stream
    engines[1]._graphs.stream = stream
    assert engines[0].generate(prompts, sp) == want[0]
    held = _build.scratch_bytes()[stream.cuda_stream]
    with torch.cuda.stream(stream):
        _build.split_plan(_big_plan, (1 << 25) + (1 << 20), 1, 1, 1, cuda)
    assert _build.scratch_bytes()[stream.cuda_stream] > held
    for i in (1, 0, 1):
        assert engines[i].generate(prompts, sp) == want[i]


# ---------------------------------------------------------------------------
# K4: packed NF4 x A8 matmul
# ---------------------------------------------------------------------------

def _packed(rng, n, kp, bs):
    """Random packed codes [N, K_pad/2] and absmax [N, K_pad/bs]."""
    return (torch.from_numpy(rng.integers(0, 256, (n, kp // 2), dtype=np.uint8)),
            torch.from_numpy(rng.uniform(5e-3, 3.5e-2, (n, kp // bs))
                             .astype(np.float32)))


@pytest.mark.parametrize("m,n,kp,bs", [
    (8, 15360, 5120, 64), (1, 5120, 5120, 128), (64, 1024, 13824, 64),
    (3, 256, 512, 16), (5, 384, 768, 4), (2, 128, 4096, 2048)])
def test_w4a8_mm_matches_plain(cuda, m, n, kp, bs):
    """Decode widths of Llama-2-13B, prefill-bucket M = 64, and block sizes
    below 32 (per-group scaling) and above 1024 (whole-warp blocks)."""
    rng = np.random.default_rng(m * n + bs)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, kp), dtype=np.int8))
    w, am = _packed(rng, n, kp, bs)
    sx = torch.from_numpy(rng.uniform(1e-3, 5e-2, (m,)).astype(np.float32))
    args = [t.to(cuda) for t in (xq, w, am, sx)]
    ref = K4.w4a8_mm_plain(*args)
    before = K4.w4a8_mm.launches
    got = K4.w4a8_mm(*args)
    torch.cuda.synchronize()
    assert K4.w4a8_mm.launches == before + 1
    assert torch.isfinite(got).all()
    assert rel_err(got, ref) <= 1e-5


def _w4a8_case(cuda, m, n, kp, bs):
    rng = np.random.default_rng(m * 7 + n + kp + bs)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, kp), dtype=np.int8))
    w, am = _packed(rng, n, kp, bs)
    sx = torch.from_numpy(rng.uniform(1e-3, 5e-2, (m,)).astype(np.float32))
    args = [t.to(cuda) for t in (xq, w, am, sx)]
    before = K4.w4a8_mm.launches
    got = K4.w4a8_mm(*args)
    torch.cuda.synchronize()
    assert K4.w4a8_mm.launches == before + 1
    assert torch.isfinite(got).all()
    assert rel_err(got, K4.w4a8_mm_plain(*args)) <= 1e-5


@pytest.mark.parametrize("bs", [16, 32, 64, 128, 2048])
@pytest.mark.parametrize("m", [1, 3, 8, 9, 32, 33, 64])
def test_w4a8_mm_tile_edges(cuda, m, bs):
    """M at and past the n8 tiles of the tensor-core path (1-64), blocks
    shorter than, equal to and longer than its 256-code chunk, and 16 (the
    __dp4a path), at N=5120 (split along K)."""
    _w4a8_case(cuda, m, 5120, 6144, bs)


@pytest.mark.parametrize("m,n,kp,bs", [
    (8, 27648, 5120, 64), (64, 27648, 5120, 64), (33, 27648, 5120, 32),
    (9, 1000, 4032, 64), (3, 4099, 512, 128), (65, 384, 512, 64)])
def test_w4a8_mm_odd_shapes(cuda, m, n, kp, bs):
    """The gate/up width of Llama-2-13B, odd N (a partial row tile), K_pad
    not a multiple of the chunk (4032), and M past 64 (two M groups)."""
    _w4a8_case(cuda, m, n, kp, bs)


def test_w4a8_mm_operand_alignment(cuda):
    """absmax may start anywhere (an offset view takes the 4-byte copies);
    x and the codes must start on a 16-byte boundary, or the wrapper
    raises."""
    rng = np.random.default_rng(5)
    m, n, kp, bs = 8, 5120, 5120, 64
    xq = torch.from_numpy(rng.integers(-127, 128, (m, kp), dtype=np.int8))
    w, am = _packed(rng, n, kp, bs)
    sx = torch.from_numpy(rng.uniform(1e-3, 5e-2, (m,)).astype(np.float32))
    xq, w, sx = xq.to(cuda), w.to(cuda), sx.to(cuda)
    am_off = torch.empty((am.numel() + 1,), device=cuda)[1:].view(am.shape)
    am_off.copy_(am.to(cuda))
    assert am_off.is_contiguous() and am_off.data_ptr() % 16
    got = K4.w4a8_mm(xq, w, am_off, sx)
    assert rel_err(got, K4.w4a8_mm_plain(xq, w, am_off, sx)) <= 1e-5
    x_off = torch.empty((m * kp + 4,), dtype=torch.int8,
                        device=cuda)[4:].view(m, kp)
    with pytest.raises(ValueError, match="16-byte"):
        K4.w4a8_mm(x_off, w, am_off, sx)


def test_w4a8_mm_two_streams(cuda):
    """Two split-K shapes with the same row tiles, launched on two streams
    at once: each stream has its own partials and counts, so every result
    equals the plain version."""
    rng = np.random.default_rng(17)
    cases = []
    for kp in (5120, 13824):
        xq = torch.from_numpy(rng.integers(-127, 128, (8, kp), dtype=np.int8))
        w, am = _packed(rng, 5120, kp, 64)
        sx = torch.from_numpy(rng.uniform(1e-3, 5e-2, (8,)).astype(np.float32))
        cases.append([t.to(cuda) for t in (xq, w, am, sx)])
    refs = [K4.w4a8_mm_plain(*args) for args in cases]
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    torch.cuda.synchronize()
    outs = [[] for _ in cases]
    for _ in range(20):
        for st, args, got in zip(streams, cases, outs):
            with torch.cuda.stream(st):
                got.append(K4.w4a8_mm(*args))
    torch.cuda.synchronize()
    for ref, got in zip(refs, outs):
        assert max(rel_err(g, ref) for g in got) <= 1e-5


@pytest.mark.parametrize("m", [1, 8, 64])
def test_w4a8_matmul_card_matches_cpu(cuda, m):
    """The wrapper's A8 row quantization and the double-quantized absmax
    give the CPU's numbers on the card."""
    rng = np.random.default_rng(m)
    w = torch.from_numpy((rng.standard_normal((512, 1000)) * 0.05)
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, 1000)).astype(np.float32))
    packed, st = TF.quantize_4bit(w, blocksize=64, compress_statistics=True)
    st.dtype = torch.float32
    ref = K4.w4a8_matmul_4bit(x, packed, st)
    st_c = dataclasses.replace(
        st, absmax=st.absmax.to(cuda),
        state2=dataclasses.replace(st.state2,
                                   absmax=st.state2.absmax.to(cuda)))
    got = K4.w4a8_matmul_4bit(x.to(cuda), packed.to(cuda), st_c)
    torch.cuda.synchronize()
    assert rel_err(got, ref) <= 1e-5


def test_w4a8_mm_rejects_bad_operands(cuda):
    xq = torch.zeros((2, 256), dtype=torch.int8, device=cuda)
    w = torch.zeros((128, 128), dtype=torch.uint8, device=cuda)
    am = torch.ones((128, 4), device=cuda)
    sx = torch.ones((2,), device=cuda)
    with pytest.raises(TypeError):
        K4.w4a8_mm(xq.float(), w, am, sx)
    with pytest.raises(ValueError):
        K4.w4a8_mm(xq, w[:, :64], am, sx)
    with pytest.raises(ValueError):
        K4.w4a8_mm(xq, torch.zeros((128, 256), dtype=torch.uint8,
                                   device=cuda)[:, ::2], am, sx)
    with pytest.raises(ValueError, match="block of 4"):   # blocksize 6
        K4.w4a8_mm(xq[:, :192].contiguous(), w[:, :96].contiguous(),
                   torch.ones((128, 32), device=cuda), sx)


# ---------------------------------------------------------------------------
# K5: fused 4-bit dequant-matmul
# ---------------------------------------------------------------------------

def _mm4_case(m, n, kp, bs, seed, mode="bf16", quant_type="nf4"):
    """Random K5 operands on the CPU: x, packed codes, absmax, codebook."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, kp)).astype(np.float32))
    x = x.to(torch.bfloat16 if mode == "bf16" else torch.float32)
    w, am = _packed(rng, n, kp, bs)
    return [x, w, am, TF.codebook(quant_type, "cpu")]


@pytest.mark.parametrize("mode", ["bf16", "f32"])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("m,n,kp,bs", [
    (65, 5120, 5120, 64), (128, 1000, 4032, 64), (256, 384, 512, 128),
    (100, 131, 200, 2), (70, 200, 96, 4),
    # the wgmma kernel's three token widths (M 1-64, 65-128, 129-256), K
    # split (N=5120, K=13824), the gate/up width, an odd N, K_pad half a
    # stage past a whole one with blocks of 16 and 32
    (1, 5120, 5120, 64), (64, 5120, 13824, 64), (129, 27648, 5120, 64),
    (256, 5120, 13824, 64), (128, 1001, 4064, 32), (200, 384, 160, 16)])
def test_matmul4bit_mm_matches_plain(cuda, mode, quant_type, m, n, kp, bs):
    """Prefill-bucket M, odd N, K padded off the 32-wide slice (K_pad 200:
    the element-wise load path of the 64 x 64-tile kernel) and blocks below
    16 (per-element absmax) on that kernel; every wgmma instance."""
    args = [t.to(cuda) for t in _mm4_case(m, n, kp, bs, m + n + kp, mode,
                                           quant_type)]
    ref = K5.matmul4bit_plain(*args, mode)
    before = K5.matmul4bit_mm.launches, K5.matmul4bit_mm.wgmma_launches
    got = K5.matmul4bit_mm(*args, mode)
    torch.cuda.synchronize()
    wgmma = K5.kernel_of(m, n, kp, bs, mode) == "wgmma"
    assert wgmma == (mode == "bf16" and bs % 16 == 0)
    assert (K5.matmul4bit_mm.launches, K5.matmul4bit_mm.wgmma_launches) == (
        before[0] + 1, before[1] + wgmma)
    assert torch.isfinite(got).all()
    assert rel_err(got, ref) <= (1e-4 if mode == "bf16" else 1e-5)


def test_matmul4bit_mm_two_streams(cuda):
    """Two split-K shapes of the wgmma kernel with the same row tiles,
    launched on two streams at once: each stream has its own partials and
    counts, so every result equals the plain version."""
    cases = [[t.to(cuda) for t in _mm4_case(128, 5120, kp, 64, kp)]
             for kp in (5120, 13824)]
    refs = [K5.matmul4bit_plain(*args, "bf16") for args in cases]
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    torch.cuda.synchronize()
    outs = [[] for _ in cases]
    for _ in range(20):
        for st, args, got in zip(streams, cases, outs):
            with torch.cuda.stream(st):
                got.append(K5.matmul4bit_mm(*args, "bf16"))
    torch.cuda.synchronize()
    for ref, got in zip(refs, outs):
        assert max(rel_err(g, ref) for g in got) <= 1e-4


def test_matmul4bit_mm_graph_replay(cuda):
    """The wgmma kernel captured in a CUDA graph (tensor maps by value,
    split-K scratch of the capture stream) and replayed on new inputs
    copied into the captured ones."""
    x1, w, am, book = (t.to(cuda) for t in _mm4_case(256, 5120, 13824, 64, 4))
    graph, _, got = _capture(
        lambda: K5.matmul4bit_mm(x1, w, am, book, "bf16"))
    for seed in (5, 6):
        x2 = _mm4_case(256, 5120, 13824, 64, seed)[0].to(cuda)
        x1.copy_(x2)
        graph.replay()
        torch.cuda.synchronize()
        assert rel_err(got, K5.matmul4bit_plain(x2, w, am, book,
                                                "bf16")) <= 1e-4


def test_matmul4bit_mm_rejects_bad_operands(cuda):
    x = torch.zeros((4, 128), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((64, 64), dtype=torch.uint8, device=cuda)
    am = torch.ones((64, 2), device=cuda)
    book = torch.zeros((16,), device=cuda)
    with pytest.raises(TypeError):
        K5.matmul4bit_mm(x, w, am, book, "f32")
    with pytest.raises(ValueError):
        K5.matmul4bit_mm(x, w[:, :32], am, book, "bf16")
    with pytest.raises(ValueError):
        K5.matmul4bit_mm(x, w, am, book, "fp8")
    x_off = torch.empty((4 * 128 + 4,), dtype=torch.bfloat16,
                        device=cuda)[4:].view(4, 128)
    with pytest.raises(ValueError, match="16-byte"):
        K5.matmul4bit_mm(x_off, w, am, book, "bf16")


def test_takes_wgmma_states_the_kernels_plan(cuda):
    """On the card the wgmma kernel's plan routes (no stages per split for a
    shape it does not take); ``takes_wgmma``, the rule the CPU tests pin,
    agrees with it over the edges of M, K_pad and the blocksize."""
    from tpu_bitsandbytes_torch.ops import _build
    plan = K5._launchers()[2]
    for m in (0, 1, 64, 65, 128, 129, 256, 257):
        for kp in (96, 160, 200, 4064, 5120, 13824):
            for bs in (2, 8, 16, 32, 48, 64, 128):
                cps = _build.plan_of(plan, m, 5120, kp, bs, cuda)[0]
                assert (cps > 0) == K5.takes_wgmma(m, 5120, kp, bs), (
                    m, kp, bs, cps)


# ---------------------------------------------------------------------------
# K3: flash prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,h_kv,d,s_real,opts,dtype", [
    (1, 1024, 8, 8, 128, 1024, {}, torch.bfloat16),
    (2, 1100, 8, 2, 64, 1000, {}, torch.bfloat16),
    (1, 1024, 4, 1, 128, 1024, {"window": 300, "softcap": 50.0},
     torch.bfloat16),
    (1, 1024, 4, 4, 64, 1024, {}, torch.float16),
    # the 128 x 128 tiles' edges: ragged S past s_real, a window straddling
    # key tiles under GQA rep 4, softcap alone, f16 at D=128, d=64 with a
    # window, S below one tile
    (1, 1100, 8, 8, 128, 1000, {}, torch.bfloat16),
    (1, 2048, 32, 8, 128, 2048, {"window": 300}, torch.bfloat16),
    (1, 1024, 8, 8, 128, 1024, {"softcap": 50.0}, torch.bfloat16),
    (1, 1100, 8, 2, 128, 1000, {}, torch.float16),
    (2, 1100, 8, 8, 64, 1000, {"window": 300}, torch.bfloat16),
    (2, 100, 4, 1, 128, 90, {}, torch.bfloat16),
    # d = 256 (64-key tiles) over the lengths JAX's kernel takes there
    # (512 to 5632): MHA, GQA with a window straddling key tiles and a
    # softcap, f16, ragged S past s_real, the longest
    (1, 512, 4, 4, 256, 512, {}, torch.bfloat16),
    (2, 1024, 8, 2, 256, 1024, {"window": 300, "softcap": 50.0},
     torch.bfloat16),
    (1, 1100, 4, 4, 256, 1000, {}, torch.float16),
    (1, 5632, 2, 1, 256, 5632, {}, torch.bfloat16)])
def test_flash_prefill_matches_plain(cuda, b, s, h, h_kv, d, s_real, opts,
                                     dtype):
    rng = np.random.default_rng(s + h + d)
    q, k, v = (torch.from_numpy((rng.standard_normal(shape) * 0.5)
                                .astype(np.float32)).to(dtype).to(cuda)
               for shape in ((b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d)))
    scale = 1.0 / d ** 0.5
    ref = K3.flash_prefill_plain(q, k, v, s_real=s_real, scale=scale,
                                 block_k=K3.KEY_TILE[d], **opts)
    before = K3.flash_prefill_attention.launches
    got = K3.flash_prefill_attention(q, k, v, s_real=s_real, scale=scale,
                                     **opts)
    torch.cuda.synchronize()
    assert K3.flash_prefill_attention.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got[:, :s_real]).all()
    # query rows past s_real are padding the caller drops
    assert row_rel_err(got[:, :s_real], ref[:, :s_real]) <= 1e-2


def test_flash_prefill_rejects_bad_operands(cuda):
    q = torch.zeros((1, 128, 4, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        K3.flash_prefill_attention(q.float(), q.float(), q.float(),
                                   s_real=128, scale=1.0)
    with pytest.raises(NotImplementedError):
        q96 = torch.zeros((1, 128, 4, 96), dtype=torch.bfloat16, device=cuda)
        K3.flash_prefill_attention(q96, q96, q96, s_real=128, scale=1.0)
    with pytest.raises(ValueError):
        K3.flash_prefill_attention(q, q[:, :64], q, s_real=128, scale=1.0)


def test_gqa_attention_flash_head_dim_96_takes_the_scan(cuda):
    """Half precision at a head dim K3 does not take runs the scan on the
    card (no K3 launch) and agrees with the CPU's, per query row."""
    from tpu_bitsandbytes_torch.models import layers
    rng = np.random.default_rng(96)
    q, k, v = (torch.from_numpy((rng.standard_normal(shape) * 0.5)
                                .astype(np.float32)).to(torch.bfloat16)
               for shape in ((1, 1024, 4, 96), (1, 1024, 2, 96),
                             (1, 1024, 2, 96)))
    ref = layers.gqa_attention_flash(q, k, v)
    before = K3.flash_prefill_attention.launches
    got = layers.gqa_attention_flash(q.to(cuda), k.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    assert K3.flash_prefill_attention.launches == before
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert row_rel_err(got, ref) <= 1e-2


@pytest.mark.parametrize("s", [600, 2048])
def test_gqa_attention_flash_head_dim_256_runs_k3(cuda, s):
    """d = 256 where JAX runs its kernel goes to K3 on the card (one
    launch) and agrees, per query row, with K3's plain version at the
    kernel's 64-key tile, which is what the CPU runs for the same call."""
    from tpu_bitsandbytes_torch.models import layers
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy((rng.standard_normal(shape) * 0.5)
                                .astype(np.float32)).to(torch.bfloat16)
               for shape in ((1, s, 4, 256), (1, s, 2, 256),
                             (1, s, 2, 256)))
    ref = layers.gqa_attention_flash(q, k, v)
    before = K3.flash_prefill_attention.launches
    got = layers.gqa_attention_flash(q.to(cuda), k.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    assert K3.flash_prefill_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert row_rel_err(got, ref) <= 1e-2


# ---------------------------------------------------------------------------
# the packed-NF4 path (no runtime cache) on the card against the CPU
# ---------------------------------------------------------------------------

def test_packed_path_card_matches_cpu(cuda):
    """bf16, no runtime cache, hidden 256 (every branch reachable): a
    5-token prompt (K4), a 70-token one (K5) and a 1,100-token one (bucket
    2048: the dequant product and K3), then 4 decode steps, each with 4 K4
    launches per layer plus the head and one K2 per layer."""
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=512, num_layers=2, num_heads=2,
                            num_kv_heads=1, max_seq_len=2048)
    gen = torch.Generator().manual_seed(3)
    params = llama.quantize_params(
        llama.init_params(cfg, generator=gen, device="cpu"),
        fuse_projections=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, n).tolist() for n in (5, 70, 1100)]

    def run(dev, fed=None):
        p = llama.to_device(params, dev)
        cache = KVCache.create(cfg.num_layers, 3, 2048, cfg.num_kv_heads,
                               cfg.hd, device=dev)
        logits = []
        for slot, pr in enumerate(prompts):
            toks = torch.zeros((1, E._bucket(len(pr), 2048)),
                               dtype=torch.int32)
            toks[0, :len(pr)] = torch.tensor(pr, dtype=torch.int32)
            lg, cache = E.prefill_step(p, cache, toks.to(dev), slot, len(pr),
                                       cfg)
            logits.append(lg)
        toks = torch.stack(logits).argmax(-1).to(torch.int32).cpu()
        active = torch.ones((3,), dtype=torch.bool, device=dev)
        cache.begin_stage(4, window=False)
        fed_out, launches = [], []
        for i in range(4):
            t_in = toks if fed is None else fed[i]
            fed_out.append(t_in)
            k4, k2 = K4.w4a8_mm.launches, K2.flash_decode_attention.launches
            lg, cache = E.decode_step(p, cache, t_in.to(dev), active, cfg,
                                      attn_span=1280)
            launches.append((K4.w4a8_mm.launches - k4,
                             K2.flash_decode_attention.launches - k2))
            logits.append(lg)
            toks = lg.argmax(-1).to(torch.int32).cpu()
        cache.flush_stage()
        return [lg.float().cpu() for lg in logits], fed_out, launches

    ref, fed, _ = run("cpu")
    k3, k5 = K3.flash_prefill_attention.launches, K5.matmul4bit_mm.launches
    got, _, launches = run(cuda, fed)
    assert K3.flash_prefill_attention.launches > k3
    assert K5.matmul4bit_mm.launches > k5
    assert launches == [(4 * cfg.num_layers + 1, cfg.num_layers)] * 4
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert rel_err(g, r) <= 3e-2


# ---------------------------------------------------------------------------
# the request API: penalty, logprobs, chunked prefill, bf16 KV
# ---------------------------------------------------------------------------

def _request_mix(vocab):
    """Prompts of 100, 20, 60 and 45 tokens: greedy, greedy with a
    penalty, greedy with logprobs, and both; prompts repeat tokens so the
    penalty acts."""
    prompts = [p + p[:6] for p in _prompts([94, 14, 54, 39], vocab)]
    sps = [SamplingParams(max_new_tokens=40),
           SamplingParams(max_new_tokens=40, repetition_penalty=1.3),
           SamplingParams(max_new_tokens=40, logprobs=True),
           SamplingParams(max_new_tokens=40, repetition_penalty=1.5,
                          logprobs=True)]
    return prompts, sps


def _serve(eng, prompts, sps):
    for p, sp in zip(prompts, sps):
        eng.add_request(p, sp)
    while eng.step():
        pass
    return {r.uid: (r.generated, r.logprobs) for r in eng.finished}


@pytest.mark.parametrize("packed", [False, True])
def test_penalty_and_logprobs_graphs_replay_eager(cuda, packed):
    """Chunks with the repetition penalty and logprobs, graphed, emit the
    tokens and logprobs the eager chunks emit (the same kernels in the
    same order: logprobs within 1e-6), through the int4 cache and off the
    packed bytes; the graphs met carry the penalty and logprobs flags."""
    cfg, params = _graph_model(packed)
    prompts, sps = _request_mix(cfg.vocab_size)
    outs, keys = {}, None
    for graphs in (False, True):
        eng = _engine(cfg, params, cuda, graphs)
        outs[graphs] = _serve(eng, prompts, sps)
        if graphs:
            keys = eng.graph_keys()
    assert {u: g for u, (g, _) in outs[True].items()} == {
        u: g for u, (g, _) in outs[False].items()}
    for u, (_, lps) in outs[True].items():
        np.testing.assert_allclose(lps, outs[False][u][1], rtol=0, atol=1e-6)
    assert len(outs[True][4][1]) == 40 and outs[True][1][1] == []
    assert any(k[3] and k[4] for k in keys)
    plain = _serve(_engine(cfg, params, cuda, True), prompts,
                   [SamplingParams(max_new_tokens=40)] * 4)
    assert plain[2][0] != outs[True][2][0]       # the penalty acted


def test_graphed_seen_mask_equals_host_rebuild(cuda):
    """Inside a replayed chunk the seen mask is updated on the device as
    tokens are emitted; after each chunk it equals the host's rebuild from
    the requests' prompts and outputs, slot by slot."""
    cfg, params = _graph_model(False)
    eng = _engine(cfg, params, cuda, True)
    prompts, _ = _request_mix(cfg.vocab_size)
    for p, pen in zip(prompts, (1.2, 1.0, 1.5, 1.3)):
        eng.add_request(p, SamplingParams(max_new_tokens=30,
                                          repetition_penalty=pen))
    checked = 0
    while eng.step():
        host = torch.from_numpy(eng._seen_mask())
        dev = eng._seen.cpu()
        for slot in eng.active:
            assert torch.equal(dev[slot], host[slot])
            checked += 1
    assert checked > 4 and eng.graph_stats()["graphs"] >= 1


@pytest.mark.parametrize("packed", [False, True])
def test_bf16_kv_engine_serves_graphed(cuda, packed):
    """``quantized_kv=False``: no stage, no K2 (decode attention is plain
    torch over the bf16 cache); graphed chunks emit the eager chunks'
    greedy tokens, with a chunked prefill among them."""
    cfg, params = _graph_model(packed)
    prompts = _prompts([100, 20, 60], cfg.vocab_size)
    sp = SamplingParams(max_new_tokens=30)
    outs = {}
    for graphs in (False, True):
        eng = E.DecodeEngine(llama.to_device(params, cuda), cfg, max_batch=4,
                             steps_per_sync=8, device=cuda, cuda_graphs=graphs,
                             quantized_kv=False, prefill_chunk=32)
        assert eng.cache.k.dtype == torch.bfloat16
        k2 = K2.flash_decode_attention.launches
        outs[graphs] = eng.generate(prompts, sp)
        assert K2.flash_decode_attention.launches == k2
    assert outs[True] == outs[False]
    assert all(len(o) == 30 for o in outs[True])


@pytest.mark.parametrize("quantized", [True, False])
def test_chunked_prefill_card_matches_cpu(cuda, quantized):
    """f32, int4 cache: 16-token prefill chunks on the card (K1 for every
    matmul) differ from the CPU's only in f32 sum order, so the greedy
    tokens are identical, on an int8 and on an unquantized cache."""
    cfg, params = _tiny(torch.float32)
    prompts = _prompts([50, 7, 33], cfg.vocab_size)
    sp = SamplingParams(max_new_tokens=8)
    kw = dict(max_batch=2, max_seq=128, steps_per_sync=4, prefill_chunk=16,
              quantized_kv=quantized)
    ref = E.DecodeEngine(params, cfg, device="cpu", **kw).generate(prompts, sp)
    k1 = K1.int4_mm.launches
    got = E.DecodeEngine(llama.to_device(params, cuda), cfg, device=cuda,
                         **kw).generate(prompts, sp)
    assert K1.int4_mm.launches > k1
    assert got == ref


# ---------------------------------------------------------------------------
# the engine's lifecycle: warm-up, snapshot and restore, pipelined dispatch,
# the speculative verify step
# ---------------------------------------------------------------------------

def test_warmup_captures_the_plans_keys(cuda):
    """Warm-up builds every kernel and captures exactly the plan's graph
    keys, leaves every length at zero, and serving the prompt lengths it
    was given then captures nothing more and emits an unwarmed engine's
    greedy tokens."""
    cfg, params = _graph_model(False)
    prompts = _prompts([100, 20, 60], cfg.vocab_size)
    sp = SamplingParams(max_new_tokens=40)
    want = _engine(cfg, params, cuda, True).generate(prompts, sp,
                                                     pipeline_depth=1)
    eng = _engine(cfg, params, cuda, True)
    plan = eng.warmup(prompt_lengths=[len(p) for p in prompts],
                      features=("sampled",))
    keys = eng.plan_graph_keys(plan)
    assert eng.graph_keys() == keys and len(keys) == 4
    assert all(_build.loaded().values())
    assert eng.cache.lengths.tolist() == [0] * 4
    assert eng.generate(prompts, sp, pipeline_depth=1) == want
    assert eng.graph_keys() == keys


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_load_state_into_a_warmed_graphed_engine(cuda, tmp_path,
                                                 temperature):
    """A snapshot loaded into a graphed engine whose graphs were captured
    before the load (by warm-up) replays them against the restored cache
    and generator: greedy and sampled requests finish with the tokens of
    the run that was not interrupted."""
    cfg, params = _graph_model(False)
    prompts = _prompts([30, 9, 50, 12, 20], cfg.vocab_size)
    sp = SamplingParams(max_new_tokens=40, temperature=temperature, top_k=20)
    a = _engine(cfg, params, cuda, True)
    for p in prompts:
        a.add_request(p, sp)
    for _ in range(3):
        a.step()
    assert a.waiting and a.active
    path = str(tmp_path / "snap.npz")
    a.save_state(path)
    while a.step():
        pass
    ref = {r.uid: r.generated for r in a.finished}
    b = _engine(cfg, params, cuda, True)
    b.warmup(prompt_lengths=[len(p) for p in prompts], features=("sampled",))
    keys = b.graph_keys()
    b.load_state(path)
    while b.step():
        pass
    assert {r.uid: r.generated for r in b.finished} == ref
    assert b.graph_keys() == keys           # every chunk replayed


def test_pipelined_and_step_loop_tokens_match(cuda):
    """``generate``'s pipelined default gives the step loop's greedy
    tokens, graphed and eager: slot turnover, requests retiring
    mid-pipeline, a repetition penalty and logprobs carried across the
    pipelined chunks on the device."""
    cfg, params = _graph_model(False)
    prompts = _prompts([100, 20, 60, 9, 33], cfg.vocab_size)
    sps = [SamplingParams(max_new_tokens=40),
           SamplingParams(max_new_tokens=12, repetition_penalty=1.3),
           SamplingParams(max_new_tokens=30, logprobs=True),
           SamplingParams(max_new_tokens=5),
           SamplingParams(max_new_tokens=40)]
    want = _engine(cfg, params, cuda, False).generate(prompts, sps,
                                                      pipeline_depth=1)
    for graphs in (False, True):
        assert _engine(cfg, params, cuda, graphs).generate(prompts,
                                                           sps) == want


def test_verify_graph_holds_k1_and_no_k2(cuda):
    """A verify step launches 4 * layers + 1 K1 (M = B * (gamma + 1)) and
    no K2, by the counters of an eager verify and of a graphed one and by
    the kernel nodes of its graph; graphed and eager speculative engines
    emit the same greedy tokens."""
    cfg, params = _graph_model(False)
    prompts = [p * 3 for p in _prompts([8, 8, 8], cfg.vocab_size)]
    sp = SamplingParams(max_new_tokens=24)
    want = {"K1": 4 * cfg.num_layers + 1, "K2": 0, "K4": 0}
    toks = np.ones((4, 5), np.int32)
    active = np.array([True, True, True, False])
    outs = {}
    for graphs in (False, True):
        eng = E.DecodeEngine(llama.to_device(params, cuda), cfg, max_batch=4,
                             steps_per_sync=8, device=cuda,
                             cuda_graphs=graphs, speculative="ngram",
                             spec_gamma=4)
        outs[graphs] = eng.generate(prompts, sp)
        assert eng.spec_stats["verify_steps"] > 0
        eng.run_verify(toks, active, all_greedy=True, attn_span=128)
        before = _launches()
        eng.run_verify(toks, active, all_greedy=True, attn_span=128)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in _launches().items()} == want
        if graphs:
            assert ("verify", 128, 4, True) in eng.graph_keys()
            names = eng.verify_kernel_names(128)
            nodes = {k: sum(c for nm, c in names.items() if re.search(rx, nm))
                     for k, rx in (("K1", r"tc_kernel<[^,]*\bInt4,"),
                                   ("K2", r"flash_decode_kernel<"),
                                   ("K4", r"tc_kernel<[^,]*\bNf4,"))}
            assert nodes == want
    assert outs[True] == outs[False]


def test_speculative_f32_tokens_card_match_cpu(cuda):
    """f32: the speculative engine on the card emits the CPU's tokens,
    which are plain greedy's."""
    cfg, params = _tiny(torch.float32)
    pat = _prompts([4], cfg.vocab_size)[0]
    prompts = [pat * 4, _prompts([12], cfg.vocab_size)[0]]
    sp = SamplingParams(max_new_tokens=12)
    kw = dict(max_batch=2, steps_per_sync=4, quantized_kv=False)
    plain = E.DecodeEngine(params, cfg, device="cpu", **kw).generate(prompts,
                                                                    sp)
    ref = E.DecodeEngine(params, cfg, device="cpu", speculative="ngram",
                         **kw).generate(prompts, sp)
    got = E.DecodeEngine(llama.to_device(params, cuda), cfg, device=cuda,
                         speculative="ngram", **kw).generate(prompts, sp)
    assert got == ref == plain


# ---------------------------------------------------------------------------
# the int8 and bf16 runtime caches, "auto", and the bitsandbytes-style API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["int8", "bf16"])
def test_runtime_cache_card_matches_cpu(cuda, fmt):
    """The int8 and bf16 caches built on the card equal the CPU's bit for
    bit (the int8 scale is max|w| / 127 by ``div_exact``: a reciprocal
    multiply would move codes), and the product on the card (one bf16
    GEMM with an f32 output) is within one bf16 ulp of the largest output
    (2^-7 of max|ref|) of the CPU's: both round f32 sums of 4096 terms in
    another order, so an output near zero may differ by more than its own
    ulp."""
    from tpu_bitsandbytes_torch.models.layers import QLinear4
    rng = np.random.default_rng(31)
    w = torch.from_numpy(rng.standard_normal((1000, 4096), dtype=np.float32))
    q = QLinear4.quantize(w, dtype=torch.bfloat16)
    cpu = q.with_runtime_cache(fmt)
    card = dataclasses.replace(
        q, packed=q.packed.to(cuda), absmax=q.absmax.to(cuda)
    ).with_runtime_cache(fmt)
    assert torch.equal(card.w_cache.cpu(), cpu.w_cache)
    if fmt == "int8":
        assert torch.equal(card.cache_scale.cpu(), cpu.cache_scale)
    x = torch.from_numpy(rng.standard_normal((8, 4096), dtype=np.float32)
                         ).to(torch.bfloat16)
    assert rel_err(card(x.to(cuda)), cpu(x)) <= 2.0 ** -7


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (8, 300, 7),
                                   (64, 11008, 4096), (17, 8, 16)])
def test_int8_dot_int_mm_exact(cuda, m, k, n):
    """``int8_dot`` on the card (``torch._int_mm``, padded to M > 16 and K,
    N multiples of 8 where needed) equals the exact integer product."""
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    b = rng.integers(-127, 128, (n, k), dtype=np.int8)
    a[0], b[0] = 127, 127
    got = TF.int8_dot(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64).T)


def test_fp8_bits_card_match_cpu(cuda):
    """E4M3 and E5M2 codes and scales on the card equal the CPU's, the
    saturation included, and NaN where the CPU has NaN. A row with an inf
    has an inf scale, and its inf / inf is a NaN whose sign is the
    hardware's (set on x86, clear on the card); E5M2 keeps that sign, as
    the JAX package's conversion does, so NaN codes are compared as NaN."""
    rng = np.random.default_rng(32)
    a = rng.standard_normal((64, 512), dtype=np.float32) * 50
    a[1, 3], a[2, :3] = np.nan, [1e9, -1e9, np.inf]
    t = torch.from_numpy(a)
    for fn, fp8 in ((TF.quantize_fp8_e4m3, torch.float8_e4m3fn),
                    (TF.quantize_fp8_e5m2, torch.float8_e5m2)):
        (qc, sc), (qh, sh) = fn(t.to(cuda)), fn(t)
        qc = qc.cpu()
        nan = qh.view(fp8).float().isnan()
        assert torch.equal(qc.view(fp8).float().isnan(), nan)
        assert torch.equal(qc[~nan], qh[~nan])
        # the NaN row's scale is NaN on both: compared as numpy, NaN == NaN
        np.testing.assert_array_equal(sc.cpu().numpy(), sh.numpy())


def test_linear4bit_launches_k5(cuda):
    """Linear4bit's forward at M = 8 runs K5 (its wgmma kernel) once, at
    M = 512 the dequantized product; both within 1e-2 of the CPU twin."""
    import copy
    import tpu_bitsandbytes_torch as P
    rng = np.random.default_rng(33)
    src = torch.nn.Linear(4096, 4096, bias=False, dtype=torch.bfloat16)
    with torch.no_grad():
        src.weight.copy_(torch.from_numpy(
            rng.standard_normal((4096, 4096), dtype=np.float32) * 0.02))
    mod = P.Linear4bit.from_linear(src.to(cuda),
                                   compress_statistics=True)
    twin = copy.deepcopy(mod).to("cpu")
    for m, want in ((8, 1), (512, 0)):
        x = torch.from_numpy(rng.standard_normal((m, 4096), dtype=np.float32)
                             ).to(torch.bfloat16)
        n = K5.matmul4bit_mm.launches, K5.matmul4bit_mm.wgmma_launches
        got = mod(x.to(cuda))
        assert (K5.matmul4bit_mm.launches - n[0],
                K5.matmul4bit_mm.wgmma_launches - n[1]) == (want, want)
        assert rel_err(got, twin(x)) <= 1e-2


def test_auto_picks_int4_then_none_on_a_shrunk_budget(cuda, monkeypatch):
    """``runtime_cache="auto"`` on the card: a budget between the int8 and
    int4 cache-only totals picks the int4 cache (K1 in decode), one below
    both the packed bytes (K4), each with the JAX engine's warning."""
    cfg, params = _graph_model(True)
    params = llama.to_device(params, cuda)
    probe = E.DecodeEngine(params, cfg, max_batch=4, device=cuda)

    def total(fmt):
        est = probe._footprint_est(params, fmt, True)
        return sum(est[k] for k in ("exec_cache", "fp", "kv",
                                    "activations_est"))

    prompts = _prompts([20, 9], cfg.vocab_size)
    for budget, fmt, warn, kernel in (
            (int((total("int8") + total("int4")) / 2 / 0.92), "int4",
             "int4 execution cache", "K1"),
            (1024, None, "W4A8", "K4")):
        monkeypatch.setattr(E, "device_memory_bytes", lambda dev: budget)
        with pytest.warns(UserWarning, match=warn):
            eng = E.DecodeEngine(params, cfg, max_batch=4, steps_per_sync=8,
                                 runtime_cache="auto", device=cuda)
        assert eng.runtime_cache == fmt
        before = _launches()
        eng.generate(prompts, SamplingParams(max_new_tokens=10))
        assert _launches()[kernel] > before[kernel]


def test_int8_cache_graphed_chunk_matches_eager(cuda):
    """A decode engine on the int8 cache ("auto" on the card) captures its
    chunks as graphs: greedy tokens identical to the eager chunks', no K1
    or K4 launch, K2 in every decode step; the graph's pool holds the
    widened weights' temporaries."""
    cfg, params = _graph_model(True)
    prompts = _prompts([100, 20, 60, 9], cfg.vocab_size)
    sp = SamplingParams(max_new_tokens=24)
    outs = {}
    for graphs in (False, True):
        eng = E.DecodeEngine(llama.to_device(params, cuda), cfg,
                             max_batch=4, steps_per_sync=8,
                             runtime_cache="auto", device=cuda,
                             cuda_graphs=graphs)
        assert eng.runtime_cache == "int8"
        before = _launches()
        outs[graphs] = eng.generate(prompts, sp)
        after = _launches()
        assert after["K1"] == before["K1"] and after["K4"] == before["K4"]
        assert after["K2"] > before["K2"]
        if graphs:
            assert eng.graph_keys() and eng._graphs.pool_bytes() > 0
    assert outs[True] == outs[False]


# ---------------------------------------------------------------------------
# training: K5's backward, K2/K3 under grad, the 8-bit and paged optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 64, 256])
def test_fused_4bit_backward_card_matches_cpu(cuda, m):
    """K5's autograd Function on the card: the forward launches the wgmma
    kernel once (and no plain version); d_x (the f32 cotangent times the
    dequantized f32 weight, cast to bf16) within one bf16 ulp (2^-8) of
    the CPU's, the f32 GEMM summing in another order."""
    rng = np.random.default_rng(m)
    w = torch.from_numpy(rng.standard_normal((1024, 2048), dtype=np.float32)
                         * 0.02)
    packed, st = TF.quantize_4bit(w, blocksize=64)
    x = torch.from_numpy(rng.standard_normal((m, 2048), dtype=np.float32)
                         ).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((m, 1024), dtype=np.float32)
                         ).to(torch.bfloat16)
    grads = []
    for dev in ("cpu", cuda):
        xd = x.clone().to(dev).requires_grad_()
        n = K5.matmul4bit_mm.wgmma_launches, K5.matmul4bit_plain.cuda_calls
        out = K5.fused_matmul_4bit(xd, packed.to(dev), st.to(dev),
                                   mxu_dtype=torch.bfloat16)
        if dev != "cpu":
            assert (K5.matmul4bit_mm.wgmma_launches - n[0],
                    K5.matmul4bit_plain.cuda_calls - n[1]) == (1, 0)
        out.to(torch.bfloat16).backward(g.to(dev))
        assert xd.grad.dtype == torch.bfloat16
        grads.append(xd.grad)
    assert rel_err(grads[1], grads[0]) <= 2 ** -8


def test_attention_kernels_refuse_grad_on_the_card(cuda):
    """K2 and K3 have no backward: with grad mode on, an input that
    requires grad raises before the launch; under no_grad they launch."""
    q = torch.zeros((1, 1024, 2, 128), dtype=torch.bfloat16, device=cuda,
                    requires_grad=True)
    n = K3.flash_prefill_attention.launches
    with pytest.raises(RuntimeError, match="no backward pass"):
        K3.flash_prefill_attention(q, q, q, s_real=1024, scale=0.1)
    with torch.no_grad():
        K3.flash_prefill_attention(q, q, q, s_real=1024, scale=0.1)
    assert K3.flash_prefill_attention.launches == n + 1
    kq = torch.zeros((1, 1, 256, 128), dtype=torch.int8, device=cuda)
    ks = torch.ones((1, 1, 256), device=cuda)
    qd = torch.zeros((1, 2, 128), device=cuda, requires_grad=True)
    off = torch.tensor([100], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward pass"):
        K2.flash_decode_attention(qd, kq, ks, kq, ks, off)
    with torch.no_grad():
        K2.flash_decode_attention(qd, kq, ks, kq, ks, off)


@pytest.mark.parametrize("name", ["Adam8bit", "PagedAdamW"])
def test_optimizer_step_card_matches_cpu(cuda, name):
    """Two steps of an 8-bit (or paged) optimizer on the card and on the
    CPU from the same bf16 and f32 parameters and gradients: every state
    (int8/uint8 codes, absmax, or the paged f32 moments) and every
    parameter bit for bit: the same elementwise f32 operations, exact
    divisions and correctly rounded square roots on both. The paged
    optimizer's states of the 32,768-element leaf sit in pinned host
    memory after each step."""
    import tpu_bitsandbytes_torch.optim as O
    rng = np.random.default_rng(1)
    shapes = [(256, 128), (300,)]
    init = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    grads = [[rng.standard_normal(s, dtype=np.float32) for s in shapes]
             for _ in range(2)]
    runs = []
    for dev in ("cpu", cuda):
        ps = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(dev, dt))
              for a, dt in zip(init, (torch.bfloat16, torch.float32))]
        opt = getattr(O, name)(ps, lr=1e-2, weight_decay=0.01)
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = torch.from_numpy(g).to(dev, p.dtype)
            opt.step()
        if name.startswith("Paged"):
            opt.synchronize()
            st = opt.state[ps[0]]
            if dev != "cpu":
                assert st["exp_avg"].device.type == "cpu"
                assert st["exp_avg"].is_pinned()
                assert opt.state[ps[1]]["exp_avg"].is_cuda
        runs.append((ps, opt))
    (cp, copt), (gp, gopt) = runs
    for a, b in zip(cp, gp):
        assert torch.equal(a.detach(), b.detach().cpu())
        for k, v in copt.state[a].items():
            w = gopt.state[b][k]
            if isinstance(v, torch.Tensor):
                assert w.dtype == v.dtype and torch.equal(v, w.cpu()), k


# ---------------------------------------------------------------------------
# the model families: windows, softcaps, MoE, LayerNorm, the ring KV cache
# ---------------------------------------------------------------------------

FAMILIES = ("tiny_mistral", "tiny_mixtral", "tiny_qwen2_moe", "tiny_gemma",
            "tiny_gemma2", "tiny_phi2", "tiny_stablelm")


@pytest.mark.parametrize("name", FAMILIES)
def test_family_card_matches_cpu(cuda, name):
    """Each tiny family in bf16 off its packed NF4 bytes (K5), prompts of
    5, 30 and 50 tokens (past every window of 16) and 4 decode steps
    through K2 (with each layer's window and Gemma2's softcaps and scale):
    the card's logits within 3e-2 of the CPU's, one K2 per layer and
    step."""
    cfg = getattr(llama.LlamaConfig, name)()
    gen = torch.Generator().manual_seed(21)
    params = llama.quantize_params(
        llama.init_params(cfg, generator=gen, device="cpu"),
        fuse_projections=True)
    prompts = _prompts([5, 30, 50], cfg.vocab_size)
    ref, fed, _ = _prefill_decode(params, cfg, "cpu", prompts, max_seq=128)
    k5 = K5.matmul4bit_mm.launches
    got, _, launches = _prefill_decode(params, cfg, cuda, prompts, fed,
                                       max_seq=128)
    assert [k2 for _, k2 in launches] == [cfg.num_layers] * 4
    assert K5.matmul4bit_mm.launches > k5
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert rel_err(g, r) <= 3e-2


def _moe_cfg():
    """A Mixtral-shaped tiny config whose every matmul K4 and K1 take:
    hidden 256, experts of 256, head_dim 64, vocab 512."""
    return llama.LlamaConfig(vocab_size=512, hidden_size=256,
                             intermediate_size=256, num_layers=2,
                             num_heads=4, num_kv_heads=2, max_seq_len=128,
                             num_experts=4, experts_per_token=2)


@pytest.mark.parametrize("cache", [None, "int4"])
def test_moe_tree_through_k4_and_k1(cuda, cache):
    """A MoE tree off its packed bytes (K4 for every decode matmul: 2 x
    (qkv + o + 4 experts x (gate/up + down)) + lm_head = 21 a step) and
    through the int4 cache (K1, as many): the card's logits within 3e-2 of
    the CPU's."""
    cfg = _moe_cfg()
    gen = torch.Generator().manual_seed(22)
    params = llama.quantize_params(
        llama.init_params(cfg, generator=gen, device="cpu"),
        fuse_projections=True)
    if cache is not None:
        params = llama.build_runtime_cache(params, cache)
    prompts = _prompts([5, 30, 50], cfg.vocab_size)
    ref, fed, _ = _prefill_decode(params, cfg, "cpu", prompts, max_seq=128)
    kernel = K1.int4_mm if cache else K4.w4a8_mm
    before = kernel.launches
    got, _, _ = _prefill_decode(params, cfg, cuda, prompts, fed,
                                max_seq=128)
    per_step = cfg.num_layers * (2 + 2 * cfg.num_experts) + 1
    assert kernel.launches - before >= 4 * per_step
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert rel_err(g, r) <= 3e-2


def _ring_engine(dev, graphs, **kw):
    cfg = dataclasses.replace(llama.LlamaConfig.tiny_mistral(),
                              sliding_window=32, max_seq_len=512)
    gen = torch.Generator().manual_seed(23)
    params = llama.quantize_params(
        llama.init_params(cfg, generator=gen, device="cpu"),
        fuse_projections=True)
    params = llama.to_device(llama.build_runtime_cache(params, "int4"), dev)
    return cfg, E.DecodeEngine(params, cfg, max_batch=4, max_seq=512,
                               steps_per_sync=8, ring_kv=True, device=dev,
                               cuda_graphs=graphs, **kw)


@pytest.mark.parametrize("quantized_kv", [True, False])
def test_ring_engine_graphed_matches_eager(cuda, quantized_kv):
    """A ring KV engine (128 entries for max_seq 512) serves prompts of 20
    to 150 tokens and 120 new tokens (past the ring) with the same tokens
    graphed and eager; no K2 (a ring reads through the ring mask in
    torch); the graphs' keys read the whole ring (span None)."""
    outs, keys = {}, {}
    prompts = _prompts([150, 20, 70], 512)
    for graphs in (False, True):
        cfg, eng = _ring_engine(cuda, graphs, quantized_kv=quantized_kv)
        assert eng.cache.ring and eng.cache.max_seq == 128
        k2 = K2.flash_decode_attention.launches
        outs[graphs] = eng.generate(prompts,
                                    SamplingParams(max_new_tokens=120))
        assert K2.flash_decode_attention.launches == k2
        keys[graphs] = eng.graph_keys()
    assert outs[True] == outs[False]
    assert keys[True] and all(k[0] is None for k in keys[True])


def test_ring_graphed_chunk_reads_nothing_back(cuda):
    """A ring engine's graphed chunk (writes at ``pos % ring`` on the
    device, no stage) runs with the synchronizing-operation check set to
    raise."""
    _, eng = _ring_engine(cuda, True)
    eng.generate(_prompts([40, 9, 150], 512),
                 SamplingParams(max_new_tokens=4))
    toks = np.array([5, 6, 7, 0], np.int32)
    active = np.array([True, True, True, False])
    eng.run_chunk(toks, active, all_greedy=True, attn_span=None)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng.run_chunk(toks, active, all_greedy=True, attn_span=None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out[0].shape == (8, 4)
    assert eng.graph_stats()["graphs"] == 1


def test_windowed_engine_sends_kpos_start_to_k2(cuda, monkeypatch):
    """A fully-windowed bf16 model (window 16) with a 1,100-token prompt:
    its decode chunks read from the window's 1024-bucket, K2 takes
    ``kpos_start`` = 1024, the graph's key carries it, and the graphed
    tokens equal the eager ones."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny_mistral(),
                              max_seq_len=2048)
    gen = torch.Generator().manual_seed(24)
    params = llama.to_device(llama.quantize_params(
        llama.init_params(cfg, generator=gen, device="cpu"),
        fuse_projections=True), cuda)
    starts = []
    orig = K2.flash_decode_attention

    def spy(*a, **kw):
        starts.append(kw.get("kpos_start", 0))
        return orig(*a, **kw)

    monkeypatch.setattr(llama, "flash_decode_attention", spy)
    prompt = _prompts([1100], cfg.vocab_size)
    outs, keys = {}, {}
    for graphs in (False, True):
        eng = E.DecodeEngine(params, cfg, max_batch=1, max_seq=2048,
                             steps_per_sync=8, device=cuda,
                             cuda_graphs=graphs)
        outs[graphs] = eng.generate(prompt, SamplingParams(max_new_tokens=12))
        keys[graphs] = eng.graph_keys()
    assert outs[True] == outs[False]
    assert 1024 in starts
    assert keys[True] and all(k[5] == 1024 for k in keys[True])


def test_flash_decode_d256_gemma2_arguments(cuda):
    """K2 at Gemma2-9B's decode: d = 256, rep 2, window 4,096, softcap 50,
    scale 256^-0.5, keys from kpos_start 1,024 on, a stage of 16, against
    its plain version (1e-3 of max|ref|)."""
    rng = np.random.default_rng(25)
    b, h, h_kv, d, t, c, start = 2, 16, 8, 256, 3584, 16, 1024

    def codes(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(
            np.int8)).to(cuda)

    def scales(*shape):
        return torch.from_numpy((rng.random(shape) * 1.5 + 0.5).astype(
            np.float32)).to(cuda)

    kv = (codes(b, h_kv, t, d), scales(b, h_kv, t),
          codes(b, h_kv, t, d), scales(b, h_kv, t))
    st = (codes(b, h_kv, c, d), scales(b, h_kv, c),
          codes(b, h_kv, c, d), scales(b, h_kv, c), 9)
    q = torch.from_numpy((rng.standard_normal((b, h, d)) * 0.3).astype(
        np.float32)).to(torch.bfloat16).to(cuda)
    off = torch.tensor([start + t - c + 9, start + 4200], dtype=torch.int32,
                       device=cuda)
    kw = dict(scale=256 ** -0.5, window=4096, softcap=50.0,
              kpos_start=start)
    got = K2.flash_decode_attention(q, *kv, off, staged=st, **kw)
    ref = K2.flash_decode_plain(q, *kv, off, *st, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert rel_err(got, ref) <= 1e-3


def test_flash_prefill_d256_window_at_4400(cuda):
    """K3 at Gemma2-9B's windowed layer: d = 256, GQA rep 2, S = 4,400
    (past the 4,096 window, ragged against the 64-key tiles), softcap 50,
    scale 256^-0.5, against its plain version (1e-2 of each row's
    max)."""
    rng = np.random.default_rng(26)
    q, k, v = (torch.from_numpy((rng.standard_normal(shape) * 0.5).astype(
        np.float32)).to(torch.bfloat16).to(cuda)
        for shape in ((1, 4400, 4, 256), (1, 4400, 2, 256),
                      (1, 4400, 2, 256)))
    kw = dict(s_real=4400, scale=256 ** -0.5, window=4096, softcap=50.0)
    ref = K3.flash_prefill_plain(q, k, v, block_k=K3.KEY_TILE[256], **kw)
    got = K3.flash_prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert row_rel_err(got, ref) <= 1e-2


# -- tensor parallelism on the one card ------------------------------------

@pytest.fixture
def nccl_group(cuda):
    """A one-rank NCCL process group in this process."""
    import datetime
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    yield cuda
    dist.destroy_process_group()


def _tp_tree(seed, hidden=512, inter=1024, tp=2):
    """A bf16 Llama of hidden ``hidden`` (4 heads of 128), NF4 at
    blocksize 64, fused and laid out for ``tp``."""
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=hidden,
                            intermediate_size=inter, num_layers=2,
                            num_heads=4, num_kv_heads=4, max_seq_len=256)
    gen = torch.Generator().manual_seed(seed)
    params = llama.quantize_params(
        llama.init_params(cfg, generator=gen, device="cpu"),
        fuse_projections=True, tp=tp)
    return cfg, params


def test_sharded_int4_cache_and_k1_shard_routes(cuda):
    """Each tp = 2 shard's int4 cache built on the card equals the CPU's,
    codes and scales; K1 takes every shard shape at decode M = 8 and the
    card's product stays within 1e-5 of the CPU's."""
    from tpu_bitsandbytes_torch.parallel import (build_sharded_int4_cache,
                                                 llama_param_specs)
    from tpu_bitsandbytes_torch.parallel.sharding import shard_local
    cfg, params = _tp_tree(31)
    specs = llama_param_specs(params)
    x = torch.from_numpy(np.random.default_rng(31).standard_normal(
        (8, 1024)).astype(np.float32)).to(torch.bfloat16)
    for r in range(2):
        cpu = build_sharded_int4_cache(shard_local(params, specs, 2, r,
                                                   "cpu"))
        card = build_sharded_int4_cache(shard_local(params, specs, 2, r,
                                                    cuda))
        for name in ("qkv_proj", "o_proj", "gateup_proj", "down_proj"):
            c, g = cpu["layers"][0][name], card["layers"][0][name]
            assert torch.equal(g.w_cache.cpu(), c.w_cache)
            assert torch.equal(g.cache_scale.cpu(), c.cache_scale)
            n, k = c.shape
            assert K1.takes_kernel(8, n, c.w_cache.shape[1] * 2, 128)
            before = K1.int4_mm.launches
            got = g(x[:, :k].to(cuda))
            assert K1.int4_mm.launches == before + 1
            assert rel_err(got, c(x[:, :k])) <= 1e-5


def test_shard_routes_k4_k5(cuda):
    """A row-parallel NF4 shard (K/tp = 512, k2 = 256) off its packed
    bytes: its layer call takes K4 at M = 8 (its own A8 scale) and K5's
    wgmma kernel at M = 256; each kernel's f32 product on the shard's
    tensors within 1e-5 (K4) and 1e-4 (K5, bf16) of its plain version on
    the CPU."""
    from tpu_bitsandbytes_torch.models.layers import QLinear4
    from tpu_bitsandbytes_torch.parallel.sharding import (_linear_spec,
                                                          shard_local)
    rng = np.random.default_rng(32)
    w = QLinear4.quantize(torch.from_numpy(
        (0.05 * rng.standard_normal((512, 1024))).astype(np.float32)))
    spec = _linear_spec(w, col=False)
    book = TF.codebook("nf4", "cpu")
    for r in range(2):
        c = shard_local(w, spec, 2, r, "cpu")
        g = shard_local(w, spec, 2, r, cuda)
        assert g.shape == (512, 512)
        for m, kernel in ((8, K4.w4a8_mm), (256, K5.matmul4bit_mm)):
            x = torch.from_numpy(rng.standard_normal((m, 512)).astype(
                np.float32)).to(torch.bfloat16)
            before = kernel.launches
            g(x.to(cuda))
            assert kernel.launches == before + 1
        xq, s_x = K4.quantize_a8(x[:8], 512)
        got = K4.w4a8_mm(xq.to(cuda), g.packed, g.absmax, s_x.to(cuda))
        assert rel_err(got, K4.w4a8_mm_plain(xq, c.packed, c.absmax,
                                             s_x)) <= 1e-5
        wg = K5.matmul4bit_mm.wgmma_launches
        got = K5.matmul4bit_mm(x.to(cuda), g.packed, g.absmax,
                               book.to(cuda), "bf16")
        assert K5.matmul4bit_mm.wgmma_launches == wg + 1
        assert rel_err(got, K5.matmul4bit_plain(x, c.packed, c.absmax, book,
                                                "bf16")) <= 1e-4


def test_a8_row_scale_all_reduce_over_nccl(nccl_group):
    """The row-parallel A8 scale's MAX all-reduce on a CUDA tensor over a
    one-rank NCCL group changes nothing."""
    from tpu_bitsandbytes_torch.parallel import make_mesh
    mesh = make_mesh(tp=1, device_type="cuda")
    x = torch.randn((8, 4096), device=nccl_group).to(torch.bfloat16)
    q, s = K4.quantize_a8(x, 4096, mesh.get_group("tp"))
    q0, s0 = K4.quantize_a8(x, 4096)
    assert torch.equal(q, q0) and torch.equal(s, s0)


def _mesh_engine_pair(dev, mesh, **kw):
    cfg, params = _tp_tree(33, hidden=256, inter=512, tp=1)
    params = llama.to_device(params, dev)
    prompts = _prompts([5, 30, 50, 17], cfg.vocab_size)
    sp = SamplingParams(max_new_tokens=24)
    common = dict(max_batch=4, max_seq=256, steps_per_sync=8,
                  runtime_cache="int4", device=dev)
    plain = E.DecodeEngine(params, cfg, cuda_graphs=kw.get(
        "cuda_graphs", True), **common).generate(prompts, sp)
    return params, cfg, prompts, sp, common, plain


def test_mesh_engine_one_rank_nccl_graphed_matches_plain(nccl_group):
    """``DecodeEngine(mesh=make_mesh(tp=1))`` on NCCL: its decode chunks
    are CUDA graphs holding the collectives, and its tokens are the plain
    engine's (one rank changes no arithmetic)."""
    from tpu_bitsandbytes_torch.parallel import make_mesh
    mesh = make_mesh(tp=1, device_type="cuda")
    params, cfg, prompts, sp, common, plain = _mesh_engine_pair(nccl_group,
                                                                mesh)
    eng = E.DecodeEngine(params, cfg, mesh=mesh, **common)
    assert eng.generate(prompts, sp) == plain
    assert eng.generate(prompts, sp) == plain       # replays
    assert eng.graph_stats()["graphs"] > 0


def test_mesh_engine_on_gloo_refuses_graphs_and_serves_eager(nccl_group):
    """A CUDA engine on a gloo mesh: ``cuda_graphs=True`` raises naming
    NCCL; ``cuda_graphs=False`` serves the plain eager engine's tokens."""
    from tpu_bitsandbytes_torch.parallel import make_mesh
    mesh = make_mesh(tp=1, device_type="cuda", backend="gloo")
    params, cfg, prompts, sp, common, plain = _mesh_engine_pair(
        nccl_group, mesh, cuda_graphs=False)
    with pytest.raises(ValueError, match="NCCL"):
        E.DecodeEngine(params, cfg, mesh=mesh, **common)
    eng = E.DecodeEngine(params, cfg, mesh=mesh, cuda_graphs=False,
                         **common)
    assert eng.generate(prompts, sp) == plain


# -- QLoRA training under a mesh, and the host packer ----------------------

def test_megatron_pair_one_rank_nccl_matches_one_device(nccl_group):
    """The training step's collectives (a sum over tp after row-parallel
    linears in the forward, before column-parallel ones in the backward,
    the head's gather, the gradients' sums) on a one-rank NCCL mesh: the
    loss, the LoRA gradients (on column- and row-parallel linears, B
    non-zero) and one adam8bit step equal one device's bit for bit, K5
    on the wgmma kernel at M = 128 in both; ``remat`` too."""
    from tpu_bitsandbytes_torch.models.lora import (attach_lora,
                                                    lora_trainable)
    from tpu_bitsandbytes_torch.optim.transforms import tree_leaves
    from tpu_bitsandbytes_torch.parallel import make_mesh, shard_params
    from tpu_bitsandbytes_torch.parallel.train import (make_qlora_train_step,
                                                       qlora_loss_and_grads)
    dev = nccl_group
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=512,
                            intermediate_size=1024, num_layers=2,
                            num_heads=4, num_kv_heads=4, max_seq_len=256)
    gen = torch.Generator().manual_seed(41)
    params = llama.to_device(llama.quantize_params(
        llama.init_params(cfg, generator=gen, device="cpu")), dev)
    lp = attach_lora(params, generator=torch.Generator(device=dev)
                     .manual_seed(42), targets=("q_proj", "v_proj",
                                                "o_proj", "down_proj"))
    tr = {k: {"A": v["A"].detach().clone(),
              "B": torch.randn(v["B"].shape, generator=torch.Generator(
                  device=dev).manual_seed(43), device=dev).to(
                  v["B"].dtype) * 0.01}
          for k, v in lora_trainable(lp).items()}
    tokens = torch.randint(0, cfg.vocab_size, (1, 129), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(44))
    mesh = make_mesh(tp=1, device_type="cuda")
    local = shard_params(lp, mesh)
    for remat in (False, True):
        loss, g = qlora_loss_and_grads(cfg, tr, lp, tokens, remat=remat)
        k5 = K5.matmul4bit_mm.wgmma_launches
        loss_m, g_m = qlora_loss_and_grads(cfg, tr, local, tokens,
                                           remat=remat, mesh=mesh)
        assert K5.matmul4bit_mm.wgmma_launches > k5
        assert torch.equal(loss, loss_m)
        for a, b in zip(tree_leaves(g), tree_leaves(g_m)):
            assert torch.equal(a, b)
    outs = []
    for m, tree in ((None, lp), (mesh, local)):
        init, step = make_qlora_train_step(cfg, mesh=m)
        outs.append(step(tr, init(tr), tree, tokens))
    for a, b in zip(tree_leaves(list(outs[0])), tree_leaves(list(outs[1]))):
        assert torch.equal(a, b)


def test_host_packer_matches_quantize_4bit_on_the_card(cuda):
    """The host library, built on the card's machine, packs a weight on 4
    threads into the bytes and absmax that ``quantize_4bit`` gives on the
    card."""
    from tpu_bitsandbytes_torch.utils import native
    w = np.random.default_rng(45).standard_normal((1024, 4096)).astype(
        np.float32)
    for qt in ("nf4", "fp4"):
        packed, absmax = native.quantize_4bit_host(w, 64, qt, num_threads=4)
        tp, ts = TF.quantize_4bit(torch.from_numpy(w).to(cuda), blocksize=64,
                                  quant_type=qt)
        np.testing.assert_array_equal(packed.reshape(-1), tp.cpu().numpy())
        np.testing.assert_array_equal(absmax.reshape(-1),
                                      ts.absmax.cpu().numpy())


# ---------------------------------------------------------------------------
# the compact-window stage
# ---------------------------------------------------------------------------

def test_flash_decode_over_the_window_is_the_two_block_call(cuda):
    """K2 fed a compact window's head (its main block, at the span's
    positions) and tail (its staged block) computes bit for bit what it
    computes over the cache's span view and the two-block stage: the same
    bytes at the same positions, the same T and C, so the same cluster
    plan. Llama-2-7B's heads, a span of 512 from position 128."""
    b, h, h_kv, d, s, c, span, start = 4, 32, 32, 128, 1024, 8, 640, 128
    gen = torch.Generator(device=cuda).manual_seed(15)
    caches = []
    for window in (True, False):
        cache = KVCache.create(1, b, s, h_kv, d, device=cuda)
        gen.manual_seed(15)
        cache.k.copy_(torch.randint(-127, 128, cache.k.shape, generator=gen,
                                    device=cuda, dtype=torch.int8))
        cache.v.copy_(torch.randint(-127, 128, cache.v.shape, generator=gen,
                                    device=cuda, dtype=torch.int8))
        cache.k_scale.uniform_(0.5, 3.0, generator=gen)
        cache.v_scale.uniform_(0.5, 3.0, generator=gen)
        cache.lengths.copy_(torch.tensor([300, 511, 200, 620],
                                         dtype=torch.int32))
        cache.begin_stage(c, span=span, start=start, window=window)
        for _ in range(3):
            k, v = (torch.randn((b, 1, h_kv, d), generator=gen, device=cuda)
                    for _ in range(2))
            cache.write_decode(0, k, v, cache.lengths)
            cache.lengths += 1
            cache.advance_stage()
        caches.append(cache)
    q = torch.randn((b, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    outs = []
    for cache in caches:
        st = cache.stage
        if st.cut:
            kq, ks, vq, vs = (x[:, :, :st.cut] for x in cache.read_window(0))
        else:
            kq, ks, vq, vs = cache.read_raw(0, span, start)
        before = K2.flash_decode_attention.launches
        outs.append(K2.flash_decode_attention(
            q, kq, ks, vq, vs, cache.lengths, staged=cache.read_stage(0),
            kpos_start=start, window=256, softcap=50.0))
        assert K2.flash_decode_attention.launches == before + 1
    assert caches[0].stage.cut == span - start
    assert torch.equal(outs[0], outs[1])


def test_graphed_window_chunk_reads_nothing_back(cuda):
    """``DecodeEngine(window_stage=True)``: the span copy into the window
    is device work inside the chunk's graph, which replays under the
    synchronizing-operation check set to raise; its greedy tokens are the
    two-block engine's (K2 reads the same bytes either way)."""
    cfg, params = _graph_model(False)
    prompts = _prompts([30, 9, 50], cfg.vocab_size)
    toks = np.array([5, 6, 7, 0], np.int32)
    active = np.array([True, True, True, False])
    outs = {}
    for window in (True, False):
        eng = E.DecodeEngine(llama.to_device(params, cuda), cfg, max_batch=4,
                             steps_per_sync=8, device=cuda,
                             window_stage=window)
        assert eng.window_stage is window
        outs[window] = eng.generate(prompts, SamplingParams(max_new_tokens=12))
        if not window:
            continue
        eng.run_chunk(toks, active, all_greedy=True, attn_span=128)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = eng.run_chunk(toks, active, all_greedy=True, attn_span=128)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert out[0].shape == (8, 4)
        assert eng.cache.window_bytes() > 0
    assert outs[True] == outs[False]


def test_graphed_gemma_chunk_matches_eager(cuda):
    """A Gemma-family decode chunk (scaled embeddings, post norms,
    softcaps, windows) captures as a CUDA graph: nothing in it copies from
    the host, and its greedy tokens are the eager chunk's."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny_gemma2(),
                              max_seq_len=256)
    gen = torch.Generator().manual_seed(9)
    params = llama.to_device(llama.quantize_params(
        llama.init_params(cfg, generator=gen, device="cpu"),
        fuse_projections=True), cuda)
    prompts = _prompts([30, 9, 50], cfg.vocab_size)
    outs = []
    for graphs in (True, False):
        eng = E.DecodeEngine(params, cfg, max_batch=4, steps_per_sync=8,
                             device=cuda, cuda_graphs=graphs)
        outs.append(eng.generate(prompts, SamplingParams(max_new_tokens=12)))
        assert eng.graph_stats()["graphs"] == (1 if graphs else 0)
    assert outs[0] == outs[1]


def test_tracer_times_graphed_dispatches_on_the_profilers_clock(cuda):
    """The engine tracer on a graphed engine: each dispatch span holds one
    graph replay or capture and its device time (CUDA events on the
    caller's stream), each prefill span its device time, the tokens are
    the untraced engine's; and the tracer's clock is the profiler's: a
    kernel launched on an idle card starts after the tracer's reading
    before the launch, within 200 us of it."""
    from torch.autograd import DeviceType
    cfg, params = _graph_model(False)
    prompts = _prompts([100, 20, 60, 9, 33], cfg.vocab_size)
    sp = SamplingParams(max_new_tokens=24)
    want = _engine(cfg, params, cuda, True).generate(prompts, sp)
    eng = _engine(cfg, params, cuda, True)
    tr = eng.tracer
    tr.start()
    assert eng.generate(prompts, sp) == want
    tr.stop()
    disp = [i for i, s in enumerate(tr.spans) if s.name == "engine.dispatch"]
    assert len(disp) == tr.counts["engine.chunks"]
    for i in disp:
        kids = [s.name for s in tr.spans if s.parent == i
                and s.name.startswith("graph.")]
        assert len(kids) == 1 and tr.spans[i].device_ms > 0
        assert kids[0] == f"graph.{tr.spans[i].attrs['graph']}"
    pre = [s for s in tr.spans if s.name.startswith("engine.prefill")]
    assert pre and all(s.device_ms > 0 for s in pre)
    x = torch.zeros(1 << 20, device=cuda)
    launched = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            torch.cuda.synchronize()
            launched.append(tr.now())
            x.add_(1.0)
            torch.cuda.synchronize()
    starts = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA)
    delays = [s - t for s, t in zip(starts, launched)]
    assert len(starts) == 5 and min(delays) >= 0, delays
    assert min(delays) <= 200_000, delays
