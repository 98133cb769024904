"""The yardstick's arithmetic against values worked by hand for both
configurations' shapes (Mistral-7B: hidden 4,096, 32 heads of 128, 8 KV
heads, MLP 14,336, vocabulary 32,000, window 4,096; Mixtral-8x7B: the
same widths, 8 experts, top 2, no window)."""

import json
import types

import pytest

from harness import spec
from harness.spec import normalize_config
from roofline import k1, k2, k3, k4, matmul, model_flops, peaks



def _config(name):
    with open(spec.BENCH / "configs" / f"{name}.json") as f:
        return normalize_config(json.load(f))


MISTRAL = _config("mistral-7b-nf4-int4cache")
MIXTRAL = _config("mixtral-8x7b-nf4-packed")
H100 = "NVIDIA H100 80GB HBM3"


def test_step_shapes():
    s = matmul.step_shapes(MISTRAL)
    assert len(s) == 129 and s[:4] == [(6144, 4096), (4096, 4096),
                                        (28672, 4096), (4096, 14336)]
    assert s[-1] == (32000, 4096)
    m = matmul.step_shapes(MIXTRAL)
    assert len(m) == 32 * (2 + 2 * 8) + 1 == 577


def test_k1_k4_bytes():
    # qkv at M = 64: x 64*4096, s_x 4*64, codes 6144*4096/2, scales
    # 4*6144*(4096/128), out 4*64*6144
    assert k1.weight_bytes(6144, 4096) == 12_582_912 + 786_432
    assert matmul.a8_bytes(64, 6144, 4096, k1.weight_bytes(6144, 4096)) \
        == 262_144 + 256 + 13_369_344 + 1_572_864
    # NF4: absmax f32 per 64-block
    assert k4.weight_bytes(6144, 4096) == 12_582_912 + 1_572_864


def test_k2_token_cost():
    b, f = k2.token_cost(MISTRAL, 1000)
    # per layer: K and V codes and scales 2*1000*8*(128+4), q bf16 32*128*2,
    # out f32 32*128*4
    assert b == 32 * (2_112_000 + 8_192 + 16_384)
    assert f == 32 * 4 * 32 * 128 * 1000


def test_k3_pairs_and_cost():
    assert k3.pairs(100, None) == 5050
    assert k3.pairs(100, 4096) == 5050
    assert k3.pairs(6000, 4096) == 4096 * 4097 // 2 + 1904 * 4096
    b, f = k3.request_cost(MISTRAL, 6000)
    assert b == 32 * (6000 * 48 * 128 * 2 + 6000 * 32 * 128 * 2)
    assert f == 32 * 4.0 * 32 * 128 * 16_189_440


def test_model_flops():
    assert model_flops.layer_weights(MISTRAL) == 218_103_808
    assert model_flops.layer_weights(MIXTRAL) == (
        41_943_040 + 2 * 176_160_768 + 8 * 4096)
    assert model_flops.decode_token(MISTRAL, 1000) == (
        2 * (32 * 218_103_808 + 32000 * 4096) + 32 * 4 * 32 * 128 * 1000)
    assert model_flops.prefill(MIXTRAL, 10) == (
        2 * 10 * 32 * model_flops.layer_weights(MIXTRAL)
        + 2 * 32000 * 4096 + 32 * 4 * 32 * 128 * 55)


def _run(cfg, counter, launches, name, ns):
    span = types.SimpleNamespace(records=[(name, 0, ns)],
                                 launches=lambda c: launches)
    return types.SimpleNamespace(
        cfg=cfg, engine={"max_batch": 64}, device_kind=H100, span=span,
        decode_launches=lambda c: launches if c == counter else 0)


def test_matmul_share_against_hand_least_time():
    shapes = matmul.step_shapes(MISTRAL)
    least = sum(max(matmul.a8_bytes(64, n, k, k1.weight_bytes(n, k))
                    / 3.35e12, 2 * 64 * n * k / 1979e12) for n, k in shapes)
    # 3 steps, device time 4x the least time: 25%
    run = _run(MISTRAL, k1.COUNTER, 3 * 129,
               "void a8tc::tc_kernel<(anonymous namespace)::Int4, 8, 2>(x)",
               int(round(4 * 3 * least * 1e9)))
    assert k1.share(run) == pytest.approx(25.0, rel=1e-6)
    bad = _run(MISTRAL, k1.COUNTER, 130, "tc_kernel<x::Int4, 1>", 10)
    with pytest.raises(ValueError):
        k1.share(bad)
    none = _run(MIXTRAL, k4.COUNTER, 0, "w4a8_dp4a_kernel", 10)
    assert k4.share(none) is None


def test_peaks():
    assert peaks.of(H100)["hbm_bytes_per_s"] == 3.35e12
    for kind in ("cpu", "NVIDIA H100 PCIe"):
        with pytest.raises(ValueError):
            peaks.of(kind)
