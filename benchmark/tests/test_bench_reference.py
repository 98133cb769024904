"""The plain reference against the port, on the CPU at a tiny size.

A prefill's last logits in float32 (the port's ``llama.forward`` over the
same NF4 bytes, dense, MoE, windowed, and through the int4 runtime cache)
agree with the reference's to float32 rounding; and the harness's whole
run of a tiny cell (the engine, bf16, int8 KV, the decode matmuls' int8
activations) serves tokens the check finds correct."""

import dataclasses
import time

import pytest
import torch

from harness import model, runner
from harness.weights import make_weights
from reference import mistral as R
import tiny

PROMPT = 80      # over 64 rows: the port's prefill takes no A8 (as in the cells)


@pytest.mark.parametrize("name,over,cache", [
    ("mistral-7b-nf4-int4cache", {}, None),
    ("mistral-7b-nf4-int4cache", {"sliding_window": 16}, None),
    ("mistral-7b-nf4-int4cache", {}, "int4"),
    ("mixtral-8x7b-nf4-packed", {}, None),
])
def test_prefill_logits_match_the_port(name, over, cache):
    from tpu_bitsandbytes_torch.models import llama
    cfg = tiny.config(name, **over)
    tree = make_weights(cfg, 77, "cpu")
    lcfg = dataclasses.replace(model.llama_config(cfg, 256),
                               dtype=torch.float32)
    params = model.program_params(tree, lcfg)
    if cache is not None:
        params = llama.build_runtime_cache(params, cache)
    toks = torch.randint(0, cfg["vocab_size"], (1, PROMPT),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        port = llama.forward(params, toks, lcfg)[0, -1]
    spec = {"runtime_cache": cache}
    ref = R.forward_logits(tree, cfg, spec, [(toks[0].tolist(), [0])])[0][0]
    assert float((port - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("name,over", [
    ("mistral-7b-nf4-int4cache", {}),
    ("mixtral-8x7b-nf4-packed", {}),
    # a mix with sampled clients (the check reads the greedy ones) and an
    # engine option the harness's own warm-up does not cover: both warmed
    # by the engine's warm-up
    ("mistral-7b-nf4-int4cache",
     {"sampling": [{"temperature": 0.0}, {"temperature": 0.8, "top_p": 0.9}],
      "engine": {"prefill_chunk": 64}}),
])
def test_served_tokens_pass_the_check(name, over):
    out = runner.execute(tiny.cell(name, **over), 2 ** 31 + 9, 1.0, False,
                         "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_gaps_and_compare():
    ref = [torch.tensor([[0.0, 2.0, 1.0], [3.0, 1.0, 0.5]])]
    got = R.compare(ref, [[1, 2]])
    assert got["gap_max"] == 2.5 and got["not_argmax"] == 0.5
    other = [torch.tensor([[0.0, 0.0, 9.0], [9.0, 0.0, 0.0]])]
    assert R.compare(ref, [[1, 0]], other)["gap_max"] == 1.0


def test_quantizers():
    x = torch.tensor([[1.0, -0.5, 0.25, 0.0]])
    assert torch.equal(R.quant_rows(x, 8), torch.round(x * 127) / 127)
    assert torch.equal(R.quant_rows(x, None), x)
    w = torch.linspace(-1, 1, 256).reshape(1, 256)
    q = R.int4_cache(w)
    assert len(torch.unique(q[0, :128])) <= 15
    kv = torch.randn(5, 2, 8)
    assert float((R.quant_kv(kv, 8) - kv).abs().max()) <= float(
        kv.abs().max()) / 254 + 1e-6
