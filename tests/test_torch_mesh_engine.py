"""PyTorch port vs JAX package: the decode engine under a mesh.

``DecodeEngine(mesh=)`` serves a tiny f32 NF4 Llama in two worlds of
processes over gloo on the CPU (``tests/torch_mesh_ranks.py``, which
imports no JAX): tp = 2, and dp = 2 x tp = 2. Each world is spawned once
and runs every serving case in one go; the references are computed here.
In f32 the shards change only the f32 sum order, so greedy tokens must
equal both JAX's mesh engine (``tpu_bitsandbytes.parallel`` on JAX's
8-device CPU backend) and the port's single-device engine, and logprobs
agree within 1e-5. Every rank returns the same output (the host state is
kept identical by gathering each chunk's tokens over dp).

Covered: off the packed bytes and through the per-shard int4 cache (the
row-parallel A8 scale all-reduced; served at hidden 256, where K/tp is
whole int4 blocks, as JAX's own mesh int4 parity test does: at hidden 128
the teacher-forced tp = 2 int4 logits agree with JAX's within 1e-5
(``test_torch_tp.py``), but one A8 code that an f32 sum order rounds the
other way turns a greedy token); the interleaved fused layout against
JAX's mesh engine; mixed greedy and sampled requests through the
pipelined loop and the ``step()`` loop; repetition penalty with logprobs;
chunked prefill; Mistral's ring KV cache; n-gram speculation through the
tp verify step; ``footprint()`` divided by the shards; ``save_state`` /
``load_state`` per rank; and the refusals (``max_batch % dp``,
``cuda_graphs=True`` on a gloo mesh).
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_bitsandbytes import parallel as JPAR
from tpu_bitsandbytes.engine import engine as JE
from tpu_bitsandbytes.engine.sampler import SamplingParams as JSP
from tpu_bitsandbytes.models import llama as JL
from tpu_bitsandbytes_torch.convert import (config_from_reference,
                                            from_reference_arrays)
from tpu_bitsandbytes_torch.engine import engine as TE
from tpu_bitsandbytes_torch.engine.sampler import SamplingParams as TSP

from test_torch_engine import _prompts
from test_torch_families import _to_jax, numpy_params
from test_torch_functional import config_fields, reference_arrays
from torch_mesh_ranks import start_world

LP_TOL = 1e-5           # f32 logprobs: another f32 sum order
NEW = 8
ENGINE = dict(max_batch=4, max_seq=64, steps_per_sync=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, **kw):
    return dataclasses.replace(getattr(JL.LlamaConfig, name)(),
                               dtype=jnp.float32, **kw)


# intermediate 192: no linear of the single-device reference takes K4
# (k2 = K/2 a multiple of 128), which JAX's CPU path never runs
CFG = _cfg("tiny", intermediate_size=192)
# K/tp = 128: each row-parallel shard holds whole int4 blocks, so the
# per-shard cache is the single-device one (JAX's exact-parity contract)
ALIGNED_CFG = _cfg("tiny", hidden_size=256, intermediate_size=512)
RING_CFG = _cfg("tiny_mistral", max_seq_len=256, intermediate_size=192)
TREE = numpy_params(CFG, seed=21)
MAIN = JL.quantize_params(_to_jax(TREE), blocksize=32, dtype=jnp.float32)
FUSED = JL.quantize_params(_to_jax(TREE), blocksize=32, dtype=jnp.float32,
                           fuse_projections=True, tp=2)
ALIGNED = JL.quantize_params(_to_jax(numpy_params(ALIGNED_CFG, seed=21)),
                             blocksize=64, dtype=jnp.float32)
RING = JL.quantize_params(_to_jax(numpy_params(RING_CFG, seed=22)),
                          blocksize=32, dtype=jnp.float32)

# five requests for four slots (one admitted into a freed slot), all in
# one prefill bucket: each JAX mesh engine compiles one prefill
PROMPTS = _prompts([5, 16, 11, 9, 13], CFG.vocab_size, seed=21)
LONG = _prompts([40, 5, 33], CFG.vocab_size, seed=22)
RING_PROMPTS = _prompts([70, 20, 41], CFG.vocab_size, seed=23)
_base = _prompts([4], CFG.vocab_size, seed=24)[0]
REPEAT = [(_base * 5)[:14], _prompts([6], CFG.vocab_size, seed=25)[0]]

GREEDY = dict(max_new_tokens=NEW)
MIXED = [GREEDY, dict(max_new_tokens=NEW, temperature=0.8, top_k=20),
         GREEDY, dict(max_new_tokens=NEW, temperature=1.0, top_p=0.9),
         GREEDY]
PEN_LP = [dict(max_new_tokens=NEW, repetition_penalty=1.3, logprobs=True),
          dict(max_new_tokens=NEW, logprobs=True), GREEDY,
          dict(max_new_tokens=NEW, repetition_penalty=1.2),
          dict(max_new_tokens=NEW, logprobs=True)]


def _runs(tmp):
    """The serving runs of a world: (id, engine kwargs, prompts,
    sampling, model, loop)."""
    g = lambda ps: [GREEDY] * len(ps)
    return [
        dict(id="greedy", engine=ENGINE, prompts=PROMPTS,
             sampling=g(PROMPTS)),
        dict(id="int4", model="aligned",
             engine=dict(ENGINE, runtime_cache="int4"), prompts=PROMPTS,
             sampling=g(PROMPTS)),
        dict(id="fused", model="fused", engine=ENGINE, prompts=PROMPTS,
             sampling=g(PROMPTS)),
        dict(id="mixed", engine=ENGINE, prompts=PROMPTS, sampling=MIXED),
        dict(id="mixed_step", engine=ENGINE, prompts=PROMPTS,
             sampling=MIXED, depth=1),
        dict(id="pen_lp", engine=ENGINE, prompts=PROMPTS, sampling=PEN_LP),
        dict(id="chunked", engine=dict(ENGINE, prefill_chunk=16),
             prompts=LONG, sampling=g(LONG), depth=1),
        dict(id="ring", model="ring",
             engine=dict(ENGINE, max_seq=256, ring_kv=True),
             prompts=RING_PROMPTS, sampling=g(RING_PROMPTS)),
        dict(id="spec", engine=dict(ENGINE, speculative="ngram",
                                    spec_gamma=3),
             prompts=REPEAT, sampling=g(REPEAT)),
        dict(id="snapshot", engine=ENGINE, prompts=PROMPTS,
             sampling=g(PROMPTS), snapshot=3),
    ]


def _port_single(run):
    """The port's single-device engine on the same run."""
    model, cfg = {"ring": (RING, RING_CFG), "aligned": (ALIGNED, ALIGNED_CFG)
                  }.get(run.get("model"), (MAIN, CFG))
    eng = TE.DecodeEngine(from_reference_arrays(reference_arrays(model),
                                                "cpu"),
                          config_from_reference(config_fields(cfg)),
                          device="cpu", **run["engine"])
    uids = eng._add_all(run["prompts"],
                        [TSP(**sp) for sp in run["sampling"]])
    if run.get("depth", 2) > 1:
        eng.run_pipelined()
    else:
        while eng.step():
            pass
    by = {r.uid: r for r in eng.finished}
    return ([by[u].generated for u in uids], [by[u].logprobs for u in uids],
            eng.footprint())


@functools.lru_cache(maxsize=None)
def _jax_mesh(run, tp, dp):
    """JAX's mesh engine's greedy tokens for a run of ``JAX_RUNS``."""
    tree, cfg, kw = JAX_RUNS[run]
    mesh = JPAR.make_mesh(tp=tp, dp=dp)
    eng = JE.DecodeEngine(tree, cfg, mesh=mesh, **ENGINE, **kw)
    return eng.generate(PROMPTS, JSP(max_new_tokens=NEW))


JAX_RUNS = {"greedy": (MAIN, CFG, {}), "fused": (FUSED, CFG, {}),
            "int4": (ALIGNED, ALIGNED_CFG, dict(runtime_cache="int4"))}


def _world(tmp_path_factory, tp, dp):
    tmp = tmp_path_factory.mktemp(f"mesh_dp{dp}_tp{tp}")
    models = {"main": dict(params=reference_arrays(MAIN),
                           config=config_fields(CFG)),
              "fused": dict(params=reference_arrays(FUSED),
                            config=config_fields(CFG)),
              "ring": dict(params=reference_arrays(RING),
                           config=config_fields(RING_CFG)),
              "aligned": dict(params=reference_arrays(ALIGNED),
                              config=config_fields(ALIGNED_CFG))}
    runs = _runs(tmp)
    job = dict(tp=tp, dp=dp, cases=[dict(
        id="engine", fn="engine", models=models, runs=runs, tmp=str(tmp),
        refusals={"batch": dict(device="cpu", max_batch=3),
                  "graphs": dict(device="cuda", cuda_graphs=True,
                                 max_batch=4)})])
    world = start_world(job, tp * dp, tmp, timeout=150)
    # the dp2 x tp2 world holds its fused and int4 runs against JAX's
    # tp = 2 engine: dp changes no arithmetic (and each JAX mesh engine
    # compiles its own steps)
    jax_ref = {"greedy": _jax_mesh("greedy", tp, dp),
               "fused": _jax_mesh("fused", tp, 1),
               "int4": _jax_mesh("int4", tp, 1)}
    single = {r["id"]: _port_single(r) for r in runs
              if r.get("model") not in ("fused", "aligned")}
    return [r["engine"] for r in world.join()], jax_ref, single


@pytest.fixture(scope="module", params=[(2, 1), (2, 2)],
                ids=["tp2", "dp2_tp2"])
def world(request, tmp_path_factory):
    tp, dp = request.param
    return (tp, dp) + _world(tmp_path_factory, tp, dp)


def test_every_rank_returns_the_same_output(world):
    tp, dp, res, _, _ = world
    for run in res[0]:
        if isinstance(res[0][run], dict):
            for r in res[1:]:
                assert r[run]["tokens"] == res[0][run]["tokens"], run
                assert r[run]["logprobs"] == res[0][run]["logprobs"], run


@pytest.mark.parametrize("run", ["greedy", "int4", "fused"])
def test_greedy_tokens_match_jax_mesh_engine(world, run):
    """Off the packed bytes, through the per-shard int4 cache (the
    row-parallel A8 scale all-reduced; K/tp whole int4 blocks) and on the
    interleaved fused layout, the tokens of JAX's mesh engine on the same
    mesh shape."""
    tp, dp, res, jax_ref, _ = world
    assert res[0][run]["tokens"] == jax_ref[run]
    assert all(len(t) == NEW for t in jax_ref[run])


@pytest.mark.parametrize("run", ["greedy", "chunked", "ring", "snapshot"])
def test_greedy_tokens_match_single_device(world, run):
    """The single-device engine's tokens: plain, with chunked prefill,
    with the ring cache, and resumed from per-rank snapshots."""
    tp, dp, res, _, single = world
    assert res[0][run]["tokens"] == single[run][0]
    assert all(len(t) == NEW for t in single[run][0])


@pytest.mark.parametrize("run", ["mixed", "mixed_step"])
def test_mixed_sampling(world, run):
    """Greedy rows keep the single-device tokens in a batch with sampled
    rows, through the pipelined loop and the step() loop; sampled rows are
    full-length in-vocabulary draws."""
    tp, dp, res, _, single = world
    got = res[0][run]["tokens"]
    for i, sp in enumerate(MIXED):
        assert len(got[i]) == NEW
        assert all(0 <= t < CFG.vocab_size for t in got[i])
        if "temperature" not in sp:
            assert got[i] == single[run][0][i], i


def test_penalty_and_logprobs(world):
    tp, dp, res, _, single = world
    toks, lps, _ = single["pen_lp"]
    assert res[0]["pen_lp"]["tokens"] == toks
    for got, ref, sp in zip(res[0]["pen_lp"]["logprobs"], lps, PEN_LP):
        assert len(got) == (NEW if sp.get("logprobs") else 0)
        np.testing.assert_allclose(got, ref, rtol=0, atol=LP_TOL)


def test_speculative_matches_plain_greedy(world):
    """n-gram speculation through the tp verify step keeps plain greedy's
    tokens and verifies at least once."""
    tp, dp, res, _, single = world
    out = res[0]["spec"]
    assert out["tokens"] == single["spec"][0]
    assert out["spec"]["verify_steps"] > 0
    assert out["spec"]["accepted"] <= out["spec"]["drafted"]


def test_footprint_divides_by_the_shards(world):
    """Each rank holds 1/tp of the weights' packed bytes and 1/(tp dp) of
    the KV cache ([L, B/dp, H_kv/tp, S, D])."""
    tp, dp, res, _, single = world
    fp, ref = res[0]["greedy"]["footprint"], single["greedy"][2]
    assert fp["kv"] == ref["kv"] // (tp * dp)
    assert fp["packed"] == ref["packed"] // tp
    assert fp["total"] == sum(fp[k] for k in ("packed", "exec_cache", "fp",
                                              "kv", "activations_est"))
    assert res[0]["greedy"]["cache_shape"] == (
        CFG.num_layers, ENGINE["max_batch"] // dp, CFG.num_kv_heads // tp,
        ENGINE["max_seq"], CFG.hd)


def test_refusals(world):
    """``max_batch`` must divide by dp; a CUDA engine on a gloo mesh
    refuses ``cuda_graphs=True`` (its chunk graphs would need NCCL)."""
    tp, dp, res, _, _ = world
    if dp == 2:
        assert "must divide by dp=2" in res[0]["batch"]
    else:
        assert res[0]["batch"] is None
    assert "NCCL" in res[0]["graphs"]
