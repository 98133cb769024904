"""PyTorch port vs JAX package: the decode engine's lifecycle.

The footprint and ``drop_packed``, the checkpoint format, snapshot and
restart, the warm-up plan and pipelined dispatch, on the tiny config in f32
with the int4 cache: the same model and prompts in both engines (the JAX
engine's parameters handed over through ``convert``). In f32 both sides
compute the same arithmetic up to f32 sum order, so greedy tokens and int8
KV codes are identical, and f32 KV values and scales agree within 1e-5 of
their largest magnitude.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpu_bitsandbytes.engine import engine as JE
from tpu_bitsandbytes.engine.sampler import SamplingParams as JSP
from tpu_bitsandbytes.models import llama as JL
from tpu_bitsandbytes.utils import metrics as JM
from tpu_bitsandbytes_torch.convert import (config_from_reference,
                                            from_reference_arrays)
from tpu_bitsandbytes_torch.engine import engine as TE
from tpu_bitsandbytes_torch.engine.sampler import SamplingParams as TSP
from tpu_bitsandbytes_torch.utils import metrics as TM
from tpu_bitsandbytes_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)

from test_torch_engine import _prompts
from test_torch_functional import config_fields, reference_arrays

KV_TOL = 1e-5      # f32 KV values and scales, of max|ref|: another sum order


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: the test workers share
    the host's cores, and many threads per worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, {"q": quantized, "int4": with the int4
    cache}: (JAX params, port params)), tiny and f32."""
    cfg = dataclasses.replace(JL.LlamaConfig.tiny(), dtype=jnp.float32)
    q = JL.quantize_params(JL.init_params(jax.random.PRNGKey(5), cfg),
                           dtype=cfg.dtype, fuse_projections=True)
    models = {}
    for name, jp in (("q", q), ("int4", JL.build_runtime_cache(q, "int4"))):
        models[name] = (jp, from_reference_arrays(reference_arrays(jp), "cpu"))
    return cfg, config_from_reference(config_fields(cfg)), models


def _engines(tiny, model="int4", **kw):
    """The JAX engine and the port's (on the CPU), built alike."""
    cfg, tcfg, models = tiny
    jp, tp = models[model]
    return (JE.DecodeEngine(jp, cfg, **kw),
            TE.DecodeEngine(tp, tcfg, device="cpu", **kw))


def _finish(engine):
    while engine.step():
        pass
    return {r.uid: list(r.generated) for r in engine.finished}


# -- footprint and drop_packed ------------------------------------------------

CATEGORIES = ("packed", "exec_cache", "fp", "kv", "activations_est", "total")


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("runtime_cache", [None, "int4"])
def test_footprint_matches_jax(tiny, runtime_cache, quantized):
    """Every category of ``footprint()`` equals the JAX engine's byte for
    byte (at these widths JAX pads no int4 cache row), with and without
    the int4 cache, on an int8 and an unquantized cache; so does the
    estimate ``drop_packed="auto"`` decides from. The port's budget is the
    host's RAM, JAX's a TPU's HBM."""
    je, te = _engines(tiny, "q", max_batch=2, max_seq=64,
                      runtime_cache=runtime_cache, quantized_kv=quantized)
    jf, tf = je.footprint(), te.footprint()
    assert {k: tf[k] for k in CATEGORIES} == {k: jf[k] for k in CATEGORIES}
    assert (tf["exec_cache"] > 0) == (runtime_cache is not None)
    assert tf["packed"] > 0 and tf["fits"]
    assert tf["budget"] == TM.device_memory_bytes("cpu") > 2 ** 30
    jp, tp = tiny[2]["q"]
    jest = je._footprint_est(jp, "int4", quantized)
    test = te._footprint_est(tp, "int4", quantized)
    assert {k: test[k] for k in CATEGORIES} == {k: jest[k]
                                                for k in CATEGORIES}
    txt = TM.format_footprint(tf)
    assert "exec_cache" in txt and "fits" in txt


def test_drop_packed_auto_under_a_tiny_budget_warns_as_jax(tiny,
                                                           monkeypatch):
    """A budget of 1 KiB: "auto" drops the packed codes, with the JAX
    engine's warning word for word (both see the same footprint), and the
    footprint shows it; ``drop_packed=False`` keeps them."""
    monkeypatch.setattr(TE, "device_memory_bytes", lambda dev: 1024)
    monkeypatch.setitem(JM.CHIP_SPECS, "fake",
                        {"hbm_gbps": 1, "bf16_tflops": 1, "int8_tops": 1,
                         "hbm_gib": 1024 / 2 ** 30})
    monkeypatch.setattr(JM, "detect_chip", lambda: "fake")
    with pytest.warns(UserWarning, match="dropping packed") as rec:
        je, te = _engines(tiny, "q", max_batch=2, max_seq=64,
                          runtime_cache="int4")
    warned = [str(w.message) for w in rec if "dropping" in str(w.message)]
    assert len(warned) == 2 and warned[0] == warned[1]
    q = te.params["layers"][0]["qkv_proj"]
    assert q.packed is None and q.absmax is None and q.w_cache is not None
    fp = te.footprint()
    assert fp["packed"] == 0 and fp["exec_cache"] > 0 and not fp["fits"]
    assert fp["budget"] == 1024
    kept = TE.DecodeEngine(tiny[2]["q"][1], tiny[1], max_batch=2, max_seq=64,
                           runtime_cache="int4", drop_packed=False,
                           device="cpu")
    assert kept.params["layers"][0]["qkv_proj"].packed is not None
    assert kept.footprint()["packed"] > 0


@pytest.mark.parametrize("fmt", ["int8", "bf16", "auto"])
def test_unported_runtime_caches_raise(tiny, fmt):
    """Every runtime cache of the JAX package is ported; a format neither
    package has (here each one's upper-case spelling) raises."""
    cfg, tcfg, models = tiny
    with pytest.raises(ValueError, match="unknown runtime_cache"):
        TE.DecodeEngine(models["q"][1], tcfg, runtime_cache=fmt.upper(),
                        device="cpu")


# -- checkpoint format ---------------------------------------------------------

def test_checkpoint_round_trip(tmp_path):
    """Dicts, lists, tuples, None, scalars, strings and tensors of every
    dtype a snapshot holds come back as they went in (tensors on the
    CPU)."""
    rng = np.random.default_rng(0)
    tree = {"f32": torch.from_numpy(rng.standard_normal((3, 4), np.float32)),
            "bf16": torch.randn(5, generator=torch.Generator().manual_seed(1)
                                ).to(torch.bfloat16),
            "i8": torch.tensor([[-127, 0, 127]], dtype=torch.int8),
            "u8": torch.arange(7, dtype=torch.uint8),
            "i32": torch.tensor(3, dtype=torch.int32),
            "b": torch.tensor([True, False]),
            "np": np.arange(4, dtype=np.int64),
            "nested": [1, 2.5, "x", None, True, (3, [4, {"y": None}])]}
    path = str(tmp_path / "ck")
    save_checkpoint(path, tree)
    got = load_checkpoint(path)
    assert set(got) == set(tree)
    for k in ("f32", "bf16", "i8", "u8", "i32", "b"):
        assert got[k].dtype == tree[k].dtype and torch.equal(got[k], tree[k])
    assert torch.equal(got["np"], torch.from_numpy(tree["np"]))
    assert got["nested"] == tree["nested"]


def test_jax_snapshot_loads_with_the_ports_loader(tiny, tmp_path):
    """A JAX engine's ``save_state`` file reads through the port's
    ``load_checkpoint``: every array equals what JAX's own loader gives,
    every other entry too."""
    from tpu_bitsandbytes.utils.checkpoint import load_checkpoint as jload
    je, _ = _engines(tiny, max_batch=2, max_seq=64, steps_per_sync=2)
    for p in _prompts([5, 9, 30], tiny[0].vocab_size, seed=4):
        je.add_request(p, JSP(max_new_tokens=6, temperature=0.7))
    je.step()
    path = str(tmp_path / "jax.npz")
    je.save_state(path)
    ref, got = jload(path), load_checkpoint(path)

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            assert a == b

    same(ref, got)
    assert got["key"].dtype == torch.uint32


# -- snapshot and restart ------------------------------------------------------

@pytest.mark.parametrize("quantized", [True, False])
def test_snapshot_matches_jax(tiny, tmp_path, quantized):
    """After three greedy steps (two slots, two requests waiting) the
    port's snapshot equals JAX's entry by entry: int8 KV codes and
    lengths exactly, f32 scales (or f32 K/V) within 1e-5 of max|ref|,
    every request's bookkeeping, the uid counter; the RNG entry (JAX's
    key, the port's generator state) is the one exception."""
    je, te = _engines(tiny, max_batch=2, max_seq=64, steps_per_sync=2,
                      quantized_kv=quantized)
    prompts = _prompts([5, 9, 30, 12], tiny[0].vocab_size, seed=1)
    for e, sp in ((je, JSP), (te, TSP)):
        for p in prompts:
            e.add_request(p, sp(max_new_tokens=8))
        for _ in range(3):
            e.step()
    snaps = []
    for name, e in (("j", je), ("t", te)):
        e.save_state(str(tmp_path / name))
        snaps.append(load_checkpoint(str(tmp_path / name)))
    ref, got = snaps
    assert ref.pop("key") is not None and got.pop("generator") is not None
    rc, gc = ref.pop("cache"), got.pop("cache")
    assert got == ref
    assert len(got["active"]) == 2 and len(got["waiting"]) == 2
    assert {k: gc.pop(k) for k in ("quantized", "ring", "max_positions",
                                   "dtype")} == {
        k: rc.pop(k) for k in ("quantized", "ring", "max_positions",
                               "dtype")}
    for name, r in rc.items():
        g = gc[name]
        if r is None:
            assert g is None
            continue
        assert g.dtype == r.dtype and g.shape == r.shape
        if r.dtype in (torch.int8, torch.int32):
            assert torch.equal(g, r), name
        else:
            assert (g - r).abs().max() <= KV_TOL * r.abs().max(), name


def test_restart_is_token_identical(tiny, tmp_path):
    """Snapshot mid-run (some requests active, some waiting), then keep
    decoding; a fresh engine with another seed restored from the snapshot
    emits the same tokens: sampled requests too, as the generator's state
    is part of the snapshot (the JAX package's
    ``test_restart_is_token_deterministic``)."""
    _, tcfg, models = tiny
    prompts = _prompts([5, 6, 4, 7], tcfg.vocab_size, seed=2)
    kw = dict(max_batch=2, max_seq=64, steps_per_sync=2, device="cpu")
    outs = {}
    for name, sp in (("greedy", TSP(max_new_tokens=12)),
                     ("sampled", TSP(max_new_tokens=12, temperature=0.8,
                                     top_k=20))):
        eng = TE.DecodeEngine(models["int4"][1], tcfg, seed=7, **kw)
        for p in prompts:
            eng.add_request(p, sp)
        for _ in range(3):
            eng.step()
        assert eng.active and eng.waiting
        path = str(tmp_path / f"{name}.npz")
        eng.save_state(path)
        ref = _finish(eng)
        eng2 = TE.DecodeEngine(models["int4"][1], tcfg, seed=999, **kw)
        eng2.load_state(path)
        outs[name] = _finish(eng2)
        assert outs[name] == ref and len(ref) == 4
    assert outs["greedy"] != outs["sampled"]


def test_restore_keeps_the_waiting_queue(tiny, tmp_path):
    _, tcfg, models = tiny
    kw = dict(max_batch=1, max_seq=64, device="cpu")
    eng = TE.DecodeEngine(models["int4"][1], tcfg, **kw)
    eng.add_request([1, 2, 3], TSP(max_new_tokens=2))
    eng.add_request([4, 5], TSP(max_new_tokens=2, stop=((7, 8),)))
    path = str(tmp_path / "s.npz")
    eng.save_state(path)
    eng2 = TE.DecodeEngine(models["int4"][1], tcfg, **kw)
    eng2.load_state(path)
    assert [r.uid for r in eng2.waiting] == [r.uid for r in eng.waiting]
    assert eng2.waiting[1].params == eng.waiting[1].params
    assert len(_finish(eng2)) == 2


@pytest.mark.parametrize("quantized", [True, False])
def test_chunked_snapshot_restart(tiny, tmp_path, quantized):
    """A snapshot taken mid-chunked-prefill (the JAX package's
    ``test_chunked_snapshot_restart``) resumes token-identically, and the
    port's tokens equal the JAX engine's."""
    cfg = tiny[0]
    prompt = _prompts([50], cfg.vocab_size, seed=3)[0]
    kw = dict(max_batch=1, max_seq=128, quantized_kv=quantized,
              prefill_chunk=16)
    je, te = _engines(tiny, **kw)
    ref = je.generate([prompt], JSP(max_new_tokens=5), pipeline_depth=1)[0]
    te.add_request(prompt, TSP(max_new_tokens=5))
    te.step()
    assert any(r.prefilling for r in te.active.values())
    path = str(tmp_path / "snap.npz")
    te.save_state(path)
    te2 = _engines(tiny, **kw)[1]
    te2.load_state(path)
    assert te2.active[0].prefill_pos == 16
    assert _finish(te2) == {1: ref}


def test_load_state_refuses_another_cache(tiny, tmp_path):
    _, tcfg, models = tiny
    eng = TE.DecodeEngine(models["int4"][1], tcfg, max_batch=2, max_seq=64,
                          device="cpu")
    path = str(tmp_path / "s.npz")
    eng.save_state(path)
    for kw in (dict(max_seq=128), dict(quantized_kv=False)):
        other = TE.DecodeEngine(models["int4"][1], tcfg, max_batch=2,
                                device="cpu", **dict(dict(max_seq=64), **kw))
        with pytest.raises(ValueError, match="load_state"):
            other.load_state(path)


# -- warm-up -------------------------------------------------------------------

@pytest.mark.parametrize("kw,args", [
    (dict(max_seq=64), {}),
    (dict(max_seq=128, prefill_chunk=16),
     dict(prompt_lengths=[20, 100], features=("sampled", "penalty"))),
    (dict(max_seq=512, steps_per_sync=32),
     dict(prompt_lengths=[16, 100, 200], group_sizes=(2, 4),
          features=("sampled", "logprobs", "penalty"))),
    (dict(max_seq=8192, prefill_chunk=512), dict(prompt_lengths=[8191])),
])
def test_warmup_plan_matches_jax(tiny, kw, args):
    """``warmup_plan`` equals the JAX engine's, field by field, and its
    graph keys are its decode windows times its variants."""
    je, te = _engines(tiny, max_batch=2, quantized_kv=False, **kw)
    plan = te.warmup_plan(**args)
    assert plan == je.warmup_plan(**args)
    keys = te.plan_graph_keys(plan)
    assert len(keys) == len(set(keys)) == (len(plan["decode_windows"])
                                           * len(plan["variants"]))


def test_warmup_runs_exactly_the_plan(tiny, monkeypatch):
    """``warmup`` runs one prefill per bucket, one batched prefill per
    bucket and group size, one chunk step per pair and one decode chunk
    per graph key (the JAX package's ``test_warmup_dispatches_match_plan``);
    it leaves every length at zero and the generator's state as it was,
    refuses an engine with requests, and the engine serves as an unwarmed
    one does afterwards."""
    calls = {n: [] for n in ("prefill_step", "prefill_batch",
                             "prefill_chunk_step", "decode_chunk")}
    for name in calls:
        orig = getattr(TE, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name].append(k)
            return _orig(*a, **k)

        monkeypatch.setattr(TE, name, spy)
    kw = dict(max_batch=2, max_seq=256, prefill_chunk=16, steps_per_sync=4)
    _, te = _engines(tiny, **kw)
    te.generator.manual_seed(11)
    state = te.generator.get_state()
    plan = te.warmup(prompt_lengths=[20, 100], group_sizes=(2,),
                     features=("sampled", "logprobs", "penalty"))
    buckets = plan["prefill_buckets"]
    assert len(calls["prefill_step"]) == len(buckets) == 2
    assert len(calls["prefill_batch"]) == len(buckets)
    assert len(calls["prefill_chunk_step"]) == len(plan["chunk_pairs"])
    got = [(k["attn_span"], k["n_steps"], k["all_greedy"],
            k["seen_mask"] is not None, k["want_logprobs"], k["attn_start"])
           for k in calls["decode_chunk"]]
    assert got == te.plan_graph_keys(plan) and len(got) == 8
    assert plan["n_compiles"] == 2 * 2 + len(plan["chunk_pairs"]) + 1 + 8
    assert plan["seconds"] > 0
    assert te.cache.lengths.tolist() == [0, 0]
    assert torch.equal(te.generator.get_state(), state)
    prompts = _prompts([20, 7, 100], tiny[0].vocab_size, seed=6)
    sp = TSP(max_new_tokens=6)
    want = _engines(tiny, **kw)[1].generate(prompts, sp, pipeline_depth=1)
    assert te.generate(prompts, sp, pipeline_depth=1) == want
    te.add_request([1, 2, 3])
    with pytest.raises(RuntimeError, match="without requests"):
        te.warmup()


# -- pipelined dispatch --------------------------------------------------------

def test_pipelined_matches_step_loop_and_jax(tiny):
    """``generate``'s default, two chunks in flight, gives the tokens of
    the step loop, with slot turnover (5 prompts, 2 slots), and the JAX
    engine's pipelined ``generate``'s, on an int8 and an unquantized
    cache; the decode chunks' emissions are counted (``stats["tokens"]``)."""
    prompts = _prompts([3, 4, 5, 6, 7], tiny[0].vocab_size, seed=7)
    for quantized in (True, False):
        kw = dict(max_batch=2, max_seq=64, steps_per_sync=2,
                  quantized_kv=quantized)
        je, te = _engines(tiny, **kw)
        ref = je.generate(prompts, JSP(max_new_tokens=6))
        step = _engines(tiny, **kw)[1].generate(prompts,
                                                TSP(max_new_tokens=6),
                                                pipeline_depth=1)
        got = te.generate(prompts, TSP(max_new_tokens=6))
        assert got == step == ref
        assert not te.active and not te.waiting
        assert te.stats["tokens"] + len(prompts) == sum(map(len, got))


def test_pipelined_dispatches_no_chunk_past_every_request(tiny,
                                                          monkeypatch):
    """Once the chunks in flight reach every request's token budget, no
    further chunk is dispatched: 9 tokens (one from prefill, 8 from
    4-step chunks) take the step loop's two chunks, not a third whose
    tokens would all be dropped."""
    calls = []
    orig = TE.decode_chunk

    def spy(*a, **k):
        calls.append(k["attn_span"])
        return orig(*a, **k)

    monkeypatch.setattr(TE, "decode_chunk", spy)
    prompts = _prompts([5, 7], tiny[0].vocab_size, seed=11)
    outs = {}
    for depth in (1, 2):
        calls.clear()
        _, te = _engines(tiny, max_batch=2, max_seq=64, steps_per_sync=4)
        outs[depth] = te.generate(prompts, TSP(max_new_tokens=9),
                                  pipeline_depth=depth)
        assert len(calls) == 2
    assert outs[1] == outs[2] and all(len(o) == 9 for o in outs[2])


def test_pipelined_uneven_finish_and_eos(tiny):
    """Requests retiring mid-pipeline (``max_new_tokens``) leave device
    emissions that are dropped, and an EOS stops a slot on the device
    mid-chunk (the JAX package's ``test_pipelined_uneven_finish_and_eos``)."""
    _, tcfg, models = tiny
    tp = models["int4"][1]
    prompts = _prompts([4, 4, 4], tcfg.vocab_size, seed=8)
    first = TE.DecodeEngine(tp, tcfg, max_batch=1, max_seq=64,
                            device="cpu").generate(
        [prompts[0]], TSP(max_new_tokens=1))[0][0]
    e = TE.DecodeEngine(tp, tcfg, max_batch=2, max_seq=64, steps_per_sync=3,
                        device="cpu")
    e.add_request(prompts[0], TSP(max_new_tokens=9, eos_token_id=first))
    e.add_request(prompts[1], TSP(max_new_tokens=2))
    e.add_request(prompts[2], TSP(max_new_tokens=5))
    e.run_pipelined(depth=2)
    outs = {r.uid: r.generated for r in e.finished}
    assert outs[1] == [first]
    assert len(outs[2]) == 2 and len(outs[3]) == 5


def test_pipelined_admits_after_first_token_retirement(tiny):
    """A request whose prefill token is its whole output frees its slot
    before any chunk finishes: the pipeline still drains to admit the
    waiting request, which finishes before the long one (the JAX
    package's ``test_pipelined_admits_after_first_token_retirement``)."""
    _, tcfg, models = tiny
    prompts = _prompts([4, 4, 4], tcfg.vocab_size, seed=9)
    e = TE.DecodeEngine(models["int4"][1], tcfg, max_batch=2, max_seq=64,
                        steps_per_sync=2, device="cpu")
    e.add_request(prompts[0], TSP(max_new_tokens=1))
    e.add_request(prompts[1], TSP(max_new_tokens=40))
    e.add_request(prompts[2], TSP(max_new_tokens=2))
    e.run_pipelined(depth=2)
    outs = {r.uid: r.generated for r in e.finished}
    assert len(outs) == 3 and len(outs[3]) == 2 and len(outs[2]) == 40
    assert [r.uid for r in e.finished] == [1, 3, 2]


def test_pipelined_penalty_logprobs_and_chunked_prefill_match_jax(tiny):
    """Penalties and logprobs carried across pipelined chunks on the
    device (the seen mask is not refilled mid-pipeline), beside a chunked
    prefill the pipeline drains for: greedy tokens equal JAX's pipelined
    engine's, logprobs within 1e-5."""
    prompts = _prompts([50, 7, 33], tiny[0].vocab_size, seed=10)
    spec = [dict(max_new_tokens=10, repetition_penalty=1.3),
            dict(max_new_tokens=10, logprobs=True),
            dict(max_new_tokens=10, repetition_penalty=1.2, logprobs=True)]
    je, te = _engines(tiny, max_batch=2, max_seq=128, prefill_chunk=16,
                      steps_per_sync=4)
    for e, sp in ((je, JSP), (te, TSP)):
        for p, d in zip(prompts, spec):
            e.add_request(p, sp(**d))
        e.run_pipelined(depth=2)
    ref = {r.uid: r for r in je.finished}
    got = {r.uid: r for r in te.finished}
    assert {u: r.generated for u, r in got.items()} == {
        u: r.generated for u, r in ref.items()}
    for u, r in ref.items():
        np.testing.assert_allclose(got[u].logprobs, r.logprobs, rtol=0,
                                   atol=1e-5)
    assert len(got[3].logprobs) == 10
