"""Rank bodies of the mesh tests: worlds of processes over gloo on the CPU.

The tests compute their JAX references in their own process, write a job
(numpy inputs, a list of cases) and spawn one process per rank with
:func:`spawn_world`; each rank runs ``python tests/torch_mesh_ranks.py
RANK WORLD PORT JOB OUT``, joins a gloo group, makes a ("dp", "tp") mesh,
runs every case of the job with one torch thread, and pickles its results.
This module imports torch and the port, never JAX.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class World:
    """``world`` rank processes running ``job`` (:func:`start_world`);
    :meth:`join` waits for them and returns each rank's results."""

    def __init__(self, job: dict, world: int, tmp: Path,
                 timeout: float = 120.0):
        self.world, self.tmp, self.timeout = world, Path(tmp), timeout
        self.tmp.mkdir(parents=True, exist_ok=True)
        job_path = self.tmp / "job.pkl"
        with open(job_path, "wb") as f:
            pickle.dump(job, f)
        port = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO), os.environ.get("PYTHONPATH", "")]))
        self.deadline = time.monotonic() + timeout
        self.procs = []
        for r in range(world):
            log = open(self.tmp / f"rank{r}.log", "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, __file__, str(r), str(world), str(port),
                 str(job_path), str(self.tmp)], cwd=REPO, env=env,
                stdout=log, stderr=subprocess.STDOUT), log))

    def join(self):
        """Each rank's results. A rank that fails, or a world that outlives
        its timeout (its processes are then killed), fails the caller with
        every failed rank's output."""
        for p, _ in self.procs:
            try:
                p.wait(timeout=max(0.1, self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
        timed_out = False
        for p, log in self.procs:
            if p.poll() is None:
                timed_out = True
                p.kill()
                p.wait()
            log.close()
        bad = [r for r, (p, _) in enumerate(self.procs) if p.returncode != 0]
        if bad:
            logs = "\n".join(
                f"--- rank {r} (exit {self.procs[r][0].returncode}) ---\n"
                + (self.tmp / f"rank{r}.log").read_text()[-6000:]
                for r in bad)
            raise AssertionError(
                f"a world of {self.world} ranks failed"
                + (f" (killed after {self.timeout} s)" if timed_out else "")
                + f": ranks {bad}\n{logs}")
        out = []
        for r in range(self.world):
            with open(self.tmp / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


def start_world(job: dict, world: int, tmp: Path,
                timeout: float = 120.0) -> World:
    """Start ``job`` on ``world`` ranks; the caller computes its references
    meanwhile and then calls :meth:`World.join`."""
    return World(job, world, tmp, timeout)


def spawn_world(job: dict, world: int, tmp: Path, timeout: float = 120.0):
    """Run ``job`` on ``world`` ranks and return each rank's results."""
    return World(job, world, tmp, timeout).join()


# -- the cases ------------------------------------------------------------

def _model(c):
    from tpu_bitsandbytes_torch.convert import (config_from_reference,
                                                from_reference_arrays)
    return (from_reference_arrays(c["params"], "cpu"),
            config_from_reference(c["config"]))


def _slots(mesh, b):
    from tpu_bitsandbytes_torch.parallel.mesh import axis_size
    per = b // axis_size(mesh, "dp")
    lo = mesh.get_local_rank("dp") * per
    return lo, lo + per


@case
def decode_steps(mesh, c):
    """make_tp_decode_step over c["tokens"] [steps, B] from an empty
    cache: this rank's logits [steps, B/dp, V] and the cache's lengths."""
    import torch
    from tpu_bitsandbytes_torch.engine.kvcache import KVCache
    from tpu_bitsandbytes_torch.parallel import (make_tp_decode_step,
                                                 shard_params)
    from tpu_bitsandbytes_torch.parallel.mesh import axis_size
    params, cfg = _model(c)
    local = shard_params(params, mesh)
    if c.get("int4"):
        from tpu_bitsandbytes_torch.parallel import build_sharded_int4_cache
        local = build_sharded_int4_cache(local)
    toks = c["tokens"]
    lo, hi = _slots(mesh, toks.shape[1])
    tp = axis_size(mesh, "tp")
    cache = KVCache.create(cfg.num_layers, hi - lo, c["max_seq"],
                           cfg.num_kv_heads // tp, cfg.hd,
                           quantized=c["quantized_kv"], dtype=cfg.dtype,
                           device="cpu")
    step = make_tp_decode_step(mesh, local, cfg, cache)
    active = torch.ones((hi - lo,), dtype=torch.bool)
    out = []
    for t in toks:
        logits, cache = step(local, cache, torch.from_numpy(t[lo:hi]), active)
        out.append(logits.numpy())
    return {"logits": np.stack(out), "lengths": cache.lengths.numpy()}


@case
def a8_codes(mesh, c):
    """A row-parallel slice's A8 codes and scales: with the row scale
    all-reduced over tp (the int4 cache's K1 path) and without (K4's)."""
    import torch
    from tpu_bitsandbytes_torch.ops.w4a8 import quantize_a8
    from tpu_bitsandbytes_torch.parallel.mesh import axis_size
    x = torch.from_numpy(c["x"])
    tp, r = axis_size(mesh, "tp"), mesh.get_local_rank("tp")
    k = x.shape[1] // tp
    xl = x[:, r * k:(r + 1) * k]
    q, s = quantize_a8(xl, k, mesh.get_group("tp"))
    q0, s0 = quantize_a8(xl, k)
    return {"codes": q.numpy(), "s_x": s.numpy(), "own_codes": q0.numpy(),
            "own_s_x": s0.numpy()}


@case
def row_linear(mesh, c):
    """A row-parallel QLinear4 through TPContext's wrap/reduce_fn: this
    rank's slice of x, the shard's route, the reduced output."""
    import torch
    from tpu_bitsandbytes_torch.convert import from_reference_arrays
    from tpu_bitsandbytes_torch.models.llama import LlamaConfig
    from tpu_bitsandbytes_torch.models.layers import linear_apply
    from tpu_bitsandbytes_torch.ops.w4a8 import takes_w4a8
    from tpu_bitsandbytes_torch.parallel.sharding import (_linear_spec,
                                                          shard_local)
    from tpu_bitsandbytes_torch.parallel.tp import TPContext
    from tpu_bitsandbytes_torch.parallel.mesh import axis_size
    w = from_reference_arrays(c["w"], "cpu")
    tp, r = axis_size(mesh, "tp"), mesh.get_local_rank("tp")
    lw = shard_local(w, _linear_spec(w, col=False), tp, r, "cpu")
    if c.get("int4"):
        lw = lw.with_runtime_cache("int4", drop_packed=True)
    ctx = TPContext(mesh, LlamaConfig.tiny())
    x = torch.from_numpy(c["x"])
    k = x.shape[1] // tp
    out = ctx.reduce_fn(linear_apply(ctx.wrap(lw, row=True),
                                     x[:, r * k:(r + 1) * k]), lw)
    return {"out": out.numpy(), "shape": lw.shape,
            "k4": takes_w4a8(x.shape[0], lw.shape[0], lw.shape[1],
                             lw.blocksize, lw.quant_type)}


@case
def window_chunk(mesh, c):
    """Each of c["prompts"] prefilled into its slot of an int8 KV cache
    through make_tp_prefill_step, then greedy decode chunks of
    make_tp_decode_chunk over [c["start"], c["span"]), staged in a compact
    window (``window_stage=True``) and in two blocks, each from that
    state: each mode's tokens [steps, B] and flushed lengths."""
    import torch
    from tpu_bitsandbytes_torch import parallel as TP
    from tpu_bitsandbytes_torch.engine.kvcache import KVCache
    from tpu_bitsandbytes_torch.engine.sampler import SamplingArrays
    params, cfg = _model(c)
    local = TP.shard_params(params, mesh)
    tp = TP.mesh.axis_size(mesh, "tp")
    prompts = c["prompts"]
    b = len(prompts)
    out = {}
    for window in (True, False):
        cache = KVCache.create(cfg.num_layers, b, c["max_seq"],
                               cfg.num_kv_heads // tp, cfg.hd,
                               dtype=cfg.dtype, device="cpu")
        pre = TP.make_tp_prefill_step(mesh, local, cfg, cache)
        first = []
        for slot, pr in enumerate(prompts):
            toks = torch.zeros((1, c["pad"]), dtype=torch.int32)
            toks[0, :len(pr)] = torch.tensor(pr, dtype=torch.int32)
            logits, cache = pre(local, cache, toks, slot, len(pr))
            first.append(logits.argmax())
        dec = TP.make_tp_decode_chunk(mesh, local, cfg, cache,
                                      n_steps=c["steps"])
        toks_seq, _, cache, *_ = dec(
            local, cache, torch.stack(first).to(torch.int32),
            torch.ones((b,), dtype=torch.bool), None,
            SamplingArrays.build({}, b, device="cpu"), None,
            all_greedy=True, attn_span=c["span"], attn_start=c["start"],
            window_stage=window)
        out[window] = {"tokens": toks_seq.numpy(),
                       "lengths": cache.lengths.numpy()}
    return out


def builder_run(params, cfg, c, mesh=None):
    """One request prefilled into slot 0, a 3-step greedy decode chunk, a
    verify step, and a second request's chunked prefill into slot 1 with
    its final logits: through the tp step builders on this rank's shards
    (``mesh``), or through the engine's single-device functions."""
    import torch
    from tpu_bitsandbytes_torch.engine import engine as E
    from tpu_bitsandbytes_torch.engine import speculative as S
    from tpu_bitsandbytes_torch.engine.kvcache import KVCache
    from tpu_bitsandbytes_torch.engine.sampler import SamplingArrays
    from tpu_bitsandbytes_torch import parallel as TP
    tp = 1 if mesh is None else TP.mesh.axis_size(mesh, "tp")
    if mesh is not None:
        params = TP.shard_params(params, mesh)
    cache = KVCache.create(cfg.num_layers, 2, 64, cfg.num_kv_heads // tp,
                           cfg.hd, quantized=False, dtype=cfg.dtype,
                           device="cpu")
    samp = SamplingArrays.build({}, 2, device="cpu")
    toks = torch.from_numpy(c["prompt"])[None]
    chunk_toks = torch.from_numpy(c["chunk"])[None]
    active = torch.tensor([True, False])
    if mesh is None:
        pre = lambda *a: E.prefill_step(*a, cfg)
        dec = (lambda p, ca, t, a, g, sa, seen, **k: E.decode_chunk(
            p, ca, t, a, g, sa, cfg, n_steps=3, seen_mask=seen, **k))
        ver = lambda *a, **k: S.verify_step(*a, cfg, **k)
        pch = lambda *a, **k: E.prefill_chunk_step(*a, cfg, **k)
        fin = lambda *a: E.prefill_final_logits(*a, cfg)
    else:
        pre = TP.make_tp_prefill_step(mesh, params, cfg, cache)
        dec = TP.make_tp_decode_chunk(mesh, params, cfg, cache, n_steps=3)
        ver = TP.make_tp_verify_step(mesh, params, cfg, cache)
        pch = TP.make_tp_prefill_chunk(mesh, params, cfg, cache)
        fin = TP.make_tp_final_logits(mesh, params, cfg)
    logits, cache = pre(params, cache, toks, 0, int(c["prompt_len"]))
    first = logits.argmax().to(torch.int32)
    tokens = torch.stack([first, torch.tensor(0, dtype=torch.int32)])
    toks_seq, _, cache, last, _, _, _ = dec(
        params, cache, tokens, active, None, samp, None, all_greedy=True,
        attn_span=64)
    vt = torch.cat([last[:, None], torch.from_numpy(c["drafts"])], dim=1)
    emitted, counts, cache = ver(params, cache, vt, active, None, samp,
                                 attn_span=64, all_greedy=True)
    x, cache = pch(params, cache, chunk_toks, 1, 0, 10, attn_span=64)
    final = fin(params, x, 9)
    return {"prefill": logits.numpy(), "tokens": toks_seq.numpy(),
            "emitted": emitted.numpy(), "counts": counts.numpy(),
            "final": final.numpy(), "lengths": cache.lengths.numpy()}


@case
def builders(mesh, c):
    """The six tp step builders (:func:`builder_run`)."""
    params, cfg = _model(c)
    return builder_run(params, cfg, c, mesh)


@case
def mesh_api(mesh, c):
    """``make_pod_mesh`` over the whole world, ``make_mesh`` asking for
    more ranks than the world has, ``initialize`` for one process."""
    from tpu_bitsandbytes_torch.parallel import (initialize, make_mesh,
                                                 make_pod_mesh)
    pod = make_pod_mesh(tp=c["tp"], device_type="cpu")
    try:
        make_mesh(tp=2 * c["world"], device_type="cpu")
        err = None
    except ValueError as e:
        err = str(e)
    initialize(num_processes=1)         # nothing for one process
    return {"pod_shape": tuple(pod.shape), "pod_names": pod.mesh_dim_names,
            "pod_tp_rank": pod.get_local_rank("tp"), "too_many": err}


def _outputs(eng, uids):
    by = {r.uid: r for r in eng.finished}
    return [by[u].generated for u in uids], [by[u].logprobs for u in uids]


@case
def engine(mesh, c):
    """The mesh engine's serving paths; each entry of c["runs"] builds an
    engine of its keyword arguments and serves its prompts."""
    from tpu_bitsandbytes_torch.engine.engine import DecodeEngine
    from tpu_bitsandbytes_torch.engine.sampler import SamplingParams
    models = {name: _model(m) for name, m in c["models"].items()}
    out = {}
    for run in c["runs"]:
        params, cfg = models[run.get("model", "main")]
        kw = dict(run.get("engine", {}))
        sps = [SamplingParams(**sp) for sp in run["sampling"]]
        eng = DecodeEngine(params, cfg, device="cpu", mesh=mesh, **kw)
        uids = eng._add_all(run["prompts"], sps)
        if run.get("snapshot"):
            # a few steps, a snapshot, and a fresh engine resumes from it
            for _ in range(run["snapshot"]):
                eng.step()
            path = os.path.join(c["tmp"], f"{run['id']}.npz")
            eng.save_state(path)
            eng = DecodeEngine(params, cfg, device="cpu", mesh=mesh, **kw)
            eng.load_state(path)
            while eng.step():
                pass
        elif run.get("depth", 2) > 1:
            eng.run_pipelined(run.get("depth", 2))
        else:
            while eng.step():
                pass
        toks, lps = _outputs(eng, uids)
        out[run["id"]] = {"tokens": toks, "logprobs": lps,
                          "footprint": eng.footprint(),
                          "spec": dict(eng.spec_stats),
                          "cache_shape": tuple(eng.cache.k.shape)}
    params, cfg = models["main"]
    for name, kw in c.get("refusals", {}).items():
        try:
            DecodeEngine(params, cfg, mesh=mesh, **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


STATE_FIELDS = ("exp_avg_int8", "exp_avg_absmax", "exp_avg_sq_uint8",
                "exp_avg_sq_max")


@case
def train(mesh, c):
    """``make_qlora_train_step(mesh=)`` on c["params"] (a LoRA-attached
    tree, whole; each rank takes its shards) and the global batch
    c["tokens"]: per step, the loss and gradients before it
    (``qlora_loss_and_grads(mesh=)``), the step's loss, the adapters and
    the 8-bit state after it (leaves in JAX's order, as numpy); then one
    ``remat`` step from the start."""
    import torch
    from tpu_bitsandbytes_torch.models.lora import lora_trainable
    from tpu_bitsandbytes_torch.optim.transforms import tree_leaves
    from tpu_bitsandbytes_torch.parallel import shard_params
    from tpu_bitsandbytes_torch.parallel.train import (make_qlora_train_step,
                                                       qlora_loss_and_grads)
    params, cfg = _model(c)
    local = shard_params(params, mesh)
    toks = torch.from_numpy(c["tokens"])
    start = {k: {"A": v["A"].detach().clone(), "B": v["B"].detach().clone()}
             for k, v in lora_trainable(params).items()}

    def np_leaves(tree):
        return [t.detach().numpy().copy() for t in tree_leaves(tree)]

    init, step = make_qlora_train_step(cfg, mesh=mesh)
    tr, st = start, init(start)
    steps = []
    for _ in range(c["steps"]):
        loss, grads = qlora_loss_and_grads(cfg, tr, local, toks, mesh=mesh)
        tr, st, step_loss = step(tr, st, local, toks)
        steps.append({"loss": float(loss), "step_loss": float(step_loss),
                      "grads": np_leaves(grads), "trainable": np_leaves(tr),
                      "state": {f: np_leaves(getattr(st, f))
                                for f in STATE_FIELDS},
                      "count": int(st.count)})
    _, remat_step = make_qlora_train_step(cfg, remat=True, mesh=mesh)
    tr_r, _, loss_r = remat_step(start, init(start), local, toks)
    return {"steps": steps,
            "remat": {"loss": float(loss_r), "trainable": np_leaves(tr_r)},
            "shard_shapes": {k: tuple(w.base.shape) for k, w in
                             local["layers"][0].items()
                             if hasattr(w, "lora_A")}}


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    job_path, out_dir = sys.argv[4], Path(sys.argv[5])
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    timeout = datetime.timedelta(seconds=job.get("timeout", 60))
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank, timeout=timeout)
        from tpu_bitsandbytes_torch.parallel import make_mesh
        mesh = make_mesh(tp=job["tp"], dp=job["dp"], device_type="cpu",
                         timeout=timeout)
        results = {}
        for c in job["cases"]:
            results[c["id"]] = CASES[c["fn"]](mesh, c)
        with open(out_dir / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


if __name__ == "__main__":
    main()
