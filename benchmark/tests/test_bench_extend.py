"""A configuration, a traffic mix, a cell and a metric are each added as
new files (and entries in ``BENCHMARK.json``) alone: a copy of the
benchmark gains a tiny cell and a metric of its own, and the harness finds
and runs them by name with no existing file edited."""

import hashlib
import json
import shutil
import time
from pathlib import Path

from harness import runner, spec
import tiny


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()
                                                     ).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_by_name(tmp_path):
    shutil.copytree(spec.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path)
    b = tmp_path / "benchmark"
    cfg = tiny.config("mistral-7b-nf4-int4cache")
    (b / "configs" / "tiny-mistral.json").write_text(json.dumps(cfg))
    (b / "traffic" / "tiny-chat.json").write_text(json.dumps(
        {"kind": "closed_loop", "clients": 3, "prompt_tokens": [70, 100],
         "output_tokens": [5, 9], "sampling": [{"temperature": 0.0}]}))
    (b / "workloads" / "tiny-cell.json").write_text(json.dumps(
        {"engine": {"max_batch": 3, "max_seq": 256, "steps_per_sync": 4},
         "trace": {"start_s": 0.0, "seconds": 1.0},
         "check": {"requests": 2, "limits": {**tiny.LIMITS, "gap_mean": 0.05}}}))
    (b / "metrics" / "requests_per_s.py").write_text(
        "def read(run):\n"
        "    done = [r for r in run.reqs if r.t_done is not None\n"
        "            and run.window.holds(r.t_done)]\n"
        "    return len(done) / run.window.seconds\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-mistral", "source": "test",
                             "file": "benchmark/configs/tiny-mistral.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny-mistral",
                               "traffic": "tiny-chat", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "requests_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["tiny-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(tmp_path)
    assert all(after[k] == v for k, v in before.items())

    cell = spec.load_cell("tiny-cell", root=tmp_path)
    assert cell.traffic["clients"] == 3 and cell.config["hidden_size"] == 256
    out = runner.execute(cell, 5, 1.0, False, "cpu", time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["requests_per_s"]["value"] > 0
    assert {"output_tokens_per_s", "setup_s"} <= set(out["metrics"])
    # a metric that lists its cells is read in those alone
    names = {m.name for m in cell.metrics}
    assert not names & {"k4_roofline", "ttft_p95_ms", "tpot_p95_ms"}
