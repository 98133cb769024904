"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Everything that belongs to one of them is a file of its own:

- ``BENCHMARK.json``'s ``configs`` entry gives the configuration's file
  (``benchmark/configs/<config>.json``): the published config's keys, the
  serving options (``serving``) and the stated precision;
- ``benchmark/traffic/<traffic>.json``: the traffic mix's parameters, read
  by :mod:`harness.traffic`;
- ``benchmark/workloads/<cell>.json``: the cell's engine settings, its
  traced sub-span and its correctness limits;
- ``benchmark/metrics/<metric>.py``: one reader per metric, a function
  ``read(run)`` returning a number or None (nothing to read); a metric
  split by what it moves (``<metric>.<part>``, reported in different
  cells) reads with the file of the part before the first dot;
- the configuration's ``model_type`` names its family's weight layout
  and program (``benchmark/harness/layouts/<model_type>.py``:
  ``make_weights``, ``build_engine``, ``read_kv``) and its plain
  reference (``benchmark/reference/<model_type>.py``);
- the mix's ``kind`` names its generator
  (``benchmark/harness/kinds/<kind>.py``, :mod:`harness.traffic`).

So a later change adds a model, a mix, a cell or a metric by adding files
and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    kind: str                    # "end_to_end" or "per_layer"
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict                 # the configuration file, normalized
    traffic: dict
    settings: dict               # benchmark/workloads/<cell>.json
    metrics: List[Metric]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def normalize_config(cfg: dict) -> dict:
    """Fill the keys a Mistral-family config.json leaves implicit: the head
    size (hidden / heads) and the expert count (0 for a dense MLP)."""
    cfg = dict(cfg)
    if cfg.get("head_dim") is None:
        cfg["head_dim"] = cfg["hidden_size"] // cfg["num_attention_heads"]
    cfg.setdefault("num_local_experts", 0)
    cfg.setdefault("num_experts_per_tok", 0)
    return cfg


def load_reader(path: Path) -> Callable:
    """The ``read`` function of a metric's file."""
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{path.stem.replace('-', '_').replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    """Whether a metric entry is reported in ``cell``: every cell unless
    it lists its cells under ``workloads``."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    root = root or ROOT
    bench = root / "benchmark"
    spec = _json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            if applies(m, name):
                metrics.append(Metric(
                    m["name"], m["unit"], kind,
                    load_reader(bench / "metrics"
                                / f"{m['name'].split('.')[0]}.py")))
    return Cell(name=name, chips=int(entry["chips"]),
                config=normalize_config(_json(root / conf["file"])),
                traffic=_json(bench / "traffic" / f"{entry['traffic']}.json"),
                settings=_json(bench / "workloads" / f"{name}.json"),
                metrics=metrics)


def layout(cfg: dict):
    """The weight layout and program of a configuration's family."""
    return importlib.import_module(f"harness.layouts.{cfg['model_type']}")


def readers(cell: Cell, kind: str) -> Dict[str, Metric]:
    return {m.name: m for m in cell.metrics if m.kind == kind}
