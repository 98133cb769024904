"""Tiny cells for the CPU tests: the two configurations' shapes cut to a
size a test run holds (the port's CPU path runs each kernel's plain
version), with the published configurations' keys. ``initializer_range``
grows by sqrt(4096 / 256), so that each layer's gain is the full width's
(the weights' std times the square root of the width)."""

import copy
import json

from harness import spec

TINY = {"hidden_size": 256, "intermediate_size": 512,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "vocab_size": 512,
        "max_position_embeddings": 1024, "initializer_range": 0.08}


LIMITS = {"gap_mean": 0.1, "kv_err_first": 0.04}


def config(name: str, **over) -> dict:
    with open(spec.BENCH / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg.update(TINY, **over)
    return spec.normalize_config(cfg)


def cell(config_name="mistral-7b-nf4-int4cache", *, clients=4,
         prompt=(65, 120), output=(6, 14), max_seq=256, steps=4,
         ring=False, trace=False, limits=None, sampling=None, engine=None,
         **over) -> spec.Cell:
    names = ["output_tokens_per_s", "ttft_p95_ms", "tpot_p95_ms",
             "setup_s"]
    metrics = [spec.Metric(n, "x", "end_to_end",
                           spec.load_reader(spec.BENCH / "metrics"
                                            / f"{n}.py")) for n in names]
    if trace:
        metrics += [spec.Metric(n, "x", "per_layer",
                                spec.load_reader(spec.BENCH / "metrics"
                                                 / f"{n}.py"))
                    for n in ("slot_occupancy", "graph_capture_s")]
    return spec.Cell(
        name="tiny", chips=1, config=config(config_name, **over),
        traffic={"kind": "closed_loop", "clients": clients,
                 "prompt_tokens": list(prompt),
                 "output_tokens": list(output),
                 "sampling": sampling or [{"temperature": 0.0}]},
        settings={"engine": {"max_batch": clients, "max_seq": max_seq,
                             "steps_per_sync": steps, "ring_kv": ring,
                             **(engine or {})},
                  "trace": {"start_s": 0.0, "seconds": 1.0},
                  "check": {"requests": 5,
                            "limits": copy.deepcopy(limits or LIMITS)}},
        metrics=metrics)
