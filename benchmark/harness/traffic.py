"""The traffic generator of a mix, found by the mix's kind.

A mix file (``benchmark/traffic/<name>.json``) names its ``kind``; the
generator of that kind is ``benchmark/harness/kinds/<kind>.py``, whose
``Traffic(params, seed, vocab)`` reads the rest of the file. So a mix of a
kind that exists is a data file alone, and a new kind is a new file. A
kind's ``Traffic`` gives ``clients``, ``prompt_range`` (the shortest and
longest prompt), ``longest()`` (the most positions a request holds),
``sampling`` (a list of every ``SamplingParams`` keywords it sends),
``request(client, r)`` (prompt ids, output length, sampling keywords) and
the loop's three hooks ``start(loop)``, ``done(loop, rec)`` and
``steady()`` (see :class:`harness.serve.Loop`).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

KINDS = Path(__file__).resolve().parent / "kinds"


def load(params: dict, seed: int, vocab: int):
    """The ``Traffic`` of mix ``params`` for ``seed``."""
    path = KINDS / f"{params.get('kind')}.py"
    if not path.is_file():
        raise ValueError(f"unknown traffic kind {params.get('kind')!r}: "
                         f"no {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_kind_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Traffic(params, seed, vocab)
