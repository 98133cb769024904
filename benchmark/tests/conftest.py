"""The benchmark's own tests. They import the harness the way
``benchmark/run.py`` does (the benchmark's folder and the checkout's root
on ``sys.path``) and import nothing of JAX."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
