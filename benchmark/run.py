"""The benchmark of the PyTorch and CUDA port (``tpu_bitsandbytes_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration, traffic mix, settings and metrics are
files under ``benchmark/`` found by name (``harness/spec.py``). The last
line of standard output is the result (JSON); the compared numbers and
their limits are the last lines of standard error. With ``--trace 0``
the metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, from a profiled sub-span of the window.

The kernels build into the checkout's ``build/kernels/`` (the port's
fixed build directory), so only a checkout's first run compiles them.
Nothing here imports JAX or the JAX package, and the run fails if any
module of theirs is loaded when it ends.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

if __name__ == "__main__":
    os.environ["USE_FLAX"] = "0"
    if not (ROOT / "tpu_bitsandbytes_torch" / "__init__.py").is_file():
        print(f"no tpu_bitsandbytes_torch package beside {BENCH}: nothing "
              "to measure", file=sys.stderr)
        sys.exit(2)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    from harness.runner import main
    sys.exit(main(t0=T0))
