"""The control of the correctness check, kept at a size a test run holds:
the reference in the program's place one precision step down (int4 where
the configuration states int8), with the KV cache alone or the decode
matmuls' activations alone lowered, reads not correct by the check's own
judge, where the program's run reads correct. The KV cache alone moves
few served tokens off the reference's argmax: the read-back KV catches
it. ``control.py`` runs the same at a cell's own size on the card."""

import time

import pytest

from harness import runner
import control
import tiny


@pytest.mark.parametrize("name", ["mistral-7b-nf4-int4cache",
                                  "mixtral-8x7b-nf4-packed"])
def test_each_lowered_part_reads_not_correct(name):
    for seed in (11, 2 ** 31 + 5):
        c = tiny.cell(name, output=(16, 24))
        limits = {**c.settings["check"]["limits"], "short_requests": 0}
        out = runner.execute(
            c, seed, 1.0, False, "cpu", time.perf_counter(),
            after=lambda tree, chosen, hold, ref: control.control_readings(
                tree, c.config, chosen, hold, ref, limits))
        assert out["correct"], out["checks"]
        after = out["after"]
        for name_ in ("kv_int4", "act_int4"):
            assert not after[name_]["correct"], after[name_]
        assert after["kv_int4"]["kv_err_first"] > limits["kv_err_first"]
        # a sound cache reads about the stated rounding
        stated = after["kv_stated"]["kv_err_first"]
        assert stated <= out["checks"]["kv_err_first"]["value"] < 3 * stated
