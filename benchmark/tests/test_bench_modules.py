"""The no-JAX check compares each loaded module's top-level name (before
the first dot) whole: the port's ``tpu_bitsandbytes_torch`` passes, the
JAX package ``tpu_bitsandbytes``, ``jax``, ``jaxlib`` and ``flax`` do
not. And the command refuses to run without a card or without the
port."""

import subprocess
import sys
import types

from harness import runner, spec


def test_top_level_names_compared_whole(monkeypatch):
    for name in ("tpu_bitsandbytes_torch", "tpu_bitsandbytes_torch.ops",
                 "jaxtyping", "flaxen", "tpu_bitsandbytes_extra"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert runner.forbidden_modules() == []
    for name in ("tpu_bitsandbytes.ops.int4cache", "jax", "jaxlib.xla",
                 "flax.linen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert runner.forbidden_modules() == sorted(
        ["tpu_bitsandbytes.ops.int4cache", "jax", "jaxlib.xla",
         "flax.linen"])


def test_no_card_no_result(capsys):
    if __import__("torch").cuda.is_available():
        return      # the card's machine: the look passes
    rc = runner.main(["--workload", "mistral7b-chat-b64", "--seed", "1",
                      "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_without_the_port_no_result(tmp_path):
    import shutil
    shutil.copytree(spec.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "mistral7b-chat-b64", "--seed", "1", "--seconds",
                        "1"], cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
