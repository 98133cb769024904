"""The check fails a run whose timed path is broken underneath. Each test
drives a whole run of a tiny cell on the CPU (past the harness's look for
a card) with one fault planted in the engine once it is warm, and sees
``correct`` come out false; the same run unbroken is correct. A KV cache
kept at 4 bits moves few served tokens: the KV read back catches it. The cells
run on one chip, so there is no exchange between chips to leave out."""

import time

import pytest
import torch

from harness import runner
import tiny

SEED = 2 ** 31 + 101


def token_altered(monkeypatch, eng):
    """Every sampled token moved to its neighbour where it is produced."""
    from tpu_bitsandbytes_torch.engine import engine as E
    orig = E.sample_batched
    v = eng.config.vocab_size
    monkeypatch.setattr(E, "sample_batched",
                        lambda *a, **k: (orig(*a, **k) + 1) % v)


def state_unchanged(monkeypatch, eng):
    """Decode steps (and group prefills) leave the KV cache as it was."""
    monkeypatch.setattr(eng.cache, "write_decode", lambda *a, **k: eng.cache)


def kv_int4(monkeypatch, eng):
    """The KV cache keeps 4 bits a value: int8 codes on int4's 15 levels."""
    from tpu_bitsandbytes_torch.engine.kvcache import KVCache
    orig = KVCache._quant

    def quant(x):
        q, absmax = orig(x)
        q4 = torch.round(q.float() * (7 / 127)).clamp(-7, 7)
        return torch.round(q4 * (127 / 7)).to(torch.int8), absmax
    monkeypatch.setattr(KVCache, "_quant", staticmethod(quant))


def half_batch(monkeypatch, eng):
    """The second half of the slots takes the first half's logits."""
    from tpu_bitsandbytes_torch.engine import engine as E
    orig = E.decode_step

    def step(*a, **k):
        logits, cache = orig(*a, **k)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:logits.shape[0] - h]]), cache
    monkeypatch.setattr(E, "decode_step", step)


def _run(fault=None):
    return runner.execute(tiny.cell(), SEED, 1.0, False, "cpu",
                          time.perf_counter(), fault=fault)


def test_sound_run_is_correct():
    assert _run()["correct"]


@pytest.mark.parametrize("plant", [token_altered, state_unchanged,
                                   half_batch, kv_int4])
def test_fault_is_not_correct(plant, monkeypatch):
    out = _run(lambda eng: plant(monkeypatch, eng))
    assert not out["correct"], out["checks"]
