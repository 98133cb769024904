"""The port's chat entry point (``python -m tpu_bitsandbytes_torch.chat``),
the counterpart of ``demo/chat.py``: a prompt piped through ``main()`` on
the CPU streams the engine's greedy tokens for it."""

import ast
import io

import torch

from tpu_bitsandbytes_torch import chat
from tpu_bitsandbytes_torch.engine import DecodeEngine, SamplingParams


def test_piped_prompt_streams_the_engines_greedy_tokens(monkeypatch, capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        monkeypatch.setattr("sys.stdin", io.StringIO("hello port\n\n"))
        chat.main(["--device", "cpu", "--max-new", "6"])
        out = capsys.readouterr().out
        config, params = chat._tiny_model(torch.device("cpu"))
        ids = [ord(c) % config.vocab_size for c in "hello port"]
        ref = DecodeEngine(params, config, max_batch=1, max_seq=512,
                           device="cpu").generate(
            [ids], SamplingParams(max_new_tokens=6))[0]
    finally:
        torch.set_num_threads(n)
    line = [ln for ln in out.splitlines() if "(random-model tokens)" in ln]
    assert len(line) == 1
    got = ast.literal_eval(line[0].split("(random-model tokens)")[1].strip())
    assert got == ref and len(ref) == 6
