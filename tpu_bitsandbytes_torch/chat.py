"""Interactive chat on the NF4 decode engine, streaming tokens as they decode.

With a local HF checkpoint directory it loads and quantizes the real model
(any family ``utils.hf`` converts: Llama/Llama-3, Qwen2/2.5, Mistral, Gemma,
Gemma2); ``transformers`` is imported only then. Without one it builds a
random-weight tiny Llama from a seed, so the engine loop runs anywhere.

Usage:
  python -m tpu_bitsandbytes_torch.chat [--model /path/to/hf/checkpoint]
      [--max-new 64] [--temperature 0.0] [--device cuda]

It serves on the first CUDA card unless ``--device cpu`` is given. Each
line read is one prompt; an empty line or the end of the input ends it.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch


def _tiny_model(device):
    from .models import llama
    config = llama.LlamaConfig(
        vocab_size=1024, hidden_size=256, intermediate_size=512,
        num_layers=2, num_heads=4, num_kv_heads=4, max_seq_len=512)
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.quantize_params(
        llama.init_params(config, generator=gen, device=device))
    return config, params


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None,
                    help="local HF checkpoint directory "
                         "(Llama/Qwen2/Mistral/Gemma/Gemma2)")
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="the engine's device (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    from .engine import DecodeEngine, SamplingParams
    tokenizer = None
    if args.model:
        from transformers import AutoTokenizer
        from .utils.hf import load_llama_from_pretrained
        print(f"loading + NF4-quantizing {args.model} ...")
        config, params = load_llama_from_pretrained(args.model, quantize=True,
                                                    device=device)
        tokenizer = AutoTokenizer.from_pretrained(args.model,
                                                  local_files_only=True)
    else:
        print("no --model given: using a random tiny Llama (engine demo only)")
        config, params = _tiny_model(device)

    engine = DecodeEngine(params, config, max_batch=1,
                          max_seq=min(config.max_seq_len, 2048),
                          device=device)
    sp = SamplingParams(
        temperature=args.temperature, max_new_tokens=args.max_new,
        eos_token_id=(tokenizer.eos_token_id if tokenizer else None))

    print("type a prompt (empty line to exit)")
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            break
        if not line:
            break
        if tokenizer:
            ids = tokenizer(line)["input_ids"]
        else:
            ids = [ord(c) % config.vocab_size for c in line]
        out, shown = [], 0
        for _, tok, _done in engine.generate_stream([ids], sp):
            out.append(tok)
            if tokenizer:
                text = tokenizer.decode(out, skip_special_tokens=True)
                print(text[shown:], end="", flush=True)
                shown = len(text)
        if tokenizer:
            print()
        else:
            print(f"(random-model tokens) {out}")


if __name__ == "__main__":
    main()
