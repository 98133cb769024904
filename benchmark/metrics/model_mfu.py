"""The model's useful FLOPs in the profiled sub-span (the decode tokens
of its chunks and the prompts it prefilled, ``roofline/model_flops.py``)
over the sub-span's seconds times the card's dense bf16 peak, in %."""

from roofline import model_flops, peaks


def read(run):
    sp = run.span
    if sp.seconds <= 0:
        return None
    flop = sum(model_flops.decode_token(run.cfg, run.keys(r, i))
               for r, i in run.decode_tokens(run.chunk_ids("span")))
    flop += sum(model_flops.prefill(run.cfg, n)
                for p in run.prefills("span") for n in p["lens"])
    if flop <= 0:
        return None
    peak = peaks.of(run.device_kind)["bf16_flops_per_s"]
    return 100.0 * flop / (sp.seconds * peak)
