"""Decode tokens the clients received from the window's decode chunks,
over the chunks' decode steps times the engine's slots, in %."""


def read(run):
    chunks = run.chunk_ids("window")
    if not chunks:
        return None
    tokens = sum(1 for _ in run.decode_tokens(chunks))
    steps = len(chunks) * run.engine["steps_per_sync"]
    return 100.0 * tokens / (steps * run.engine["max_batch"])
