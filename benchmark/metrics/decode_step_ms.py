"""Device ms per decode step: CUDA events on the caller's stream around
each of the window's chunk replays, summed, over the chunks' steps."""


def read(run):
    chunks = sorted(run.chunk_ids("window"))
    if not chunks:
        return None
    return (run.inst.decode_ms(chunks)
            / (len(chunks) * run.engine["steps_per_sync"]))
