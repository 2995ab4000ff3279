"""``torch.cuda.max_memory_allocated()`` over the window, in GiB."""


def read(run):
    peak = run.counters.get("window_peak_bytes")
    return None if not peak else peak / 2**30
