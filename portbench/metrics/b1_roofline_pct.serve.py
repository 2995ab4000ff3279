"""B1's bytes-bound time over its device time in the trace, summed over the
window's forwards: each upload's valid pooled steps of ht, plus a query,
the lengths and the contexts a launch."""

from harness import arith


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.classes.get("b1", (0.0, 0))
    ok = [r for r in run.requests if r["status"] == 200]
    if seconds <= 0 or launches != run.counters.get("forwards") or not ok:
        return None
    heads = run.conf["heads_number"]
    d_h = 5 * run.conf["kernel_size"] // heads
    valid = sum(arith.pooled_steps(arith.frames_of(r["samples"])) for r in ok)
    n_bytes = 4 * (heads * d_h * (valid + launches + len(ok)) + len(ok))
    return 100.0 * n_bytes / arith.HBM_BYTES_PER_S / seconds
