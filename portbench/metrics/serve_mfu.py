"""Forward FLOPs of the answered uploads at their true lengths (the
encoder, pooling and embedding layers; serving computes no AM-Softmax) over
the traced window and the float32 peak."""

from harness import arith


def read(run):
    ok = [r for r in run.requests if r["status"] == 200]
    if not ok or run.trace is None:
        return None
    flops = sum(arith.forward_flops(run.conf, arith.frames_of(r["samples"]), head=False)
                for r in ok)
    return 100.0 * flops / (run.trace.window_s * arith.PEAK_BY_DTYPE[run.conf["compute_dtype"]])
