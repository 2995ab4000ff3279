"""B2's bytes-bound time, summed over the window's uploads, over its device
time in the trace; read only where the trace holds one B2 launch an
answered upload."""

from harness import arith


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.classes.get("b2", (0.0, 0))
    ok = [r for r in run.requests if r["status"] == 200]
    if seconds <= 0 or launches != len(ok):
        return None
    bound = sum(arith.b2_bytes(r["samples"]) for r in ok) / arith.HBM_BYTES_PER_S
    return 100.0 * bound / seconds
