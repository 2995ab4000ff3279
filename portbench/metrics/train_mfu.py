"""The window's train steps as a share of the card's peak for the
configuration's compute type: the frozen analytic FLOPs of a step (three
forwards of every window, the AM-Softmax head included) over the window's
seconds."""

from harness import arith


def read(run):
    steps = run.counters.get("steps")
    if not steps:
        return None
    peak = arith.PEAK_BY_DTYPE[run.conf["compute_dtype"]]
    return 100.0 * steps * arith.train_step_flops(run.conf, run.counters["frames"]) / (
        run.window_s * peak)
