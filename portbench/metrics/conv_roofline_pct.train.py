"""The VGG convolutions' direct-form operations of the window's steps over
the device time of the convolution and matrix-product kernels in the trace
(the ``conv_gemm`` class of ``kernel_classes.json``), against the peak of
the configuration's compute type."""

from harness import arith


def read(run):
    steps = run.counters.get("steps")
    if run.trace is None or not steps:
        return None
    seconds = run.trace.class_seconds("conv_gemm")
    if seconds <= 0:
        return None
    peak = arith.PEAK_BY_DTYPE[run.conf["compute_dtype"]]
    return 100.0 * steps * arith.train_step_conv_flops(run.conf, run.counters["frames"]) / (
        peak * seconds)
