"""Device timing and bounds on one H100.

Peaks are NVIDIA's data-sheet figures for the H100 SXM at its full 700 W
power limit, dense (no sparsity); a card set to a lower limit runs slower
under load, so every time is reported beside ``nvidia-smi``'s name and
power limit.
"""

from __future__ import annotations

from typing import Callable, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12        # CUDA cores, outside the tensor cores
BF16_OPS_PER_S = 989e12       # tensor cores
INT8_OPS_PER_S = 1979e12      # tensor cores


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float) -> Tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def eager_ms(fn: Callable[[], object], iters: int, warmup: int = 3) -> float:
    """Time of one eager ``fn`` call between CUDA events, host work
    included: every call is a launch, so a kernel's launch count is the
    calls made (``warmup + iters``)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn: Callable[[], object], iters: int, replays: int = 10) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's work between launches is not counted
    (inputs stay in L2 where they fit, as after the producing kernel)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * iters)
