"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, reduced to what the per-layer readers and the result's
``breakdown`` need.

The window is marked by a ``portbench.window`` annotation on the host's
timeline. Device time is every kernel, copy and memset of the trace's
device events, clipped to that annotation; idle gaps are the stretches of
the window in which none ran, each named by the innermost host event that
covers its middle (or ``host: untraced python`` where none does).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
WINDOW = "portbench.window"
NAME_CHARS = 96
MIN_GAP_US = 50.0          # shorter idle stretches are launch gaps, not named


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]           # name -> (seconds, launches)
    classes: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def class_seconds(self, name: str) -> float:
        return self.classes.get(name, (0.0, 0))[0]

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(((n[:NAME_CHARS], s) for n, (s, _) in self.kernels.items()),
                     key=lambda x: -x[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in sorted(self.gaps, key=lambda x: -x[1])[:10]]}


class Profiler:
    """``torch.profiler`` with host and device activity, started and stopped
    around the measured window; the trace goes to a temporary file in
    ``TMPDIR`` and is removed once read."""

    def __init__(self, cuda: bool):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.mark = torch.profiler.record_function(WINDOW)

    def start(self) -> None:
        self.prof.start()
        self.mark.__enter__()

    def stop(self) -> str:
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".pt.trace.json")
        os.close(fd)
        self.prof.export_chrome_trace(path)
        return path


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(path: str, classes: Dict[str, List[str]]) -> Optional[TraceSummary]:
    """The summary of the chrome trace at ``path``, which it removes; None
    where the trace has no window mark."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    marks = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if not marks:
        return None
    w0 = min(float(e["ts"]) for e in marks)
    w1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in marks)
    dev, host = [], []
    kernels: Dict[str, Tuple[float, int]] = {}
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            s, n = kernels.get(e["name"], (0.0, 0))
            kernels[e["name"]] = (s + (b - a) * 1e-6, n + 1)
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host.append((a, b, e["name"]))
    busy = _union(dev)
    busy_us = sum(b - a for a, b in busy)
    holes, prev = [], w0
    for a, b in busy:
        if a - prev >= MIN_GAP_US:
            holes.append((prev, a))
        prev = max(prev, b)
    if w1 - prev >= MIN_GAP_US:
        holes.append((prev, w1))
    holes = sorted(holes, key=lambda h: h[0] - h[1])[:10]
    gaps = []
    for a, b in holes:
        mid = 0.5 * (a + b)
        covering = [(hb - ha, name) for ha, hb, name in host if ha <= mid <= hb]
        label = min(covering)[1] if covering else "host: untraced python"
        gaps.append((f"{label[:NAME_CHARS]} @{(a - w0) * 1e-6:.3f}s", (b - a) * 1e-6))
    summary = TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6, kernels=kernels,
                           gaps=gaps)
    for cls, patterns in classes.items():
        rx = re.compile("|".join(patterns))
        hit = [v for k, v in kernels.items() if rx.search(k)]
        summary.classes[cls] = (sum(s for s, _ in hit), sum(n for _, n in hit))
    return summary
