"""Tracing and profiling (JAX ``utils/profiling.py``).

The reference's only observability is wall-clock prints
(``train.py:102,173,193``). Here: a ``torch.profiler`` trace context manager
(CPU ops, and on the card the CUDA kernels through CUPTI), written as a
Chrome / Perfetto JSON trace (``*.pt.trace.json``, which TensorBoard's
profiler plugin also reads), a step window for the trainer, and a
throughput meter that tracks the framework's north-star metric,
audio-seconds per second per device.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Iterator, Optional

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync(sync=None) -> None:
    """Wait for the device work issued so far: a host read of ``sync``, if
    given, and the card's synchronize where CUDA is in use."""
    if sync is not None:
        sync.cpu() if isinstance(sync, torch.Tensor) else float(sync)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _export(prof: "torch.profiler.profile", log_dir: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    host = socket.gethostname().split(".")[0] or "localhost"
    path = os.path.join(log_dir, f"{host}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Capture a trace of the enclosed region into ``log_dir``; yields the
    profiler (``key_averages()`` for tables)."""
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        _export(prof, log_dir)


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


class StepProfiler:
    """Trace a window of optimizer steps to ``log_dir``.

    A bounded capture of steps ``[start_step, start_step + num_steps)``:
    long enough to see the steady state, short enough not to distort a
    production run. Call :meth:`before_step` at the top of the step loop
    with the upcoming step index; pass the previous step's device metrics
    as ``sync`` so the capture closes only after that step's device work is
    done. The trace's path is :attr:`path` once written; the profiler of
    the last window stays in :attr:`profile`.
    """

    def __init__(self, log_dir: str, start_step: int, num_steps: int):
        self.log_dir = log_dir
        self.start = start_step
        self.num_steps = max(1, num_steps)
        self.active = False
        self.done = not log_dir
        self.profile: Optional[torch.profiler.profile] = None
        self.path: Optional[str] = None

    def _stop(self, sync) -> None:
        _sync(sync)
        self.profile.stop()
        self.path = _export(self.profile, self.log_dir)
        self.active = False
        self.done = True

    def before_step(self, step: int, sync=None) -> Optional[str]:
        """Returns 'started' / 'stopped' on transitions, else None."""
        if self.done:
            return None
        if not self.active and step >= self.start:
            self.profile = torch.profiler.profile(activities=_activities())
            self.profile.start()
            self.active = True
            return "started"
        if self.active and step >= self.start + self.num_steps:
            self._stop(sync)
            return "stopped"
        return None

    def close(self, sync=None) -> None:
        """Stop a still-open capture (training ended inside the window)."""
        if self.active:
            self._stop(sync)


class ThroughputMeter:
    """Sliding throughput counters for the training loop."""

    def __init__(self, window_audio_s: float, samples_per_step: int, n_chips: int = 1):
        self.window_audio_s = window_audio_s
        self.samples_per_step = samples_per_step
        self.n_chips = max(1, n_chips)
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self, n: int = 1) -> None:
        self._steps += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def audio_seconds_per_second_per_chip(self) -> Optional[float]:
        if self._steps == 0 or self.elapsed <= 0:
            return None
        audio = self._steps * self.samples_per_step * self.window_audio_s
        return audio / self.elapsed / self.n_chips

    def steps_per_second(self) -> Optional[float]:
        if self._steps == 0 or self.elapsed <= 0:
            return None
        return self._steps / self.elapsed
