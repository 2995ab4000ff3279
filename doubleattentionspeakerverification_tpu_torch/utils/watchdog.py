"""Stall detection: a copy of the JAX package's ``utils/watchdog.py``.

The reference has no failure detection at all (SURVEY §5) — a hung data
loader or a wedged device call stalls training silently until slurm kills
the job. This watchdog observes a heartbeat the train loop beats every step
and invokes a callback (default: log loudly) when no progress happens for
``timeout_s``. It never kills anything itself — surfacing the stall (with
the last step and age) is the job; the requeue mechanism handles recovery.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

THREAD_NAME = "stall-watchdog"


class Watchdog:
    def __init__(
        self,
        timeout_s: float = 600.0,
        on_stall: Optional[Callable[[float, int], None]] = None,
        poll_s: float = 5.0,
    ):
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self.on_stall = on_stall or self._default_report
        self._last_beat = time.monotonic()
        self._last_step = -1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0

    def beat(self, step: int) -> None:
        self._last_beat = time.monotonic()
        self._last_step = step

    def start(self) -> "Watchdog":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name=THREAD_NAME, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s * 2)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            age = time.monotonic() - self._last_beat
            if age > self.timeout_s:
                self.stall_count += 1
                self.on_stall(age, self._last_step)
                self._last_beat = time.monotonic()  # avoid spamming

    @staticmethod
    def _default_report(age: float, step: int) -> None:
        print(
            f"[watchdog] TRAINING STALLED: no step progress for {age:.0f}s "
            f"(last completed step {step})",
            flush=True,
        )
