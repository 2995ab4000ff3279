"""Metrics logging: a copy of the JAX package's ``utils/logging.py``.

The reference logs with bare prints (``train.py:192-194,171-173``). Here a
small structured logger: console lines, an optional JSONL metrics file (one
JSON object per event) for downstream tooling, and an optional TensorBoard
scalar sink (``utils/tensorboard.py``, a dependency-free event-file
writer): every numeric field of an event becomes the scalar
``{event}/{field}`` at the event's step (the last step seen for an event
without one).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional


class MetricLogger:
    def __init__(
        self,
        jsonl_path: Optional[str] = None,
        stream=None,
        tensorboard_dir: Optional[str] = None,
    ):
        self.jsonl_path = jsonl_path
        self.stream = stream or sys.stdout
        self._fh = open(jsonl_path, "a") if jsonl_path else None
        self._tb = None
        self._tb_step = 0  # last seen global step, for step-less events
        if tensorboard_dir:
            from .tensorboard import TensorBoardWriter

            self._tb = TensorBoardWriter(tensorboard_dir)

    def log(self, event: str, **fields: Any) -> None:
        ts = time.time()
        parts = [f"{k}={self._fmt(v)}" for k, v in fields.items()]
        print(f"[{event}] " + " ".join(parts), file=self.stream, flush=True)
        if self._fh:
            rec: Dict[str, Any] = {"event": event, "time": ts}
            rec.update({k: self._plain(v) for k, v in fields.items()})
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._tb:
            step = fields.get("step")
            if isinstance(step, (int, float)) and not isinstance(step, bool):
                self._tb_step = int(step)
            for k, v in fields.items():
                if k == "step" or isinstance(v, bool):
                    continue
                num = self._number(v)
                if num is not None:
                    self._tb.add_scalar(f"{event}/{k}", num, self._tb_step, ts)
            # events come at print-window cadence, so a flush per event is
            # cheap; it keeps live dashboards current and survives a
            # watchdog os._exit (which skips finalizers)
            self._tb.flush()

    @staticmethod
    def _fmt(v) -> str:
        if isinstance(v, float):
            return f"{v:.4f}"
        return str(v)

    @staticmethod
    def _plain(v):
        try:
            return float(v)
        except (TypeError, ValueError):
            return str(v)

    @staticmethod
    def _number(v) -> Optional[float]:
        """Numeric scalars only: strings and paths never become points."""
        if isinstance(v, (int, float)):
            return float(v)
        try:  # 0-d numpy arrays and tensors
            if getattr(v, "shape", None) == () or getattr(v, "ndim", None) == 0:
                return float(v)
        except (TypeError, ValueError):
            pass
        return None

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb:
            self._tb.close()
            self._tb = None
