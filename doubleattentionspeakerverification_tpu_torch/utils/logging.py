"""Metrics logging: a copy of the JAX package's ``utils/logging.py``.

The reference logs with bare prints (``train.py:192-194,171-173``). Here a
small structured logger: console lines and an optional JSONL metrics file
(one JSON object per event) for downstream tooling. The JAX package's
TensorBoard sink is not ported (ROADMAP Queue A item 8): a
``tensorboard_dir`` is refused.
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
        if tensorboard_dir:
            raise ValueError("tensorboard_dir: the TensorBoard sink is not ported yet "
                             "(ROADMAP Queue A item 8)")
        self.jsonl_path = jsonl_path
        self.stream = stream or sys.stdout
        self._fh = open(jsonl_path, "a") if jsonl_path else None

    def log(self, event: str, **fields: Any) -> None:
        ts = time.time()
        parts = [f"{k}={self._fmt(v)}" for k, v in fields.items()]
        print(f"[{event}] " + " ".join(parts), file=self.stream, flush=True)
        if self._fh:
            rec: Dict[str, Any] = {"event": event, "time": ts}
            rec.update({k: self._plain(v) for k, v in fields.items()})
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

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

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
