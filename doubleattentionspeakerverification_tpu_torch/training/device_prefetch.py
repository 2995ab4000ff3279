"""Host -> device batch pipeline (JAX ``training/device_prefetch.py``).

With ``depth`` 0 each batch is a plain ``.to(device, non_blocking=True)``
per tensor as the loop asks for it. With ``depth`` > 0 a background thread
puts each batch into pinned host memory and copies it on a side CUDA
stream, ``depth`` batches ahead; it records an event after the copies, the
consuming stream waits on that event, and ``record_stream`` keeps each
buffer alive until the work queued on the consuming stream has used it. On
the CPU there is nothing to copy and the thread only converts.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np
import torch

Batch = Dict[str, Any]


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))


def _to_device(batch: Batch, device: torch.device) -> Batch:
    return {k: _as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def device_prefetch(batches: Iterator[Batch], depth: int = 2,
                    device="cuda") -> Iterator[Batch]:
    """Yield batches of tensors on ``device``, copying ``depth`` ahead."""
    device = torch.device(device)
    if depth <= 0 or device.type != "cuda":
        for b in batches:
            yield _to_device(b, device)
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    side = torch.cuda.Stream(device=device)

    def worker():
        try:
            for b in batches:
                if stop.is_set():
                    return
                pinned = {k: _as_tensor(v).pin_memory() for k, v in b.items()}
                with torch.cuda.stream(side):
                    out = {k: v.to(device, non_blocking=True) for k, v in pinned.items()}
                    done = torch.cuda.Event()
                    done.record(side)
                # the pinned buffers stay referenced until the event has fired
                q.put((out, done, pinned))
        except BaseException as e:
            q.put(e)
            return
        q.put(None)

    th = threading.Thread(target=worker, name="device_prefetch", daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            out, done, _pinned = item
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in out.values():
                t.record_stream(consumer)
            yield out
    finally:
        stop.set()
        while th.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        th.join(timeout=5)
