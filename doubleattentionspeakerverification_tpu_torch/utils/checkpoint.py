"""The JAX package's ``.npz`` checkpoints, read and written with numpy alone.

The format (JAX ``utils/checkpoint.py:28-58``): one ``.npz`` whose entries
are the leaves of the saved tree, keyed by their path joined with "/"
(``params/vgg/conv11/w``, ``model_state/bn_mean``, ``opt_state/...``), plus
``__meta__``, a uint8 array holding the UTF-8 JSON of the run's metadata,
whose ``config`` is the full ``ExperimentConfig``. The port writes the same
leaves (``utils/weights.py:train_state_to_jax``), so each package resumes
from the other's files.

Writes are atomic (a temporary file, then ``os.replace``).
:class:`AsyncCheckpointer` writes on one background thread; its caller
copies the state to the host first (the optimizer updates its tensors in
place), and the leaves may be a function of that copy, run on the writer.
``latest_checkpoint`` picks the highest step in a file name (creation time
breaks ties) and ``prune_checkpoints`` keeps the newest periodic files;
best-EER files are never pruned. ``load_checkpoint`` also reads the
sharded ``.dcp`` directories of ``utils/dist_ckpt.py``.
"""

from __future__ import annotations

import io
import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """-> (flat leaves keyed by path, meta), from a ``.npz`` or a ``.dcp``
    directory (``utils/dist_ckpt.py``); a JAX ``.orbax`` directory is
    refused with the way across."""
    from . import dist_ckpt

    if dist_ckpt.is_orbax(path):
        raise ValueError(dist_ckpt.ORBAX_REFUSAL.format(path=path))
    if dist_ckpt.is_dcp(path):
        return dist_ckpt.load_checkpoint_dcp(path)
    with np.load(path, allow_pickle=False) as z:
        if "__meta__" not in z.files:
            raise ValueError(f"{path} has no __meta__ entry; not a checkpoint of this format")
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    return flat, meta


def save_checkpoint(path: str, flat: Mapping[str, np.ndarray], meta: Dict[str, Any]) -> str:
    """Atomic write of flat host leaves + meta to ``path`` (.npz)."""
    entries = {k: np.asarray(v) for k, v in flat.items()}
    entries["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **entries)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)
    return path


class AsyncCheckpointer:
    """Non-blocking checkpoint writes on one background thread.

    ``save`` takes host leaves, or a function that returns them from a host
    copy the caller has made (the JAX layout's transposes then run on the
    writer), and hands serialization and disk IO to the writer. A
    newer save to the SAME path supersedes a queued one; saves to distinct
    paths all land. ``then`` runs on the writer right after its file lands
    (the trainer prunes there, so the directory it leaves does not depend on
    how fast the disk was). ``wait`` drains outstanding writes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._pending: Dict[str, Tuple[Any, Dict[str, Any], Optional[Callable]]] = {}
        self.error: Optional[BaseException] = None

    def save(self, path: str,
             flat: Union[Mapping[str, np.ndarray], Callable[[], Mapping[str, np.ndarray]]],
             meta: Dict[str, Any], then: Optional[Callable[[], None]] = None) -> str:
        with self._lock:
            self._pending[path] = (flat if callable(flat) else dict(flat), meta, then)
            # _drain clears self._thread under this same lock before exiting,
            # so checking the attribute cannot lose a save
            if self._thread is None:
                self._thread = threading.Thread(target=self._drain, name="checkpoint",
                                                daemon=True)
                self._thread.start()
        return path

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    self._thread = None
                    return
                path = next(iter(self._pending))
                flat, meta, then = self._pending.pop(path)
            try:
                save_checkpoint(path, flat() if callable(flat) else flat, meta)
                if then is not None:
                    then()
            except BaseException as e:  # surfaced by wait()
                self.error = e

    def wait(self, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                t = self._thread
            if t is None:
                break
            t.join(max(0.0, deadline - time.monotonic()))
            if time.monotonic() >= deadline:
                break
        if self.error is not None:
            err, self.error = self.error, None
            raise err


_STEP_RE = re.compile(r"_(\d+)\.npz$")


def checkpoint_path(out_dir: str, model_name: str, step: int) -> str:
    return os.path.join(out_dir, f"{model_name}_{step}.npz")


def latest_checkpoint(out_dir: str) -> Optional[str]:
    """The ``.npz`` with the highest step in its name; creation time breaks
    ties (JAX ``latest_checkpoint``)."""
    if not os.path.isdir(out_dir):
        return None
    best = None
    best_key = None
    for fname in os.listdir(out_dir):
        if not fname.endswith(".npz"):
            continue
        full = os.path.join(out_dir, fname)
        m = _STEP_RE.search(fname)
        step = int(m.group(1)) if m else -1
        key = (step, os.path.getctime(full))
        if best_key is None or key > best_key:
            best, best_key = full, key
    return best


def prune_checkpoints(out_dir: str, model_name: str, keep: int, protect: Tuple[str, ...] = ()) -> None:
    """Keep the newest ``keep`` periodic checkpoints. Best-EER checkpoints
    (``*_best_*.npz``) and the paths in ``protect`` are never pruned."""
    if keep <= 0 or not os.path.isdir(out_dir):
        return
    entries = []
    for fname in os.listdir(out_dir):
        if fname.startswith(model_name) and fname.endswith(".npz"):
            full = os.path.join(out_dir, fname)
            if full in protect or "_best_" in fname:
                continue
            m = _STEP_RE.search(fname)
            entries.append((int(m.group(1)) if m else -1, full))
    entries.sort()
    for _, full in entries[:-keep] if len(entries) > keep else []:
        os.remove(full)
