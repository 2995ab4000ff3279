"""Sharded multi-process checkpoints over ``torch.distributed.checkpoint``
(the port's counterpart of JAX ``utils/orbax_ckpt.py``).

A checkpoint is a directory ``<name>_<step>.dcp/``: DCP's shard files and
``.metadata``, plus ``meta.json`` (the npz backend's meta dict). The leaves
are the JAX package's flat ``TrainState`` leaves (``utils/weights.py``).
Every process writes: a leaf that every process holds alike is written
once, and the AM-Softmax ``W`` and its moments, split by columns over the
model ranks, are written as each rank's columns under
``<leaf>@<lo>:<hi>``. Reading joins the columns back into whole leaves, and
a model rank takes its own columns of them (``weights.load_train_state``),
so a checkpoint written by one layout of processes resumes in any other (2
ranks with ``W`` split, to one process and back).

As in the JAX package: ``meta.json`` is written last, by process 0, once
every process's shards are written, with a barrier after it. It is the
finalization marker: :func:`latest_dcp_checkpoint` and
:func:`prune_dcp_checkpoints` count only directories that have it, so a
save cut short is never resumed from. Selected with
``TrainConfig.checkpoint_backend = "orbax"`` (the config value either
package reads); more than one process requires it.

:class:`DcpAsyncSaver` is the counterpart of JAX ``OrbaxAsyncSaver``
(``utils/orbax_ckpt.py:58-124``): ``torch.distributed.checkpoint.async_save``
writes on a thread of its own, and ``meta.json`` lands at the next
``wait()`` on the calling thread, so a save in flight is invisible to
:func:`latest_dcp_checkpoint` as one cut short is.

The JAX package's own ``.orbax`` directories cannot be read here (no orbax,
no JAX): :data:`ORBAX_REFUSAL` says how to carry one across.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .weights import is_w_leaf

SUFFIX = ".dcp"
ORBAX_REFUSAL = (
    "{path}: a .orbax directory is the JAX package's checkpoint format, which the "
    "port cannot read; convert it to .npz where the JAX package is installed "
    "(python -m doubleattentionspeakerverification_tpu.cli.convert_checkpoint "
    "--input {path} --output <name>.npz), or to .dcp from that .npz with the port's "
    "cli/convert_checkpoint.py"
)
_STEP_RE = re.compile(r"_(\d+)\.dcp$")
_SHARD_RE = re.compile(r"^(.*)@(\d+):(\d+)$")


def is_orbax(path: str) -> bool:
    return path.rstrip("/").endswith(".orbax")


def is_dcp(path: str) -> bool:
    return path.rstrip("/").endswith(SUFFIX)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _finalize_meta(path: str, meta: Dict[str, Any]) -> None:
    """Every process's shards written, then ``meta.json`` from process 0,
    then a barrier: no process sees (or prunes around) a checkpoint whose
    marker has not landed."""
    _barrier()
    if _rank() == 0:
        tmp = os.path.join(path, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(path, "meta.json"))
    _barrier()


def _dcp_state(flat: Mapping[str, np.ndarray],
               columns: Optional[Tuple[int, int]]) -> Dict[str, torch.Tensor]:
    """The leaves as DCP's state dict: ``W`` and its moments keyed by their
    ``columns`` [lo, hi) of the whole matrices (all of them by default)."""
    state = {}
    for key, value in flat.items():
        t = torch.from_numpy(np.array(value, copy=True))
        if is_w_leaf(key):
            lo, hi = columns if columns is not None else (0, t.shape[1])
            if hi - lo != t.shape[1]:
                raise ValueError(f"{key}: {t.shape[1]} columns given as [{lo}, {hi})")
            key = f"{key}@{lo}:{hi}"
        state[key] = t
    return state


def _clear(path: str) -> None:
    """Remove a leftover of a save cut short at this step (process 0), then
    a barrier: no process writes into a directory being removed."""
    if _rank() == 0 and os.path.isdir(path):
        shutil.rmtree(path)
    _barrier()


def save_checkpoint_dcp(path: str, flat: Mapping[str, np.ndarray], meta: Dict[str, Any],
                        columns: Optional[Tuple[int, int]] = None) -> str:
    """Write this process's leaves to the directory ``path``; ``W`` and its
    moments are its ``columns`` [lo, hi) of the whole matrices (all of them
    by default). A collective: every process calls it at the same point."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    state = _dcp_state(flat, columns)
    _clear(path)
    with warnings.catch_warnings():   # DCP warns that one process saves alone
        warnings.simplefilter("ignore", UserWarning)
        dcp.save(state, checkpoint_id=path, no_dist=not dist.is_initialized())
    _finalize_meta(path, meta)
    return path


class DcpAsyncSaver:
    """Asynchronous ``.dcp`` writes with ``meta.json`` deferred to
    :meth:`wait`, as JAX ``OrbaxAsyncSaver``.

    :meth:`save` first finalizes the save in flight, clears a leftover at
    ``path`` (process 0, then a barrier) and issues ``async_save``, which
    copies the leaves and returns; DCP plans and writes on its own thread.
    :meth:`wait` takes that write's result (raising its error) and then
    writes ``meta.json`` through :func:`_finalize_meta` on the calling
    thread. So save N's marker lands at the next ``wait()``: the next save,
    a best save (``block=True``), a graceful stop or the end of training,
    and a process killed between them resumes from the save before. One
    save is in flight at a time. A failing ``async_save`` raises; nothing
    falls back to a synchronous write.

    Across processes every method is a collective, called at the same step
    on every process. DCP's writer thread issues its collectives (its plan's
    gathers and its barrier) on a gloo group of its own, created here on
    every process in the same order, so they never pair with the training
    step's on the loop thread; the group also gives DCP the CPU backend that
    ``async_save`` requires where the default group is NCCL's. One process
    without ``torch.distributed`` saves with ``no_dist``."""

    def __init__(self):
        import torch.distributed as dist

        self._group = dist.new_group(backend="gloo") if dist.is_initialized() else None
        self._pending: Optional[Tuple[Any, str, Dict[str, Any]]] = None

    def save(self, path: str, flat: Mapping[str, np.ndarray], meta: Dict[str, Any],
             columns: Optional[Tuple[int, int]] = None, block: bool = False) -> str:
        import torch.distributed.checkpoint as dcp

        self.wait()
        path = os.path.abspath(path)
        state = _dcp_state(flat, columns)
        _clear(path)
        if self._group is None:
            future = dcp.async_save(state, checkpoint_id=path, no_dist=True)
        else:
            future = dcp.async_save(state, checkpoint_id=path, process_group=self._group)
        self._pending = (future, path, meta)
        if block:
            self.wait()
        return path

    def wait(self) -> None:
        """Finalize the save in flight, if any: its write's result, then
        ``meta.json`` (with the barriers around it across processes)."""
        if self._pending is None:
            return
        future, path, meta = self._pending
        self._pending = None
        future.result()
        _finalize_meta(path, meta)

    def close(self) -> None:
        self.wait()


def load_checkpoint_dcp(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """-> (the whole state's flat leaves, ``W`` and its moments joined from
    their columns; meta). Each process reads every shard file itself: no
    collective."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, "meta.json")):
        raise ValueError(f"{path} has no meta.json: not a finished .dcp checkpoint")
    md = FileSystemReader(path).read_metadata()
    state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
             for k, m in md.state_dict_metadata.items() if isinstance(m, TensorStorageMetadata)}
    with warnings.catch_warnings():   # DCP warns that a process reads alone
        warnings.simplefilter("ignore", UserWarning)
        dcp.load(state, checkpoint_id=path, no_dist=True)
    flat: Dict[str, np.ndarray] = {}
    parts: Dict[str, list] = {}
    for key, t in state.items():
        m = _SHARD_RE.match(key)
        if m is None:
            flat[key] = t.numpy()
        else:
            parts.setdefault(m.group(1), []).append((int(m.group(2)), int(m.group(3)), t.numpy()))
    for key, pieces in parts.items():
        pieces.sort(key=lambda p: p[0])
        edges = [lo for lo, _, _ in pieces] + [pieces[-1][1]]
        if edges[0] != 0 or any(hi != nxt for (_, hi, _), nxt in zip(pieces, edges[1:])):
            raise ValueError(f"{path}: the columns of {key} do not tile it: "
                             f"{[(lo, hi) for lo, hi, _ in pieces]}")
        flat[key] = np.concatenate([a for _, _, a in pieces], axis=1)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return flat, meta


def latest_dcp_checkpoint(out_dir: str) -> Optional[str]:
    """The finished ``.dcp`` with the highest step in its name; creation
    time breaks ties."""
    if not os.path.isdir(out_dir):
        return None
    best, best_key = None, None
    for fname in os.listdir(out_dir):
        full = os.path.join(out_dir, fname)
        m = _STEP_RE.search(fname)
        if m is None or not os.path.exists(os.path.join(full, "meta.json")):
            continue
        key = (int(m.group(1)), os.path.getctime(full))
        if best_key is None or key > best_key:
            best, best_key = full, key
    return best


def prune_dcp_checkpoints(out_dir: str, model_name: str, keep: int,
                          protect: Tuple[str, ...] = ()) -> None:
    """Keep the newest ``keep`` finished periodic ``.dcp`` directories; best
    ones and ``protect`` are never removed. Unfinished directories older
    than the newest finished one are leftovers of saves cut short and go
    too. Only process 0 deletes."""
    if keep <= 0 or not os.path.isdir(out_dir) or _rank() != 0:
        return
    finished, unfinished = [], []
    for fname in os.listdir(out_dir):
        full = os.path.join(out_dir, fname)
        m = _STEP_RE.search(fname)
        if (m is None or not fname.startswith(model_name) or "_best_" in fname
                or full in protect or os.path.abspath(full) in protect):
            continue
        (finished if os.path.exists(os.path.join(full, "meta.json")) else unfinished).append(
            (int(m.group(1)), full))
    finished.sort()
    doomed = [full for _, full in finished[:-keep]] if len(finished) > keep else []
    if finished:
        doomed += [full for step, full in unfinished if step < finished[-1][0]]
    for full in doomed:
        shutil.rmtree(full, ignore_errors=True)
