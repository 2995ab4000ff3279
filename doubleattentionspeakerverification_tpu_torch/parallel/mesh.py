"""The ('data', 'model') layout over processes (JAX ``parallel/mesh.py``).

One process a device. Process ``r`` sits at data index ``r // model`` and
model index ``r % model``, as JAX reshapes its device list to (data, model).
Batches are split over 'data'; every leaf of the train state is replicated
except the AM-Softmax speaker matrix ``W`` (emb, n_spkrs) and its optimizer
moments, which are split by columns over 'model' (:data:`SHARDED`): the
model rank ``m`` holds columns
``[m * n / model, (m + 1) * n / model)`` (:func:`shard_columns`). Where JAX's
GSPMD inserts the collectives, the port's train step names them
(``training/step.py``, ``parallel/sharded_amsoftmax.py``): over every
process for the replicated gradients, over the data group for ``W``'s
gradient and BatchNorm's statistics, over the model group for the sharded
softmax. :func:`gather_columns` is the counterpart of JAX's
``host_local_tree`` for ``W``: every rank gets the whole matrix.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MeshConfig
from .distributed import all_gather_rows

SHARDED = "amsoftmax.W"     # the placement rule: the one parameter split over 'model'


@dataclass
class Mesh:
    """``processes[d, m]``: the process at data index d and model index m;
    ``rank`` is this process. ``data_group`` / ``model_group`` are this
    process's groups along each axis, ``None`` for an axis of size 1 or
    where no process group exists; ``world_group`` is the group of every
    process (of one, too), ``None`` where no process group exists."""

    processes: np.ndarray
    rank: int = 0
    axis_names: Tuple[str, str] = ("data", "model")
    data_group: object = field(default=None, repr=False)
    model_group: object = field(default=None, repr=False)
    world_group: object = field(default=None, repr=False)

    @property
    def data(self) -> int:
        return int(self.processes.shape[0])

    @property
    def model(self) -> int:
        return int(self.processes.shape[1])

    @property
    def size(self) -> int:
        return int(self.processes.size)

    @property
    def model_index(self) -> int:
        d, m = np.argwhere(self.processes == self.rank)[0]
        return int(m)


def make_mesh(cfg: Optional[MeshConfig] = None, world_size: Optional[int] = None,
              rank: Optional[int] = None, processes: Optional[Sequence[int]] = None) -> Mesh:
    """The layout of ``world_size`` devices (the process group's size by
    default), with JAX ``make_mesh``'s two errors. ``processes`` gives each
    device's process (one device a process by default). Where a process
    group of that size exists, this builds the axis groups: a collective
    that every process calls at the same point."""
    import torch.distributed as dist

    cfg = cfg or MeshConfig()
    live = dist.is_initialized()
    n = world_size if world_size is not None else (dist.get_world_size() if live else 1)
    model = max(1, cfg.model_axis)
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model_axis={model}")
    data = n // model if cfg.data_axis == -1 else cfg.data_axis
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    procs = np.arange(n) if processes is None else np.asarray(processes)
    if rank is None:
        rank = dist.get_rank() if live else 0
    mesh = Mesh(procs.reshape(data, model), int(rank), (cfg.data_axis_name, cfg.model_axis_name))
    if live and processes is None and n == dist.get_world_size():
        mesh.world_group = dist.group.WORLD
        grid = mesh.processes
        mesh.data_group = _axis_group([grid[:, m] for m in range(model)], rank, n)
        mesh.model_group = _axis_group([grid[d, :] for d in range(data)], rank, n)
    return mesh


def _axis_group(rank_lists, rank: int, world: int):
    """This rank's group among ``rank_lists`` (every rank creates every
    group, in one order); ``None`` for groups of one rank, the world group
    for one group of all ranks."""
    import torch.distributed as dist

    if len(rank_lists[0]) == 1:
        return None
    if len(rank_lists[0]) == world:
        return dist.group.WORLD
    mine = None
    for ranks in rank_lists:
        g = dist.new_group([int(r) for r in ranks])
        if rank in ranks:
            mine = g
    return mine


def host_batch_rows(mesh: Mesh, global_batch: int, process: Optional[int] = None) -> Tuple[int, int]:
    """This process's contiguous row range [start, stop) of the global
    batch, split over 'data' (JAX ``host_batch_rows``): the rows of every
    data index that holds one of its devices."""
    process = mesh.rank if process is None else process
    if global_batch % mesh.data:
        raise ValueError(f"global batch {global_batch} not divisible by the data axis "
                         f"({mesh.data})")
    per = global_batch // mesh.data
    rows = set()
    for d in range(mesh.data):
        if process in mesh.processes[d]:
            rows.update(range(d * per, (d + 1) * per))
    ordered = sorted(rows)
    if not ordered or ordered != list(range(ordered[0], ordered[-1] + 1)):
        raise ValueError(
            f"process {process} owns non-contiguous batch rows "
            f"{ordered} under mesh {dict(zip(mesh.axis_names, mesh.processes.shape))}; "
            "use a mesh whose 'data' axis aligns with process boundaries"
        )
    return ordered[0], ordered[-1] + 1


def shard_columns(n: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """The columns [lo, hi) of an ``n``-column matrix this model rank holds."""
    if mesh is None or mesh.model == 1:
        return 0, n
    if n % mesh.model:
        raise ValueError(f"num_spkrs {n} not divisible by the model axis ({mesh.model})")
    per = n // mesh.model
    return mesh.model_index * per, (mesh.model_index + 1) * per


def shard_model(model: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Keep only this model rank's columns of ``W`` (in place; before the
    optimizer is built)."""
    w = model.amsoftmax.W
    lo, hi = shard_columns(w.shape[1], mesh)
    if (lo, hi) != (0, w.shape[1]):
        model.amsoftmax.W = torch.nn.Parameter(w.detach()[:, lo:hi].clone())
    return model


def gather_columns(shard: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The whole matrix from every model rank's columns (a collective over
    the model group)."""
    if mesh is None or mesh.model_group is None:
        return shard
    parts = all_gather_rows(shard.detach().contiguous(), mesh.model_group)
    return torch.cat(list(parts), dim=1)
