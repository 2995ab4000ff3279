"""Multi-process initialization and the collectives of the port's parallel
paths (JAX ``parallel/distributed.py``).

Every process runs the same program on its own device and the same global
batch stream; ``data/dataset.py``'s loader assembles only this process's
rows of it (``parallel/mesh.py:host_batch_rows``), as the JAX package's
multi-host loader does. ``initialize`` joins the processes into one
``torch.distributed`` group. The topology comes from its arguments, or from
the JAX package's variables (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), or from torchrun's
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), which take the
place of JAX's cluster auto-detection. The address is ``host:port`` (or
``tcp://host:port``; process 0 listens there) or ``file:///path`` (a file
store, for processes on one machine).

The backend follows a rule: NCCL where every process of a machine has a
card of its own, gloo where processes share a card or run on the CPU (gloo
carries CUDA tensors for all-reduce and broadcast, which is all that the
collectives below use). Process ``r`` trains on ``cuda:<local rank % card
count>`` unless the caller asks for the CPU.

The collectives take a process group and do nothing when it is ``None``:
``parallel/mesh.py`` hands out ``None`` for an axis of size 1. Three of them
are differentiable, each with the backward its use needs:

- :func:`all_reduce_sum`: sum forward, sum backward. BatchNorm's batch
  statistics over the data ranks: each rank's loss depends on every rank's
  rows through them.
- :func:`reduce_from`: sum forward, identity backward. A value whose sum is
  replicated on every rank of the group, where every rank takes the same
  loss from it (the sharded AM-Softmax's sum of exponentials): the gradient
  arriving on each rank is already the whole gradient, and summing it again
  would make it the group's size times too large.
- :func:`copy_to`: identity forward, sum backward. The input of the sharded
  AM-Softmax: each model rank sees the part of its gradient that flows
  through its own columns.
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class HostInfo:
    host_id: int
    num_hosts: int
    local_device_count: int
    global_device_count: int
    backend: str = "none"      # "nccl", "gloo", or "none" for one process
    device: str = "cpu"        # this process's device


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def topology(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
             process_id: Optional[int] = None) -> Tuple[Optional[str], Optional[int], Optional[int]]:
    """(address, process count, process id) from the arguments, else the
    JAX package's variables, else torchrun's."""
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS") or None
    n = num_processes if num_processes is not None else _env_int("JAX_NUM_PROCESSES")
    pid = process_id if process_id is not None else _env_int("JAX_PROCESS_ID")
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if n is None:
        n = _env_int("WORLD_SIZE")
    if pid is None:
        pid = _env_int("RANK")
    return addr, n, pid


def _store(address: str, n: int, pid: int):
    if address.startswith("file://"):
        return dist.FileStore(address[len("file://"):], n)
    host, _, port = address[len("tcp://"):].rpartition(":") if address.startswith("tcp://") \
        else address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r}: give host:port, tcp://host:port "
                         "or file:///path")
    return dist.TCPStore(host, int(port), n, is_master=(pid == 0), timeout=TIMEOUT)


def choose_backend(device: str, local_processes: int) -> str:
    """NCCL when each process of this machine has a card of its own; gloo
    when they share one, or train on the CPU."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available() \
            and local_processes <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _info(device: str) -> HostInfo:
    n_local = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    if not dist.is_initialized():
        dev = "cuda" if torch.device(device).type == "cuda" else "cpu"
        return HostInfo(0, 1, n_local, n_local, "none", dev)
    world = dist.get_world_size()
    dev = f"cuda:{torch.cuda.current_device()}" if torch.device(device).type == "cuda" else "cpu"
    return HostInfo(dist.get_rank(), world, n_local, world, dist.get_backend(), dev)


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, force: bool = False,
               device: str = "cuda") -> HostInfo:
    """Join this process to the run's process group; a no-op for one
    process and when the group exists already (a process may run
    ``cli.train.main`` several times on one group). ``force`` joins even a
    group of one process."""
    if dist.is_initialized():
        return _info(device)
    addr, n, pid = topology(coordinator_address, num_processes, process_id)
    if not (force or addr is not None) or (n == 1 and not force):
        return _info(device)
    if addr is None:
        raise ValueError("multi-process training needs a coordinator: --coordinator_address, "
                         "JAX_COORDINATOR_ADDRESS, or torchrun's MASTER_ADDR/MASTER_PORT")
    if n is None or pid is None:
        raise ValueError("multi-process training needs the process count and this process's "
                         "id: --num_processes/--process_id, JAX_NUM_PROCESSES/JAX_PROCESS_ID, "
                         "or torchrun's WORLD_SIZE/RANK")
    if not 0 <= pid < n:
        raise ValueError(f"process id {pid} outside 0..{n - 1}")
    store = _store(addr, n, pid)
    me = socket.gethostname()
    store.set(f"host/{pid}", me)
    hosts = [store.get(f"host/{r}").decode() for r in range(n)]
    local_rank, local_world = hosts[:pid].count(me), hosts.count(me)
    backend = choose_backend(device, local_world)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.PrefixStore("pg", store), rank=pid,
                            world_size=n, timeout=TIMEOUT)
    info = _info(device)
    print(f"distributed: process {pid} of {n}, backend {backend}, device {info.device}, "
          f"{local_world} process(es) on {me}", flush=True)
    return info


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


# ------------------------------------------------------ differentiable sums
class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the backward sums the gradients too."""
    return t if group is None else _AllReduceSum.apply(t, group)


def reduce_from(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the backward passes the gradient through."""
    return t if group is None else _ReduceFrom.apply(t, group)


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    """The identity; the backward sums the gradient over the group."""
    return t if group is None else _CopyTo.apply(t, group)


# ------------------------------------------------------ plain collectives
def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` (no gradient); returns it."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """(group size, *t.shape): every rank's ``t`` by group rank, as a sum
    of zero-padded copies (exact: each entry adds zeros to one value), with
    only all-reduce, which gloo also carries for CUDA tensors."""
    n = group_size(group)
    out = torch.zeros((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    out[group_rank(group)] = t
    return all_reduce_(out, group)


def comm_device(group=None) -> torch.device:
    """Where host values travel for a collective: the current card under
    NCCL, the CPU under gloo."""
    if dist.is_initialized() and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_np(arr, group=None, src: int = 0) -> np.ndarray:
    """Process ``src``'s value of ``arr`` (the same shape and dtype on every
    process) on every process of the default group (or ``group``)."""
    a = np.ascontiguousarray(arr)
    if not dist.is_initialized():
        return a
    t = torch.from_numpy(a.copy()).to(comm_device(group))
    dist.broadcast(t, src=src, group=group)
    return t.cpu().numpy()


def all_gather_np(arr, group=None) -> np.ndarray:
    """(processes, *arr.shape): every process's ``arr``, by rank."""
    a = np.ascontiguousarray(arr)
    if not dist.is_initialized():
        return a[None]
    if group is None:
        group = dist.group.WORLD
    t = torch.from_numpy(a.copy()).to(comm_device(group))
    return all_gather_rows(t, group).cpu().numpy()

