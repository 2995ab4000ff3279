"""Multi-process training (JAX ``parallel/``): the process group, the
('data', 'model') layout over processes, and the AM-Softmax with ``W``
split over the model ranks."""

from .distributed import HostInfo, initialize
from .mesh import Mesh, host_batch_rows, make_mesh
from .sharded_amsoftmax import sharded_amsoftmax_ce, sharded_cosine_scores_allgather

__all__ = [
    "HostInfo",
    "initialize",
    "Mesh",
    "host_batch_rows",
    "make_mesh",
    "sharded_amsoftmax_ce",
    "sharded_cosine_scores_allgather",
]
