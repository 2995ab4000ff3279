"""The AM-Softmax cross-entropy with ``W`` split over the 'model' ranks
(JAX ``parallel/sharded_amsoftmax.py``).

Each model rank holds ``W``'s columns [lo, hi) and computes the cosine
logits of its speakers; the margin goes on at the label's owner only. The
softmax over all speakers needs a global maximum (an all-reduce MAX, a
stabilizer taken without gradient: logsumexp's gradient does not depend on
it), the sum of exponentials and the gold logit (all-reduce sums whose
backward passes the gradient through, ``distributed.reduce_from``: every
model rank takes the same loss from them). The embedding enters through
``distributed.copy_to``, whose backward sums over the model ranks the parts
of its gradient that flow through each rank's columns, so the trunk below
gets the whole gradient on every rank. Accuracy takes the global maximum of
the cosines and the lowest owning speaker index on a tie.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import ModelConfig
from ..models.amsoftmax import annealing_alpha, cosine_logits
from .distributed import all_gather_rows, all_reduce_, copy_to, reduce_from
from .mesh import Mesh


def sharded_amsoftmax_ce(w_shard: torch.Tensor, x: torch.Tensor, labels: torch.Tensor, step,
                         cfg: ModelConfig, mesh: Optional[Mesh]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean cross-entropy, accuracy), both replicated over the model ranks,
    for ``x`` (B, emb) and ``labels`` (B,) replicated over them and this
    rank's ``w_shard`` (emb, n / model)."""
    group = None if mesh is None else mesh.model_group
    idx = 0 if mesh is None else mesh.model_index
    shard = w_shard.shape[1]
    n_classes = shard * (1 if mesh is None else mesh.model)
    labels = labels.to(torch.int64)
    x = copy_to(x, group)
    costh = cosine_logits(w_shard, x)                                  # (B, n / model)
    local = labels - idx * shard
    in_range = (local >= 0) & (local < shard)
    onehot = F.one_hot(torch.where(in_range, local, 0), shard).to(costh.dtype) \
        * in_range[:, None].to(costh.dtype)
    costh_m = costh - onehot * cfg.margin_factor
    if cfg.annealing:
        alpha = annealing_alpha(step).to(costh.device)
        combined = (costh_m + alpha * costh) / (1.0 + alpha)
    else:
        combined = costh_m
    logits = cfg.scaling_factor * combined
    gmax = all_reduce_(logits.detach().amax(dim=-1), group, dist.ReduceOp.MAX)
    sumexp = reduce_from(torch.exp(logits - gmax[:, None]).sum(dim=-1), group)
    gold = reduce_from((logits * onehot).sum(dim=-1), group)
    ce = (torch.log(sumexp) + gmax - gold).mean()

    with torch.no_grad():
        local_best, local_arg = costh.max(dim=-1)
        gbest = all_reduce_(local_best.clone(), group, dist.ReduceOp.MAX)
        arg = torch.where(local_best == gbest, local_arg + idx * shard,
                          torch.full_like(local_arg, n_classes + 1))
        arg = all_reduce_(arg, group, dist.ReduceOp.MIN)
        acc = (arg == labels).to(torch.float32).mean()
    return ce, acc


def sharded_cosine_scores_allgather(embeddings: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every data rank's embeddings, concatenated in rank order: each rank
    scores against the whole set."""
    group = None if mesh is None else mesh.data_group
    if group is None:
        return embeddings
    parts = all_gather_rows(embeddings.contiguous(), group)
    return parts.reshape((-1,) + tuple(embeddings.shape[1:]))
