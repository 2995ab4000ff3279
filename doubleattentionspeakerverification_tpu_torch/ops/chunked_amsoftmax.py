"""AM-Softmax cross-entropy over the classes in chunks (JAX
``ops/chunked_amsoftmax.py``), for speaker counts whose (B, n_classes)
logits would not fit.

The columns of ``W`` are walked ``chunk`` at a time with an online max and
sum of exponentials, so the forward holds (B, chunk) logits at once; each
chunk's body runs under ``torch.utils.checkpoint``, so the backward
recomputes it instead of keeping it, as ``jax.checkpoint`` does. The last
chunk is clamped to start at ``n_classes - chunk``, and the columns it
covers again are masked out. The margin, annealing, scale and the accuracy
(argmax of the unmargined cosine) are the dense head's
(``models/amsoftmax.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..models.amsoftmax import annealing_alpha, unit_columns, unit_rows


def _chunk_body(x_n, w, label, alpha, run_max, run_sum, gold, best, best_arg,
                c_idx: int, chunk: int, s: float, m: float):
    n_classes = w.shape[1]
    start = min(c_idx * chunk, n_classes - chunk)
    costh = x_n @ unit_columns(w[:, start:start + chunk])              # (B, chunk)
    col = start + torch.arange(chunk, device=x_n.device)[None, :]       # class ids
    valid = col >= c_idx * chunk        # drop the clamped last chunk's overlap
    is_gold = (col == label[:, None]) & valid
    costh_m = costh - torch.where(is_gold, m, 0.0)
    combined = (costh_m + alpha * costh) / (1.0 + alpha)
    logits = torch.where(valid, s * combined, -torch.inf)
    new_max = torch.maximum(run_max, logits.amax(dim=-1))
    run_sum = run_sum * torch.exp(run_max - new_max) + torch.exp(logits - new_max[:, None]).sum(-1)
    gold = gold + torch.where(is_gold, logits, 0.0).sum(-1)
    costh_v = torch.where(valid, costh, -torch.inf).detach()
    c_best, c_arg = costh_v.max(dim=-1)
    take = c_best > best
    return (new_max, run_sum, gold, torch.where(take, c_best, best),
            torch.where(take, start + c_arg, best_arg))


def chunked_amsoftmax_ce(w: torch.Tensor, x: torch.Tensor, label: torch.Tensor, step,
                         cfg: ModelConfig, chunk: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean CE, accuracy) of the AM-Softmax head ``w`` (emb, n_classes) on
    x (B, emb) and label (B,), without the full (B, n_classes) logits."""
    n_classes = w.shape[1]
    b = x.shape[0]
    chunk = min(chunk, n_classes)
    x_n = unit_rows(x)
    alpha = (annealing_alpha(step) if cfg.annealing else torch.tensor(0.0)).to(x.device)
    label = label.to(torch.int64)
    carry = (torch.full((b,), -torch.inf, device=x.device), torch.zeros(b, device=x.device),
             torch.zeros(b, device=x.device), torch.full((b,), -torch.inf, device=x.device),
             torch.zeros(b, dtype=torch.int64, device=x.device))
    for c_idx in range(-(-n_classes // chunk)):
        carry = checkpoint(_chunk_body, x_n, w, label, alpha, *carry, c_idx, chunk,
                           cfg.scaling_factor, cfg.margin_factor, use_reentrant=False)
    run_max, run_sum, gold, _, best_arg = carry
    ce = (torch.log(run_sum) + run_max - gold).mean()
    return ce, (best_arg == label).to(torch.float32).mean()
