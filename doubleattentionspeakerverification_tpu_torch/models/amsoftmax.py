"""Additive-Margin Softmax head (reference ``loss.py:5-70``; JAX
``models/amsoftmax.py``).

Cosine logits between the L2-normalized embedding and the L2-normalized
columns of ``W`` (emb, n_classes); the margin is a one-hot subtract at the
label. Annealing (``loss.py:26-35``): alpha(step) = max(0, 1000 / (1 +
1e-4 * step)^2), combined = (costh_m + alpha * costh) / (1 + alpha), and the
logits are s * combined.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig

NORM_EPS = 1e-12  # the reference's torch.norm(...).clamp(min=1e-12)


def annealing_alpha(step) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    return torch.clamp(1000.0 / torch.square(1.0 + 1e-4 * step), min=0.0)


def annealed_factor(step, cfg: ModelConfig) -> torch.Tensor:
    """``getAnnealedFactor`` (``loss.py:26-28``): 1 / (1 + alpha)."""
    alpha = annealing_alpha(step) if cfg.annealing else torch.tensor(0.0)
    return 1.0 / (1.0 + alpha)


def unit_columns(w: torch.Tensor) -> torch.Tensor:
    return w / torch.clamp(torch.linalg.vector_norm(w, dim=0, keepdim=True), min=NORM_EPS)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=NORM_EPS)


def cosine_logits(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """costh = x_hat @ W_hat: (B, emb), (emb, n_classes) -> (B, n_classes)."""
    return unit_rows(x) @ unit_columns(w)


def amsoftmax_logits(w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor, step,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(costh, scaled margin logits), as ``AMSoftmax.forward``: costh feeds
    accuracy, the logits feed the cross-entropy."""
    costh = cosine_logits(w, x)
    delt = F.one_hot(labels.to(torch.int64), costh.shape[-1]).to(costh.dtype) * cfg.margin_factor
    costh_m = costh - delt
    if cfg.annealing:
        alpha = annealing_alpha(step).to(costh.device)
        combined = (costh_m + alpha * costh) / (1.0 + alpha)
    else:
        combined = costh_m
    return costh, cfg.scaling_factor * combined


class AMSoftmax(nn.Module):
    """``predictionLayer``: ``W`` (in_feats, n_classes)."""

    def __init__(self, in_feats: int, n_classes: int):
        super().__init__()
        self.W = nn.Parameter(torch.empty(in_feats, n_classes))

    def forward(self, x: torch.Tensor, labels: torch.Tensor, step,
                cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
        return amsoftmax_logits(self.W, x, labels, step, cfg)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of logsumexp - gold (``nn.CrossEntropyLoss``)."""
    gold = logits.gather(-1, labels.to(torch.int64)[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def focal_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        gamma: float = 2.0) -> torch.Tensor:
    """Focal softmax (``loss.py:54-70``): (1 - p)^gamma * CE with p = exp(-CE),
    on the batch-mean CE as the reference computes it."""
    return focal_of(cross_entropy(logits, labels), gamma)


def focal_of(ce: torch.Tensor, gamma: float = 2.0) -> torch.Tensor:
    """The focal loss of a batch-mean cross-entropy ``ce``."""
    return (1.0 - torch.exp(-ce)) ** gamma * ce
