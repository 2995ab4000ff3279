"""The optimizers of the train step as ``torch.optim`` (JAX
``training/optimizers.py``, reference ``train.py:82-95``).

Adam, SGD without momentum, and RMSprop share the learning rate and the
weight decay; torch's ``weight_decay`` is L2 folded into the gradient before
the update, as the JAX package's ``optax.add_decayed_weights`` ahead of the
core is. The learning rate lives in ``param_groups`` so the trainer can
halve it (``train.py:90-95``).
"""

from __future__ import annotations

from typing import Iterable

import torch

from ..config import TrainConfig


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    lr, wd = cfg.learning_rate, cfg.weight_decay
    if cfg.optimizer == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    if cfg.optimizer == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=0.0, weight_decay=wd)
    if cfg.optimizer == "RMSprop":
        # v = 0.99 v + 0.01 g^2; update g / (sqrt(v) + eps)
        return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8, weight_decay=wd)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def with_lr(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer
