"""Seeded parameter initialization from a ``torch.Generator``.

The same distributions as the JAX package's ``models/init.py`` (which mirror
the reference): torch's default ``kaiming_uniform_(a=sqrt(5))`` with the
matching uniform bias bound for convolutions and linears, ``xavier_normal_``
for the attention vectors. The draws differ from JAX's for the same seed;
tests that need equal weights carry JAX's through ``utils/weights.py``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def kaiming_uniform(shape: Sequence[int], fan_in: int, generator: torch.Generator,
                    a: float = math.sqrt(5.0)) -> torch.Tensor:
    """bound = sqrt(6 / ((1 + a^2) * fan_in))."""
    bound = math.sqrt(2.0 / (1.0 + a * a)) * math.sqrt(3.0 / fan_in)
    return (torch.rand(tuple(shape), generator=generator) * 2.0 - 1.0) * bound


def uniform_bias(shape: Sequence[int], fan_in: int, generator: torch.Generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return (torch.rand(tuple(shape), generator=generator) * 2.0 - 1.0) * bound


def xavier_normal(shape: Sequence[int], generator: torch.Generator, gain: float = 1.0) -> torch.Tensor:
    """std = gain * sqrt(2 / (fan_in + fan_out)), torch's fans for 2-D
    tensors: fan_in = shape[1], fan_out = shape[0]."""
    fan_out, fan_in = shape[0], shape[1]
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn(tuple(shape), generator=generator) * std


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of a freshly built model in place, in
    the order of ``model.named_modules()``: convolution and linear layers
    (weight, then bias) with torch's defaults, attention vectors with
    ``xavier_normal``, BatchNorm at weight 1, bias 0, running mean 0 and
    running variance 1."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            fan_in = module.weight[0].numel()
            module.weight.copy_(kaiming_uniform(module.weight.shape, fan_in, generator))
            module.bias.copy_(uniform_bias(module.bias.shape, fan_in, generator))
        elif isinstance(module, nn.BatchNorm1d):
            module.weight.fill_(1.0)
            module.bias.fill_(0.0)
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
            module.num_batches_tracked.zero_()
        else:
            for p in module.parameters(recurse=False):
                p.copy_(xavier_normal(p.shape, generator))
    return model
