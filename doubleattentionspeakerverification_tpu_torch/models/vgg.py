"""VGG conv front-ends (reference ``CNNs.py``) in PyTorch.

NCHW inside, as torch convolutions want: (B, T, F) features become
(B, 1, T, F). The output keeps the reference's channel-major flatten
(B, T', C*F') (JAX ``models/vgg.py:138-140``), so head slicing downstream
matches. Valid-length tracking makes padded batches equal to unpadded
forwards: invalid frames are re-zeroed after every ReLU (so zero padding
equals the conv's boundary padding) and lengths follow the ceil-mode pools.
The convolutions are cuDNN's through ``F.conv2d``; they were XLA convs
outside any kernel in the JAX package too.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.masked_ops import mask_time


def vgg_channel_plan(front_end: str, kernel_size: int) -> Tuple[Tuple[int, int], ...]:
    """Per-block (in, out) channel pairs. VGG3L: k/4, k/2, k (``CNNs.py:22-33``);
    VGG4L: k/8, k/4, k/2, k (``CNNs.py:54-67``)."""
    k = kernel_size
    if front_end == "VGG3L":
        chans = [k // 4, k // 2, k]
    elif front_end == "VGG4L":
        chans = [k // 8, k // 4, k // 2, k]
    else:
        raise ValueError(f"unknown front_end {front_end!r}")
    plan, prev = [], 1
    for c in chans:
        plan.append((prev, c))
        prev = c
    return tuple(plan)


def vgg_output_dim(front_end: str, kernel_size: int, feature_size: int = 80) -> int:
    """Ceil-halve the freq axis per block, times channels (``CNNs.py:7-20``)."""
    f = feature_size
    for _ in vgg_channel_plan(front_end, kernel_size):
        f = math.ceil(f / 2)
    return f * kernel_size


def _ceil_half(lengths: torch.Tensor) -> torch.Tensor:
    return torch.div(lengths + 1, 2, rounding_mode="floor")


def output_lengths(lengths: torch.Tensor, front_end: str) -> torch.Tensor:
    """Valid time length through the ceil-mode pool stack."""
    n_blocks = 3 if front_end == "VGG3L" else 4
    out = lengths
    for _ in range(n_blocks):
        out = _ceil_half(out)
    return out


class VGG(nn.Module):
    """(B, T, F) features -> (B, T', C*F') encodings + valid output lengths.

    Per block (``CNNs.py:68-91``): conv3x3+ReLU, conv3x3+ReLU, 2x2 ceil-mode
    max-pool. Parameters are named ``conv{block}{1,2}`` as in the JAX
    package and the reference.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.front_end = cfg.front_end
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        plan = vgg_channel_plan(cfg.front_end, cfg.kernel_size)
        self.n_blocks = len(plan)
        for i, (cin, cout) in enumerate(plan):
            self.add_module(f"conv{i + 1}1", nn.Conv2d(cin, cout, 3, padding=1))
            self.add_module(f"conv{i + 1}2", nn.Conv2d(cout, cout, 3, padding=1))

    def _conv(self, h: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(h.to(dt), conv.weight.to(dt), conv.bias.to(dt), padding=1)

    def forward(
        self, x: torch.Tensor, lengths: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h = mask_time(x, lengths)[:, None]          # (B, 1, T, F)
        cur_len = lengths
        for i in range(1, self.n_blocks + 1):
            for j in (1, 2):
                h = F.relu(self._conv(h, getattr(self, f"conv{i}{j}")))
                # post-ReLU values are >= 0, so a ceil-mode window straddling
                # the valid boundary picks the valid value
                h = mask_time(h, cur_len, dim=2)
            h = F.max_pool2d(h, kernel_size=2, stride=2, ceil_mode=True)
            if cur_len is not None:
                cur_len = _ceil_half(cur_len)
        # (B, C, T', F') -> reference channel-major flatten (B, T', C*F')
        b, c, t, f = h.shape
        out = h.permute(0, 2, 1, 3).reshape(b, t, c * f)
        return out.to(torch.float32), cur_len
