"""Attention pooling family (reference ``poolings.py``), mask-aware, eval path.

- ``AttentionPooling``   — single learned-vector attention (poolings.py:14-27)
- ``MHAPooling``         — level-1 multi-head attention (poolings.py:73-109);
                           kernel B1 on the card (``ops/mha_pool.py``)
- ``HeadAttention``      — level-2 attention over the head vectors
                           (poolings.py:29-71). Train-time head dropout comes
                           with the training slice.
- ``DoubleMHAPooling``   — the paper's Double MHA (poolings.py:112-129)
- ``StatisticalPooling`` — masked mean + std pooling (baseline variant)

Parameters keep the reference's shapes and the JAX package's names:
``query`` (d_h, H), ``att`` (dim, 1). The MHA score scale divides by
sqrt(heads_number) under the reference's ``d_k = heads`` quirk
(``ModelConfig.mha_dk_is_heads``, poolings.py:75-76).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.masked_ops import length_mask, masked_softmax
from ..ops.mha_pool import mha_pool


class AttentionPooling(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.att = nn.Parameter(torch.empty(dim, 1))

    def forward(self, ht: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, T, D) -> (B, D)."""
        scores = (ht @ self.att)[..., 0]                                   # (B, T)
        mask = None if lengths is None else length_mask(lengths, ht.shape[1])
        w = masked_softmax(scores, mask, dim=-1)
        return torch.einsum("bt,btd->bd", w, ht)


class MHAPooling(nn.Module):
    def __init__(self, encoder_size: int, heads: int, dk_is_heads: bool = True):
        super().__init__()
        if encoder_size % heads:
            raise ValueError(f"encoder size {encoder_size} is not a multiple of {heads} heads")
        self.heads = heads
        self.dk_is_heads = dk_is_heads
        self.query = nn.Parameter(torch.empty(encoder_size // heads, heads))

    def forward(self, ht: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, T, D) -> per-head contexts (B, H, d_h)."""
        return mha_pool(ht, self.query, lengths, self.heads, self.dk_is_heads)


class HeadAttention(nn.Module):
    def __init__(self, head_size: int):
        super().__init__()
        self.att = nn.Parameter(torch.empty(head_size, 1))

    def forward(self, heads_ctx: torch.Tensor) -> torch.Tensor:
        """(B, H, d_h) -> (B, d_h), softmax over the heads."""
        w = torch.softmax((heads_ctx @ self.att)[..., 0], dim=-1)
        return torch.einsum("bh,bhd->bd", w, heads_ctx)


class DoubleMHAPooling(nn.Module):
    def __init__(self, encoder_size: int, heads: int, dk_is_heads: bool = True):
        super().__init__()
        self.mha = MHAPooling(encoder_size, heads, dk_is_heads)
        self.head_att = HeadAttention(encoder_size // heads)

    def forward(self, ht: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        return self.head_att(self.mha(ht, lengths))


class StatisticalPooling(nn.Module):
    def __init__(self, eps: float = 1e-8):
        super().__init__()
        self.eps = eps

    def forward(self, ht: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, T, D) -> masked mean ++ std (B, 2D)."""
        if lengths is None:
            mean = ht.mean(dim=1)
            var = ((ht - mean[:, None]) ** 2).mean(dim=1)
        else:
            mask = length_mask(lengths, ht.shape[1])[..., None]
            denom = torch.clamp(lengths, min=1)[:, None].to(ht.dtype)
            mean = torch.where(mask, ht, 0.0).sum(dim=1) / denom
            var = torch.where(mask, (ht - mean[:, None]) ** 2, 0.0).sum(dim=1) / denom
        return torch.cat([mean, torch.sqrt(var + self.eps)], dim=-1)


class _FlatMHA(MHAPooling):
    """MHA as a pooling layer: the head contexts flattened to (B, D)."""

    def forward(self, ht, lengths):
        return super().forward(ht, lengths).flatten(1)


def make_pooling(cfg: ModelConfig, encoder_size: int) -> nn.Module:
    method, heads = cfg.pooling_method, cfg.heads_number
    if method == "Attention":
        return AttentionPooling(encoder_size)
    if method == "MHA":
        return _FlatMHA(encoder_size, heads, cfg.mha_dk_is_heads)
    if method == "DoubleMHA":
        return DoubleMHAPooling(encoder_size, heads, cfg.mha_dk_is_heads)
    if method == "StatisticalPooling":
        return StatisticalPooling()
    raise ValueError(f"unknown pooling_method {method!r}")


def pooled_dim(method: str, encoder_size: int, heads: int) -> int:
    """Output dim of the pooling layer (reference ``model.py:32-41``)."""
    if method in ("Attention", "MHA"):
        return encoder_size
    if method == "DoubleMHA":
        return encoder_size // heads
    if method == "StatisticalPooling":
        return 2 * encoder_size
    raise ValueError(f"unknown pooling_method {method!r}")
