"""Attention pooling family (reference ``poolings.py``), mask-aware.

- ``AttentionPooling``   — single learned-vector attention (poolings.py:14-27)
- ``MHAPooling``         — level-1 multi-head attention (poolings.py:73-109);
                           kernel B1 on the card (``ops/mha_pool.py``) unless
                           its ``use_kernel`` is False (the kernel dispatcher's
                           choice, set at the construction sites by
                           ``utils/kernel_auto.py:route_model``)
- ``HeadAttention``      — level-2 attention over the head vectors
                           (poolings.py:29-71), with train-time head dropout
- ``DoubleMHAPooling``   — the paper's Double MHA (poolings.py:112-129)
- ``StatisticalPooling`` — masked mean + std pooling (baseline variant)

Parameters keep the reference's shapes and the JAX package's names:
``query`` (d_h, H), ``att`` (dim, 1). The MHA score scale divides by
sqrt(heads_number) under the reference's ``d_k = heads`` quirk
(``ModelConfig.mha_dk_is_heads``, poolings.py:75-76).

Head dropout (poolings.py:36-43, JAX ``models/poolings.py:126-153``): in
``train()`` each head's score is masked to ``NEG_INF`` with probability
``1 / int(1 / mask_prob)``; a row whose heads are all dropped keeps its
scores. The caller gives the keep mask (:func:`draw_head_keep`; the train
step draws it for the global batch), so tests can feed the JAX package's
draws.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.masked_ops import NEG_INF, length_mask, masked_softmax
from ..ops.mha_pool import mha_pool, mha_pool_alignments


class AttentionPooling(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.att = nn.Parameter(torch.empty(dim, 1))

    def forward(self, ht: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, T, D) -> (B, D)."""
        return torch.einsum("bt,btd->bd", self.alignments(ht, lengths), ht)

    def alignments(self, ht: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        """The weights over time (B, T)."""
        scores = (ht @ self.att)[..., 0]
        mask = None if lengths is None else length_mask(lengths, ht.shape[1])
        return masked_softmax(scores, mask, dim=-1)


class MHAPooling(nn.Module):
    def __init__(self, encoder_size: int, heads: int, dk_is_heads: bool = True,
                 use_kernel: bool = True):
        super().__init__()
        if encoder_size % heads:
            raise ValueError(f"encoder size {encoder_size} is not a multiple of {heads} heads")
        self.heads = heads
        self.dk_is_heads = dk_is_heads
        self.use_kernel = use_kernel
        self.query = nn.Parameter(torch.empty(encoder_size // heads, heads))

    def forward(self, ht: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, T, D) -> per-head contexts (B, H, d_h)."""
        return mha_pool(ht, self.query, lengths, self.heads, self.dk_is_heads, self.use_kernel)

    def alignments(self, ht: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        """Each head's weights over time (B, T, H), from the plain version."""
        return mha_pool_alignments(ht, self.query, lengths, self.heads, self.dk_is_heads)


def draw_head_keep(batch: int, heads: int, mask_prob: float,
                   generator: torch.Generator) -> torch.Tensor:
    """(batch, heads) bool keep mask: a head is dropped where a draw from
    U{0 .. int(1/mask_prob) - 1} is 0, as JAX's ``randint(rng, (B, H), 0, n) > 0``."""
    n_levels = int(1.0 / mask_prob)
    return torch.randint(0, n_levels, (batch, heads), generator=generator,
                         device=generator.device) > 0


class HeadAttention(nn.Module):
    def __init__(self, head_size: int, mask_prob: float = 0.0):
        super().__init__()
        self.mask_prob = mask_prob
        self.att = nn.Parameter(torch.empty(head_size, 1))

    def forward(self, heads_ctx: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, H, d_h) -> (B, d_h), softmax over the heads. In ``train()``
        with ``mask_prob > 0``, heads where ``keep`` (B, H) is False are
        dropped; ``keep`` is then required."""
        scores = (heads_ctx @ self.att)[..., 0]
        if self.training and self.mask_prob > 0:
            if keep is None:
                raise ValueError("head dropout in train mode needs a keep mask (draw_head_keep)")
            keep = keep.to(scores.device)
            masked = torch.where(keep, scores, NEG_INF)
            scores = torch.where(keep.any(dim=-1, keepdim=True), masked, scores)
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("bh,bhd->bd", w, heads_ctx)

    def alignments(self, heads_ctx: torch.Tensor) -> torch.Tensor:
        """The weights over heads (B, H), as in eval mode (no head dropout)."""
        return torch.softmax((heads_ctx @ self.att)[..., 0], dim=-1)


class DoubleMHAPooling(nn.Module):
    def __init__(self, encoder_size: int, heads: int, dk_is_heads: bool = True,
                 mask_prob: float = 0.0, use_kernel: bool = True):
        super().__init__()
        self.mha = MHAPooling(encoder_size, heads, dk_is_heads, use_kernel)
        self.head_att = HeadAttention(encoder_size // heads, mask_prob)

    def forward(self, ht: torch.Tensor, lengths: Optional[torch.Tensor],
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.head_att(self.mha(ht, lengths), keep)

    def alignments(self, ht: torch.Tensor, lengths: Optional[torch.Tensor]):
        """(time weights (B, T, H), head weights (B, H)); the head contexts
        pooled with the plain version's weights."""
        w = self.mha.alignments(ht, lengths)
        b, t, _ = ht.shape
        heads_ctx = torch.einsum("bth,bthd->bhd", w,
                                 ht.reshape(b, t, w.shape[-1], -1).to(torch.float32))
        return w, self.head_att.alignments(heads_ctx)


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
    """The pooling layer; an MHA pooling takes B1 on the card unless
    ``cfg.use_pallas_pooling`` is False (auto, None, is resolved where the
    model is run: ``utils/kernel_auto.py``)."""
    method, heads = cfg.pooling_method, cfg.heads_number
    use_kernel = cfg.use_pallas_pooling is not False
    if method == "Attention":
        return AttentionPooling(encoder_size)
    if method == "MHA":
        return _FlatMHA(encoder_size, heads, cfg.mha_dk_is_heads, use_kernel)
    if method == "DoubleMHA":
        return DoubleMHAPooling(encoder_size, heads, cfg.mha_dk_is_heads, cfg.mask_prob,
                                use_kernel)
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
