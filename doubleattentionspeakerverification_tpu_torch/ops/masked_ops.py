"""Mask-aware primitive ops shared across the model.

Masks make bucketed padded batches give the same results as unpadded
forwards (the reference never pads, so it has no masking at all).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # finite -inf stand-in: keeps masked softmax NaN-free


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int -> (B, max_len) bool validity mask."""
    return torch.arange(max_len, device=lengths.device) < lengths[..., None]


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor], dim: int) -> torch.Tensor:
    """Numerically stable softmax that gives masked slots zero weight.

    ``mask`` broadcasts against ``scores`` (True = valid). If every slot
    along ``dim`` is masked the result is all-zero rather than NaN.
    """
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=dim, keepdim=True)
    # fully masked rows: shift by 0 there so exp() stays finite
    e = torch.exp(scores - torch.where(m <= NEG_INF * 0.5, 0.0, m))
    if mask is not None:
        e = torch.where(mask, e, 0.0)
    return e / torch.clamp(e.sum(dim=dim, keepdim=True), min=1e-30)


def mask_time(x: torch.Tensor, lengths: Optional[torch.Tensor], dim: int = 1) -> torch.Tensor:
    """Zero the frames at or past ``lengths`` (B,) along time axis ``dim``
    of a batch-first tensor."""
    if lengths is None:
        return x
    mask = length_mask(lengths, x.shape[dim])
    mask = mask.reshape(mask.shape[:1] + (1,) * (dim - 1) + mask.shape[1:] + (1,) * (x.dim() - dim - 1))
    return torch.where(mask, x, 0.0)
