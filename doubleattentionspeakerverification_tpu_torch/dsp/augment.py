"""SpecAugment time and frequency masks (Park et al., Interspeech 2019; JAX
``dsp/augment.py``), applied in the train step to the normalized feature
windows. Masked cells are zeroed: the features are CMN'd, so zero is the
utterance's mean.

Per sample and mask, the width is drawn from U{0..max_width} and the start
from U{0..L - width}. :func:`axis_keep` builds a keep mask from given widths
and starts (the tests feed it the JAX package's draws); :func:`draw_spans`
draws them from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Spans = Tuple[torch.Tensor, torch.Tensor]   # (widths, starts), each (B, n_masks) int


def draw_spans(generator: torch.Generator, batch: int, n_masks: int, axis_len: int,
               max_width: int) -> Spans:
    """Widths from U{0..max_width}, starts from U{0..axis_len - width}."""
    widths = torch.randint(0, max_width + 1, (batch, n_masks), generator=generator,
                           device=generator.device)
    u = torch.rand((batch, n_masks), generator=generator, device=generator.device)
    starts = (u * (axis_len - widths + 1).to(torch.float32)).to(torch.int64)
    return widths, starts


def axis_keep(spans: Spans, axis_len: int) -> torch.Tensor:
    """(B, axis_len) bool: False inside any of a sample's spans."""
    widths, starts = spans
    pos = torch.arange(axis_len, device=widths.device)[None, None, :]
    inside = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    return ~inside.any(dim=1)


def apply_masks(feats: torch.Tensor, time: Optional[Spans], freq: Optional[Spans]) -> torch.Tensor:
    """Zero a (B, T, F) batch inside the given time and frequency spans."""
    b, t, f = feats.shape
    keep = torch.ones((b, t, f), dtype=torch.bool, device=feats.device)
    if time is not None:
        keep &= axis_keep(time, t).to(feats.device)[:, :, None]
    if freq is not None:
        keep &= axis_keep(freq, f).to(feats.device)[:, None, :]
    return torch.where(keep, feats, torch.zeros((), dtype=feats.dtype, device=feats.device))


def spec_augment(feats: torch.Tensor, generator: torch.Generator, time_masks: int = 2,
                 time_width: int = 30, freq_masks: int = 2, freq_width: int = 10,
                 rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """SpecAugment on a (B, T, F) batch, its spans drawn from ``generator``.
    ``rows`` = (lo, hi, total): the batch is rows [lo, hi) of a global batch
    of ``total``; the spans are drawn for the global batch and these rows
    take theirs, so every process of a data-parallel step draws what one
    process would."""
    b, t, f = feats.shape
    lo, hi, total = rows or (0, b, b)
    time = freq = None
    if time_masks > 0 and time_width > 0:
        time = tuple(a[lo:hi] for a in draw_spans(generator, total, time_masks, t,
                                                  min(time_width, t)))
    if freq_masks > 0 and freq_width > 0:
        freq = tuple(a[lo:hi] for a in draw_spans(generator, total, freq_masks, f,
                                                  min(freq_width, f)))
    return apply_masks(feats, time, freq)
