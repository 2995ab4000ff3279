"""Length buckets and long-audio chunking shared with the JAX package's
offline extractor (``evaluation/embeddings.py``), so served and offline
embeddings follow one policy. The extractor itself comes later."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def split_long_audio(feats, chunk: int, min_tail: int = 50) -> List:
    """Non-overlapping ``chunk``-frame pieces along axis 0; a final piece
    under ``min_tail`` frames (half a second at 100 fps) is dropped."""
    segs = [feats[i : i + chunk] for i in range(0, feats.shape[0], chunk)]
    if len(segs) > 1 and segs[-1].shape[0] < min_tail:
        segs.pop()
    return segs


def weighted_unit_centroid(embs, weights) -> np.ndarray:
    """Duration-weighted mean of L2-normalized embeddings."""
    acc, wsum = None, 0.0
    for e, w in zip(embs, weights):
        e = np.asarray(e, np.float64)
        e = e / max(1e-12, float(np.linalg.norm(e)))
        acc = float(w) * e if acc is None else acc + float(w) * e
        wsum += float(w)
    return (acc / wsum).astype(np.float32)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that holds ``length``; beyond the grid, a multiple of
    the largest bucket."""
    for b in buckets:
        if length <= b:
            return b
    big = buckets[-1]
    return -(-length // big) * big
