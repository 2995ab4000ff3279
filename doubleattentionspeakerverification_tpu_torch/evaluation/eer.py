"""Cosine scoring (the EER sweeps come later)."""

from __future__ import annotations

import numpy as np


def cosine_scores(emb1: np.ndarray, emb2: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Batched cosine similarity, torch ``F.cosine_similarity`` semantics
    (reference ``utils.py:18-21``): denominators clamped at eps per vector."""
    n1 = np.maximum(np.linalg.norm(emb1, axis=-1), eps)
    n2 = np.maximum(np.linalg.norm(emb2, axis=-1), eps)
    return np.sum(emb1 * emb2, axis=-1) / (n1 * n2)
