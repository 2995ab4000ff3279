"""Cosine scoring and the EER sweeps (JAX ``evaluation/eer.py``).

``eer_reference`` follows the reference's threshold sweep
(``train.py:135-149`` + ``utils.py:5-16``): 200 thresholds in
arange(-1, 1, 0.01); FRR = % of client scores < th and FAR = % of impostor
scores >= th, each rounded to 4 decimals; the EER is the mean of FAR and
FRR at the first sign change of FAR - FRR (rounded to 4), else 50.0.
``eer_exact`` interpolates the ROC crossing; ``min_dcf`` is the NIST
minimum normalized detection cost.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def far_frr(scores: np.ndarray, thresholds: np.ndarray):
    """(% of scores >= th, % of scores < th) at each threshold, unrounded."""
    s = np.sort(np.asarray(scores, dtype=np.float64))
    n = len(s)
    below = np.searchsorted(s, thresholds, side="left")
    return (n - below) * 100.0 / n, below * 100.0 / n


def eer_reference(client_scores: Sequence[float], impostor_scores: Sequence[float]) -> float:
    thresholds = np.arange(-1, 1, 0.01)
    _, frr_c = far_frr(np.asarray(client_scores), thresholds)
    far_i, _ = far_frr(np.asarray(impostor_scores), thresholds)
    frr = np.round(frr_c, 4)
    far = np.round(far_i, 4)
    idx = np.argwhere(np.diff(np.sign(far - frr)) != 0).reshape(-1)
    if len(idx) > 0:
        i = int(idx[0])
        return round((far[i] + frr[i]) / 2, 4)
    return 50.00


def eer_exact(client_scores: Sequence[float], impostor_scores: Sequence[float]) -> float:
    """ROC EER with linear interpolation at the FAR == FRR crossing (in %)."""
    clients = np.asarray(client_scores, dtype=np.float64)
    impostors = np.asarray(impostor_scores, dtype=np.float64)
    thresholds = np.unique(np.concatenate([clients, impostors]))
    far, _ = far_frr(impostors, thresholds)
    _, frr = far_frr(clients, thresholds)
    d = far - frr
    cross = np.where(d <= 0)[0]
    if len(cross) == 0:
        return 50.0
    i = cross[0]
    if i == 0 or d[i] == 0:
        return float((far[i] + frr[i]) / 2)
    t = d[i - 1] / (d[i - 1] - d[i])
    far_x = far[i - 1] + t * (far[i] - far[i - 1])
    frr_x = frr[i - 1] + t * (frr[i] - frr[i - 1])
    return float((far_x + frr_x) / 2)


def min_dcf(client_scores: Sequence[float], impostor_scores: Sequence[float],
            p_target: float = 0.01, c_miss: float = 1.0, c_fa: float = 1.0) -> float:
    """Minimum normalized detection cost over every distinct score threshold
    and a reject-everything one (so it is at most 1)."""
    clients = np.asarray(client_scores, dtype=np.float64)
    impostors = np.asarray(impostor_scores, dtype=np.float64)
    scores = np.concatenate([clients, impostors])
    thresholds = np.unique(np.concatenate([scores, [scores.max() + 1.0]]))
    far, _ = far_frr(impostors, thresholds)
    _, frr = far_frr(clients, thresholds)
    p_miss, p_fa = frr / 100.0, far / 100.0
    dcf = c_miss * p_miss * p_target + c_fa * p_fa * (1.0 - p_target)
    return float(np.min(dcf / min(c_miss * p_target, c_fa * (1.0 - p_target))))


def cosine_scores(emb1: np.ndarray, emb2: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Batched cosine similarity, torch ``F.cosine_similarity`` semantics
    (reference ``utils.py:18-21``): denominators clamped at eps per vector."""
    n1 = np.maximum(np.linalg.norm(emb1, axis=-1), eps)
    n2 = np.maximum(np.linalg.norm(emb2, axis=-1), eps)
    return np.sum(emb1 * emb2, axis=-1) / (n1 * n2)
