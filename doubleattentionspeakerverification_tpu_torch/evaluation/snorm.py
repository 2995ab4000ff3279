"""Adaptive score normalization (S-norm / AS-Norm) for trial scoring: the
port's own copy of the JAX package's ``evaluation/snorm.py`` (numpy float64
on the host, as there).

Not present in the reference — its scoring is raw cosine similarity
(``scripts/train.py:117-133`` + ``scripts/utils.py:18-21``). Score
normalization is the standard production companion to a cosine backend:
each trial score is re-centered against the score distribution of its two
sides over a *cohort* of held-out utterances, removing per-utterance score
offsets (duration, channel, acoustic mismatch). AS-Norm is the adaptive
variant (Matejka et al., "Analysis of Score Normalization in Multilingual
Speaker Recognition", Interspeech 2017): the statistics use only each
utterance's top-K most-similar cohort scores.

For a trial (e, t) with raw cosine s:

    s' = 0.5 * ((s - mu_e) / sd_e + (s - mu_t) / sd_t)

where mu_u/sd_u are the mean/std of u's cosine scores against its top-K
cohort neighbours (K=0 or K>=N uses the full cohort — plain S-norm).

Normalized scores are z-scores, NOT bounded to [-1, 1]; the reference's
threshold-sweep EER (``eer_reference``, fixed -1..1 grid) does not apply to
them — report ``eer_exact`` / ``min_dcf`` instead (the CLI does exactly
this).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from .eer import cosine_scores


def _unit(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), eps)


def cohort_stats(
    embs: np.ndarray, cohort: np.ndarray, topk: int = 0, eps: float = 1e-8
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row cohort score statistics.

    ``embs`` (M, d) scored against ``cohort`` (N, d) by cosine; returns
    (mu (M,), sd (M,)) over each row's top-``topk`` cohort scores
    (``topk`` <= 0 or >= N: all of them). ``sd`` is floored at ``eps``.
    """
    cohort = np.asarray(cohort, np.float64)
    if cohort.ndim != 2 or cohort.shape[0] == 0:
        raise ValueError(f"cohort must be a non-empty (N, d) matrix, got {cohort.shape}")
    scores = _unit(np.asarray(embs, np.float64), eps) @ _unit(cohort, eps).T  # (M, N)
    n = cohort.shape[0]
    if 0 < topk < n:
        scores = np.partition(scores, n - topk, axis=1)[:, n - topk :]
    mu = scores.mean(axis=1)
    sd = np.maximum(scores.std(axis=1), eps)
    return mu, sd


def asnorm_trial_scores(
    trials: Sequence[Tuple[str, str]],
    embeddings: Dict[str, np.ndarray],
    cohort: np.ndarray,
    topk: int = 0,
) -> np.ndarray:
    """AS-Norm scores for utterance-id trials given an embedding map.

    Cohort statistics are computed once per unique utterance (each id
    usually appears in many trials), then applied per pair.
    """
    utts = sorted({u for pair in trials for u in pair})
    mu, sd = cohort_stats(np.stack([embeddings[u] for u in utts]), cohort, topk)
    stat = {u: (mu[i], sd[i]) for i, u in enumerate(utts)}

    e1 = np.stack([embeddings[a] for a, _ in trials])
    e2 = np.stack([embeddings[b] for _, b in trials])
    raw = cosine_scores(e1, e2)
    mu1, sd1 = (np.array([stat[a][k] for a, _ in trials]) for k in (0, 1))
    mu2, sd2 = (np.array([stat[b][k] for _, b in trials]) for k in (0, 1))
    return 0.5 * ((raw - mu1) / sd1 + (raw - mu2) / sd2)
