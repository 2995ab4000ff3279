"""Two-covariance PLDA backend (training + pair LLR scoring): the port's own
copy of the JAX package's ``evaluation/plda.py`` (numpy float64 on the host,
as there; the ``.npz`` model file is the same, so either package loads the
other's).

The reference scores trials with raw cosine only (``scripts/utils.py:18-21``).
PLDA is the classic probabilistic backend on top of speaker embeddings:
model each embedding as ``x = y + e`` with speaker factor
``y ~ N(mu, B)`` (between-speaker covariance) and residual
``e ~ N(0, W)`` (within-speaker covariance); a trial score is the
log-likelihood ratio of same-speaker vs different-speaker for the pair.

Training is EM on labeled embeddings (Brümmer's two-covariance model):

  E-step per speaker s (n_s utterances, mean m_s):
      L_s      = B^-1 + n_s W^-1              (posterior precision of y_s)
      y_hat_s  = L_s^-1 (B^-1 mu + n_s W^-1 m_s)
  M-step over speakers S and utterances N:
      mu = mean_s y_hat_s
      B  = mean_s [ L_s^-1 + (y_hat_s - mu)(y_hat_s - mu)^T ]
      W  = (1/N) sum_s [ sum_i (x_si - y_hat_s)(x_si - y_hat_s)^T + n_s L_s^-1 ]

Scoring (centered x, T = B + W the total covariance):

  LLR(x1, x2) = 0.5 x1^T Q x1 + 0.5 x2^T Q x2 + x1^T P x2 + const
      A = (T - B T^-1 B)^-1          (Schur complement of the joint cov)
      Q = T^-1 - A
      P = T^-1 B A
      const = 0.5 (log|T| - log|T - B T^-1 B|)

Embeddings are length-normalized (L2) before everything — the standard
recipe for cosine-trained embeddings (Garcia-Romero & Espy-Wilson 2011),
and what makes PLDA composable with this framework's AM-Softmax models.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np


def _length_norm(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), eps)


@dataclass
class PLDA:
    mu: np.ndarray           # (d,)  global speaker-factor mean
    between: np.ndarray      # (d,d) B
    within: np.ndarray       # (d,d) W
    length_norm: bool = True

    # ------------------------------------------------------------- training
    @classmethod
    def fit(
        cls,
        embeddings: np.ndarray,
        labels: Sequence,
        n_iters: int = 10,
        length_norm: bool = True,
        jitter: float = 1e-6,
    ) -> "PLDA":
        """EM fit on (N, d) embeddings with per-row speaker labels."""
        x = np.asarray(embeddings, np.float64)
        if length_norm:
            x = _length_norm(x)
        labels = np.asarray(labels)
        speakers = np.unique(labels)
        if len(speakers) < 2:
            raise ValueError("PLDA needs >= 2 speakers")
        d = x.shape[1]
        groups = [x[labels == s] for s in speakers]
        counts = np.array([len(g) for g in groups])
        means = np.stack([g.mean(axis=0) for g in groups])
        n_total = int(counts.sum())

        # moment initialization: between/within scatter
        mu = x.mean(axis=0)
        within = sum(
            ((g - m).T @ (g - m)) for g, m in zip(groups, means)
        ) / max(1, n_total - len(speakers))
        between = ((means - mu).T * counts) @ (means - mu) / counts.sum()
        eye = np.eye(d)
        within = within + jitter * eye
        between = between + jitter * eye

        for _ in range(n_iters):
            b_inv = np.linalg.inv(between)
            w_inv = np.linalg.inv(within)
            y_hats, l_invs = [], {}
            # E-step: posterior per distinct utterance count (L_s depends
            # only on n_s, so factor the inversions)
            for n in np.unique(counts):
                l_invs[int(n)] = np.linalg.inv(b_inv + n * w_inv)
            for g, m, n in zip(groups, means, counts):
                y_hats.append(l_invs[int(n)] @ (b_inv @ mu + n * (w_inv @ m)))
            y_hats = np.stack(y_hats)

            # M-step
            mu = y_hats.mean(axis=0)
            dev = y_hats - mu
            between = (
                sum(l_invs[int(n)] for n in counts) + dev.T @ dev
            ) / len(speakers)
            w_acc = np.zeros((d, d))
            for g, y, n in zip(groups, y_hats, counts):
                r = g - y
                w_acc += r.T @ r + n * l_invs[int(n)]
            within = w_acc / n_total
            between = between + jitter * eye
            within = within + jitter * eye

        return cls(mu=mu, between=between, within=within, length_norm=length_norm)

    # -------------------------------------------------------------- scoring
    def _score_matrices(self) -> Tuple[np.ndarray, np.ndarray, float]:
        t = self.between + self.within
        t_inv = np.linalg.inv(t)
        schur = t - self.between @ t_inv @ self.between
        a = np.linalg.inv(schur)
        q = t_inv - a
        p = t_inv @ self.between @ a
        _, logdet_t = np.linalg.slogdet(t)
        _, logdet_s = np.linalg.slogdet(schur)
        const = 0.5 * (logdet_t - logdet_s)
        return q, p, const

    def score_pairs(self, emb1: np.ndarray, emb2: np.ndarray) -> np.ndarray:
        """LLR for row-aligned embedding pairs; (n,) float64."""
        x1 = np.atleast_2d(np.asarray(emb1, np.float64))
        x2 = np.atleast_2d(np.asarray(emb2, np.float64))
        if self.length_norm:
            x1, x2 = _length_norm(x1), _length_norm(x2)
        x1 = x1 - self.mu
        x2 = x2 - self.mu
        q, p, const = self._score_matrices()
        return (
            0.5 * np.einsum("nd,dk,nk->n", x1, q, x1)
            + 0.5 * np.einsum("nd,dk,nk->n", x2, q, x2)
            + np.einsum("nd,dk,nk->n", x1, p, x2)
            + const
        )

    def score_trials(
        self, trials: Sequence[Tuple[str, str]], embeddings: Dict[str, np.ndarray]
    ) -> np.ndarray:
        e1 = np.stack([embeddings[a] for a, _ in trials])
        e2 = np.stack([embeddings[b] for _, b in trials])
        return self.score_pairs(e1, e2)

    # ---------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            mu=self.mu,
            between=self.between,
            within=self.within,
            meta=np.frombuffer(
                json.dumps({"length_norm": bool(self.length_norm)}).encode(),
                dtype=np.uint8,
            ),
        )

    @classmethod
    def load(cls, path: str) -> "PLDA":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta"].tobytes()).decode())
            return cls(
                mu=z["mu"],
                between=z["between"],
                within=z["within"],
                length_norm=bool(meta["length_norm"]),
            )
