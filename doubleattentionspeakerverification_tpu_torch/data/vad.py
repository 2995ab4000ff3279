"""Voice-activity filtering: the port's own copy of the JAX package's
``data/vad.py`` (numpy).

The reference declares a VAD hook but never uses it
(``scripts/data.py:7-19``: ``featureReader(path, VAD=None)`` — ``VAD.filter``
would drop frames from the (80, T) feature matrix). This module provides a
working implementation of that hook: a simple energy VAD over log-mel frames
plus the same filter interface, so the capability actually exists here.
"""

from __future__ import annotations

import numpy as np


class EnergyVAD:
    """Drop frames whose log-mel energy is far below the utterance's peak.

    ``threshold_db``: frames with mean log-mel energy more than this many dB
    below the utterance's 95th-percentile energy are removed.
    ``min_frames``: never reduce an utterance below this many frames.
    """

    def __init__(self, threshold_db: float = 30.0, min_frames: int = 10):
        self.threshold_db = threshold_db
        self.min_frames = min_frames

    def frame_mask(self, features: np.ndarray) -> np.ndarray:
        """features (n_mels, T) raw log-mel -> (T,) bool keep-mask."""
        # mean log-energy per frame; log-mel is natural log, dB = 10*log10(e)
        e = features.mean(axis=0)
        ref = np.percentile(e, 95)
        thr = ref - self.threshold_db / (10.0 * np.log10(np.e))
        mask = e >= thr
        if mask.sum() < min(self.min_frames, len(mask)):
            order = np.argsort(e)[::-1][: self.min_frames]
            mask = np.zeros_like(mask)
            mask[order] = True
        return mask

    def filter(self, features: np.ndarray) -> np.ndarray:
        """Reference hook interface: (n_mels, T) -> (n_mels, T_kept)."""
        return features[:, self.frame_mask(features)]


def feature_reader(feature_path: str, vad: "EnergyVAD | None" = None) -> np.ndarray:
    """Reference ``featureReader`` semantics (``data.py:7-19``): unpickle
    (80, T), optionally VAD-filter, transpose to (T, 80); falls back to the
    unfiltered features if the filter empties the utterance."""
    import pickle

    with open(feature_path, "rb") as f:
        features = pickle.load(f)
    filtered = vad.filter(features) if vad is not None else features
    if filtered.shape[1] > 0:
        return np.transpose(filtered)
    return np.transpose(features)
