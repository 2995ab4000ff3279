"""Full-utterance training feature cache for wav-mode training: a copy of
the JAX package's ``data/feature_cache.py``.

The reference trains from features extracted OFFLINE once
(``scripts/featureExtractor.py:35-43`` writes ``<audio>.pickle``) and then
re-windows those cached features every epoch (``scripts/data.py:50-55``).
The online wav mode collapses extraction into training, but recomputes the
DSP for every window of every epoch.

This module restores the reference's compute-once property without the
offline stage: the first time an utterance is touched, its FULL raw log-mel
(same math as the extractor CLI) is computed on the host — native C++ SIMD
kernel when built — and memoized. Every later access is a window slice of
cached frames, i.e. steady-state wav-mode training costs exactly what
feature-mode training costs.

Two tiers:
- a RAM LRU bounded by a byte budget (``DataConfig.train_feature_cache_mb``);
- an optional disk tier (``DataConfig.train_feature_cache_dir``) holding
  reference-format pickles of raw ``(n_mels, T)`` float32 — byte-compatible
  with ``featureExtractor.py`` output, so a cache directory doubles as a
  precomputed-features directory for ``--data_source features`` runs (and an
  existing extractor output directory can seed the cache).

Windowing/normalization semantics on the cached path are EXACTLY the
reference pipeline's (``data.py:40-55``): CMN/CMVN over the full utterance,
then a random fixed window in the frame domain — unlike the uncached wav
sources, which must window PCM before features exist.
"""

from __future__ import annotations

import os
import pickle
import threading
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np

from ..config import FeatureConfig
from .dataset import normalize_np, sample_window
from .manifest import Utterance
from .wav import read_wav


class UtteranceFeatureCache:
    """Thread-safe LRU of full-utterance raw log-mel ``(T, n_mels)`` float32,
    with optional disk spill in reference pickle format."""

    def __init__(
        self,
        compute: Callable[[str], np.ndarray],
        budget_mb: float = 1024.0,
        disk_dir: str = "",
    ):
        self._compute = compute
        self._budget = int(budget_mb * 1e6)
        self._disk_dir = disk_dir
        self._lock = threading.Lock()
        self._items: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0

    # ------------------------------------------------------------------ tiers
    def _disk_path(self, key: str) -> str:
        return os.path.join(self._disk_dir, f"{key}.pickle")

    def _disk_load(self, key: str) -> Optional[np.ndarray]:
        if not self._disk_dir:
            return None
        try:
            with open(self._disk_path(key), "rb") as f:
                raw = pickle.load(f)  # (n_mels, T) — extractor CLI layout
            return np.ascontiguousarray(np.transpose(raw).astype(np.float32))
        except (OSError, pickle.UnpicklingError, EOFError):
            return None

    def _disk_store(self, key: str, feats_tm: np.ndarray) -> None:
        if not self._disk_dir:
            return
        path = self._disk_path(key)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                # (n_mels, T) float32: the exact object featureExtractor.py:42
                # pickles, so the cache dir is a valid features dir
                pickle.dump(np.transpose(feats_tm), f)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _ram_put(self, key: str, feats: np.ndarray) -> None:
        if self._budget <= 0:
            return
        with self._lock:
            if key in self._items:
                return
            self._items[key] = feats
            self._bytes += feats.nbytes
            while self._bytes > self._budget and len(self._items) > 1:
                _, old = self._items.popitem(last=False)
                self._bytes -= old.nbytes

    # ------------------------------------------------------------------- api
    def get(self, key: str) -> np.ndarray:
        """Raw full-utterance features (T, n_mels); computes + caches on miss."""
        with self._lock:
            feats = self._items.get(key)
            if feats is not None:
                self._items.move_to_end(key)
                self.hits += 1
                return feats
        feats = self._disk_load(key)
        if feats is not None:
            self.disk_hits += 1
        else:
            self.misses += 1
            feats = np.ascontiguousarray(self._compute(key), np.float32)
            self._disk_store(key, feats)
        self._ram_put(key, feats)
        return feats

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._items),
                "ram_mb": self._bytes / 1e6,
                "hits": self.hits,
                "disk_hits": self.disk_hits,
                "misses": self.misses,
            }


def _wav_logmel_compute(data_dir: str, feat_cfg: FeatureConfig) -> Callable[[str], np.ndarray]:
    """Full-wav -> raw (T, n_mels) log-mel on the host; native kernel when
    built (``native/logmel.cpp``), numpy otherwise. Same math as the
    extractor CLI / reference ``mfsc`` (featureExtractor.py:8-23)."""
    from ..utils.native import get_lib, native_read_wav, try_native_logmel

    plan = try_native_logmel(feat_cfg)
    native_decode = native_read_wav if get_lib() is not None else None

    def compute(key: str) -> np.ndarray:
        path = os.path.join(data_dir, key)
        if not path.endswith(".wav"):
            path += ".wav"
        if native_decode is not None:
            wave = native_decode(path)
        else:
            wave, _sr = read_wav(path)
            wave = wave.astype(np.float32)
        if plan is not None:
            return plan.compute(wave, "none")
        from ..dsp.features import log_mel_spectrogram_np

        return log_mel_spectrogram_np(wave, feat_cfg)

    return compute


class CachedDspWavSource:
    """Wav-mode training source with compute-once features (see module doc).

    Emits the same ``(window (t, n_mels) float32, t)`` items as
    :class:`..data.dataset.FeaturePickleSource` — byte-identical to training
    from extractor-CLI pickles of the same wavs (tested) — so the trainer
    runs its feature path (``is_wave=False``).
    """

    def __init__(
        self,
        data_dir: str,
        feat_cfg: FeatureConfig,
        window_frames: int,
        normalization: str = "cmn",
        cache_mb: float = 1024.0,
        cache_dir: str = "",
    ):
        self.normalization = normalization
        self.window = window_frames
        self.cache = UtteranceFeatureCache(
            _wav_logmel_compute(data_dir, feat_cfg),
            budget_mb=cache_mb,
            disk_dir=cache_dir,
        )

    def load(self, utt: Utterance, rng: np.random.Generator):
        feats = normalize_np(self.cache.get(utt.path), self.normalization)
        win = sample_window(feats, self.window, rng)
        return win, win.shape[0]


def estimate_feature_working_set_mb(
    data_dir: str, utt_paths, sample: int = 64
) -> float:
    """Rough full-corpus feature-RAM estimate from a deterministic sample of
    wav file sizes (evenly strided through the manifest, so every host of a
    multi-host run computes the identical number).

    At the reference constants, f32 log-mel features cost almost exactly the
    PCM16 bytes they came from: 80 mels x 4 B per 160-sample hop x 2 B/sample
    = 320/320 bytes — so the wav bytes ARE the estimate."""
    n = len(utt_paths)
    if n == 0:
        return 0.0
    total = counted = 0
    for i in range(0, n, max(1, n // sample)):
        p = os.path.join(data_dir, utt_paths[i])
        if not p.endswith(".wav"):
            p += ".wav"
        try:
            total += os.path.getsize(p)
            counted += 1
        except OSError:
            pass
    if counted == 0:
        return 0.0
    return (total / counted) * n / 1e6
