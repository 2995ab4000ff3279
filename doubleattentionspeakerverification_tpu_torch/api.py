"""High-level inference API: load once, embed and score many.

    from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel

    model = SpeakerEmbeddingModel.from_checkpoint("run1/..._best_1234.npz")
    emb = model.embed_wav("a.wav")
    sim = model.score(emb, model.embed_wav("b.wav"))   # cosine in [-1, 1]

Runs on the card unless ``device="cpu"`` is given; asking for CUDA where
there is none raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .config import ExperimentConfig, FeatureConfig
from .data.wav import read_wav
from .dsp.features import extract_normalized
from .evaluation.eer import cosine_scores
from .models.classifier import SpeakerClassifier
from .models.init import init_parameters
from .utils.checkpoint import load_checkpoint
from .utils.device import resolve_device
from .utils.weights import params_from_jax

ArrayLike = Union[np.ndarray, torch.Tensor]


def _empty_model(cfg: ExperimentConfig) -> SpeakerClassifier:
    """The module with uninitialized storage (no wasted default init)."""
    with torch.device("meta"):
        model = SpeakerClassifier(cfg.model)
    return model.to_empty(device="cpu")


class SpeakerEmbeddingModel:
    def __init__(self, model: SpeakerClassifier, cfg: ExperimentConfig,
                 normalization: str = "cmn", device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.normalization = normalization

    # ------------------------------------------------------------- loaders
    @classmethod
    def from_checkpoint(cls, path: str, normalization: str = "cmn",
                        device="cuda") -> "SpeakerEmbeddingModel":
        """Load a JAX package ``.npz`` checkpoint; its embedded config wins."""
        flat, meta = load_checkpoint(path)
        return cls.from_jax(flat, ExperimentConfig.from_dict(meta["config"]),
                            normalization, device)

    @classmethod
    def from_jax(cls, flat, cfg: ExperimentConfig, normalization: str = "cmn",
                 device="cuda") -> "SpeakerEmbeddingModel":
        """From the JAX package's parameters as flat numpy leaves keyed
        ``params/...`` and ``model_state/...`` (``utils/weights.py``)."""
        model = _empty_model(cfg)
        state = params_from_jax(flat)
        model.load_state_dict({k: state[k] for k in model.state_dict()})
        return cls(model, cfg, normalization, device)

    @classmethod
    def from_random_init(cls, cfg: ExperimentConfig, seed: int = 0,
                         device="cuda") -> "SpeakerEmbeddingModel":
        generator = torch.Generator().manual_seed(seed)
        return cls(init_parameters(_empty_model(cfg), generator), cfg, device=device)

    # ------------------------------------------------------------- embed
    @torch.inference_mode()
    def embed_features(self, features: ArrayLike,
                       lengths: Optional[ArrayLike] = None) -> np.ndarray:
        """(T, F) or (B, T, F) normalized log-mel -> (emb,) or (B, emb)."""
        x = torch.as_tensor(features, dtype=torch.float32, device=self.device)
        single = x.dim() == 2
        if single:
            x = x[None]
        if lengths is not None:
            lengths = torch.as_tensor(lengths, dtype=torch.int64, device=self.device)
        emb = self.model(x, lengths).cpu().numpy()
        return emb[0] if single else emb

    def features_cfg_for_rate(self, sample_rate: int) -> FeatureConfig:
        """The configured front-end, rate-adjusted: every constant stays;
        only the rate, and with it the ms-denominated window and hop,
        follows the audio (fmax=None re-derives sr/2)."""
        cfg = self.cfg.features
        if sample_rate != cfg.sample_rate:
            cfg = dataclasses.replace(cfg, sample_rate=sample_rate, fmax=None)
        return cfg

    @torch.inference_mode()
    def features_of_wave(self, wave: ArrayLike, sample_rate: int = 16000) -> torch.Tensor:
        """Wave (N,) -> normalized (T, n_mels) on this model's device; on the
        card the log-mel is kernel B2."""
        if isinstance(wave, torch.Tensor):
            w = wave.to(self.device, torch.float32)
        else:
            w = torch.from_numpy(np.asarray(wave, np.float32)).to(self.device)
        return extract_normalized(w, self.features_cfg_for_rate(sample_rate), self.normalization)

    def embed_wave(self, wave: ArrayLike, sample_rate: int = 16000) -> np.ndarray:
        return self.embed_features(self.features_of_wave(wave, sample_rate))

    def embed_wav(self, path: str) -> np.ndarray:
        wave, sr = read_wav(path)
        return self.embed_wave(wave, sr)

    # ------------------------------------------------------------- scoring
    def score(self, emb1: np.ndarray, emb2: np.ndarray) -> float:
        return float(cosine_scores(np.asarray(emb1)[None], np.asarray(emb2)[None])[0])
