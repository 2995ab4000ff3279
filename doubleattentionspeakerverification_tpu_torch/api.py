"""High-level inference API: load once, embed and score many.

    from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel

    model = SpeakerEmbeddingModel.from_checkpoint("run1/..._best_1234.npz")  # or a .chkpt
    emb = model.embed_wav("a.wav")
    sim = model.score(emb, model.embed_wav("b.wav"))   # cosine in [-1, 1]
    same = model.verify("a.wav", "b.wav", threshold=0.5)

Runs on the card unless ``device="cpu"`` is given; asking for CUDA where
there is none raises. The config's tri-state kernel flags are resolved for
the device at construction (``utils/kernel_auto.py``): B2 for uploads, B1 in
the pooling, each behind a one-time self-check unless set explicitly.
``quantize="int8"`` or ``"int8_static"`` serves the int8 encoder
(``models/quantized.py``; kernel B3 on the card):

    model = SpeakerEmbeddingModel.from_checkpoint(path, quantize="int8_static")
    model.calibrate_quantization_wav("calibration.wav")   # else the first real batch
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
from .models.quantized import make_int8_embed_fn
from .utils.checkpoint import load_checkpoint
from .utils.device import resolve_device
from .utils.kernel_auto import resolve_model_kernels, route_model
from .utils.torch_import import load_torch_checkpoint
from .utils.weights import params_from_jax

ArrayLike = Union[np.ndarray, torch.Tensor]


def empty_model(cfg: ExperimentConfig) -> SpeakerClassifier:
    """The module with uninitialized storage (no wasted default init)."""
    with torch.device("meta"):
        model = SpeakerClassifier(cfg.model)
    return model.to_empty(device="cpu")


def _model_from_state(state, cfg: ExperimentConfig) -> SpeakerClassifier:
    """The module holding ``state``, a state dict keyed by the port's names
    that may carry more (``utils/weights.py``, ``utils/torch_import.py``)."""
    model = empty_model(cfg)
    model.load_state_dict({k: state[k] for k in model.state_dict()})
    return model


QUANTIZE_MODES = ("none", "int8", "int8_static")
REFERENCE_SUFFIXES = (".chkpt", ".pt", ".pth")


class SpeakerEmbeddingModel:
    def __init__(self, model: SpeakerClassifier, cfg: ExperimentConfig,
                 normalization: str = "cmn", device="cuda", quantize: str = "none",
                 quantize_scales_path: Optional[str] = None):
        if quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r}; use one of {QUANTIZE_MODES}")
        self.device = resolve_device(device)
        kernels = resolve_model_kernels(cfg.model, cfg.features, device=self.device)
        self._dsp_kernel = kernels.use_pallas_dsp
        self.model = route_model(model.to(self.device).eval(), kernels)
        self.cfg = cfg
        self.normalization = normalization
        self.quantize = quantize
        if quantize == "none":
            self._embed = self.model
        else:
            # 'int8': dynamic per-forward activation scales; 'int8_static':
            # scales calibrated on one batch (the first non-degenerate one,
            # or calibrate_quantization*), persisted at quantize_scales_path
            self._embed = make_int8_embed_fn(
                self.model, cfg.model,
                scheme="static" if quantize == "int8_static" else "dynamic",
                scales_path=quantize_scales_path)

    @property
    def embed_fn(self):
        """``(x, lengths) -> (B, emb)`` as this model embeds: the module
        itself, or its int8 path under ``quantize``."""
        return self._embed

    # --------------------------------------------------------- calibration
    @torch.inference_mode()
    def calibrate_quantization(self, features: ArrayLike,
                               lengths: Optional[ArrayLike] = None) -> str:
        """An explicit ``int8_static`` calibration batch ((T, F) or (B, T, F)
        normalized features). Raises on degenerate input (zeros, silence) or
        when the quantize mode takes no calibration; returns the resulting
        state ('static', or 'fallback_dynamic' if the cosine guard rejected
        the scales)."""
        calibrate = getattr(self._embed, "calibrate", None)
        if calibrate is None:
            raise ValueError(f"quantize mode {self.quantize!r} takes no calibration batch")
        x, lengths = self._batch(features, lengths)
        return calibrate(x, lengths)

    def calibrate_quantization_wav(self, path: str) -> str:
        """Calibrate ``int8_static`` on one wav file (serve's
        ``--calibration_wav``) through the inference feature path."""
        wave, sr = read_wav(path)
        return self.calibrate_quantization(self.features_of_wave(wave, sr))

    def quantize_calibration_state(self) -> str:
        """'none' (fp model), 'dynamic', 'uncalibrated', 'static' or
        'fallback_dynamic'."""
        state_fn = getattr(self._embed, "calibration_state", None)
        return state_fn() if state_fn is not None else "none"

    # ------------------------------------------------------------- loaders
    @classmethod
    def from_checkpoint(cls, path: str, normalization: str = "cmn", device="cuda",
                        quantize: str = "none",
                        quantize_scales_path: Optional[str] = None) -> "SpeakerEmbeddingModel":
        """Load a JAX package ``.npz`` checkpoint, a ``.dcp`` directory of the
        multi-process trainer, or a reference torch ``.chkpt`` (also
        ``.pt``/``.pth``); the config it carries wins."""
        if path.endswith(REFERENCE_SUFFIXES):
            state, cfg, _epoch, _step = load_torch_checkpoint(path)
            return cls(_model_from_state(state, cfg), cfg, normalization, device, quantize,
                       quantize_scales_path)
        flat, meta = load_checkpoint(path)
        return cls.from_jax(flat, ExperimentConfig.from_dict(meta["config"]),
                            normalization, device, quantize, quantize_scales_path)

    @classmethod
    def from_jax(cls, flat, cfg: ExperimentConfig, normalization: str = "cmn",
                 device="cuda", quantize: str = "none",
                 quantize_scales_path: Optional[str] = None) -> "SpeakerEmbeddingModel":
        """From the JAX package's parameters as flat numpy leaves keyed
        ``params/...`` and ``model_state/...`` (``utils/weights.py``)."""
        return cls(_model_from_state(params_from_jax(flat), cfg), cfg, normalization, device,
                   quantize, quantize_scales_path)

    @classmethod
    def from_random_init(cls, cfg: ExperimentConfig, seed: int = 0, device="cuda",
                         quantize: str = "none") -> "SpeakerEmbeddingModel":
        generator = torch.Generator().manual_seed(seed)
        return cls(init_parameters(empty_model(cfg), generator), cfg, device=device,
                   quantize=quantize)

    # ------------------------------------------------------------- embed
    def _batch(self, features: ArrayLike, lengths: Optional[ArrayLike]):
        x = torch.as_tensor(features, dtype=torch.float32, device=self.device)
        if x.dim() == 2:
            x = x[None]
        if lengths is not None:
            lengths = torch.as_tensor(lengths, dtype=torch.int64, device=self.device)
        return x, lengths

    @torch.inference_mode()
    def embed_features(self, features: ArrayLike,
                       lengths: Optional[ArrayLike] = None) -> np.ndarray:
        """(T, F) or (B, T, F) normalized log-mel -> (emb,) or (B, emb)."""
        x, lengths = self._batch(features, lengths)
        emb = self._embed(x, lengths).cpu().numpy()
        return emb[0] if np.ndim(features) == 2 else emb

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
        return extract_normalized(w, self.features_cfg_for_rate(sample_rate), self.normalization,
                                  self._dsp_kernel)

    def embed_wave(self, wave: ArrayLike, sample_rate: int = 16000) -> np.ndarray:
        return self.embed_features(self.features_of_wave(wave, sample_rate))

    def embed_wav(self, path: str) -> np.ndarray:
        wave, sr = read_wav(path)
        return self.embed_wave(wave, sr)

    # ------------------------------------------------------------- scoring
    def score(self, emb1: np.ndarray, emb2: np.ndarray) -> float:
        return float(cosine_scores(np.asarray(emb1)[None], np.asarray(emb2)[None])[0])

    def score_wavs(self, path1: str, path2: str) -> float:
        return self.score(self.embed_wav(path1), self.embed_wav(path2))

    def verify(self, path1: str, path2: str, threshold: float = 0.5) -> bool:
        return self.score_wavs(path1, path2) >= threshold
