"""Log-mel feature extraction in PyTorch.

The reference's librosa pipeline (``featureExtractor.py:8-23``: rescale
x32768 -> pre-emphasis 0.97 -> Hamming STFT 25 ms / 10 ms, n_fft 512,
center=False -> 80 Slaney mels, norm=None -> log(max(1, .))) as torch code:
framing is an unfold, the windowed DFT and the mel projection are two
products in true float32. ``log_mel_spectrogram`` here is the plain version
of the log-mel kernel in ``ops/logmel.py``; ``extract_normalized`` runs that
kernel on the card. CMN/CMVN (``data.py:21-30``) is mask-aware for padded
batches.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import FeatureConfig
from .mel import mel_filterbank, padded_stft_window


def num_frames(num_samples: int, cfg: FeatureConfig) -> int:
    """Frame count of a ``center=False`` STFT (frame length = n_fft)."""
    return max(0, 1 + (num_samples - cfg.n_fft) // cfg.hop_length)


@functools.lru_cache(maxsize=8)
def dft_mel_constants(cfg: FeatureConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cos_basis, sin_basis, mel_T) with the analysis window folded into the
    DFT bases. cos/sin: (n_fft, n_bins); mel_T: (n_bins, n_mels). float32."""
    n_fft = cfg.n_fft
    n_bins = 1 + n_fft // 2
    window = padded_stft_window(cfg.win_length, n_fft, dtype=np.float64)
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_bins, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    cos_b = (window[:, None] * np.cos(ang)).astype(np.float32)
    sin_b = (window[:, None] * -np.sin(ang)).astype(np.float32)
    mel = mel_filterbank(cfg.sample_rate, n_fft, cfg.n_mels, cfg.fmin, cfg.fmax_hz)
    return cos_b, sin_b, mel.T.copy()


@functools.lru_cache(maxsize=8)
def dft_mel_tensors(cfg: FeatureConfig, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """:func:`dft_mel_constants` as tensors on ``device``, copied there once
    (also on the CPU: torch's own aligned buffers keep the CPU's choice of
    matmul kernel, and with it the summation order, the same from run to
    run)."""
    return tuple(torch.tensor(a, device=device) for a in dft_mel_constants(cfg))


def preemphasize(wave: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """x32768 rescale + pre-emphasis, as ``featureExtractor.py:16-18``:
    ``y[1:] -= 0.97*y[:-1]; y[0] *= (1-0.97)``. Operates on the last axis."""
    y = wave * cfg.rescale
    first = y[..., :1] * (1.0 - cfg.preemphasis)
    rest = y[..., 1:] - cfg.preemphasis * y[..., :-1]
    return torch.cat([first, rest], dim=-1)


def log_mel_spectrogram(wave: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Waveform (..., N) in [-1, 1] -> log-mel features (..., T, n_mels).

    The plain version of the log-mel kernel: the products run in true
    float32 (``torch.matmul`` is full float32 unless TF32 is switched on,
    which ``utils.device.resolve_device`` keeps off) because
    the near-cancelling low-frequency bins of the pre-emphasized signal do
    not survive reduced precision.
    """
    cos_b, sin_b, mel_t = dft_mel_tensors(cfg, wave.device)
    n_frames = num_frames(wave.shape[-1], cfg)
    if n_frames == 0:
        return wave.new_zeros(wave.shape[:-1] + (0, cfg.n_mels), dtype=torch.float32)
    y = preemphasize(wave.to(torch.float32), cfg)
    frames = y.unfold(-1, cfg.n_fft, cfg.hop_length)[..., :n_frames, :]  # (..., T, n_fft)
    re = frames @ cos_b
    im = frames @ sin_b
    mag = torch.sqrt(re * re + im * im)
    melspec = mag @ mel_t
    return torch.log(torch.clamp(melspec, min=cfg.log_floor))


def normalize_features(
    features: torch.Tensor,
    mode: str = "cmn",
    lengths: Optional[torch.Tensor] = None,
    std_floor: float = 0.01,
) -> torch.Tensor:
    """Masked CMN / CMVN over the time axis (axis -2).

    Reference semantics (``data.py:21-30``): subtract the per-feature time
    mean; for 'cmvn' also divide by the biased std with the floor
    ``std = where(std > 0.01, std, 1)``. With ``lengths`` given, statistics
    use only the first ``lengths`` frames of each item and padded frames are
    zeroed on output.
    """
    x = features
    if lengths is None:
        mean = x.mean(dim=-2, keepdim=True)
        out = x - mean
        if mode == "cmvn":
            std = x.std(dim=-2, keepdim=True, correction=0)
            out = out / torch.where(std > std_floor, std, torch.ones_like(std))
        return out

    t = x.shape[-2]
    mask = (torch.arange(t, device=x.device) < lengths[..., None])[..., None]  # (..., T, 1)
    denom = torch.clamp(lengths, min=1)[..., None, None].to(x.dtype)
    mean = torch.where(mask, x, 0.0).sum(dim=-2, keepdim=True) / denom
    out = x - mean
    if mode == "cmvn":
        var = torch.where(mask, out * out, 0.0).sum(dim=-2, keepdim=True) / denom
        std = torch.sqrt(var)
        out = out / torch.where(std > std_floor, std, torch.ones_like(std))
    return torch.where(mask, out, 0.0)


def extract_normalized(wave: torch.Tensor, cfg: FeatureConfig, mode: str = "cmn") -> torch.Tensor:
    """Wave (N,) -> CMN'd (T, n_mels) on the wave's device, the inference
    combination of ``featureExtractor.extractFeatures`` (``:25-33``). On the
    card the log-mel runs in the hand-written kernel (``ops/logmel.py``)."""
    from ..ops.logmel import log_mel_spectrogram_fused

    return normalize_features(log_mel_spectrogram_fused(wave, cfg), mode)
