"""Kernel B2: fused log-mel spectrogram (``csrc/logmel.cu``).

The counterpart of ``ops/logmel_pallas.py`` in the JAX package. The CUDA
kernel reads the audio once and writes the (B, T, n_mels) features once; the
plain version, ``dsp.features.log_mel_spectrogram``, materializes the framed
signal (a 3.2x blow-up of the audio) and runs three products.

``log_mel_spectrogram_fused`` takes the plain version only for a tensor on
the CPU; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import FeatureConfig
from ..dsp.features import dft_mel_tensors, log_mel_spectrogram, num_frames, preemphasize
from .kernels import CudaKernel

_p, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "logmel", "logmel.cu", "logmel_f32",
    [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, ctypes.c_float, _p],
)

log_mel_plain = log_mel_spectrogram


def log_mel_cuda(wave: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(B, N) float32 CUDA waveform -> (B, T, n_mels) through the kernel."""
    if wave.device.type != "cuda":
        raise ValueError(f"log_mel_cuda needs a CUDA tensor, got {wave.device}")
    if wave.dtype != torch.float32 or wave.dim() != 2:
        raise ValueError(f"log_mel_cuda takes (B, N) float32, got {tuple(wave.shape)} {wave.dtype}")
    b, n = wave.shape
    t = num_frames(n, cfg)
    out = torch.empty((b, t, cfg.n_mels), dtype=torch.float32, device=wave.device)
    if b == 0 or t == 0:
        return out
    y = preemphasize(wave, cfg).contiguous()
    cos_b, sin_b, mel_t = dft_mel_tensors(cfg, wave.device)
    KERNEL.launch(
        y.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), mel_t.data_ptr(), out.data_ptr(),
        b, n, t, cfg.hop_length, cfg.n_fft, cos_b.shape[1], cfg.n_mels, float(cfg.log_floor),
        torch.cuda.current_stream(wave.device).cuda_stream,
    )
    return out


def log_mel_spectrogram_fused(wave: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Waveform (N,) or (B, N) -> log-mel (T, n_mels) or (B, T, n_mels):
    the kernel on the card, its plain version on the CPU."""
    if wave.dim() == 1:
        return log_mel_spectrogram_fused(wave[None], cfg)[0]
    if wave.device.type == "cpu":
        return log_mel_plain(wave, cfg)
    return log_mel_cuda(wave.to(torch.float32), cfg)
