"""Log-mel front-end (JAX ``dsp/``), with the JAX package's exported names."""

from .features import (
    extract_normalized,
    frames_for_samples,
    log_mel_spectrogram,
    normalize_features,
    num_frames,
    num_samples_for_frames,
    preemphasize,
)
from .mel import mel_filterbank, padded_stft_window

__all__ = [
    "extract_normalized",
    "frames_for_samples",
    "log_mel_spectrogram",
    "normalize_features",
    "num_frames",
    "num_samples_for_frames",
    "preemphasize",
    "mel_filterbank",
    "padded_stft_window",
]
