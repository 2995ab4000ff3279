"""Mel filterbank and window construction (host-side, numpy).

Reproduces the filterbank the reference obtains from
``librosa.feature.melspectrogram(..., n_mels=80, fmin=0, fmax=sr/2, norm=None)``
(reference ``scripts/featureExtractor.py:8-23``): Slaney-scale mel spacing
(linear below 1 kHz, log above), triangular filters, no area normalization.

These are tiny constant matrices computed once on the host and copied to the
device by the log-mel front-end (``dsp/features.py``, ``ops/logmel.py``).
"""

from __future__ import annotations

import numpy as np

# Slaney auditory-toolbox mel scale constants.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP  # 15.0
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies) -> np.ndarray:
    """Hz -> Slaney mel (librosa ``htk=False`` semantics)."""
    f = np.asarray(frequencies, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(log_region, _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP, mels)
    return mels


def mel_to_hz(mels) -> np.ndarray:
    """Slaney mel -> Hz."""
    m = np.asarray(mels, dtype=np.float64)
    freqs = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    freqs = np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), freqs)
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_mels, 1 + n_fft // 2)``.

    ``norm=None``: raw triangles with unit peak (in the continuous domain),
    matching the reference's melspectrogram call.
    """
    if fmax is None:
        fmax = sample_rate / 2.0

    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2, dtype=np.float64)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights.astype(dtype)


def periodic_hamming(win_length: int, dtype=np.float64) -> np.ndarray:
    """scipy ``get_window('hamming', N, fftbins=True)`` — the periodic hamming
    window librosa uses inside stft: ``0.54 - 0.46 cos(2 pi n / N)``."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / win_length)
    return w.astype(dtype)


def padded_stft_window(win_length: int, n_fft: int, dtype=np.float32) -> np.ndarray:
    """The analysis window actually applied per frame by librosa.stft: the
    ``win_length`` periodic hamming window zero-padded symmetrically to
    ``n_fft`` (librosa ``util.pad_center``). Frames are ``n_fft`` samples long
    when ``center=False``."""
    w = periodic_hamming(win_length)
    if n_fft < win_length:
        raise ValueError("n_fft must be >= win_length")
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[lpad : lpad + win_length] = w
    return out.astype(dtype)
