"""Kernel B2: fused log-mel spectrogram (``csrc/logmel.cu``).

The counterpart of ``ops/logmel_pallas.py`` in the JAX package. The CUDA
kernel reads the raw audio once and writes the (B, T, n_mels) features once:
pre-emphasis, framing, the Hamming window, a mixed-radix FFT, the magnitude,
the band-limited mel sum and the log floor all stay in shared memory. The
plain version, ``dsp.features.log_mel_spectrogram``, materializes the framed
signal (a 3.2x blow-up of the audio) and runs three products.

The FFT's plan (factorization, stage order, twiddle tables) and the mel
filters' nonzero bands are built here on the host, in float64 and rounded to
float32 once, and passed to the kernel (:func:`fft_plan`, :func:`mel_bands`,
:func:`fft_mel_tensors`). :func:`log_mel_fft_reference` runs that plan stage
by stage in torch, for the tests only: the kernel cannot run on the CPU.

``log_mel_spectrogram_fused`` takes the plain version only for a tensor on
the CPU; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import FeatureConfig
from ..dsp.features import dft_mel_constants, log_mel_spectrogram, num_frames, preemphasize
from ..dsp.mel import padded_stft_window
from .kernels import CudaKernel

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "logmel", "logmel.cu", "logmel_f32",
    [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _f, _f, _f, _f, _p],
)

log_mel_plain = log_mel_spectrogram


def _roots(num: int, den: int) -> np.ndarray:
    """exp(-2*pi*i*num/den) in float64, rounded to complex64 once."""
    return np.exp(-2j * np.pi * np.asarray(num, np.float64) / den).astype(np.complex64)


def factorize(n: int) -> Tuple[int, ...]:
    """The FFT's radices for ``n`` points: 4s, then a 2, then odd primes in
    ascending order (a prime ``n`` is one direct stage)."""
    radices = []
    for p in (4, 2):
        while n % p == 0:
            radices.append(p)
            n //= p
    p = 3
    while n > 1:
        if p * p > n:
            p = n
        while n % p == 0:
            radices.append(p)
            n //= p
        p += 2
    return tuple(radices)


@dataclass(frozen=True)
class FftPlan:
    """A Stockham mixed-radix FFT of ``size`` complex points.

    Even ``n_fft`` is packed: sample pairs (x[2m], x[2m+1]) are the complex
    points of an ``n_fft/2``-point FFT, and the split step with ``split``
    (exp(-2*pi*i*k/n_fft), k = 0..n_fft/2) gives bins 0..n_fft/2. Odd
    ``n_fft`` runs an ``n_fft``-point FFT of the real frame. Stage s of radix
    R with stride Ns (the product of the earlier radices) maps point
    j + r*size/R, times ``twiddles[s][r, j % Ns]`` = exp(-2*pi*i*r*(j%Ns)/(Ns*R)),
    through a radix-R DFT (``roots[s][m]`` = exp(-2*pi*i*m/R)) to point
    (j // Ns)*Ns*R + j % Ns + k*Ns.
    """

    packed: bool
    size: int
    radices: Tuple[int, ...]
    strides: Tuple[int, ...]
    twiddles: Tuple[np.ndarray, ...]   # per stage, (R, Ns) complex64
    roots: Tuple[np.ndarray, ...]      # per stage, (R,) complex64
    split: Optional[np.ndarray]        # (n_fft/2 + 1,) complex64 when packed


@functools.lru_cache(maxsize=16)
def fft_plan(n_fft: int) -> FftPlan:
    packed = n_fft % 2 == 0
    size = n_fft // 2 if packed else n_fft
    radices = factorize(size)
    strides = tuple(int(np.prod(radices[:s], dtype=np.int64)) for s in range(len(radices)))
    twiddles = tuple(
        _roots(np.outer(np.arange(r), np.arange(ns)), ns * r) for r, ns in zip(radices, strides)
    )
    roots = tuple(_roots(np.arange(r), r) for r in radices)
    split = _roots(np.arange(size + 1), n_fft) if packed else None
    return FftPlan(packed, size, radices, strides, twiddles, roots, split)


def mel_bands(mel_t: np.ndarray) -> np.ndarray:
    """(n_mels, 2) int32 [k_lo, k_hi): the bins where each mel filter (a
    column of ``mel_t``, (n_bins, n_mels)) is nonzero; (0, 0) for none."""
    bands = np.zeros((mel_t.shape[1], 2), np.int32)
    for m in range(mel_t.shape[1]):
        nz = np.flatnonzero(mel_t[:, m])
        if nz.size:
            bands[m] = nz[0], nz[-1] + 1
    return bands


def pack_plan(plan: FftPlan) -> Tuple[np.ndarray, np.ndarray]:
    """The plan as the kernel reads it: an int32 header
    [n_stages, split_offset, (radix, Ns, twiddle_offset, root_offset) per stage]
    and one complex64 table; offsets count complex entries."""
    tables, header, offset = [], [len(plan.radices), 0], 0

    def put(a: np.ndarray) -> int:
        nonlocal offset
        tables.append(a.reshape(-1))
        offset += a.size
        return offset - a.size

    for r, ns, tw, roots in zip(plan.radices, plan.strides, plan.twiddles, plan.roots):
        header += [r, ns, put(tw), put(roots)]
    if plan.split is not None:
        header[1] = put(plan.split)
    return np.asarray(header, np.int32), np.concatenate(tables)


@functools.lru_cache(maxsize=8)
def fft_mel_tensors(cfg: FeatureConfig, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(window, plan header, twiddle table as (K, 2) float32, mel_T, mel bands)
    on ``device``, copied there once per config."""
    header, table = pack_plan(fft_plan(cfg.n_fft))
    mel_t = dft_mel_constants(cfg)[2]
    window = padded_stft_window(cfg.win_length, cfg.n_fft, dtype=np.float32)
    arrays = (window, header, table.view(np.float32).reshape(-1, 2), mel_t, mel_bands(mel_t))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def log_mel_cuda(wave: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(B, N) float32 CUDA waveform -> (B, T, n_mels) through the kernel;
    the x32768 rescale and pre-emphasis run inside it."""
    if wave.device.type != "cuda":
        raise ValueError(f"log_mel_cuda needs a CUDA tensor, got {wave.device}")
    if wave.dtype != torch.float32 or wave.dim() != 2:
        raise ValueError(f"log_mel_cuda takes (B, N) float32, got {tuple(wave.shape)} {wave.dtype}")
    b, n = wave.shape
    t = num_frames(n, cfg)
    out = torch.empty((b, t, cfg.n_mels), dtype=torch.float32, device=wave.device)
    if b == 0 or t == 0:
        return out
    x = wave.contiguous()
    window, header, table, mel_t, bands = fft_mel_tensors(cfg, wave.device)
    # the constants as float32, as torch's float32 ops in ``preemphasize`` take them
    KERNEL.launch(
        x.data_ptr(), window.data_ptr(), table.data_ptr(), header.data_ptr(),
        mel_t.data_ptr(), bands.data_ptr(), out.data_ptr(),
        b, n, t, cfg.hop_length, cfg.n_fft, cfg.n_mels,
        float(np.float32(cfg.log_floor)), float(np.float32(cfg.rescale)),
        float(np.float32(cfg.preemphasis)), float(np.float32(1.0 - cfg.preemphasis)),
        torch.cuda.current_stream(wave.device).cuda_stream,
    )
    return out


def log_mel_spectrogram_fused(wave: torch.Tensor, cfg: FeatureConfig,
                              use_kernel: bool = True) -> torch.Tensor:
    """Waveform (N,) or (B, N) -> log-mel (T, n_mels) or (B, T, n_mels):
    the kernel on the card, its plain version on the CPU or where
    ``use_kernel`` is False (the kernel dispatcher's explicit plain choice,
    ``utils/kernel_auto.py``)."""
    if wave.dim() == 1:
        return log_mel_spectrogram_fused(wave[None], cfg, use_kernel)[0]
    if wave.device.type == "cpu" or not use_kernel:
        return log_mel_plain(wave, cfg)
    return log_mel_cuda(wave.to(torch.float32), cfg)


# ------------------------------------------------------------ tests only
def _fft_stage(z: torch.Tensor, radix: int, ns: int, twiddles: np.ndarray,
               roots: np.ndarray) -> torch.Tensor:
    lead, n = z.shape[:-1], z.shape[-1]
    nr = n // radix
    v = z.reshape(*lead, radix, nr) * torch.from_numpy(twiddles)[:, torch.arange(nr) % ns]
    k = torch.arange(radix)
    dft = torch.from_numpy(roots)[(k[:, None] * k[None, :]) % radix]   # [k, r]
    out = torch.einsum("kr,...rj->...kj", dft, v)                       # [k, j]
    # j = g*Ns + j%Ns goes to g*Ns*R + k*Ns + j%Ns
    return out.reshape(*lead, radix, nr // ns, ns).transpose(-3, -2).reshape(*lead, n)


def log_mel_fft_reference(wave: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """The kernel's algorithm in torch float32 on the CPU: the same host-built
    plan, twiddles and mel bands, stage by stage. (B, N) -> (B, T, n_mels)."""
    plan = fft_plan(cfg.n_fft)
    t = num_frames(wave.shape[-1], cfg)
    window, _, _, mel_t, bands = fft_mel_tensors(cfg, torch.device("cpu"))
    y = preemphasize(wave.to(torch.float32), cfg)
    frames = y.unfold(-1, cfg.n_fft, cfg.hop_length)[..., :t, :] * window
    if plan.packed:
        z = torch.complex(frames[..., 0::2], frames[..., 1::2])
    else:
        z = torch.complex(frames, torch.zeros_like(frames))
    for stage in zip(plan.radices, plan.strides, plan.twiddles, plan.roots):
        z = _fft_stage(z, *stage)
    if plan.packed:
        k = torch.arange(plan.size + 1)
        a, b = z[..., k % plan.size], z[..., (plan.size - k) % plan.size].conj()
        z = 0.5 * (a + b) + torch.from_numpy(plan.split) * (-0.5j * (a - b))
    else:
        z = z[..., : cfg.n_fft // 2 + 1]
    mag = torch.sqrt(z.real * z.real + z.imag * z.imag)
    k = torch.arange(mel_t.shape[0])[:, None]
    band_mel_t = torch.where((k >= bands[:, 0]) & (k < bands[:, 1]), mel_t, 0.0)
    return torch.log(torch.clamp(mag @ band_mel_t, min=cfg.log_floor))
