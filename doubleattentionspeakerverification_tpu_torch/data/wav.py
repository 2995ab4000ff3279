"""WAV decoding.

A copy of the JAX package's ``data/wav.py``, the decoder of uploads. Supports
PCM 16/24/32-bit and IEEE float32/64, mono or multichannel (channels are
averaged to mono, matching soundfile's common usage for VoxCeleb wavs which
are mono anyway). Output: float64 in [-1, 1] like ``soundfile.read``.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (samples float64 in [-1,1], sample_rate). Mono output."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_wav_bytes(data)


def decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    sr = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = pos + 8
        if chunk_id == b"fmt ":
            audio_format, n_ch, sr, _br, _ba, bits = struct.unpack_from(
                "<HHIIHH", data, body
            )
            if audio_format == 0xFFFE and chunk_size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                (audio_format,) = struct.unpack_from("<H", data, body + 24)
            fmt = (audio_format, n_ch, bits)
        elif chunk_id == b"data":
            if fmt is None:
                raise ValueError("data chunk before fmt chunk")
            audio_format, n_ch, bits = fmt
            if n_ch < 1:
                raise ValueError(f"invalid channel count {n_ch}")
            if body + chunk_size > len(data):
                # a silently-shortened slice would decode a truncated upload
                # (network cut, partial copy) into valid-looking audio
                raise ValueError(
                    f"truncated data chunk: header declares {chunk_size} "
                    f"bytes, {len(data) - body} present"
                )
            raw = data[body : body + chunk_size]
            samples = _decode_samples(raw, audio_format, bits)
            if n_ch > 1:
                samples = samples[: len(samples) // n_ch * n_ch]
                samples = samples.reshape(-1, n_ch).mean(axis=1)
        pos = body + chunk_size + (chunk_size & 1)
    if samples is None or sr is None:
        raise ValueError("missing fmt/data chunk")
    if samples.size == 0:
        raise ValueError("empty data chunk (zero audio samples)")
    if sr <= 0:
        raise ValueError(f"invalid sample rate {sr}")
    return samples, sr


def _decode_samples(raw: bytes, audio_format: int, bits: int) -> np.ndarray:
    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw[: len(raw) // 3 * 3], dtype=np.uint8).reshape(-1, 3)
            val = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            x = val.astype(np.float64) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float64)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float64)
        else:
            raise ValueError(f"unsupported float bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAVE format code {audio_format}")
    return x


def encode_wav(samples: np.ndarray, sample_rate: int) -> bytes:
    """Mono PCM16 RIFF/WAVE bytes (for tests and synthetic uploads)."""
    x = np.clip(np.asarray(samples, dtype=np.float64), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    return hdr + pcm
