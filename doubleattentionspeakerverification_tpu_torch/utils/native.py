"""ctypes bindings for the repo's host C++ data-loading library.

The port's own loader of ``native/wavio.cpp`` and ``native/logmel.cpp``
(the JAX package's ``utils/native.py`` is its model): on first use it
compiles the two sources with ``native/Makefile``'s flags into the port's
``_build/libdmha_native.so``, never into ``native/``. Every entry point has
the JAX package's pure-python fallback, which draws other windows than the
native path; :func:`native_available` says which path a run takes, and the
trainer logs it in its ``source_mode`` event.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_SO_PATH = os.path.join(_BUILD_DIR, "libdmha_native.so")
# native/Makefile's CXX, CXXFLAGS and LDFLAGS
_CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall")
_LD_FLAGS = ("-shared", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False


def _try_build() -> bool:
    global _build_attempted
    if _build_attempted:
        return os.path.exists(_SO_PATH)
    _build_attempted = True
    sources = [os.path.join(_NATIVE_DIR, f) for f in ("wavio.cpp", "logmel.cpp")]
    if not all(os.path.exists(f) for f in sources):
        return False
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), *_CXX_FLAGS, *sources, *_LD_FLAGS, "-o", tmp],
            cwd=_NATIVE_DIR, check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _SO_PATH)
    except Exception:
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False
    return os.path.exists(_SO_PATH)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH) and not _try_build():
            return None
        lib = ctypes.CDLL(_SO_PATH)
        lib.wav_read.restype = ctypes.c_long
        lib.wav_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.wav_length.restype = ctypes.c_long
        lib.wav_length.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.wav_read_windows.restype = None
        lib.wav_read_windows.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_long),
            ctypes.c_int,
        ]
        fp = ctypes.POINTER(ctypes.c_float)
        lib.logmel_create.restype = ctypes.c_void_p
        lib.logmel_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, fp, fp,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ]
        lib.logmel_destroy.restype = None
        lib.logmel_destroy.argtypes = [ctypes.c_void_p]
        lib.logmel_num_frames.restype = ctypes.c_long
        lib.logmel_num_frames.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.logmel_compute.restype = ctypes.c_long
        lib.logmel_compute.argtypes = [
            ctypes.c_void_p, fp, ctypes.c_long, ctypes.c_int, ctypes.c_float, fp,
        ]
        lib.wav_logmel_windows.restype = None
        lib.wav_logmel_windows.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_float,
            fp, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


_tls = threading.local()


def native_read_wav(path: str, max_seconds: float = 600.0, sample_rate_hint: int = 16000):
    """Decode one wav to mono float32; returns np.ndarray. Raises on failure.
    Signature matches what ``data.dataset.WavSource`` expects."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    max_samples = int(max_seconds * sample_rate_hint)
    # reuse a thread-local scratch buffer instead of a fresh ~40 MB per call
    buf = getattr(_tls, "buf", None)
    if buf is None or buf.shape[0] < max_samples:
        buf = np.empty((max_samples,), np.float32)
        _tls.buf = buf
    sr = ctypes.c_int(0)
    n = lib.wav_read(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples, ctypes.byref(sr),
    )
    if n < 0:
        raise IOError(f"native wav decode failed: {path}")
    return buf[:n].copy()


def native_read_windows(
    paths: Sequence[str],
    window_samples: int,
    seeds: Sequence[int],
    n_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Parallel decode + window-sample a whole batch.

    Returns (windows (n, window) float32 zero-padded, lengths (n,) int64;
    length -1 marks a failed read).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(paths)
    blob = b"".join(p.encode() + b"\x00" for p in paths)
    out = np.empty((n, window_samples), np.float32)
    lengths = np.empty((n,), np.int64)
    seeds_arr = np.asarray(list(seeds), np.uint64)
    lib.wav_read_windows(
        blob,
        n,
        window_samples,
        seeds_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n_threads,
    )
    return out, lengths


_NORM_MODES = {"none": 0, "cmn": 1, "cmvn": 2}


class NativeLogmel:
    """Handle to a native log-mel plan (``native/logmel.cpp``).

    Same math as the log-mel of the step (``dsp/features.log_mel_spectrogram``);
    the mel filterbank and analysis window are computed in python
    (``dsp/mel.py``) and passed in, so the filterbank exists in one place.
    Raises RuntimeError in ``__init__`` if the native library is unavailable.
    """

    def __init__(self, feat_cfg):
        from ..dsp.mel import mel_filterbank, padded_stft_window

        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.cfg = feat_cfg
        self.n_mels = feat_cfg.n_mels
        window = np.ascontiguousarray(
            padded_stft_window(feat_cfg.win_length, feat_cfg.n_fft, dtype=np.float32)
        )
        fb = np.ascontiguousarray(
            mel_filterbank(
                feat_cfg.sample_rate, feat_cfg.n_fft, feat_cfg.n_mels,
                feat_cfg.fmin, feat_cfg.fmax_hz, dtype=np.float32,
            )
        )
        fp = ctypes.POINTER(ctypes.c_float)
        self._plan = lib.logmel_create(
            feat_cfg.n_fft, feat_cfg.hop_length, feat_cfg.n_mels,
            window.ctypes.data_as(fp), fb.ctypes.data_as(fp),
            feat_cfg.preemphasis, feat_cfg.rescale, feat_cfg.log_floor,
        )
        if not self._plan:
            raise RuntimeError("logmel_create failed (n_fft must be a power of two)")

    def __del__(self):
        plan = getattr(self, "_plan", None)
        if plan:
            self._lib.logmel_destroy(plan)
            self._plan = None

    def num_frames(self, n_samples: int) -> int:
        return int(self._lib.logmel_num_frames(self._plan, n_samples))

    def compute(self, wave: np.ndarray, normalization: str = "none",
                std_floor: float = 0.01) -> np.ndarray:
        """wave (N,) float32 in [-1,1] -> (T, n_mels) float32 log-mel."""
        wave = np.ascontiguousarray(wave, np.float32)
        frames = self.num_frames(wave.shape[0])
        out = np.empty((frames, self.n_mels), np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        got = self._lib.logmel_compute(
            self._plan, wave.ctypes.data_as(fp), wave.shape[0],
            _NORM_MODES[normalization], std_floor, out.ctypes.data_as(fp),
        )
        assert got == frames
        return out

    def wav_windows(
        self,
        paths: Sequence[str],
        window_samples: int,
        seeds: Sequence[int],
        normalization: str = "cmn",
        std_floor: float = 0.01,
        n_threads: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused decode + random-window + log-mel + CMN/CMVN over a batch.

        Returns (features (n, max_frames, n_mels) float32 zero-padded,
        frame_lengths (n,) int64; -1 marks a failed read).
        """
        n = len(paths)
        blob = b"".join(p.encode() + b"\x00" for p in paths)
        max_frames = self.num_frames(window_samples)
        out = np.empty((n, max_frames, self.n_mels), np.float32)
        lengths = np.empty((n,), np.int64)
        seeds_arr = np.asarray(list(seeds), np.uint64)
        fp = ctypes.POINTER(ctypes.c_float)
        self._lib.wav_logmel_windows(
            self._plan, blob, n, window_samples,
            seeds_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            _NORM_MODES[normalization], std_floor,
            out.ctypes.data_as(fp),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            n_threads,
        )
        return out, lengths


def try_native_logmel(feat_cfg) -> Optional["NativeLogmel"]:
    """A NativeLogmel plan, or None when the library can't be built."""
    try:
        return NativeLogmel(feat_cfg)
    except Exception:
        return None


def host_logmel_extractor(feat_cfg, normalization: str = "none"):
    """``wave (N,) float32 -> (T, n_mels) float32`` on the HOST: the native
    C++ kernel when built, numpy (pocketfft) otherwise. The one shared
    implementation behind serving uploads, wav validation loaders and the
    host-DSP training source."""
    plan = try_native_logmel(feat_cfg)
    if plan is not None:
        return lambda wave: plan.compute(wave, normalization)

    from ..data.dataset import normalize_np
    from ..dsp.features import log_mel_spectrogram_np

    def extract(wave: np.ndarray) -> np.ndarray:
        feats = log_mel_spectrogram_np(wave, feat_cfg)
        return feats if normalization == "none" else normalize_np(feats, normalization)

    return extract
