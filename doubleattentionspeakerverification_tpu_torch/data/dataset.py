"""Host-side training data pipeline: a copy of the JAX package's
``data/dataset.py``.

Reference semantics (``scripts/data.py:32-73``): per item, load pickled
(80, T) raw log-mel, transpose, CMN/CMVN over the *full* utterance, then take
a random fixed window of ``window_size*100`` frames (whole file if shorter).

The loader assembles fixed-shape microbatch groups (grad_accum, batch, T, 80)
on background threads; short utterances are zero-padded and carry a valid
length. Sources: precomputed feature pickles (reference parity), raw wavs
whose log-mel runs in the step (windows sampled in the sample domain), or
wavs whose log-mel runs on the host. Every draw is a pure function of
(seed, epoch, step, global row), so the stream is bit-identical to the JAX
package's for any worker count. A ``bfloat16`` feature transfer is a
``torch.bfloat16`` tensor (round to nearest even, as ``ml_dtypes``).
"""

from __future__ import annotations

import pickle
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..config import DataConfig, FeatureConfig, TrainConfig
from ..dsp.features import num_samples_for_frames
from .manifest import Utterance
from .wav import read_wav


def normalize_np(features: np.ndarray, mode: str, std_floor: float = 0.01) -> np.ndarray:
    """Host-side CMN/CMVN, identical to ``scripts/data.py:21-30``."""
    f = features - np.mean(features, axis=0)
    if mode == "cmvn":
        std = np.std(features, axis=0)
        std = np.where(std > std_floor, std, 1.0)
        f = f / std
    return f


def sample_window(features: np.ndarray, window: int, rng: np.random.Generator) -> np.ndarray:
    """Random fixed window (``data.py:50-55``): start ~ randint(0, max(0, T-W-1))
    inclusive; whole file if shorter than the window. Works on any leading
    axis (feature frames or raw samples) — the wav sources use the same
    distribution in the sample domain, as does the native batch kernel."""
    t = features.shape[0]
    hi = max(0, t - window - 1)
    start = int(rng.integers(0, hi + 1))
    return features[start : start + min(t, window)]


def as_row_rngs(rngs, n: int) -> List[np.random.Generator]:
    """Normalize a ``load_batch`` rng argument to one Generator per row.

    TrainLoader passes per-row Generators (streams keyed on the GLOBAL row
    index, so multi-host loaders agree); a single Generator is also accepted
    (library/tests convenience) and deterministically split."""
    if isinstance(rngs, np.random.Generator):
        return list(rngs.spawn(n))
    rngs = list(rngs)
    if len(rngs) != n:
        raise ValueError(f"expected {n} per-row rngs, got {len(rngs)}")
    return rngs


class FeaturePickleSource:
    """Reads reference-format ``<path>.pickle`` files of raw (80, T) log-mel."""

    def __init__(self, data_dir: str, normalization: str, window_frames: int):
        self.data_dir = data_dir
        self.normalization = normalization
        self.window = window_frames

    def load(self, utt: Utterance, rng: np.random.Generator):
        with open(f"{self.data_dir}/{utt.path}.pickle", "rb") as f:
            feats = pickle.load(f)
        feats = normalize_np(np.transpose(feats).astype(np.float32), self.normalization)
        win = sample_window(feats, self.window, rng)
        return win, win.shape[0]


class WavSource:
    """Reads wavs; returns raw sample windows — the log-mel runs inside the
    train step (kernel B2 on the card)."""

    def __init__(self, data_dir: str, feat_cfg: FeatureConfig, window_frames: int,
                 native_reader=None):
        self.data_dir = data_dir
        self.feat_cfg = feat_cfg
        self.window_samples = num_samples_for_frames(window_frames, feat_cfg)
        self.native_reader = native_reader

    def _path(self, utt: Utterance) -> str:
        path = f"{self.data_dir}/{utt.path}"
        if not path.endswith(".wav"):
            path += ".wav"
        return path

    def load(self, utt: Utterance, rng: np.random.Generator):
        path = self._path(utt)
        if self.native_reader is not None:
            wave = self.native_reader(path)
        else:
            wave, _sr = read_wav(path)
        win = sample_window(wave, self.window_samples, rng).astype(np.float32)
        return win, win.shape[0]

    def load_batch(self, utts, rngs: List[np.random.Generator]):
        """Whole-batch parallel decode + window via the native loader
        (falls back to per-file python reads, which draw other windows). ``rngs`` carries one Generator
        per row (host/worker-count-invariant streams, see TrainLoader).
        Returns (windows, lengths)."""
        rngs = as_row_rngs(rngs, len(utts))
        try:
            from ..utils.native import native_available, native_read_windows
        except Exception:
            native_available = lambda: False  # noqa: E731
        if not native_available():
            wins = np.zeros((len(utts), self.window_samples), np.float32)
            lengths = np.zeros((len(utts),), np.int64)
            for i, u in enumerate(utts):
                w, n = self.load(u, rngs[i])
                wins[i, :n] = w
                lengths[i] = n
            return wins, lengths
        seeds = np.asarray(
            [r.integers(0, 2**63 - 1, dtype=np.uint64) for r in rngs], np.uint64
        )
        wins, lengths = native_read_windows(
            [self._path(u) for u in utts], self.window_samples, seeds
        )
        bad = np.where(lengths < 0)[0]
        for i in bad:  # fall back per-file so one corrupt wav raises cleanly
            w, n = self.load(utts[i], rngs[i])
            wins[i, :n] = w
            lengths[i] = n
        return wins, lengths


class HostDspWavSource(WavSource):
    """Reads wavs and computes normalized log-mel windows ON THE HOST — the
    native C++ fused kernel (``native/logmel.cpp``: parallel decode + random
    window + FFT/mel + CMN) when built, numpy (pocketfft) otherwise.

    Emits feature batches in the same layout as :class:`FeaturePickleSource`,
    so the step runs its feature path.

    Normalization matches the device wav path (CMN/CMVN over the window's
    valid frames), not the reference's full-utterance normalization — the
    same deliberate deviation `WavSource` makes (windows are sampled before
    features exist).
    """

    def __init__(self, data_dir: str, feat_cfg: FeatureConfig, window_frames: int,
                 normalization: str = "cmn"):
        super().__init__(data_dir, feat_cfg, window_frames)
        self.feat_cfg = feat_cfg
        self.normalization = normalization
        self.window_frames = window_frames
        from ..utils.native import try_native_logmel

        self._native = try_native_logmel(feat_cfg)

    def _logmel_normalized(self, window: np.ndarray) -> np.ndarray:
        if self._native is not None:
            return self._native.compute(window, self.normalization)
        from ..dsp.features import log_mel_spectrogram_np

        feats = log_mel_spectrogram_np(window, self.feat_cfg)
        return normalize_np(feats, self.normalization)

    def load(self, utt: Utterance, rng: np.random.Generator):
        win, _n = super().load(utt, rng)
        feats = self._logmel_normalized(win)
        return feats, feats.shape[0]

    def load_batch(self, utts, rngs: List[np.random.Generator]):
        """Whole-batch fused native path; per-file python fallback.
        Returns (features (n, window_frames, n_mels), frame_lengths)."""
        n = len(utts)
        rngs = as_row_rngs(rngs, n)
        if self._native is None:
            out = np.zeros((n, self.window_frames, self.feat_cfg.n_mels), np.float32)
            lengths = np.zeros((n,), np.int64)
            for i, u in enumerate(utts):
                f, t = self.load(u, rngs[i])
                out[i, :t] = f
                lengths[i] = t
            return out, lengths
        seeds = np.asarray(
            [r.integers(0, 2**63 - 1, dtype=np.uint64) for r in rngs], np.uint64
        )
        feats, lengths = self._native.wav_windows(
            [self._path(u) for u in utts], self.window_samples, seeds,
            self.normalization,
        )
        bad = np.where(lengths < 0)[0]
        for i in bad:  # fall back per-file so one corrupt wav raises cleanly
            f, t = self.load(utts[i], rngs[i])
            feats[i, :t] = f
            lengths[i] = t
        return feats, lengths


class TrainLoader:
    """Yields microbatch groups ready for the train step.

    Each item: dict(inputs (G, B, T, F) float32 | waves (G, B, S) float32,
    lengths (G, B) int32, labels (G, B) int32). ``G`` is the gradient
    accumulation factor; the tail that doesn't fill a full group is dropped
    (the reference's leftover microbatches never trigger an optimizer step
    either, ``train.py:225-226``). With ``transfer_dtype="bfloat16"`` the
    feature batch ``inputs`` is a ``torch.bfloat16`` tensor.

    The GLOBAL batch stream (shuffle order, window draws, slicing cuts) is a
    pure function of (seed, epoch, step, global row); a host assembles only
    its ``local_rows`` slice of each batch's row axis (all of it on one
    host, the port's case), as the JAX package's multi-host loader does.
    """

    def __init__(
        self,
        manifest: Sequence[Utterance],
        source,
        train_cfg: TrainConfig,
        data_cfg: DataConfig,
        feature_dim: int = 80,
        is_wave: bool = False,
        host_id: int = 0,
        num_hosts: int = 1,
        seed: Optional[int] = None,
        local_rows: Optional[tuple] = None,
    ):
        self.manifest = list(manifest)
        self.source = source
        self.cfg = train_cfg
        self.data_cfg = data_cfg
        self.feature_dim = feature_dim
        self.is_wave = is_wave
        self.seed = train_cfg.seed if seed is None else seed
        self.window_frames = int(train_cfg.window_size * 100)
        self.group = train_cfg.gradient_accumulation
        self.batch = train_cfg.batch_size  # GLOBAL batch rows per microbatch
        if local_rows is None:
            num_hosts = max(1, num_hosts)
            if self.batch % num_hosts:
                raise ValueError(
                    f"batch_size {self.batch} not divisible by {num_hosts} hosts"
                )
            per = self.batch // num_hosts
            local_rows = (host_id * per, (host_id + 1) * per)
        self.local_rows = (int(local_rows[0]), int(local_rows[1]))

    @property
    def rows_per_host(self) -> int:
        return self.local_rows[1] - self.local_rows[0]

    def steps_per_epoch(self) -> int:
        return len(self.manifest) // (self.group * self.batch)

    # ------------------------------------------------------------------ core
    def _row_rng(self, epoch_idx: int, step: int, global_row: int) -> np.random.Generator:
        """Every random draw for one batch row comes from this stream — host-
        count- and worker-count-invariant by construction."""
        return np.random.default_rng((self.seed, epoch_idx, step, global_row))

    def _assemble(
        self,
        utts: List[Utterance],
        rngs: List[np.random.Generator],
        slice_rng: np.random.Generator,
    ) -> Dict[str, np.ndarray]:
        g, b = self.group, self.rows_per_host
        if self.is_wave:
            t_dim = self.source.window_samples
            inputs = np.zeros((g * b, t_dim), np.float32)
        else:
            t_dim = self.window_frames
            inputs = np.zeros((g * b, t_dim, self.feature_dim), np.float32)
        lengths = np.zeros((g * b,), np.int32)
        labels = np.asarray([u.label for u in utts], np.int32)
        if hasattr(self.source, "load_batch"):
            wins, lens = self.source.load_batch(utts, rngs)
            inputs[:, :] = wins
            lengths[:] = lens
        else:
            for i, utt in enumerate(utts):
                win, n = self.source.load(utt, rngs[i])
                inputs[i, :n] = win
                lengths[i] = n

        if self.cfg.assume_full_lengths and int(lengths.min()) < t_dim:
            short = [u.path for u, n in zip(utts, lengths) if n < t_dim][:3]
            raise ValueError(
                "assume_full_lengths is set but these utterances are shorter "
                f"than the {t_dim}-unit window: {short} ..."
            )

        if self.cfg.random_slicing:
            # Reference truncates each batch to a random length in
            # [200, window) frames (train.py:205-207). Snap up to a multiple
            # of 50, as the JAX package does. In device-DSP
            # wav mode the same cut is applied in the sample domain (exact
            # frame-count equivalence via num_samples_for_frames). Drawn from
            # the per-step slice stream, so every host cuts identically.
            cut = int(slice_rng.integers(200, self.window_frames))
            cut = min(self.window_frames, -(-cut // 50) * 50)
            if self.is_wave:
                cut_samples = num_samples_for_frames(cut, self.source.feat_cfg)
                inputs = inputs[:, :cut_samples]
                lengths = np.minimum(lengths, cut_samples)
            else:
                inputs = inputs[:, :cut]
                lengths = np.minimum(lengths, cut)

        key = "waves" if self.is_wave else "inputs"
        if self.cfg.transfer_dtype != "float32":
            if self.is_wave:
                # ship the original PCM16 samples losslessly at half width;
                # the device divides by 32768 again (dsp re-multiplies).
                # bfloat16 is silently promoted to int16 here: same 2
                # bytes/sample on the wire, but bf16's 8-bit mantissa would
                # QUANTIZE the audio (features then drift systematically) —
                # the flag means "halve the transfer", not "degrade PCM"
                inputs = np.clip(inputs * 32768.0, -32768, 32767).astype(np.int16)
            elif self.cfg.transfer_dtype == "bfloat16":
                import torch

                # round to nearest even, the rounding of ml_dtypes' cast
                inputs = torch.from_numpy(np.ascontiguousarray(inputs)).to(torch.bfloat16)
        return {
            key: inputs.reshape((g, b) + inputs.shape[1:]),
            "lengths": lengths.reshape(g, b),
            "labels": labels.reshape(g, b),
        }

    def epoch(
        self, epoch_idx: int, start_step: int = 0
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate one epoch with deterministic shuffling + prefetch thread.

        ``DataConfig.num_workers`` (the reference DataLoader's knob,
        ``train.py:78``) sets how many threads assemble batches in parallel;
        every draw derives from (seed, epoch, step, global row), so the
        output stream is identical for any worker count and any host count.

        ``start_step`` skips the first in-epoch steps exactly (each step's
        draws are keyed by its own step index, so the remainder of the
        stream is bit-identical to an uninterrupted epoch) — the mid-epoch
        resume path after a graceful-preemption checkpoint.
        """
        shuffle_rng = np.random.default_rng((self.seed, epoch_idx, 0xD47A))
        order = shuffle_rng.permutation(len(self.manifest))
        per_step = self.group * self.batch
        n_steps = len(order) // per_step
        if n_steps == 0 or start_step >= n_steps:
            return

        q: queue.Queue = queue.Queue(maxsize=max(1, self.data_cfg.prefetch))
        stop = threading.Event()
        workers = max(1, self.data_cfg.num_workers)
        lo, hi = self.local_rows

        def make_step(s: int) -> Dict[str, np.ndarray]:
            idx = order[s * per_step : (s + 1) * per_step]
            # this host's slice of each microbatch's global row axis
            utts, rngs = [], []
            for gi in range(self.group):
                for bi in range(lo, hi):
                    row = gi * self.batch + bi
                    utts.append(self.manifest[idx[row]])
                    rngs.append(self._row_rng(epoch_idx, s, row))
            slice_rng = np.random.default_rng((self.seed, epoch_idx, s, 0x51C3))
            return self._assemble(utts, rngs, slice_rng)

        def safe_put(item) -> bool:
            # never block forever on a consumer that went away: a producer
            # stuck in q.put would keep the executor's non-daemon threads
            # alive past interpreter shutdown
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                if workers == 1:
                    for s in range(start_step, n_steps):
                        if stop.is_set() or not safe_put(make_step(s)):
                            return
                else:
                    from collections import deque
                    from concurrent.futures import ThreadPoolExecutor

                    with ThreadPoolExecutor(max_workers=workers) as ex:
                        pending: deque = deque()
                        next_s = start_step
                        # bounded in-flight submissions: queue maxsize bounds
                        # finished batches, this bounds unfinished ones
                        while (next_s < n_steps or pending) and not stop.is_set():
                            while next_s < n_steps and len(pending) < workers + 2:
                                pending.append(ex.submit(make_step, next_s))
                                next_s += 1
                            if not safe_put(pending.popleft().result()):
                                return
            except BaseException as e:  # propagate to the consumer
                safe_put(e)
            else:
                safe_put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can finish
            while th.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            th.join(timeout=5)
