#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``csrc/`` (one ``nvcc``
each, all at once), holds each one against its plain PyTorch version on the
card and times it beside its bound: B2 (the FFT log-mel, at every radix
branch of its plan), B1 (MHA pooling, in float32 and bfloat16 at the four
serving buckets, with a cold-L2 time at the longest and, at each, the times
of other launches than the plan's, and at edge batches: rows of length 0
and below 0, rows split over a 2-rank cluster with lengths below 2, a head
of 5 values and one of 512; and its gradient, ``MhaPoolFunction``'s torch-op
backward around the kernel's forward, against autograd through the plain
version, with one launch a forward under grad mode), B3 (the
int8 3x3 conv on ``wgmma``, at the seven
paper-width conv shapes and edge shapes) and the two probes P1 (the
``wgmma`` int8/bf16 matrix rate) and P2 (B3's full / dot-only / copy-only
modes). It checks the card's path
against the CPU path on the committed example checkpoint, in float32 and in
int8_static (equal scales, equal int8 activations at every conv), then
serves HTTP requests with two paper-width models (VGG4L, kernel_size 1024,
32 heads, DoubleMHA, embedding 400; random weights from a fixed seed): the
float32 one, and an ``int8_static`` one calibrated on a seeded upload,
whose embeddings are held to its own static forward with B3's plain
version. The kernels' launch
counts, set to 0 just before each server is driven and read just after,
show that each serving path went through its kernels. Last, the ``[train]``
phase trains the paper's model with its recipe (5994 speakers, Adam at
1e-4, 2 microbatches of 64 windows of 3.5 s as int16 PCM, so B2 runs in the
step and B1 in every forward): step 1's gradients on the kernel path are
held to the same step with B1's plain version, one small step to the CPU,
and three steps, driven with every launch count at 0, are timed beside the
peak memory. The ``[trainer]`` phase then runs the port's trainer through
its CLI (``cli/train.py``'s ``main``) at the same width on a seeded wav
corpus (32 speakers x 8 utterances of 3.5-6 s; validation over 16
utterances of 2-12 s): two epochs of two steps with the log-mel in the step,
asynchronous validation every 2 steps and a checkpoint every step. It checks
finite losses, two EERs in [0, 50], the checkpoints' JAX-format leaves, the
pruning, B1's and B2's launches (counts read from 0), and that a run stopped
by ``request_stop`` at step 3 and resumed with ``--requeue`` takes step 4 as
the uninterrupted run does (cuDNN deterministic; that run copies its
batches ahead with ``--device_prefetch 2``); it prints the loop's
steps/s, audio seconds per second, loader wait, dispatch, validation and
checkpoint times, the peak memory and the isolated step's time.

``[distributed]`` trains across processes (``parallel/``), each started by
``tools/multihost_check.py`` from this script (``chip_smoke:dist_*``).
First NCCL at world size 1: one step of a small model through the port's
multi-process step, whose gradient all-reduce runs on the communicator,
against the same step without it. Then two ranks sharing the card over
gloo take the paper recipe's step ([train]'s batch, seed-0 weights): once
data-parallel (32 rows a rank), once with the AM-Softmax W split over the
two ranks (2997 columns a rank); each is held to one process's step on the
card (the loss to [train]'s card-vs-CPU tolerance, the gradients by
[train]'s measure, the Adam update by its L2 distance), the two ranks'
parameters equal bit for bit after it; each rank launches B1 and B2
(counts from 0) and prints its median step time (CUDA events) and peak
memory. Last ``cli/train.py --distributed --model_parallel 2
--checkpoint_backend orbax`` with SGD on the [trainer] corpus for 4 steps:
its losses within 1e-3 and its sharded EERs within 0.51 of one process's
run (JAX scenario A's tolerances), each rank embedding half the validation
utterances, the embedding cache each validation gathered equal on both
ranks and held to one process's run's, utterance by utterance; and one
process resuming from the ranks' step-2 ``.dcp`` continues that run to
1e-3 (scenario T).

On that corpus, ``[score_trials]`` drives ``cli/score_trials.py``'s and
``cli/train_plda.py``'s ``main`` at paper width (seed 0, written as a
JAX-format ``.npz``; its weights made input-driven, as a trained model's
are, so cosines spread over [-1, 1]): float32 in wav mode (B2 once an
utterance, B1 once a bucketed batch; each score against the cosine of
``embed_wave``'s embeddings of the same two waves; the extraction's
utterances and audio seconds per second), ``int8_static`` calibrated on a
wav and again on the saved scales (7 B3 launches a forward; the same
bytes), AS-Norm against the 256 training utterances' store at top-0 and
top-50 and PLDA trained on that store (each line equal to a host
recomputation from the stores). ``[score_trials example]`` scores
``example_model.npz`` over the example corpus on the card and on the CPU
against ``golden_scores.json``; ``[extract_features]`` writes the 16
validation wavs' pickles (B2 once a file) against B2's plain version;
``[alignments]`` holds the example checkpoint's attention weights, card
against CPU; ``[export]`` turns the trainer's newest checkpoint into a
reference ``.chkpt`` that embeds on the card as the ``.npz`` does. Each
counts its kernels' launches from 0.

The kernel dispatcher (``utils/kernel_auto.py``): ``[dispatch]`` resolves
the paper config from scratch (B2 and B1 to their kernels behind their
self-checks, whose launches are counted apart from the path's; each
check's largest difference and time), shows a B2 made 5e-4 off failing
its check with a raise, runs a 4 s upload with ``use_pallas_dsp=False``
and ``use_pallas_pooling=False`` (no B1 or B2 launch; log-mel, B1's
contexts and the embedding against the default path's) and prints the
``int8_static`` gate's verdict with B3's and its plain version's times.
``[train remat]`` takes [train]'s step with ``remat_vgg`` (step 1's
gradients held to [train]'s by [train]'s measure; the median of three
timed steps and the peak memory beside [train]'s). ``[train bf16]`` takes
it with ``compute_dtype="bfloat16"``, on [train]'s batch and with
``assume_full_lengths`` on full windows (bench.py's configuration): the
loss, the accuracy and every gradient against the float32 step's, each
gradient's distance held to that of the float32 step with the bfloat16
encoder's roundings emulated (``tools/bf16_drift.py``); ``[train full]``
takes the float32 step with ``assume_full_lengths`` against the masked one
on the same full windows; each is timed beside [train] with its peak memory
and B1 2 and B2 1 launches a step. ``[distributed]`` also checks the
asynchronous ``.dcp`` saves (``utils/dist_ckpt.py:DcpAsyncSaver``): one
through NCCL at world size 1 (no ``meta.json`` before its wait, every leaf
back), the CLI runs' ``ckpt_save`` modes and ``blocked_s``, a
``--no-checkpoint_async`` run leaving the leaves of the asynchronous one,
and the saver alone on the paper model's leaves against a synchronous
save. ``[profile]`` runs
``cli/train.py`` for 4 steps on the [trainer] corpus with
``--profile_dir`` (steps 2-3) and ``--tensorboard_dir``: the trace holds
B1's and B2's kernels by symbol, the TensorBoard scalars equal the JSONL
losses, and the window's ten kernels with the most device time are
printed. Any failed phase exits non-zero. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "doubleattentionspeakerverification_tpu_torch"
DEVICE = "cuda"

TOL_LOGMEL = 2e-4        # JAX holds Pallas against XLA to this (tests/test_pallas_logmel.py)
TOL_POOL = 1e-5
# B1's bfloat16 d_ht against autograd through the plain version: both compute
# in float32 and round to bfloat16 once, so where their float32 values differ
# in the last bits they may round to neighbouring bfloat16 values, one step
# (at most 2^-7 of the value) apart
TOL_POOL_GRAD_BF16 = 2.0 ** -7
# train step: each gradient within this fraction of the largest value of its
# scale (scale_key); the loss card vs CPU within this
TOL_TRAIN_GRAD = 1e-4
TOL_TRAIN_LOSS = 1e-5
# Card vs CPU: at random weights the encoder's gradients, and fc2.bias's
# (scale_key), jump where float32 rounding moves a ReLU or a max-pool
# decision across its tie, and the card's convolutions round differently
# from the CPU's in every layer. So these are held by their L2 distance,
# within TOL_TRAIN_L2 of their scale's norm, and the rest by TOL_TRAIN_GRAD.
# The phase shows the effect on the CPU alone: its own step again with its
# features moved by TRAIN_NUDGE of their value
TOL_TRAIN_L2 = 2e-2
TRAIN_NUDGE = 1e-7
TRAIN_STEPS = 3
# B x seconds of the card-vs-CPU step: at B=2 train-mode BatchNorm is near
# saturation (each feature normalizes to about +-1), which leaves the
# gradients before it a near-cancellation; 8 items keep them well-conditioned
TRAIN_SMALL = (8, 2.0)
# [train bf16]: the bfloat16 step (compute_dtype="bfloat16") against the
# float32 step on the same batch. bfloat16 rounds to nearest at 8 significant
# bits, a relative error of at most 2^-9 a rounding. The loss (a mean of
# float32 terms after the encoder) within one bfloat16 step, 2^-8, of its
# value; the accuracy within one item a microbatch (an item whose top two
# cosines lie within the encoder's rounding may swap them). Each gradient's
# L2 distance from the float32 step's is what bfloat16's roundings make of
# it through the encoder (at random weights, tens of percent in the first
# convs, whose gradients are sums that largely cancel), so it is held to the
# float32 step run with the encoder's roundings emulated by random errors of
# their size (tools/bf16_drift.py): within TOL_BF16_EMU times that step's
# distance, or within 2^-8 of the gradient's norm. The bfloat16 step also
# rounds its backward's cotangents, which the emulation does not; on the CPU
# the largest ratio of the two distances was 2.90 at k=64, 2.47 at k=128 and
# 1.44-1.87 at k=256 over three seeds (bf16_drift on normal features).
TOL_BF16_LOSS = 2.0 ** -8
TOL_BF16_EMU = 4.0
# [trainer]: the corpus, and step 4's loss after a stop at step 3 and a
# resume, against the uninterrupted run's (cuDNN deterministic, the state
# read back from float32 checkpoint leaves: equal up to float32 rounding)
TRAINER_SPEAKERS, TRAINER_UTTS, TRAINER_SECONDS = 32, 8, (3.5, 6.0)
TRAINER_VALID, TRAINER_VALID_SECONDS = 16, (2.0, 12.0)
TRAINER_STOP = 3
TRAINER_BENCH = 4
PROFILE_WINDOW = (2, 2)  # [profile]: trace steps 2 and 3 of a 4-step cli/train.py run
PROFILE_GROUPS = (       # [profile]: kernel names by what they compute, first match wins
    ("B1", ("mha_pool_kernel",)),
    ("B2", ("logmel_kernel",)),
    ("convolutions and matrix products (cuDNN, cuBLAS, FFT)",
     ("xmma", "gemm", "cudnn", "fft", "fprop", "dgrad", "wgrad")),
    ("max-pool", ("max_pool",)),
    ("elementwise and reductions (ATen)", ("at::native",)),
)
TOL_TRAINER_RESUME = 1e-5
# [distributed]: two ranks share the card over gloo. The step at paper width
# is held to one process's as [train] holds card vs CPU; the CLI runs' losses
# and EERs to JAX scenario A's cross-topology tolerances
# (tools/multihost_trainer_check.py:292), its 2 -> 1 resume to scenario T's
DIST_STEPS = 3           # timed steps a rank after the compared step 1
TOL_DIST_LOSS = 1e-3
TOL_DIST_EER = 0.51
# The step's update (the parameters after it less those before) against one
# process's, by L2 distance over the norm of one process's update. Adam's
# first step moves each element by about lr times the sign of its gradient,
# so an element whose gradient lies below the runs' rounding disagreement
# may flip, adding 2 / sqrt(n) for a tensor of n elements; a step that did
# not update, or updated at another scale, lies at 1. fc2.bias is exempt:
# b2 takes the batch mean out of fc2's outputs, so its gradient is what
# rounding leaves of a cancellation, and Adam turns that into an update of
# full size in any direction (its gradient is held by L2 with the rest)
TOL_DIST_UPDATE = 0.1
UPDATE_EXEMPT = ("fc2.bias",)
# sharded validation: the 2-rank run's gathered embedding cache against one
# process's, within this fraction of its largest value (the runs' weights
# differ by the ranks' rounding), each utterance's nearest to its own
TOL_DIST_EMBED = 1e-5
DIST_TIMEOUT = 900
TOL_EMBED = 1e-4         # golden-embedding tolerance (tests/test_example_artifact.py)
TOL_CONV_FP = 1e-6       # B3 float outputs, relative (int8 outputs must be equal)
COSINE_GUARD = 0.98      # int8_static vs fp embeddings (models/quantized.py's guard)
# served int8_static embeddings vs the same forward with B3's plain version: the
# int8 activations are equal, so only the float32 tail's other batch shapes
# differ; random paper-width embeddings differ from upload to upload by ~1e-4
TOL_INT8_SERVED = 1e-6

LOGMEL_CASES = ((1, 2.0), (1, 10.0), (1, 60.0), (8, 10.0))   # (batch, seconds)
LOGMEL_MAIN = (1, 10.0)                                        # reported in the kernels line
LOGMEL_OTHER = (dict(sample_rate=8000), dict(sample_rate=8000, n_fft=256),
                dict(window_stride_s=0.0026), dict(n_fft=480), dict(n_fft=448), dict(n_fft=449))
POOL_T = (7, 32, 63, 250)        # T' of the 100/500/1000/4000-frame serving buckets
POOL_MAIN = 63
POOL_B, POOL_H, POOL_DH = 8, 32, 160
POOL_EDGE = (            # (B, T, H, d_h, lengths), each in float32 and bfloat16:
    # paper width with length-0 rows (-3 counts as 0), one above T; one block a row
    (8, 50, 32, 160, (0, 1, 3, 7, 50, 9, -3, 57)),
    # spans of 15 values: not 16-byte aligned, so plain loads
    (3, 20, 3, 5, (20, 0, 6)),
    # the largest head the wrapper takes
    (4, 40, 4, 512, (40, 0, 5, 33)),
    # T and a launch past the plan's cluster thresholds, so a cluster of R = 2
    # ranks a row: lengths 0 and below, 1 (below R: the second rank has no
    # step), odd, above T
    (8, 200, 8, 160, (0, 1, 7, 199, 250, -1, 200, 33)),
    (3, 201, 3, 5, (201, 1, 0)),
    (2, 240, 4, 512, (239, 1)),
)
POOL_SINGLE = (250, 1000)        # T' of one upload alone (B=1): 10 s, and a 40 s file
# (R, G, S) launches timed beside the plan's (pool_sweep)
POOL_SWEEP = ((1, 4, 1), (1, 2, 1), (1, 2, 2), (1, 1, 4), (1, 1, 8), (2, 1, 4), (2, 1, 8))
POOL_FLUSH_BYTES = 64 * 2**20    # written between launches for B1's cold-L2 time
SERVE_SECONDS = (1.0, 2.5, 4.0, 4.5, 8.0, 8.5, 9.0, 12.0)
# [score_trials]: AS-Norm top-K cases; each written score against the cosine of
# embed_wave's embeddings of the same two waves (one upload at a time, so other
# batch shapes and cuDNN algorithms; scores are written with 6 decimals)
SCORE_TOPK = (0, 50)
TOL_SCORE_EMBED = 1e-4
TOL_SCORE_DEVICES = 1e-4  # example checkpoint: the card's score file against the CPU's
TOL_ALIGN = 1e-5          # alignments, card vs CPU (the CPU tests hold the port to JAX at this)
TOL_EXPORT = 1e-6         # the exported .chkpt's embeddings against the .npz's, both on the card
CONV_B = 8               # 8 uploads of 10 s: T = 1000 frames at the first conv
CONV_PAPER = (           # (name, T, F, Cin, Cout) of the seven B3 convs of VGG4L k=1024
    ("conv12", 1000, 80, 128, 128), ("conv21", 500, 40, 128, 256),
    ("conv22", 500, 40, 256, 256), ("conv31", 250, 20, 256, 512),
    ("conv32", 250, 20, 512, 512), ("conv41", 125, 10, 512, 1024),
    ("conv42", 125, 10, 1024, 1024),
)
CONV_EDGE = (            # (B, T, F, Cin, Cout): ragged last tile, T=1, tiny F, small Cin/Cout,
    (3, 37, 40, 128, 256), (2, 13, 10, 96, 200), (1, 1, 80, 128, 128), (2, 1, 5, 8, 16),
    (2, 20, 5, 8, 16), (2, 50, 80, 2, 16), (2, 50, 80, 3, 8), (2, 50, 80, 4, 32),
    # Cin 1; a one-channel last chunk with an N tail past 256; F > 258, where
    # the patch's three bands no longer overlap
    (2, 9, 7, 1, 3), (1, 3, 80, 33, 264), (1, 4, 300, 16, 24),
)


class PhaseError(RuntimeError):
    pass


class StopAt:
    """A trainer logger (the port's ``MetricLogger``, built at first use)
    that calls ``request_stop`` on its trainer when the ``train`` event of
    ``step`` is logged: a SIGTERM handler's call, at a known step."""

    def __init__(self, path, step):
        from doubleattentionspeakerverification_tpu_torch.utils.logging import MetricLogger

        self.inner = MetricLogger(jsonl_path=path)
        self.trainer, self.stop_step = None, step

    def log(self, event, **fields):
        self.inner.log(event, **fields)
        if event == "train" and int(fields["step"]) == self.stop_step and self.trainer:
            self.trainer.request_stop("chip_smoke")

    def close(self):
        self.inner.close()


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseError(msg)


def cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def seeded_speech(rng, seconds: float, sr: int = 16000) -> np.ndarray:
    """A harmonic stack with a wandering pitch plus noise, in [-1, 1]."""
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(100, 250) + 30 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    y = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6))
    return (y + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


# ---------------------------------------------------------------- phases
def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} visible")
    print(smi.stdout.strip())
    return name, smi.stdout.strip()


def phase_build():
    from doubleattentionspeakerverification_tpu_torch import ops
    from doubleattentionspeakerverification_tpu_torch.ops.kernels import build_all
    from doubleattentionspeakerverification_tpu_torch.tools import rate_probe

    t0 = time.perf_counter()
    logs = build_all(ops.KERNELS + [rate_probe.KERNEL])
    print(f"[build] {len(logs)} kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if ("registers" in line or ("spill" in line and "0 bytes spill" not in line)
                    or "wgmma" in line):
                print(f"[build] {name}: {line.strip()}")


def logmel_work(cfg, b: int, n: int):
    """(bytes, operations) B2 needs for a (b, n) upload: audio in, features
    out and its constants read once; the plan's butterflies and twiddle
    multiplies (a direct radix-R stage: R outputs of R-1 complex
    multiply-adds), the window, the split step, the magnitudes and the
    band-limited mel sum, per frame."""
    from doubleattentionspeakerverification_tpu_torch.dsp.features import (
        dft_mel_constants, num_frames,
    )
    from doubleattentionspeakerverification_tpu_torch.ops import logmel

    plan = logmel.fft_plan(cfg.n_fft)
    header, table = logmel.pack_plan(plan)
    bands = logmel.mel_bands(dft_mel_constants(cfg)[2])
    band_bins = int((bands[:, 1] - bands[:, 0]).sum())
    n_bins = cfg.n_fft // 2 + 1
    frame_ops = cfg.n_fft + n_bins * (4 + (16 if plan.packed else 0)) + 2 * band_bins + 2 * cfg.n_mels
    for r, ns in zip(plan.radices, plan.strides):
        core = {4: 16, 2: 4}.get(r, 8 * r * (r - 1))
        frame_ops += plan.size // r * (core + (6 * (r - 1) if ns > 1 else 0))
    t = num_frames(n, cfg)
    n_bytes = (4 * (b * n + b * t * cfg.n_mels + cfg.n_fft + band_bins)
               + header.nbytes + table.nbytes + bands.nbytes)
    return n_bytes, float(b * t * frame_ops)


def phase_logmel():
    import torch

    from doubleattentionspeakerverification_tpu_torch.config import FeatureConfig
    from doubleattentionspeakerverification_tpu_torch.dsp.features import (
        dft_mel_constants, num_frames, preemphasize,
    )
    from doubleattentionspeakerverification_tpu_torch.dsp.mel import padded_stft_window
    from doubleattentionspeakerverification_tpu_torch.ops import logmel
    from doubleattentionspeakerverification_tpu_torch.tools.timing import (
        FP32_OPS_PER_S, bound_ms, cuda_ms, eager_ms,
    )

    cfg = FeatureConfig()
    rng = np.random.default_rng(0)
    n_bins = cfg.n_fft // 2 + 1
    window = torch.from_numpy(padded_stft_window(cfg.win_length, cfg.n_fft)).to(DEVICE)
    mel_t = torch.from_numpy(dft_mel_constants(cfg)[2]).to(DEVICE)

    def library(w):
        spec = torch.stft(preemphasize(w, cfg), cfg.n_fft, cfg.hop_length, cfg.n_fft, window,
                          center=False, return_complex=True)
        return torch.log(torch.clamp(spec.abs().transpose(1, 2) @ mel_t, min=cfg.log_floor))

    def truth(w, c):
        """The log-mel in float64 (torch.fft on the card), for the error of each version."""
        t = num_frames(w.shape[-1], c)
        win = torch.from_numpy(padded_stft_window(c.win_length, c.n_fft, np.float64)).to(DEVICE)
        frames = preemphasize(w, c).double().unfold(-1, c.n_fft, c.hop_length)[..., :t, :] * win
        mel = torch.fft.rfft(frames).abs() @ torch.from_numpy(dft_mel_constants(c)[2]).to(DEVICE).double()
        return torch.log(torch.clamp(mel, min=c.log_floor))

    worst, main = 0.0, None
    for b, seconds in LOGMEL_CASES:
        n = int(seconds * cfg.sample_rate)
        wave = torch.from_numpy(np.stack([seeded_speech(rng, seconds) for _ in range(b)])).to(DEVICE)
        got = logmel.log_mel_cuda(wave, cfg)
        ref = logmel.log_mel_plain(wave, cfg)
        lib = library(wave)
        exact = truth(wave, cfg)
        torch.cuda.synchronize()
        t = num_frames(n, cfg)
        check(got.shape == ref.shape == (b, t, cfg.n_mels), f"B2 shape {tuple(got.shape)}")
        err = float((got - ref).abs().max())
        check(math.isfinite(err) and err <= TOL_LOGMEL,
              f"B2 disagrees with its plain version at B={b}, {seconds} s: {err:.3g}")
        worst = max(worst, err)
        iters = 20 if b * seconds <= 10 else 5
        ms = cuda_ms(lambda: logmel.log_mel_cuda(wave, cfg), iters)
        eager = eager_ms(lambda: logmel.log_mel_cuda(wave, cfg), 50)
        plain_ms = cuda_ms(lambda: logmel.log_mel_plain(wave, cfg), iters)
        library_ms = cuda_ms(lambda: library(wave), iters)
        b_ms, b_by = bound_ms(*logmel_work(cfg, b, n), FP32_OPS_PER_S)
        dft_ms = 2.0 * b * t * (cfg.n_fft * 2 * n_bins + n_bins * cfg.n_mels) / FP32_OPS_PER_S * 1e3
        print(f"[B2 logmel] B={b} {seconds:g} s T={t}: max|d|={err:.3g} (tol {TOL_LOGMEL}); "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by}; the DFT's operation bound {dft_ms:.4f}); "
              f"eager call {eager:.4f} ms; vs float64: kernel {float((got - exact).abs().max()):.3g}, "
              f"plain {float((ref - exact).abs().max()):.3g}, stft+matmul {float((lib - exact).abs().max()):.3g}")
        if (b, seconds) == LOGMEL_MAIN:
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    # every radix branch of the plan: 4 and 2 (n_fft 256 and 512), 3 and 5 (480),
    # 7 (448), a prime n_fft as one direct stage (449), hop 41 (unaligned frames)
    for kw in LOGMEL_OTHER:
        other = FeatureConfig(**kw)
        wave = torch.from_numpy(np.stack([seeded_speech(rng, 3.0, other.sample_rate)
                                          for _ in range(2)])).to(DEVICE)
        err = float((logmel.log_mel_cuda(wave, other) - logmel.log_mel_plain(wave, other)).abs().max())
        check(math.isfinite(err) and err <= TOL_LOGMEL,
              f"B2 disagrees with its plain version at {other}: {err:.3g}")
        worst = max(worst, err)
        plan = logmel.fft_plan(other.n_fft)
        b_ms, b_by = bound_ms(*logmel_work(other, *wave.shape), FP32_OPS_PER_S)
        print(f"[B2 logmel] B=2 3 s at {other.sample_rate} Hz, n_fft {other.n_fft}, hop "
              f"{other.hop_length} (radices {plan.radices}{'' if plan.packed else ', unpacked'}): "
              f"max|d|={err:.3g} (tol {TOL_LOGMEL}); kernel_ms="
              f"{cuda_ms(lambda: logmel.log_mel_cuda(wave, other), 5):.4f} plain_ms="
              f"{cuda_ms(lambda: logmel.log_mel_plain(wave, other), 5):.4f} bound_ms={b_ms:.5f} ({b_by})")
    return dict(max_abs_err=worst, **main)


def pool_check(ht4, q_t, lens, what):
    """B1 against its plain version on the same inputs; rows whose length
    is 0 or below must come out exactly zero. Returns max |d|."""
    import torch

    from doubleattentionspeakerverification_tpu_torch.ops import mha_pool

    got = mha_pool.mha_pool_cuda(ht4, q_t, lens)
    ref = mha_pool.mha_pool_plain(ht4, q_t, lens)
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"B1 shape {tuple(got.shape)} at {what}")
    err = float((got - ref).abs().max())
    check(math.isfinite(err) and err <= TOL_POOL,
          f"B1 disagrees with its plain version at {what}: max|d| {err:.3g}")
    empty = lens <= 0
    check(bool((got[empty] == 0).all()), f"B1 rows of length <= 0 are not zero at {what}")
    return err


def pool_plan(b, tp, heads, d_h, dtype):
    """The launch B1 makes for these shapes. The kernel's launch bounds (256
    threads, 2 blocks an SM) cap it at 128 registers a thread, so an SM holds
    at least 65536 / (128 * threads) of its blocks (shared memory is at most
    17 KB a block)."""
    import torch

    from doubleattentionspeakerverification_tpu_torch.ops import mha_pool

    plan = mha_pool.launch_plan(b, tp, heads, d_h, torch.finfo(dtype).bits // 8)
    threads = 32 * plan["heads_per_block"] * plan["warps_per_head"]
    resident = torch.cuda.get_device_properties(0).multi_processor_count * min(
        32, 65536 // (128 * threads))
    return (f"G={plan['heads_per_block']} S={plan['warps_per_head']} R={plan['ranks']} "
            f"chains of {plan['chain_lanes']} lanes, "
            f"{'16-byte' if plan['vec'] > 1 else 'single-value'} loads, {plan['smem']} B shared "
            f"a block, {plan['blocks']} blocks of {threads} threads, at least {resident} resident "
            f"({'one wave' if resident >= plan['blocks'] else 'more than one wave'})")


def pool_launch(ht4, q_t, lens, out, ranks, heads_per_block, warps_per_head):
    """One B1 launch with the given R, G, S instead of the plan's: what the
    plan's choice is measured against. Not a path of the port."""
    import torch

    from doubleattentionspeakerverification_tpu_torch.ops import mha_pool

    b, t, heads, d_h = ht4.shape
    plan = mha_pool.launch_plan(b, t, heads, d_h, ht4.element_size(), ht4.data_ptr(),
                                q_t.data_ptr())
    mha_pool.KERNEL.launch(
        ht4.data_ptr(), q_t.data_ptr(), lens.data_ptr(), out.data_ptr(), b, t, heads, d_h,
        int(ht4.dtype == torch.bfloat16), heads_per_block, warps_per_head, ranks, plan["vec"],
        torch.cuda.current_stream().cuda_stream)


def pool_sweep(ht4, q_t, lens, ms):
    """B1's time at these inputs with the plan's launch, with all lengths 0
    (launch, setup, combine and output, no step loaded) and all lengths 1, and
    with each launch of POOL_SWEEP (each also held to the plain version)."""
    import torch

    from doubleattentionspeakerverification_tpu_torch.ops import mha_pool
    from doubleattentionspeakerverification_tpu_torch.tools.timing import cuda_ms

    times = {}
    for name, lengths in (("lengths 0", torch.zeros_like(lens)), ("lengths 1", torch.ones_like(lens))):
        times[name] = cuda_ms(lambda: mha_pool.mha_pool_cuda(ht4, q_t, lengths), 50)
    ref = mha_pool.mha_pool_plain(ht4, q_t, lens)
    out = torch.empty_like(ref)
    for r, g, s in POOL_SWEEP:
        pool_launch(ht4, q_t, lens, out, r, g, s)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(math.isfinite(err) and err <= TOL_POOL,
              f"B1 launched with R={r} G={g} S={s} disagrees with its plain version: {err:.3g}")
        times[f"R{r}G{g}S{s}"] = cuda_ms(lambda: pool_launch(ht4, q_t, lens, out, r, g, s), 50)
    print(f"[B1 mha_pool] T'={ht4.shape[1]} sweep: kernel_ms={ms:.5f} with the plan's launch; "
          + ", ".join(f"{k} {v:.5f}" for k, v in times.items()))


def phase_pool():
    import torch
    import torch.nn.functional as F

    from doubleattentionspeakerverification_tpu_torch.ops import mha_pool
    from doubleattentionspeakerverification_tpu_torch.tools.timing import (
        FP32_OPS_PER_S, bound_ms, cuda_ms, eager_ms,
    )

    rng = np.random.default_rng(1)
    scale = 1.0 / math.sqrt(POOL_H)          # the reference's d_k = heads quirk
    worst, main = 0.0, None
    for tp in POOL_T:
        ht4 = torch.from_numpy(
            rng.standard_normal((POOL_B, tp, POOL_H, POOL_DH)).astype(np.float32)).to(DEVICE)
        q_t = torch.from_numpy(
            (rng.standard_normal((POOL_H, POOL_DH)) * scale).astype(np.float32)).to(DEVICE)
        lens_np = np.r_[tp, 1, rng.integers(1, tp + 1, POOL_B - 2)].astype(np.int32)
        lens = torch.from_numpy(lens_np).to(DEVICE)
        err = pool_check(ht4, q_t, lens, f"T'={tp} float32")
        ref = mha_pool.mha_pool_plain(ht4, q_t, lens)
        ht_bf = ht4.to(torch.bfloat16)
        err_bf = pool_check(ht_bf, q_t, lens, f"T'={tp} bfloat16")
        worst = max(worst, err, err_bf)
        # yardstick: SDPA with one query per head and the length mask
        q4 = q_t[None, :, None, :].expand(POOL_B, -1, -1, -1).contiguous()
        kv = ht4.permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(tp, device=DEVICE)[None, :] < lens[:, None])[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(q4, kv, kv, attn_mask=mask, scale=1.0)

        lib = library()[:, :, 0]
        ms = cuda_ms(lambda: mha_pool.mha_pool_cuda(ht4, q_t, lens), 50)
        bf_ms = cuda_ms(lambda: mha_pool.mha_pool_cuda(ht_bf, q_t, lens), 50)
        eager = eager_ms(lambda: mha_pool.mha_pool_cuda(ht4, q_t, lens), 100)
        plain_ms = cuda_ms(lambda: mha_pool.mha_pool_plain(ht4, q_t, lens), 20)
        library_ms = cuda_ms(library, 20)
        valid = int(np.minimum(lens_np, tp).sum())
        b_ms, b_by = bound_ms(
            (valid * POOL_H * POOL_DH + q_t.numel() + POOL_B + POOL_B * POOL_H * POOL_DH) * 4,
            4.0 * valid * POOL_H * POOL_DH, FP32_OPS_PER_S)
        print(f"[B1 mha_pool] B={POOL_B} T'={tp} H={POOL_H} d_h={POOL_DH} lengths={lens_np.tolist()}: "
              f"max|d|={err:.3g} (tol {TOL_POOL}); kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={library_ms:.5f} bound_ms={b_ms:.5f} ({b_by}); "
              f"eager call {eager:.4f} ms; sdpa max|d|={float((lib - ref).abs().max()):.3g}; "
              f"bfloat16 ht max|d|={err_bf:.3g} kernel_ms={bf_ms:.5f}")
        print(f"[B1 mha_pool] T'={tp} float32: {pool_plan(POOL_B, tp, POOL_H, POOL_DH, torch.float32)}; "
              f"bfloat16: {pool_plan(POOL_B, tp, POOL_H, POOL_DH, torch.bfloat16)}")
        pool_sweep(ht4, q_t, lens, ms)
        if tp == POOL_MAIN:
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
        if tp == max(POOL_T):
            # cold L2: a 64 MB write between launches, timed alone and subtracted
            flush = torch.empty(POOL_FLUSH_BYTES // 4, device=DEVICE)

            def both():
                flush.fill_(1.0)
                mha_pool.mha_pool_cuda(ht4, q_t, lens)

            with_flush = cuda_ms(both, 20)
            flush_ms = cuda_ms(lambda: flush.fill_(1.0), 20)
            print(f"[B1 mha_pool] T'={tp} cold L2: kernel_ms={with_flush - flush_ms:.5f} "
                  f"({with_flush:.5f} with a {POOL_FLUSH_BYTES >> 20} MB write before each "
                  f"launch, the write alone {flush_ms:.5f}); bound_ms={b_ms:.5f}")
            del flush
    for tp in POOL_SINGLE:
        # one upload alone, every step valid: the plan splits it over a cluster
        ht4 = torch.from_numpy(
            rng.standard_normal((1, tp, POOL_H, POOL_DH)).astype(np.float32)).to(DEVICE)
        q_t = torch.from_numpy(
            (rng.standard_normal((POOL_H, POOL_DH)) * scale).astype(np.float32)).to(DEVICE)
        lens = torch.full((1,), tp, dtype=torch.int32, device=DEVICE)
        err = pool_check(ht4, q_t, lens, f"B=1 T'={tp} float32")
        worst = max(worst, err)
        ref = mha_pool.mha_pool_plain(ht4, q_t, lens)
        q4 = q_t[None, :, None, :].contiguous()
        kv = ht4.permute(0, 2, 1, 3).contiguous()
        mask = torch.ones((1, 1, 1, tp), dtype=torch.bool, device=DEVICE)

        def library():
            return F.scaled_dot_product_attention(q4, kv, kv, attn_mask=mask, scale=1.0)

        lib = library()[:, :, 0]
        ms = cuda_ms(lambda: mha_pool.mha_pool_cuda(ht4, q_t, lens), 50)
        plain_ms = cuda_ms(lambda: mha_pool.mha_pool_plain(ht4, q_t, lens), 20)
        library_ms = cuda_ms(library, 20)
        b_ms, b_by = bound_ms((tp * POOL_H * POOL_DH + q_t.numel() + 1 + POOL_H * POOL_DH) * 4,
                              4.0 * tp * POOL_H * POOL_DH, FP32_OPS_PER_S)
        print(f"[B1 mha_pool] B=1 T'={tp} H={POOL_H} d_h={POOL_DH}: max|d|={err:.3g} "
              f"(tol {TOL_POOL}); kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={library_ms:.5f} bound_ms={b_ms:.5f} ({b_by}); sdpa max|d|="
              f"{float((lib - ref).abs().max()):.3g}; "
              f"{pool_plan(1, tp, POOL_H, POOL_DH, torch.float32)}")
        pool_sweep(ht4, q_t, lens, ms)
    rng = np.random.default_rng(8)
    for b, tp, heads, d_h, lengths in POOL_EDGE:
        ht4 = torch.from_numpy(rng.standard_normal((b, tp, heads, d_h)).astype(np.float32)).to(DEVICE)
        q_t = torch.from_numpy((rng.standard_normal((heads, d_h)) / math.sqrt(heads))
                               .astype(np.float32)).to(DEVICE)
        lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            what = f"B={b} T={tp} H={heads} d_h={d_h} {str(dtype)[6:]}"
            err = pool_check(ht4.to(dtype), q_t, lens, what)
            worst = max(worst, err)
            print(f"[B1 mha_pool] {what} lengths={list(lengths)}: max|d|={err:.3g} "
                  f"(tol {TOL_POOL}), rows of length <= 0 exactly zero; "
                  f"{pool_plan(b, tp, heads, d_h, dtype)}")
    return dict(max_abs_err=worst, **main)


def pool_grads(fn, ht, query, lens, g):
    """d_ht and d_query of sum(fn(ht, query, lens) * g), on fresh leaves."""
    import torch

    ht = ht.detach().requires_grad_(True)
    query = query.detach().requires_grad_(True)
    (fn(ht, query, lens) * g).sum().backward()
    return ht.grad, query.grad


def phase_pool_backward():
    """B1's gradient: d_ht and d_query through ``MhaPoolFunction`` (the
    kernel's forward, the torch-op backward) against autograd through
    ``mha_pool_plain`` on the card, at the serving buckets' T' with a row of
    length 0 and one above T, in float32 and bfloat16; one B1 launch per
    forward under grad mode. Times the backward beside its byte bound and
    autograd through the plain version. Returns the main bucket's row."""
    import torch

    from doubleattentionspeakerverification_tpu_torch.ops import mha_pool
    from doubleattentionspeakerverification_tpu_torch.tools.timing import (
        FP32_OPS_PER_S, bound_ms, cuda_ms,
    )

    rng = np.random.default_rng(9)
    scale = 1.0 / math.sqrt(POOL_H)

    def plain(ht, query, lens):
        b, t, _ = ht.shape
        return mha_pool.mha_pool_plain(ht.reshape(b, t, POOL_H, POOL_DH),
                                       (query.t() * scale).contiguous(), lens)

    def port(ht, query, lens):
        return mha_pool.mha_pool(ht, query, lens, POOL_H)

    worst, main = 0.0, None
    for tp in POOL_T:
        lens_np = np.r_[0, tp + 5, 1, tp, rng.integers(1, tp + 1, POOL_B - 4)].astype(np.int32)
        lens = torch.from_numpy(lens_np).to(DEVICE)
        ht = torch.from_numpy(rng.standard_normal((POOL_B, tp, POOL_H * POOL_DH))
                              .astype(np.float32)).to(DEVICE)
        query = torch.from_numpy(rng.standard_normal((POOL_DH, POOL_H)).astype(np.float32)).to(DEVICE)
        g = torch.from_numpy(rng.standard_normal((POOL_B, POOL_H, POOL_DH)).astype(np.float32)).to(DEVICE)
        for dtype, tol in ((torch.float32, TOL_POOL), (torch.bfloat16, TOL_POOL_GRAD_BF16)):
            x = ht.to(dtype)
            before = mha_pool.KERNEL.launches
            d_ht, d_q = pool_grads(port, x, query, lens, g)
            launched = mha_pool.KERNEL.launches - before
            ref_ht, ref_q = pool_grads(plain, x, query, lens, g)
            torch.cuda.synchronize()
            check(launched == 1, f"B1 under grad mode at T'={tp} {dtype}: {launched} launches")
            check(d_ht.dtype == dtype and d_q.dtype == torch.float32,
                  f"B1 backward gradient types {d_ht.dtype} {d_q.dtype}")
            err_ht = float((d_ht.float() - ref_ht.float()).abs().max())
            err_q = float((d_q - ref_q).abs().max())
            if dtype == torch.float32:
                ok = err_ht <= tol and err_q <= tol
            else:   # one bfloat16 rounding of each d_ht value, d_query in float32
                ok = (bool(((d_ht.float() - ref_ht.float()).abs()
                            <= tol * ref_ht.float().abs() + TOL_POOL).all()) and err_q <= TOL_POOL)
            check(math.isfinite(err_ht) and math.isfinite(err_q) and ok,
                  f"B1 backward disagrees with autograd through the plain version at T'={tp} "
                  f"{dtype}: d_ht {err_ht:.3g}, d_query {err_q:.3g}")
            check(not bool(d_ht[torch.from_numpy(lens_np <= 0).to(DEVICE)].any()),
                  f"B1 backward: rows of length 0 got a gradient at T'={tp} {dtype}")
            worst = max(worst, err_q, err_ht if dtype == torch.float32 else 0.0)
            print(f"[B1 backward] B={POOL_B} T'={tp} {str(dtype)[6:]} lengths={lens_np.tolist()}: "
                  f"one launch a forward under grad mode; d_ht max|d|={err_ht:.3g}, d_query "
                  f"max|d|={err_q:.3g} against autograd through the plain version (tol "
                  f"{tol if dtype == torch.float32 else f'{tol} relative + {TOL_POOL}'}); "
                  f"rows of length 0 get zero gradient")
        # the backward alone on the Function's saved inputs; forward and
        # backward through the Function (the kernel's forward) and through
        # autograd of the plain version, each captured whole in a CUDA graph
        ht4 = ht.reshape(POOL_B, tp, POOL_H, POOL_DH).requires_grad_(True)
        q_t = (query.t() * scale).contiguous().requires_grad_(True)
        ms = cuda_ms(lambda: mha_pool.mha_pool_backward(ht4.detach(), q_t.detach(), lens, g), 20)
        fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            mha_pool.MhaPoolFunction.apply(ht4, q_t, lens), (ht4, q_t), g), 20)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            mha_pool.mha_pool_plain(ht4, q_t, lens), (ht4, q_t), g), 20)
        valid = int(np.minimum(lens_np, tp).sum())
        elems = POOL_B * tp * POOL_H * POOL_DH
        b_ms, b_by = bound_ms(
            (valid * POOL_H * POOL_DH + elems + 2 * q_t.numel() + 2 * g.numel() + POOL_B) * 4,
            10.0 * valid * POOL_H * POOL_DH, FP32_OPS_PER_S)
        print(f"[B1 backward] T'={tp}: backward_ms={ms:.5f} (torch ops) bound_ms={b_ms:.5f} "
              f"({b_by}: valid ht read once, d_ht written once); forward + backward: "
              f"{fwd_bwd_ms:.5f} through the Function, library_ms={library_ms:.5f} through "
              f"autograd of the plain version (CUDA-graph replay)")
        if tp == POOL_MAIN:
            main = dict(ms=ms, fwd_bwd_ms=fwd_bwd_ms, library_ms=library_ms, bound_ms=b_ms,
                        bound_by=b_by)
    return dict(max_abs_err=worst, **main)


def scale_key(name):
    """The gradient whose size sets ``name``'s tolerance: its own, but
    ``fc2.weight``'s for ``fc2.bias``. ``b2`` normalizes by the batch
    statistics in train mode, so it removes any constant added to a feature
    before it: the bias's gradient is zero wherever the ReLU between passes
    every item of the batch, and is rounding in a sum that cancels there."""
    return "fc2.weight" if name == "fc2.bias" else name


def compare_grads(got, ref, what, sensitive=(), tag="[train]"):
    """Every gradient within TOL_TRAIN_GRAD of the largest value of its
    scale (``scale_key``); a gradient in ``sensitive`` may instead be within
    TOL_TRAIN_L2 of its scale's L2 norm. Prints the worst tensors; returns
    the worst ratio of the others and the worst L2 distance of these."""
    ratios = {k: float((got[k] - ref[k]).abs().max()) / float(ref[scale_key(k)].abs().max())
              for k in ref}
    l2 = {k: float((got[k] - ref[k]).norm()) / max(float(ref[scale_key(k)].norm()), 1e-30)
          for k in ref}
    worst = sorted(ratios, key=lambda k: -ratios[k])
    print(f"{tag} {what}: max|d| / max|g| (L2 distance / |g|) per tensor, worst five: "
          + ", ".join(f"{k} {ratios[k]:.3g} ({l2[k]:.3g})" for k in worst[:5]))
    bad = [k for k in worst
           if not (ratios[k] <= TOL_TRAIN_GRAD or (k in sensitive and l2[k] <= TOL_TRAIN_L2))]
    check(not bad, f"{tag} {what}: gradients beyond {TOL_TRAIN_GRAD} of their largest (the "
          f"encoder's and fc2.bias's, beyond {TOL_TRAIN_L2} of their norm): "
          + ", ".join(f"{k} {ratios[k]:.3g} ({l2[k]:.3g})" for k in bad))
    return (max([ratios[k] for k in ref if k not in sensitive], default=0.0),
            max([l2[k] for k in sensitive], default=0.0))


def train_batch(rng, cfg, g, b, seconds, ragged):
    """Seeded speech windows as int16 PCM (G, B, N), their lengths (the
    microbatches in ``ragged`` cut to random lengths of 1 s and more) and
    random speaker labels."""
    from doubleattentionspeakerverification_tpu_torch.dsp.features import num_samples_for_frames

    n = num_samples_for_frames(int(round(seconds * 100)), cfg.features)
    waves = np.stack([np.stack([seeded_speech(rng, n / 16000) for _ in range(b)])
                      for _ in range(g)])
    pcm = np.clip(np.round(waves * 32767), -32768, 32767).astype(np.int16)
    lengths = np.full((g, b), n, np.int32)
    for i in ragged:
        lengths[i] = rng.integers(num_samples_for_frames(100, cfg.features), n + 1, b)
        lengths[i, 0] = n
    labels = rng.integers(0, cfg.model.num_spkrs, (g, b)).astype(np.int32)
    return {"waves": pcm, "lengths": lengths, "labels": labels}


def train_run(cfg, state0, batch, keep, device, plain_pool=False):
    """One step of a model holding ``state0`` on ``device`` (the kernel path,
    or with B1's plain version in the kernel's place); returns the metrics,
    the gradients and the launches of B1 in the step."""
    import torch

    from doubleattentionspeakerverification_tpu_torch.models.classifier import SpeakerClassifier
    from doubleattentionspeakerverification_tpu_torch.ops import mha_pool
    from doubleattentionspeakerverification_tpu_torch.training.optimizers import make_optimizer
    from doubleattentionspeakerverification_tpu_torch.training.step import make_train_step

    model = SpeakerClassifier(cfg.model)
    model.load_state_dict(state0)
    step = make_train_step(cfg, model, make_optimizer(cfg.train, model.parameters()), device)
    before, kernel = mha_pool.KERNEL.launches, mha_pool.mha_pool_cuda
    if plain_pool:
        mha_pool.mha_pool_cuda = mha_pool.mha_pool_plain
    try:
        out = step(batch, keep=keep)
    finally:
        mha_pool.mha_pool_cuda = kernel
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
    return ({k: float(v) for k, v in out.items()}, grads, mha_pool.KERNEL.launches - before)


def compare_bf16(label, out, grads, ref_out, ref_grads, emu_grads, b):
    """[train bf16]: a bfloat16 step's loss, accuracy and every gradient
    against the float32 step's (``ref_*``), each gradient's distance beside
    the emulated step's (TOL_BF16_LOSS, TOL_BF16_EMU). Returns the largest
    distance and the largest ratio to the emulated one."""
    dl = abs(out["loss"] - ref_out["loss"])
    check(dl <= TOL_BF16_LOSS * abs(ref_out["loss"]), f"[train bf16] {label}: loss "
          f"{out['loss']} vs float32 {ref_out['loss']} (tol {TOL_BF16_LOSS} relative)")
    da = abs(out["accuracy"] - ref_out["accuracy"])
    check(da <= 1.0 / b + 1e-6, f"[train bf16] {label}: accuracy {out['accuracy']} vs float32 "
          f"{ref_out['accuracy']} (tol one item a microbatch, {1.0 / b:.4g})")
    from doubleattentionspeakerverification_tpu_torch.tools.bf16_drift import distances

    check(set(grads) == set(ref_grads), f"[train bf16] {label}: parameter set")
    got, emu = distances(grads, ref_grads), distances(emu_grads, ref_grads)
    ratio = {k: got[k] / max(emu[k], 1e-30) for k in got}
    bad = [k for k in got if not (got[k] <= TOL_BF16_EMU * emu[k] or got[k] <= TOL_BF16_LOSS)]
    print(f"[train bf16] {label}: loss {out['loss']:.6f} vs float32 {ref_out['loss']:.6f} "
          f"(|d| / loss {dl / abs(ref_out['loss']):.3g}, tol {TOL_BF16_LOSS:.4g}); accuracy "
          f"{out['accuracy']:.4f} vs {ref_out['accuracy']:.4f}; each gradient's L2 distance "
          f"from the float32 step's / its norm (the emulated step's): "
          + ", ".join(f"{k} {got[k]:.3g} ({emu[k]:.3g})" for k in ref_grads)
          + f"; worst ratio {max(ratio.values()):.3g} ({max(ratio, key=ratio.get)}, tol "
          f"{TOL_BF16_EMU})")
    check(not bad, f"[train bf16] {label}: gradients beyond {TOL_BF16_EMU} x the emulated "
          f"step's distance: " + ", ".join(f"{k} {got[k]:.3g} ({emu[k]:.3g})" for k in bad))
    return max(got.values()), max(ratio.values())


def train_conv_ops(cfg, b, frames):
    """Operations of the encoder's convolutions in one microbatch of b
    windows of ``frames`` frames, forward and backward (weight gradients of
    all, input gradients of all but the first, whose input needs none)."""
    from doubleattentionspeakerverification_tpu_torch.models.vgg import vgg_channel_plan

    t, f, ops = frames, cfg.model.feature_size, 0.0
    for i, (cin, cout) in enumerate(vgg_channel_plan(cfg.model.front_end, cfg.model.kernel_size)):
        for j, c_in in enumerate((cin, cout)):
            fwd = 2.0 * 9 * c_in * cout * t * f * b
            ops += fwd * (2 if i == 0 and j == 0 else 3)
        t, f = -(-t // 2), -(-f // 2)
    return ops


def phase_train():
    """The train step at the paper's width and recipe, wav mode: its
    gradients on the kernel path against the plain pooling's on the card,
    with ``remat_vgg`` ([train remat]), in bfloat16 on the same batch and
    with ``assume_full_lengths`` on full windows ([train bf16], each against
    the float32 step and the emulated one), the float32 step with
    ``assume_full_lengths`` against the masked one ([train full]), one small
    step against the CPU, then three steps of each driven with every kernel
    count at 0, timed. Returns B1's and B2's launches in [train]'s steps."""
    import torch

    from doubleattentionspeakerverification_tpu_torch import ops
    from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig
    from doubleattentionspeakerverification_tpu_torch.models.classifier import SpeakerClassifier
    from doubleattentionspeakerverification_tpu_torch.models.init import init_parameters
    from doubleattentionspeakerverification_tpu_torch.models.poolings import draw_head_keep
    from doubleattentionspeakerverification_tpu_torch.tools.bf16_drift import emulated_bf16_convs
    from doubleattentionspeakerverification_tpu_torch.tools.timing import FP32_OPS_PER_S
    from doubleattentionspeakerverification_tpu_torch.training.optimizers import make_optimizer
    from doubleattentionspeakerverification_tpu_torch.training.step import (
        make_train_step, prepare_inputs,
    )

    cfg = ExperimentConfig()
    m, t = cfg.model, cfg.train
    check((m.front_end, m.kernel_size, m.heads_number, m.pooling_method, m.embedding_size,
           m.num_spkrs, m.mask_prob, t.optimizer, t.learning_rate, t.weight_decay, t.batch_size,
           t.gradient_accumulation, t.window_size)
          == ("VGG4L", 1024, 32, "DoubleMHA", 400, 5994, 0.3, "Adam", 1e-4, 1e-3, 64, 2, 3.5),
          f"not the paper's training configuration: {cfg}")
    state0 = init_parameters(SpeakerClassifier(m), torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(10)
    g, b = t.gradient_accumulation, t.batch_size
    batch = train_batch(rng, cfg, g, b, t.window_size, ragged=(1,))
    gen = torch.Generator().manual_seed(1)
    keep = [draw_head_keep(b, m.heads_number, m.mask_prob, gen) for _ in range(g)]

    # step 1 on the kernel path against the same step with B1's plain version,
    # cuDNN deterministic, the same weights and keep masks
    torch.backends.cudnn.deterministic = True
    try:
        out_k, grads_k, launched_k = train_run(cfg, state0, batch, keep, DEVICE)
        out_p, grads_p, launched_p = train_run(cfg, state0, batch, keep, DEVICE, plain_pool=True)
    finally:
        torch.backends.cudnn.deterministic = False
    check(launched_k == g and launched_p == 0,
          f"[train] B1 launches: {launched_k} on the kernel path, {launched_p} with its plain version")
    check(abs(out_k["loss"] - out_p["loss"]) <= TOL_POOL * max(1.0, abs(out_p["loss"])),
          f"[train] loss on the kernel path {out_k['loss']} vs the plain pooling {out_p['loss']}")
    with torch.device("meta"):
        names = {n for n, _ in SpeakerClassifier(m).named_parameters()}
    check(set(grads_k) == names, "[train] a parameter got no gradient")
    for n, v in grads_k.items():
        check(bool(torch.isfinite(v).all()) and bool(v.abs().max() > 0),
              f"[train] gradient of {n} not finite or all zero")
    kp, _ = compare_grads(grads_k, grads_p, "step 1, kernel path vs B1's plain version on the card")
    print(f"[train] step 1 (G={g} x B={b} x {t.window_size} s, the second microbatch ragged): "
          f"loss {out_k['loss']:.6f} (plain pooling {out_p['loss']:.6f}), accuracy "
          f"{out_k['accuracy']:.4f}; {launched_k} B1 launches; every parameter has a finite, "
          f"nonzero gradient; gradients within {kp:.3g} of their scale of the plain pooling's")
    del grads_p

    # the same step 1 with remat_vgg, held to the kernel path's by the same measure
    remat = cfg.replace(model=dataclasses.replace(m, remat_vgg=True))
    torch.backends.cudnn.deterministic = True
    try:
        out_r, grads_r, launched_r = train_run(remat, state0, batch, keep, DEVICE)
    finally:
        torch.backends.cudnn.deterministic = False
    check(launched_r == g, f"[train remat] B1 launches {launched_r}")
    check(abs(out_r["loss"] - out_k["loss"]) <= TOL_POOL * max(1.0, abs(out_k["loss"])),
          f"[train remat] loss {out_r['loss']} vs [train]'s {out_k['loss']}")
    kr, _ = compare_grads(grads_r, grads_k, "step 1 with remat_vgg vs without", tag="[train remat]")
    print(f"[train remat] step 1: loss {out_r['loss']:.6f} ([train] {out_k['loss']:.6f}); "
          f"gradients within {kr:.3g} of their scale of [train]'s (tol {TOL_TRAIN_GRAD})")
    del grads_r

    # step 1 in bfloat16 against float32: on [train]'s batch, and with
    # assume_full_lengths on full windows (bench.py's configuration). The
    # float32 step with assume_full_lengths against the masked one on the
    # same full windows ([train full])
    bf16 = cfg.replace(model=dataclasses.replace(m, compute_dtype="bfloat16"))
    full = cfg.replace(train=dataclasses.replace(t, assume_full_lengths=True))
    bf16_full = full.replace(model=bf16.model)
    full_batch = dict(batch, lengths=np.full_like(batch["lengths"], batch["waves"].shape[-1]))
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for key, c, bb in (("bf16", bf16, batch), ("f32 full", full, full_batch),
                           ("f32 masked full", cfg, full_batch),
                           ("bf16 full", bf16_full, full_batch)):
            runs[key] = train_run(c, state0, bb, keep, DEVICE)
        for key, c, bb in (("emu", cfg, batch), ("emu full", full, full_batch)):
            with emulated_bf16_convs(seed=14, device=DEVICE):
                runs[key] = train_run(c, state0, bb, keep, DEVICE)
    finally:
        torch.backends.cudnn.deterministic = False
    for key, (_, _, launched) in runs.items():
        check(launched == g, f"[train bf16] {key}: B1 launches {launched}")
    bf16_worst = [
        compare_bf16(f"{label} ({what})", runs[key][0], runs[key][1], ref[0], ref[1],
                     runs[emu][1], b)
        for label, what, key, ref, emu in (
            ("ragged", "[train]'s batch, the second microbatch ragged", "bf16",
             (out_k, grads_k), "emu"),
            ("full-length", "assume_full_lengths on full windows", "bf16 full",
             runs["f32 full"], "emu full"))]
    # On full windows the masks are identities, but the masked CMN's mean
    # is another sum than the unmasked one: the features differ in their
    # last bits, which moves the encoder's gradients as [train]'s card vs
    # CPU does, so those are held by [train]'s L2 measure
    out_m, grads_m, _ = runs["f32 masked full"]
    out_f, grads_f, _ = runs["f32 full"]
    feats = [prepare_inputs(full_batch, c, torch.device(DEVICE))[0] for c in (cfg, full)]
    feat_d = float((feats[1] - feats[0]).abs().max()) / float(feats[0].abs().max())
    del feats
    check(abs(out_f["loss"] - out_m["loss"]) <= TOL_TRAIN_LOSS,
          f"[train full] loss {out_f['loss']} vs the masked step's {out_m['loss']}")
    sensitive = {k for k in grads_m if k.startswith("vgg.")} | {"fc2.bias"}
    kf, kf_l2 = compare_grads(grads_f, grads_m, "step 1 with assume_full_lengths vs the masked "
                              "step on the same full windows", sensitive, tag="[train full]")
    print(f"[train full] step 1 on full windows: features within {feat_d:.3g} of their largest "
          f"of the masked step's; loss {out_f['loss']:.6f} (masked {out_m['loss']:.6f}, tol "
          f"{TOL_TRAIN_LOSS}); gradients within {kf:.3g} of their largest (tol "
          f"{TOL_TRAIN_GRAD}), the encoder's and fc2.bias's within {kf_l2:.3g} of their norm "
          f"(tol {TOL_TRAIN_L2})")
    del grads_k, runs, grads_m, grads_f

    # one small step, card against CPU, on the same CPU-made features
    small = train_batch(np.random.default_rng(11), cfg, 1, TRAIN_SMALL[0], TRAIN_SMALL[1], ragged=())
    feats, lengths = prepare_inputs(small, cfg, torch.device("cpu"))
    small = {"inputs": feats.numpy(), "lengths": lengths.numpy(), "labels": small["labels"]}
    keep1 = [draw_head_keep(TRAIN_SMALL[0], m.heads_number, m.mask_prob, gen)]
    out_c, grads_c, _ = train_run(cfg, state0, small, keep1, DEVICE)
    out_h, grads_h, _ = train_run(cfg, state0, small, keep1, "cpu")
    nudge = np.random.default_rng(12).standard_normal(small["inputs"].shape).astype(np.float32)
    nudged = dict(small, inputs=(small["inputs"] * (1 + TRAIN_NUDGE * nudge)).astype(np.float32))
    _, grads_n, _ = train_run(cfg, state0, nudged, keep1, "cpu")
    moved = {k: float((grads_n[k] - grads_h[k]).abs().max())
             / float(grads_h[scale_key(k)].abs().max()) for k in grads_h}
    print(f"[train] the CPU's own step with its features moved by {TRAIN_NUDGE:g} of their value: "
          f"gradients move by up to {max(moved.values()):.3g} of their largest "
          f"({max(moved, key=moved.get)}); beyond {TOL_TRAIN_GRAD}: "
          + ", ".join(f"{k} {v:.3g}" for k, v in sorted(moved.items()) if v > TOL_TRAIN_GRAD))
    sensitive = {k for k in grads_h if k.startswith("vgg.")} | {"fc2.bias"}
    del grads_n
    err = abs(out_c["loss"] - out_h["loss"])
    check(err <= TOL_TRAIN_LOSS, f"[train] small step loss: card {out_c['loss']} vs CPU {out_h['loss']}")
    ch, ch_l2 = compare_grads(grads_c, grads_h, f"one step of B={TRAIN_SMALL[0]} x "
                              f"{TRAIN_SMALL[1]} s, card vs CPU", sensitive)
    print(f"[train] B={TRAIN_SMALL[0]} x {TRAIN_SMALL[1]} s, G=1: loss card {out_c['loss']:.6f}, "
          f"CPU {out_h['loss']:.6f}, |d|={err:.3g} (tol {TOL_TRAIN_LOSS}); gradients within "
          f"{ch:.3g} of their largest (tol {TOL_TRAIN_GRAD}), the encoder's and fc2.bias's "
          f"within {ch_l2:.3g} of their norm (tol {TOL_TRAIN_L2})")
    del grads_c, grads_h

    conv_ops = g * train_conv_ops(cfg, b, int(round(t.window_size * 100)))
    print(f"[train] the step's convolutions: {conv_ops / 1e12:.2f} TFLOP forward and backward, "
          f"{conv_ops / FP32_OPS_PER_S * 1e3:.1f} ms at the float32 peak")

    # the main path: TRAIN_STEPS steps, kernel counts read from 0; then the
    # same with remat_vgg, in bfloat16 and with assume_full_lengths
    timed = {}
    for tag, c, bb in (("[train]", cfg, batch), ("[train remat]", remat, batch),
                       ("[train bf16] ragged", bf16, batch),
                       ("[train bf16] full-length", bf16_full, full_batch),
                       ("[train full]", full, full_batch)):
        model = SpeakerClassifier(c.model)
        model.load_state_dict(state0)
        step = make_train_step(c, model, make_optimizer(t, model.parameters()), DEVICE)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in ops.KERNELS:
            k.launches = 0
        times, losses = [], []
        for _ in range(TRAIN_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(bb)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            losses.append(float(out["loss"]))
            for n, p in model.named_parameters():
                check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                      f"{tag} step {step.step}: gradient of {n} missing or not finite")
        launches = {k.name: k.launches for k in ops.KERNELS}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        del model, step
        check(all(math.isfinite(x) for x in losses), f"{tag} losses {losses}")
        for name, per_step in (("mha_pool", g), ("logmel", 1)):
            check(launches[name] == per_step * TRAIN_STEPS, f"kernel {name}: "
                  f"{launches[name]} launches in {TRAIN_STEPS} steps on the {tag} path")
        timed[tag] = (float(np.median(times)), peak_gib, launches)
        print(f"{tag} kernel launches in {TRAIN_STEPS} steps: {json.dumps(launches)}")
        print(f"{tag} {TRAIN_STEPS} steps of G={g} x B={b} x {t.window_size} s windows (wav "
              f"mode, int16 PCM; Adam lr {t.learning_rate}, weight decay {t.weight_decay}): "
              "losses " + ", ".join(f"{x:.6f}" for x in losses) + f"; step times "
              + ", ".join(f"{x:.1f}" for x in times) + f" ms (CUDA events), median "
              f"{float(np.median(times)):.1f} ms; peak torch.cuda.max_memory_allocated = "
              f"{peak_gib:.2f} GiB")
    ms0, peak0, launches = timed["[train]"]
    for tag in ("[train remat]", "[train bf16] ragged", "[train bf16] full-length",
                "[train full]"):
        ms1, peak1, _ = timed[tag]
        print(f"{tag} median step {ms1:.1f} ms against [train]'s {ms0:.1f} ms "
              f"({ms1 / ms0 - 1:+.1%}); peak {peak1:.2f} GiB against {peak0:.2f} GiB "
              f"({peak1 / peak0 - 1:+.1%})")
    (d_ragged, r_ragged), (d_full, r_full) = bf16_worst
    print(f"[train bf16] step 1 against float32: gradients' largest L2 distance / norm "
          f"{d_ragged:.3g} ragged, {d_full:.3g} full-length, at most {max(r_ragged, r_full):.3g} "
          f"times the emulated step's (tol {TOL_BF16_EMU})")
    return launches


def trainer_corpus(root):
    """Seeded speech as 16-bit wavs: TRAINER_SPEAKERS x TRAINER_UTTS training
    utterances with their manifest, and TRAINER_VALID validation utterances
    spread over TRAINER_VALID_SECONDS (several length buckets) with client
    and impostor trial lists."""
    from doubleattentionspeakerverification_tpu_torch.data.wav import encode_wav

    rng = np.random.default_rng(20)
    for sub in ("train", "valid"):
        os.makedirs(os.path.join(root, sub))
    lines = []
    for s in range(TRAINER_SPEAKERS):
        for i in range(TRAINER_UTTS):
            y = seeded_speech(rng, rng.uniform(*TRAINER_SECONDS))
            with open(os.path.join(root, "train", f"s{s}_u{i}.wav"), "wb") as f:
                f.write(encode_wav(y, 16000))
            lines.append(f"s{s}_u{i} {s} -1\n")
    lo, hi = TRAINER_VALID_SECONDS
    for j in range(TRAINER_VALID):
        y = seeded_speech(rng, lo + (hi - lo) * j / (TRAINER_VALID - 1))
        with open(os.path.join(root, "valid", f"v{j}.wav"), "wb") as f:
            f.write(encode_wav(y, 16000))
    n = TRAINER_VALID
    with open(os.path.join(root, "labels.ndx"), "w") as f:
        f.writelines(lines)
    with open(os.path.join(root, "clients.ndx"), "w") as f:
        f.writelines(f"v{j} v{j + 1}\n" for j in range(0, n, 2))
    with open(os.path.join(root, "impostors.ndx"), "w") as f:
        f.writelines(f"v{j} v{(j + 5) % n}\n" for j in range(n))


def trainer_argv(root, out, *extra):
    """The CLI's paper defaults (VGG4L, k=1024, 32 heads, DoubleMHA, emb 400,
    64 x 2 windows of 3.5 s, Adam 1e-4, weight decay 1e-3, mask_prob 0.3,
    async validation) on the corpus, wav PCM with the log-mel in the step."""
    return ["--train_data_dir", os.path.join(root, "train"),
            "--valid_data_dir", os.path.join(root, "valid"),
            "--train_labels_path", os.path.join(root, "labels.ndx"),
            "--valid_clients", os.path.join(root, "clients.ndx"),
            "--valid_impostors", os.path.join(root, "impostors.ndx"),
            "--out_dir", out, "--device", DEVICE, "--data_source", "wav", "--wav_mode", "pcm",
            "--max_epochs", "2", "--validate_every", "2", "--checkpoint_every", "1",
            "--print_every", "1", *extra]


def trainer_events(out):
    (name,) = [f for f in os.listdir(out) if f.endswith("_metrics.jsonl")]
    with open(os.path.join(out, name)) as f:
        return [json.loads(line) for line in f]


def trainer_cli(argv, log):
    """``cli/train.py``'s main with its console lines appended to ``log``."""
    import contextlib

    from doubleattentionspeakerverification_tpu_torch.cli import train as cli

    with open(log, "a") as f, contextlib.redirect_stdout(f):
        rc = cli.main(argv)
    check(rc == 0, f"[trainer] cli.train.main exited {rc}; see {log}")


def phase_trainer(root, smi):
    """The port's trainer through its CLI at paper width (see the module
    docstring), its corpus and runs under ``root`` (kept for the phases
    after it); returns B1's and B2's launches in the main run."""
    import contextlib

    import torch

    from doubleattentionspeakerverification_tpu_torch import ops
    from doubleattentionspeakerverification_tpu_torch.cli import train as cli
    from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig
    from doubleattentionspeakerverification_tpu_torch.models.classifier import SpeakerClassifier
    from doubleattentionspeakerverification_tpu_torch.training.trainer import Trainer
    from doubleattentionspeakerverification_tpu_torch.utils.checkpoint import load_checkpoint
    from doubleattentionspeakerverification_tpu_torch.utils.weights import train_state_to_jax

    log = os.path.join(root, "console.log")
    t0 = time.perf_counter()
    trainer_corpus(root)
    print(f"[trainer] corpus: {TRAINER_SPEAKERS} x {TRAINER_UTTS} training wavs of "
          f"{TRAINER_SECONDS[0]}-{TRAINER_SECONDS[1]} s, {TRAINER_VALID} validation wavs "
          f"of {TRAINER_VALID_SECONDS[0]}-{TRAINER_VALID_SECONDS[1]} s, written in "
          f"{time.perf_counter() - t0:.1f} s")

    # the main run, every kernel count at 0
    out = os.path.join(root, "run")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    trainer_cli(trainer_argv(root, out, "--post_step_bench", str(TRAINER_BENCH)), log)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ops.KERNELS}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    events = trainer_events(out)

    def of(kind):
        return [e for e in events if e["event"] == kind]

    (mode,) = of("source_mode")
    check(mode["mode"] == "wav_pcm", f"[trainer] source mode {mode}")
    train = of("train")
    check([int(e["step"]) for e in train] == [1, 2, 3, 4]
          and all(math.isfinite(e["xent"]) for e in train), f"[trainer] train events {train}")
    val = of("validate")
    check(len(val) == 2 and all(0.0 <= e["eer"] <= 50.0 for e in val),
          f"[trainer] validations {val}")
    for name in ("mha_pool", "logmel"):
        check(launches[name] > 0, f"kernel {name} was never launched on the [trainer] path")
    (cfg_file,) = [f for f in os.listdir(out) if f.endswith("_config.json")]
    with open(os.path.join(out, cfg_file)) as f:
        cfg = ExperimentConfig.from_json(f.read())
    check(cfg.model.num_spkrs == TRAINER_SPEAKERS, f"[trainer] num_spkrs {cfg.model.num_spkrs}")
    with torch.device("meta"):
        meta_model = SpeakerClassifier(cfg.model)
    want = set(train_state_to_jax(
        {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in meta_model.state_dict().items()},
        {}, "Adam", 0, cfg.train.learning_rate))
    files = sorted(f for f in os.listdir(out) if f.endswith(".npz"))
    for f in files:
        check(set(load_checkpoint(os.path.join(out, f))[0]) == want,
              f"[trainer] {f}: leaves differ from the JAX-format key set")
    periodic = sorted(int(f.rsplit("_", 1)[1][:-4]) for f in files if "_best_" not in f)
    check(periodic == [2, 3, 4], f"[trainer] periodic checkpoints left {periodic}: the "
          f"newest {cfg.train.keep_checkpoints} of 4 should remain")
    secs = [e["elapsed_min"] * 60 for e in train]
    saves = of("ckpt_save")
    (bench,) = of("step_bench")
    print(f"[trainer] kernel launches in the run (4 steps, 2 validations): "
          f"{json.dumps(launches)}")
    print(f"[trainer] losses " + ", ".join(f"{e['xent']:.6f}" for e in train)
          + "; EERs " + ", ".join(f"{e['eer']:.4f} (exact {e['eer_exact']:.4f})" for e in val)
          + f"; checkpoints left: {files}")
    print(f"[trainer] loop: {len(train) / sum(secs):.3f} steps/s over the 4 steps, "
          f"{(len(train) - 1) / sum(secs[1:]):.3f} steps/s over steps 2-4; audio_s_per_s "
          + ", ".join(f"{e['audio_s_per_s']:.1f}" for e in train)
          + "; loader_wait_s " + ", ".join(f"{e['loader_wait_s']:.3f}" for e in train)
          + "; dispatch_s " + ", ".join(f"{e['dispatch_s']:.3f}" for e in train))
    print(f"[trainer] validation elapsed_s " + ", ".join(f"{e['elapsed_s']:.3f}" for e in val)
          + "; checkpoint blocked_s " + ", ".join(
              f"{e['kind']} {e['step']:.0f}: {e['blocked_s']:.3f}" for e in saves)
          + f"; isolated step (post_step_bench, {bench['steps']:.0f} steps, CUDA events) "
          f"{bench['ms_per_step']:.1f} ms against {1e3 * sum(secs[1:]) / 3:.1f} ms a step "
          f"in the loop (steps 2-4); run wall {wall:.1f} s; peak "
          f"torch.cuda.max_memory_allocated {peak_gib:.2f} GiB; on {smi}")

    # a stop at step 3, then --requeue, against the uninterrupted run
    quiet = ("--validate_every", "0", "--checkpoint_every", "0")
    torch.backends.cudnn.deterministic = True
    try:
        # the uninterrupted run copies its batches ahead on a side stream
        full = os.path.join(root, "full")
        trainer_cli(trainer_argv(root, full, *quiet, "--device_prefetch", "2"), log)
        stopped = os.path.join(root, "stopped")
        argv = trainer_argv(root, stopped, *quiet)
        with open(log, "a") as f, contextlib.redirect_stdout(f):
            cfg = cli.build_config(cli.make_parser().parse_args(argv))
            stop_log = StopAt(os.path.join(root, "stopped.jsonl"), TRAINER_STOP)
            tr = Trainer(cfg, logger=stop_log, device=DEVICE)
            stop_log.trainer = tr
            tr.train()
            stop_log.close()
        check(tr.preempted and tr.step == TRAINER_STOP,
              f"[trainer] request_stop at step {TRAINER_STOP}: stopped at {tr.step}")
        del tr
        trainer_cli(argv + ["--requeue"], log)
    finally:
        torch.backends.cudnn.deterministic = False
    full_train = [e for e in trainer_events(full) if e["event"] == "train"]
    ref = {int(e["step"]): e["xent"] for e in full_train}
    secs = [e["elapsed_min"] * 60 for e in full_train[1:]]
    print(f"[trainer] the loop without validation or checkpoints (cuDNN deterministic, "
          f"--device_prefetch 2): {len(secs) / sum(secs):.3f} steps/s over steps 2-4; "
          "audio_s_per_s " + ", ".join(f"{e['audio_s_per_s']:.1f}" for e in full_train)
          + "; loader_wait_s " + ", ".join(f"{e['loader_wait_s']:.3f}" for e in full_train)
          + "; dispatch_s " + ", ".join(f"{e['dispatch_s']:.3f}" for e in full_train))
    got = {int(e["step"]): e["xent"] for e in trainer_events(stopped) if e["event"] == "train"}
    with open(os.path.join(root, "stopped.jsonl")) as f:
        got.update({int(e["step"]): e["xent"] for e in map(json.loads, f)
                    if e["event"] == "train"})
    (resume,) = [e for e in trainer_events(stopped) if e["event"] == "resume"]
    check(sorted(got) == sorted(ref) == [1, 2, 3, 4] and resume["step"] == TRAINER_STOP,
          f"[trainer] steps: stopped and resumed {sorted(got)}, uninterrupted {sorted(ref)}")
    err = abs(got[4] - ref[4]) / abs(ref[4])
    check(err <= TOL_TRAINER_RESUME, f"[trainer] step 4 after a stop at step "
          f"{TRAINER_STOP} and --requeue: loss {got[4]} vs uninterrupted {ref[4]}")
    print(f"[trainer] stopped by request_stop at step {TRAINER_STOP} (mid-epoch 1), resumed "
          f"with --requeue (in-epoch skip {resume['in_epoch_skip']:.0f}): losses "
          + ", ".join(f"{got[k]:.6f}" for k in sorted(got)) + "; uninterrupted "
          + ", ".join(f"{ref[k]:.6f}" for k in sorted(ref))
          + f"; step 4 relative difference {err:.3g} (tol {TOL_TRAINER_RESUME}, cuDNN "
          "deterministic; the uninterrupted run with --device_prefetch 2)")
    return launches


def dist_launch(fn, nprocs, workdir, tag):
    """``fn`` (a function of this module) in ``nprocs`` processes on the
    card, joined by ``tools/multihost_check.py``; fails the phase unless
    every one exits 0. Returns their outputs."""
    from doubleattentionspeakerverification_tpu_torch.tools.multihost_check import (
        call_argv, launch,
    )

    results = launch(call_argv(f"chip_smoke:{fn}", workdir, device=DEVICE), nprocs,
                     timeout=DIST_TIMEOUT, env={"PYTHONPATH": HERE}, cwd=HERE,
                     workdir=os.path.join(workdir, f"group_{fn}"))
    for r in results:
        check(r.returncode == 0, f"{tag} rank {r.rank} exited {r.returncode}: "
              f"{r.stdout[-2000:]} {r.stderr[-3000:]}")
    return results


def dist_model(cfg, mesh=None):
    """The paper-width model of seed 0 (as [train]'s), this rank's columns
    of W where they are split."""
    import torch

    from doubleattentionspeakerverification_tpu_torch.models.classifier import SpeakerClassifier
    from doubleattentionspeakerverification_tpu_torch.models.init import init_parameters
    from doubleattentionspeakerverification_tpu_torch.parallel.mesh import shard_model

    model = init_parameters(SpeakerClassifier(cfg.model), torch.Generator().manual_seed(0))
    return shard_model(model, mesh)


def dist_step_result(model, mesh, out):
    """(metrics, gradients and parameters after the step as host arrays,
    W's gathered from the model ranks)."""
    from doubleattentionspeakerverification_tpu_torch.parallel.mesh import (
        SHARDED, gather_columns,
    )

    grads, params = {}, {}
    for n, p in model.named_parameters():
        g, v = p.grad, p.detach()
        if n == SHARDED:
            g, v = gather_columns(g, mesh), gather_columns(v, mesh)
        grads[n], params[n] = g.cpu().numpy(), v.cpu().numpy()
    return {k: float(v) for k, v in out.items()}, grads, params


@contextlib.contextmanager
def saved_validation_caches(prefix):
    """While open, each validation of the port's trainer in this process
    saves the embedding cache its EER was computed from (across ranks, the
    gathered one) to ``<prefix>_<i>.npz``; i counts the validations."""
    from doubleattentionspeakerverification_tpu_torch.training import trainer

    original, calls = trainer.validate_eer, []

    def hook(extractor, *args, **kwargs):
        result = original(extractor, *args, **kwargs)
        ids = sorted(extractor.cache)
        np.savez(f"{prefix}_{len(calls)}.npz", ids=np.array(ids),
                 emb=np.stack([np.asarray(extractor.cache[u], np.float32) for u in ids]))
        calls.append(prefix)
        return result

    trainer.validate_eer = hook
    try:
        yield
    finally:
        trainer.validate_eer = original


def dist_nccl_rank(workdir):
    """[distributed], NCCL at world size 1: one train step of a small model
    through the port's multi-process step (its gradient all-reduce runs
    on the NCCL communicator), against the same step without the group."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig
    from doubleattentionspeakerverification_tpu_torch.parallel.mesh import make_mesh
    from doubleattentionspeakerverification_tpu_torch.training.optimizers import make_optimizer
    from doubleattentionspeakerverification_tpu_torch.training.step import make_train_step

    base = ExperimentConfig()
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, kernel_size=64, heads_number=8,
                                        num_spkrs=40),
        train=dataclasses.replace(base.train, batch_size=8))
    batch = train_batch(np.random.default_rng(13), cfg, 2, 8, 2.0, ragged=(1,))
    got = []
    torch.backends.cudnn.deterministic = True
    for mesh in (make_mesh(cfg.mesh), None):
        model = dist_model(cfg)
        step = make_train_step(cfg, model, make_optimizer(cfg.train, model.parameters()), DEVICE,
                               mesh=mesh)
        got.append(dist_step_result(model, mesh, step(batch)))
    (m_g, g_g, p_g), (m_p, g_p, p_p) = got

    # the state after the step as one asynchronous .dcp through the trainer's
    # saver (its own gloo group, since async_save needs a CPU backend and the
    # default group is NCCL's): no meta.json until wait(), then every leaf
    from doubleattentionspeakerverification_tpu_torch.utils.dist_ckpt import (
        DcpAsyncSaver, load_checkpoint_dcp,
    )
    from doubleattentionspeakerverification_tpu_torch.utils.weights import train_state_to_jax

    leaves = train_state_to_jax({k: v.cpu() for k, v in model.state_dict().items()}, {}, "SGD",
                                1, 0.1)
    saver = DcpAsyncSaver()
    t0 = time.perf_counter()
    path = saver.save(os.path.join(workdir, "nccl_1.dcp"), leaves, {"step": 1})
    issued_s = time.perf_counter() - t0
    marker_early = os.path.exists(os.path.join(path, "meta.json"))
    saver.wait()
    back, meta = load_checkpoint_dcp(path)
    dcp = dict(issued_s=issued_s, wait_s=time.perf_counter() - t0 - issued_s,
               marker_early=marker_early, meta=meta, n_leaves=len(leaves),
               equal=set(back) == set(leaves) and all(np.array_equal(back[k], leaves[k])
                                                      for k in leaves))

    def rel(a, b):
        return max(float(np.abs(a[k] - b[k]).max()) / max(float(np.abs(b[k]).max()), 1e-30)
                   for k in b)

    with open(os.path.join(workdir, "nccl.json"), "w") as f:
        json.dump(dict(backend=dist.get_backend(), world=dist.get_world_size(),
                       nccl=".".join(map(str, torch.cuda.nccl.version())),
                       device=torch.cuda.get_device_name(torch.cuda.current_device()),
                       loss=m_g["loss"], loss_plain=m_p["loss"], grad_rel=rel(g_g, g_p),
                       param_rel=rel(p_g, p_p), dcp=dcp), f)


def dist_rank(workdir):
    """[distributed], each of two ranks sharing the card (gloo): the paper
    recipe's step on this rank's rows, data-parallel and with W split over
    the two ranks (step 1 for the comparison, then DIST_STEPS timed with
    CUDA events, the kernel counts from 0), then ``cli/train.py
    --distributed`` on the [trainer] corpus."""
    import contextlib
    import dataclasses

    import torch
    import torch.distributed as dist

    from doubleattentionspeakerverification_tpu_torch.cli import train as cli
    from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig, MeshConfig
    from doubleattentionspeakerverification_tpu_torch.parallel.mesh import make_mesh
    from doubleattentionspeakerverification_tpu_torch.training.optimizers import make_optimizer
    from doubleattentionspeakerverification_tpu_torch.training.step import make_train_step

    rank = dist.get_rank()
    with np.load(os.path.join(workdir, "batch.npz")) as z:
        batch = {k: z[k] for k in z.files}
    stats = {"backend": dist.get_backend(), "device": str(torch.cuda.current_device())}
    for tag, model_axis in (("dp", 1), ("mp", 2)):
        cfg = dataclasses.replace(ExperimentConfig(), mesh=MeshConfig(model_axis=model_axis))
        mesh = make_mesh(cfg.mesh)
        model = dist_model(cfg, mesh)
        step = make_train_step(cfg, model, make_optimizer(cfg.train, model.parameters()), DEVICE,
                               mesh=mesh)
        lo, hi, _ = step.rows
        local = {k: v[:, lo:hi] for k, v in batch.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        count_reset()
        metrics, grads, params = dist_step_result(model, mesh, step(local))
        # every rank's parameters, to hold the replicas equal; rank 0's gradients
        np.savez(os.path.join(workdir, f"{tag}_rank{rank}.npz"),
                 **{f"param/{k}": v for k, v in params.items()},
                 **({f"grad/{k}": v for k, v in grads.items()} if rank == 0 else {}))
        del grads, params
        times = []
        for _ in range(DIST_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(local)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        stats[tag] = dict(metrics, rows=[lo, hi], columns=list(model.amsoftmax.W.shape),
                          launches=counts(), times_ms=times,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del model, step
        torch.cuda.empty_cache()
        dist.barrier()
    # the CLI across the two ranks, on the [trainer] corpus
    with open(os.path.join(workdir, "cli_argv.json")) as f:
        argv = json.load(f)
    count_reset()
    t0 = time.perf_counter()
    with open(os.path.join(workdir, f"cli_rank{rank}.log"), "w") as f, \
            contextlib.redirect_stdout(f), \
            saved_validation_caches(os.path.join(workdir, f"cache_rank{rank}")):
        stats["cli_rc"] = cli.main(argv + ["--distributed"])
    stats["cli"] = dict(launches=counts(), wall_s=time.perf_counter() - t0)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(stats, f)


def compare_validation_caches(work, n):
    """Holds the embedding caches that ``saved_validation_caches`` wrote for
    each of ``n`` validations: the two ranks' gathered caches equal bit for
    bit, and within TOL_DIST_EMBED of one process's, each utterance's
    embedding nearer its own than any other's, so a gather onto the wrong
    utterances shows. Returns, a validation each, the largest distance
    from one process's and the nearest other utterance's, over the largest
    value."""
    emb_err, emb_gap = [], []
    for i in range(n):
        caches = []
        for who in ("rank0", "rank1", "one"):
            with np.load(os.path.join(work, f"cache_{who}_{i}.npz")) as z:
                caches.append((z["ids"], z["emb"]))
        (ids0, emb0), (ids1, emb1), (ids, emb) = caches
        check(np.array_equal(ids0, ids) and np.array_equal(ids1, ids)
              and np.array_equal(emb0, emb1),
              f"[distributed] validation {i}: the ranks' gathered caches differ from each other "
              f"or in their utterances from one process's")
        d = np.abs(emb0[:, None, :] - emb[None, :, :]).max(axis=-1)   # sharded x one process
        own = np.diag(d)
        others = np.where(np.eye(len(ids), dtype=bool), np.inf, d).min(axis=1)
        emb_err.append(float(own.max()) / float(np.abs(emb).max()))
        emb_gap.append(float(others.min()) / float(np.abs(emb).max()))
        check(emb_err[-1] <= TOL_DIST_EMBED and bool((own < others).all()),
              f"[distributed] validation {i}: sharded embeddings within {emb_err[-1]:.3g} of "
              f"their largest from one process's (tol {TOL_DIST_EMBED}); "
              f"{int((own >= others).sum())} utterances nearer another's embedding")
    return emb_err, emb_gap


def phase_distributed(root, smi):
    """The port's multi-process training on the card (see the module
    docstring): NCCL at world size 1; the paper-width step on two ranks
    sharing the card over gloo, data-parallel and with W split, against
    one process's step; ``cli/train.py --distributed --model_parallel 2
    --checkpoint_backend orbax`` against one process's run, and a 2 -> 1
    resume from its step-2 ``.dcp``. Uses the [trainer] corpus under
    ``root``. Returns B1's and B2's launches a rank in the step."""
    import torch

    from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig
    from doubleattentionspeakerverification_tpu_torch.training.optimizers import make_optimizer
    from doubleattentionspeakerverification_tpu_torch.training.step import make_train_step
    from doubleattentionspeakerverification_tpu_torch.utils.dist_ckpt import (
        DcpAsyncSaver, load_checkpoint_dcp, save_checkpoint_dcp,
    )
    from doubleattentionspeakerverification_tpu_torch.utils.weights import train_state_to_jax

    t_phase = time.perf_counter()
    work = os.path.join(root, "distributed")
    os.makedirs(work)

    # NCCL at world size 1
    dist_launch("dist_nccl_rank", 1, work, "[distributed] NCCL")
    with open(os.path.join(work, "nccl.json")) as f:
        nccl = json.load(f)
    check(nccl["backend"] == "nccl" and nccl["world"] == 1, f"[distributed] NCCL run: {nccl}")
    check(abs(nccl["loss"] - nccl["loss_plain"]) <= TOL_TRAIN_LOSS
          and nccl["grad_rel"] <= TOL_TRAIN_GRAD and nccl["param_rel"] <= TOL_TRAIN_GRAD,
          f"[distributed] the step through NCCL at world size 1 differs from the plain step: "
          f"{nccl}")
    print(f"[distributed] NCCL {nccl['nccl']} at world size 1 on {nccl['device']}: backend "
          f"{nccl['backend']}; one step of a k=64 model through the communicator (its gradient "
          f"all-reduce), cuDNN deterministic, against the step without it: loss "
          f"{nccl['loss']:.6f} vs {nccl['loss_plain']:.6f}, gradients within "
          f"{nccl['grad_rel']:.3g} and parameters within {nccl['param_rel']:.3g} of their "
          f"largest (tol {TOL_TRAIN_GRAD})")
    dcp = nccl["dcp"]
    check(not dcp["marker_early"] and dcp["equal"] and dcp["meta"] == {"step": 1},
          f"[distributed] NCCL: the asynchronous .dcp save: {dcp}")
    print(f"[distributed] NCCL at world size 1: one asynchronous .dcp of the {dcp['n_leaves']} "
          f"leaves after the step (DcpAsyncSaver, its own gloo group): issued in "
          f"{dcp['issued_s']:.4f} s, no meta.json before wait(), finalized in a further "
          f"{dcp['wait_s']:.4f} s; every leaf read back equal")

    # the paper-width step, one process, as the two ranks will take it
    cfg = ExperimentConfig()
    t = cfg.train
    batch = train_batch(np.random.default_rng(10), cfg, t.gradient_accumulation, t.batch_size,
                        t.window_size, ragged=(1,))
    np.savez(os.path.join(work, "batch.npz"), **batch)
    model = dist_model(cfg)
    step = make_train_step(cfg, model, make_optimizer(t, model.parameters()), DEVICE)
    ref_m, ref_g, ref_p = dist_step_result(model, None, step(batch))
    p0 = {n: v.detach().numpy() for n, v in dist_model(cfg).named_parameters()}
    del model, step
    torch.cuda.empty_cache()
    out_dir = os.path.join(root, "dist_cli")
    cli_flags = ("--model_parallel", "2", "--checkpoint_backend", "orbax", "--optimizer", "SGD")
    with open(os.path.join(work, "cli_argv.json"), "w") as f:
        json.dump(trainer_argv(root, out_dir, *cli_flags), f)

    t0 = time.perf_counter()
    results = dist_launch("dist_rank", 2, work, "[distributed]")
    ranks_wall = time.perf_counter() - t0
    stats = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            stats.append(json.load(f))
    for r, (res, st) in enumerate(zip(results, stats)):
        check(st["backend"] == "gloo" and "backend gloo" in res.stdout,
              f"[distributed] rank {r}: backend {st['backend']} (two ranks on one card: gloo)")
    sensitive = {k for k in ref_g if k.startswith("vgg.")} | {"fc2.bias"}
    for tag in ("dp", "mp"):
        lo, hi = stats[0][tag]["rows"]
        what = (f"data-parallel, {hi - lo} rows a rank" if tag == "dp" else
                f"W split, {stats[0][tag]['columns'][1]} columns a rank")
        got_p = []
        for r in range(2):
            with np.load(os.path.join(work, f"{tag}_rank{r}.npz")) as z:
                got_p.append({k[6:]: z[k] for k in z.files if k.startswith("param/")})
                if r == 0:
                    got_g = {k[5:]: torch.from_numpy(z[k]) for k in z.files
                             if k.startswith("grad/")}
        check(sorted(got_g) == sorted(got_p[0]) == sorted(got_p[1]) == sorted(ref_g),
              f"[distributed] {tag}: parameter set")
        unequal = [k for k in ref_p if not np.array_equal(got_p[0][k], got_p[1][k])]
        check(not unequal, f"[distributed] {tag}: the two ranks' replicas differ after the step "
              f"in {unequal}")
        for r, st in enumerate(stats):
            s = st[tag]
            err = abs(s["loss"] - ref_m["loss"])
            check(err <= TOL_TRAIN_LOSS, f"[distributed] {tag} rank {r}: loss {s['loss']} vs "
                  f"one process {ref_m['loss']}")
            for name in ("mha_pool", "logmel"):
                check(s["launches"][name] > 0, f"[distributed] {tag} rank {r}: kernel {name} "
                      "was never launched")
        gmax, gl2 = compare_grads(got_g, {k: torch.from_numpy(v) for k, v in ref_g.items()},
                                  f"{what}, vs one process", sensitive, tag="[distributed]")
        ul2 = {k: float(np.linalg.norm((got_p[0][k] - p0[k]) - (ref_p[k] - p0[k]))
                        / max(np.linalg.norm(ref_p[k] - p0[k]), 1e-30)) for k in ref_p}
        held = {k: v for k, v in ul2.items() if k not in UPDATE_EXEMPT}
        worst = sorted(held, key=held.get, reverse=True)[:5]
        check(held[worst[0]] <= TOL_DIST_UPDATE, f"[distributed] {tag}: the step's update of "
              f"{worst[0]} at L2 {held[worst[0]]:.3g} of its norm from one process's")
        print(f"[distributed] step 1, {what} (G={t.gradient_accumulation} x {t.batch_size} "
              f"windows of {t.window_size} s in all): loss "
              + ", ".join(f"rank {r} {st[tag]['loss']:.6f}" for r, st in enumerate(stats))
              + f" vs one process {ref_m['loss']:.6f} (tol {TOL_TRAIN_LOSS}); gradients within "
              f"{gmax:.3g} of their largest, the encoder's and fc2.bias's within {gl2:.3g} of "
              f"their norm (tol {TOL_TRAIN_GRAD} / {TOL_TRAIN_L2}); the two ranks' parameters "
              f"equal bit for bit after the step; the Adam update's L2 distance / norm from one "
              f"process's, worst five: " + ", ".join(f"{k} {held[k]:.3g}" for k in worst)
              + f" (tol {TOL_DIST_UPDATE}; " + ", ".join(f"{k} {ul2[k]:.3g}"
                                                          for k in UPDATE_EXEMPT)
              + " exempt)")
        for r, st in enumerate(stats):
            s = st[tag]
            print(f"[distributed] {tag} rank {r}: rows {s['rows']}, W {s['columns']}, "
                  f"launches in its 1 + {DIST_STEPS} steps {json.dumps(s['launches'])}; step "
                  f"times " + ", ".join(f"{x:.1f}" for x in s["times_ms"]) + f" ms (CUDA "
                  f"events, two ranks sharing the card), median "
                  f"{float(np.median(s['times_ms'])):.1f} ms; peak "
                  f"torch.cuda.max_memory_allocated {s['peak_gib']:.2f} GiB; on {smi}")
    del got_g, got_p, ref_g

    # the CLI: 2 ranks, W split, .dcp checkpoints, SGD, 4 steps, against one process
    check(all(st["cli_rc"] == 0 for st in stats), f"[distributed] cli exits {stats}")
    for r, st in enumerate(stats):
        for name in ("mha_pool", "logmel"):
            check(st["cli"]["launches"][name] > 0,
                  f"[distributed] cli rank {r}: kernel {name} was never launched")
    log = os.path.join(root, "console.log")
    one = os.path.join(root, "dist_one")
    sync = os.path.join(root, "dist_sync")
    # one process, asynchronous .dcp (no process group: no_dist), then the
    # same run writing every .dcp synchronously; cuDNN deterministic, so the
    # two runs take the same steps
    torch.backends.cudnn.deterministic = True
    try:
        with saved_validation_caches(os.path.join(work, "cache_one")):
            trainer_cli(trainer_argv(root, one, *cli_flags), log)
        trainer_cli(trainer_argv(root, sync, *cli_flags, "--no-checkpoint_async"), log)
    finally:
        torch.backends.cudnn.deterministic = False
    ev2, ev1 = trainer_events(out_dir), trainer_events(one)

    def by_step(events, kind, key):
        return {int(e["step"]): e[key] for e in events if e["event"] == kind}

    l2, l1 = by_step(ev2, "train", "xent"), by_step(ev1, "train", "xent")
    e2, e1 = by_step(ev2, "validate", "eer"), by_step(ev1, "validate", "eer")
    check(sorted(l2) == sorted(l1) == [1, 2, 3, 4] and sorted(e2) == sorted(e1) == [2, 4],
          f"[distributed] cli steps {sorted(l2)} / {sorted(l1)}, validations {e2} / {e1}")
    dl = max(abs(l2[k] - l1[k]) for k in l1)
    de = max(abs(e2[k] - e1[k]) for k in e1)
    check(dl <= TOL_DIST_LOSS and de <= TOL_DIST_EER,
          f"[distributed] cli: losses {l2} vs one process {l1}; EERs {e2} vs {e1}")
    shards = [e for e in ev2 if e["event"] == "validate_shard"]
    check(len(shards) == 2 and all(e["n_local"] == -(-e["n_total"] // 2) for e in shards),
          f"[distributed] sharded validation {shards}")
    emb_err, emb_gap = compare_validation_caches(work, len(e1))
    # the asynchronous saves: each run's ckpt_save modes; the prune runs as a
    # save is issued and counts only finished directories (JAX's rule), so
    # the last save lands on top of the 3 kept, and every one is finished
    blocked = {}
    for run, d, mode in (("2 ranks", out_dir, "async"), ("one process", one, "async"),
                         ("one process, --no-checkpoint_async", sync, "sync")):
        saves = [e for e in trainer_events(d) if e["event"] == "ckpt_save"]
        check([e["step"] for e in saves if e["kind"] == "periodic"] == [1, 2, 3, 4]
              and all((e["backend"], e["mode"]) == ("dcp", mode) for e in saves),
              f"[distributed] {run}: ckpt_save events {saves}")
        blocked[f"{mode} ({run})"] = [e["blocked_s"] for e in saves]
        dcps = sorted(f for f in os.listdir(d) if f.endswith(".dcp") and "_best_" not in f)
        steps = sorted(int(f.rsplit("_", 1)[1][:-4]) for f in dcps)
        check(steps == ([2, 3, 4] if mode == "sync" else [1, 2, 3, 4])
              and all(os.path.exists(os.path.join(d, f, "meta.json")) for f in dcps),
              f"[distributed] {run}: .dcp checkpoints {dcps}")
    # the asynchronous and the synchronous one-process runs leave the same
    # leaves (up to the card's run-to-run rounding, which cuDNN's
    # deterministic algorithms leave out)
    (a_dir,), (s_dir,) = ([os.path.join(d, f) for f in os.listdir(d) if f.endswith("_4.dcp")]
                          for d in (one, sync))
    a_leaves, _ = load_checkpoint_dcp(a_dir)
    s_leaves, _ = load_checkpoint_dcp(s_dir)
    check(set(a_leaves) == set(s_leaves), "[distributed] async vs sync: leaf sets")
    leaf_err = max(float(np.abs(a_leaves[k] - s_leaves[k]).max())
                   / max(float(np.abs(s_leaves[k]).max()), 1e-30) for k in s_leaves)
    n_equal = sum(np.array_equal(a_leaves[k], s_leaves[k]) for k in s_leaves)
    check(leaf_err <= TOL_TRAINER_RESUME, f"[distributed] async vs sync: step 4's leaves "
          f"differ by {leaf_err:.3g} of their largest")
    print(f"[distributed] .dcp saves, ckpt_save blocked_s by mode: "
          + "; ".join(f"{k}: " + ", ".join(f"{x:.4f}" for x in v) for k, v in blocked.items())
          + f" s; step 4's {len(s_leaves)} leaves, async against sync: {n_equal} bit for bit, "
          f"all within {leaf_err:.3g} of their largest (tol {TOL_TRAINER_RESUME}); on {smi}")
    # the saver alone, one process, on the paper model's leaves (SGD, no
    # moments): a synchronous save against an asynchronous one issued with
    # nothing in flight and then waited for, twice
    leaves = train_state_to_jax(dist_model(cfg).state_dict(), {}, "SGD", 1, 1e-4)
    mb = sum(v.nbytes for v in leaves.values()) / 2**20
    saver, split = DcpAsyncSaver(), []
    for i in range(2):
        t0 = time.perf_counter()
        save_checkpoint_dcp(os.path.join(work, f"sync_{i}.dcp"), leaves, {"step": i})
        t1 = time.perf_counter()
        path = saver.save(os.path.join(work, f"async_{i}.dcp"), leaves, {"step": i})
        t2 = time.perf_counter()
        saver.wait()
        split.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
        back, _ = load_checkpoint_dcp(path)
        check(all(np.array_equal(back[k], leaves[k]) for k in leaves),
              f"[distributed] the asynchronous save {i} read back unequal")
    del leaves, back
    print(f"[distributed] one process, the paper model's {mb:.1f} MiB of leaves: synchronous "
          f"save / asynchronous issue / its wait " + ", ".join(
              f"{a:.4f} / {b:.4f} / {c:.4f}" for a, b, c in split) + f" s; on {smi}")
    dcps = sorted(f for f in os.listdir(out_dir) if f.endswith(".dcp"))
    # 2 -> 1: one process resumes from the two ranks' step-2 checkpoint
    (two,) = [d for d in dcps if d.endswith("_2.dcp")]
    resumed = os.path.join(root, "dist_resumed")
    os.makedirs(resumed)
    shutil.copytree(os.path.join(out_dir, two), os.path.join(resumed, two))
    trainer_cli(trainer_argv(root, resumed, *cli_flags, "--requeue"), log)
    lr = by_step(trainer_events(resumed), "train", "xent")
    check(sorted(lr) == [3, 4], f"[distributed] 2 -> 1 resume took steps {sorted(lr)}")
    dr = max(abs(lr[k] - l1[k]) for k in lr)
    check(dr <= TOL_DIST_LOSS, f"[distributed] 2 -> 1 resume: losses {lr} vs {l1}")
    shard_info = shards[0]
    print(f"[distributed] cli.train --distributed, 2 ranks on one card, --model_parallel 2, "
          f".dcp checkpoints every step, SGD, 4 steps: losses "
          + ", ".join(f"{l2[k]:.6f}" for k in sorted(l2)) + " vs one process "
          + ", ".join(f"{l1[k]:.6f}" for k in sorted(l1)) + f" (max |d| {dl:.3g}, tol "
          f"{TOL_DIST_LOSS}); sharded EERs " + ", ".join(f"{e2[k]:.4f}" for k in sorted(e2))
          + " vs unsharded " + ", ".join(f"{e1[k]:.4f}" for k in sorted(e1))
          + f" (max |d| {de:.3g}, tol {TOL_DIST_EER}); {shard_info['n_local']:.0f} of "
          f"{shard_info['n_total']:.0f} utterances a rank; the ranks' gathered embedding "
          f"caches equal, within " + ", ".join(f"{x:.3g}" for x in emb_err) + " of their "
          f"largest from one process's (tol {TOL_DIST_EMBED}), each nearest its own (the "
          f"nearest other utterance " + ", ".join(f"{x:.3g}" for x in emb_gap) + " away); "
          f"launches a rank "
          + "; ".join(json.dumps(st["cli"]["launches"]) for st in stats)
          + "; rank walls " + ", ".join(f"{st['cli']['wall_s']:.1f}" for st in stats) + " s")
    print(f"[distributed] 2 -> 1: one process resumed the ranks' {two} and took steps 3, 4: "
          + ", ".join(f"{lr[k]:.6f}" for k in sorted(lr)) + f" (max |d| {dr:.3g} from the "
          f"uninterrupted one-process run, tol {TOL_DIST_LOSS})")
    print(f"[distributed] the ranks' command {ranks_wall:.1f} s; the phase "
          f"{time.perf_counter() - t_phase:.1f} s of wall time")
    return {k: stats[0]["dp"]["launches"][k] // (1 + DIST_STEPS) for k in ("mha_pool", "logmel")}


def phase_example_checkpoint():
    from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel

    path = os.path.join(HERE, "examples", "pretrained", "example_model.npz")
    gpu = SpeakerEmbeddingModel.from_checkpoint(path, device=DEVICE)
    cpu = SpeakerEmbeddingModel.from_checkpoint(path, device="cpu")
    rng = np.random.default_rng(2)
    worst = 0.0
    for seconds in (1.0, 1.5, 3.0, 6.0):
        wave = seeded_speech(rng, seconds)
        a, b = gpu.embed_wave(wave), cpu.embed_wave(wave)
        check(np.all(np.isfinite(a)) and a.shape == (gpu.cfg.model.embedding_size,),
              "example-model embedding not finite or of the wrong size")
        worst = max(worst, float(np.abs(a - b).max()))
    check(worst <= TOL_EMBED, f"card path disagrees with the CPU path: {worst:.3g}")
    print(f"[example checkpoint] cuda vs cpu embeddings of 4 waves: max|d|={worst:.3g} "
          f"(tol {TOL_EMBED})")


def conv_inputs(rng, b, t, f, cin, cout):
    """Seeded B3 inputs on the card: int8 activations and taps, and a mult
    that spreads the int8 outputs over 0..127."""
    import torch

    q = rng.integers(-127, 128, (b, t, f, cin), dtype=np.int8)
    w9 = rng.integers(-127, 128, (9, cin, cout), dtype=np.int8)
    spread = 64.0 / (math.sqrt(9 * cin) * 127 * 127 / 3)
    mult = (rng.uniform(0.5, 2.0, cout) * spread).astype(np.float32)
    bias = (rng.standard_normal(cout) * 10).astype(np.float32)
    return tuple(torch.from_numpy(x).to(DEVICE) for x in (q, w9, mult, bias))


def conv_check(q, w9, mult, bias) -> float:
    """B3 against its plain version for every out_kind: int8 equal, bit for
    bit; float32/bfloat16 within TOL_CONV_FP relative. Returns max |d|."""
    import torch

    from doubleattentionspeakerverification_tpu_torch.ops import conv_int8

    wp = conv_int8.pack_weights(w9)
    shape = tuple(q.shape)
    worst = 0.0
    for kind in conv_int8.OUT_KINDS:
        got = conv_int8.conv3x3_int8_cuda(q, wp, mult, bias, kind)
        ref = conv_int8.conv3x3_int8_plain(q, w9, mult, bias, kind)
        torch.cuda.synchronize()
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"B3 {kind} at {shape}: {tuple(got.shape)} {got.dtype}")
        d = (got.to(torch.float64) - ref.to(torch.float64)).abs()
        if kind == "int8":
            check(bool((d == 0).all()), f"B3 int8 output differs from its plain version at "
                  f"{shape}: {int((d != 0).sum())} elements, max |d| {float(d.max())}")
        else:
            check(bool((d <= TOL_CONV_FP * ref.to(torch.float64).abs()).all()),
                  f"B3 {kind} output beyond {TOL_CONV_FP} relative at {shape}: max |d| {float(d.max())}")
        worst = max(worst, float(d.max()))
    return worst


def phase_conv_int8():
    """B3 at the seven paper-width convs of one forward of 8 x 10 s (each
    checked for every out_kind and timed with int8 out) and at edge shapes."""
    import torch
    import torch.nn.functional as F

    from doubleattentionspeakerverification_tpu_torch.ops import conv_int8
    from doubleattentionspeakerverification_tpu_torch.tools.conv_int8_probe import im2col_int_mm
    from doubleattentionspeakerverification_tpu_torch.tools.timing import (
        HBM_BYTES_PER_S, INT8_OPS_PER_S, bound_ms, cuda_ms,
    )

    rng = np.random.default_rng(4)
    worst = 0.0
    for shape in CONV_EDGE:
        err = conv_check(*conv_inputs(rng, *shape))
        worst = max(worst, err)
        print(f"[B3 conv_int8] edge B,T,F,Cin,Cout={shape}: int8 equal, float max|d|={err:.3g}")
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, cudnn_f32_ms=0.0)
    ops_ms = bytes_ms = 0.0
    for name, t, f, cin, cout in CONV_PAPER:
        q, w9, mult, bias = conv_inputs(rng, CONV_B, t, f, cin, cout)
        worst = max(worst, conv_check(q, w9, mult, bias))
        wp = conv_int8.pack_weights(w9)
        ms = cuda_ms(lambda: conv_int8.conv3x3_int8_cuda(q, wp, mult, bias), 5)
        plain_ms = cuda_ms(lambda: conv_int8.conv3x3_int8_plain(q, w9, mult, bias), 1, replays=2)
        library_ms = cuda_ms(lambda: im2col_int_mm(q, w9, mult, bias), 2, replays=3)
        lib = im2col_int_mm(q, w9, mult, bias)
        check(torch.equal(lib, conv_int8.conv3x3_int8_cuda(q, wp, mult, bias)),
              f"im2col + torch._int_mm disagrees with B3 at {name}")
        # the fp path's counterpart: float32 cuDNN conv of the same shape (TF32 off)
        xf = q.permute(0, 3, 1, 2).to(torch.float32).contiguous()
        wf = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).to(torch.float32).contiguous()
        cudnn_ms = cuda_ms(lambda: F.conv2d(xf, wf, padding=1), 2, replays=3)
        del xf, wf, lib
        n_ops = 2.0 * CONV_B * t * f * 9 * cin * cout
        n_bytes = CONV_B * t * f * (cin + cout) + 9 * cin * cout + 8 * cout
        b_ms, b_by = bound_ms(n_bytes, n_ops, INT8_OPS_PER_S)
        ops_ms += n_ops / INT8_OPS_PER_S * 1e3
        bytes_ms += n_bytes / HBM_BYTES_PER_S * 1e3
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                     ("bound_ms", b_ms), ("cudnn_f32_ms", cudnn_ms)):
            total[k] += v
        print(f"[B3 conv_int8] {name} B={CONV_B} T={t} F={f} {cin}->{cout}: every out_kind checked; "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"(im2col + torch._int_mm + epilogue) bound_ms={b_ms:.4f} ({b_by}) "
              f"cudnn_f32_ms={cudnn_ms:.4f}; {n_ops / ms / 1e9:.1f} TOP/s")
        del q, w9, mult, bias, wp
        torch.cuda.empty_cache()
    print(f"[B3 conv_int8] the seven convs of one 8 x 10 s forward: kernel_ms={total['ms']:.4f} "
          f"plain_ms={total['plain_ms']:.4f} library_ms={total['library_ms']:.4f} "
          f"bound_ms={total['bound_ms']:.4f} cudnn_f32_ms={total['cudnn_f32_ms']:.4f}; "
          f"max|d| over all shapes and out_kinds {worst:.3g} (int8 equal, float tol "
          f"{TOL_CONV_FP} relative)")
    del total["cudnn_f32_ms"]
    return dict(max_abs_err=worst, bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                **total)


def example_batch(rng):
    """Seeded normalized features of three uploads, padded into one batch
    (computed on the CPU, so both devices get the same numbers)."""
    from doubleattentionspeakerverification_tpu_torch.config import FeatureConfig
    from doubleattentionspeakerverification_tpu_torch.dsp.features import extract_normalized
    import torch

    feats = [extract_normalized(torch.from_numpy(seeded_speech(rng, s)), FeatureConfig(), "cmn")
             for s in (1.5, 3.0, 6.0)]
    lens = np.array([x.shape[0] for x in feats], np.int64)
    batch = np.zeros((len(feats), lens.max(), feats[0].shape[1]), np.float32)
    for i, x in enumerate(feats):
        batch[i, : len(x)] = x.numpy()
    return batch, lens


def phase_example_int8():
    """example_model.npz in int8_static on the card and on the CPU, each
    calibrated on the same seeded batch: equal scales, equal int8
    activations at every conv, embeddings within TOL_EMBED."""
    import torch

    from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel
    from doubleattentionspeakerverification_tpu_torch.models import quantized

    path = os.path.join(HERE, "examples", "pretrained", "example_model.npz")
    models = {dev: SpeakerEmbeddingModel.from_checkpoint(path, device=dev, quantize="int8_static")
              for dev in (DEVICE, "cpu")}
    batch, lens = example_batch(np.random.default_rng(5))
    mcfg = models["cpu"].cfg.model
    scales, acts, embs = {}, {}, {}
    with torch.inference_mode():
        for dev, m in models.items():
            x, ln = torch.from_numpy(batch).to(dev), torch.from_numpy(lens).to(dev)
            qvgg = quantized.quantize_vgg(m.model.vgg)
            scales[dev] = quantized.calibrate_int8_scales(qvgg, x, ln, mcfg)
            folded = quantized.fold_static_scales(qvgg, scales[dev], mcfg)
            acts[dev] = []
            quantized.quantized_vgg_apply_static(folded, scales[dev][0], x, ln, mcfg,
                                                 intermediates=acts[dev])
            check(m.calibrate_quantization(batch, lens) == "static",
                  f"example checkpoint int8_static on {dev}: {m.quantize_calibration_state()}")
            embs[dev] = m.embed_features(batch, lens)
    check(scales[DEVICE] == scales["cpu"],
          f"int8_static scales differ between the card and the CPU: {scales[DEVICE]} vs {scales['cpu']}")
    for k, (a, b) in enumerate(zip(acts[DEVICE], acts["cpu"])):
        check(a.dtype == b.dtype and torch.equal(a.cpu(), b),
              f"conv {k}: the card's activations differ from the CPU's "
              f"({int((a.cpu() != b).sum())} of {b.numel()} elements)")
    err = float(np.abs(embs[DEVICE] - embs["cpu"]).max())
    check(np.all(np.isfinite(embs[DEVICE])) and err <= TOL_EMBED,
          f"int8_static embeddings: card vs CPU max|d| {err:.3g}")
    print(f"[example checkpoint int8_static] {len(scales['cpu'])} scales equal on card and CPU; "
          f"int8 activations equal at {len(acts['cpu'])} convs ({sum(a.numel() for a in acts['cpu'])} "
          f"values); embeddings max|d|={err:.3g} (tol {TOL_EMBED})")


def paper_config():
    from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig()
    m = cfg.model
    check((m.front_end, m.kernel_size, m.heads_number, m.pooling_method, m.embedding_size)
          == ("VGG4L", 1024, 32, "DoubleMHA", 400), f"not the paper configuration: {m}")
    return cfg


def forward_batch(model):
    """8 seeded 10 s uploads as one normalized feature batch on the card."""
    import torch

    rng = np.random.default_rng(7)
    feats = [model.features_of_wave(seeded_speech(rng, 10.0)) for _ in range(8)]
    return torch.stack(feats), torch.full((8,), feats[0].shape[0], device=DEVICE)


def phase_serve(cfg, quantize="none", expect=("mha_pool", "logmel")):
    """A serving path: an HTTP server of ``cfg``'s width answering 8
    concurrent uploads, then /enroll, /verify and /identify. Under
    ``int8_static`` the model is calibrated on a seeded upload first.
    Returns the launch counts of the kernels in ``expect``, the /embed
    embeddings and the device time of one 8 x 10 s forward."""
    import torch

    from doubleattentionspeakerverification_tpu_torch import ops
    from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel
    from doubleattentionspeakerverification_tpu_torch.data.wav import encode_wav
    from doubleattentionspeakerverification_tpu_torch.serving import make_server
    from doubleattentionspeakerverification_tpu_torch.tools.timing import cuda_ms

    tag = "[serve]" if quantize == "none" else f"[serve {quantize}]"
    m = cfg.model
    model = SpeakerEmbeddingModel.from_random_init(cfg, seed=0, device=DEVICE, quantize=quantize)
    if quantize == "int8_static":
        calib = model.features_of_wave(seeded_speech(np.random.default_rng(6), 6.0))
        state = model.calibrate_quantization(calib)
        check(state == "static", f"{tag} calibration on a seeded upload gave state {state!r}")
    server = make_server(model, "127.0.0.1", 0, max_batch=8, max_wait_ms=20.0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    rng = np.random.default_rng(3)
    uploads = [encode_wav(seeded_speech(rng, s), 16000) for s in SERVE_SECONDS]

    def post(path, body):
        t0 = time.perf_counter()
        req = urllib.request.Request(base + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        return out, (time.perf_counter() - t0) * 1e3

    for k in ops.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    thread.start()
    try:
        results = [None] * len(uploads)

        def client(i):
            results[i] = post("/embed", uploads[i])

        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(uploads))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        enroll, t_enroll = post("/enroll?speaker=spk0", uploads[1])
        verify, t_verify = post("/verify?speaker=spk0", uploads[1])
        ident, t_ident = post("/identify?top_k=1", uploads[1])
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        torch.cuda.synchronize()
    finally:
        server.shutdown()
        server.batcher.close()
        thread.join(timeout=60)
    launches = {k.name: k.launches for k in ops.KERNELS}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    embs = []
    for i, (s, r) in enumerate(zip(SERVE_SECONDS, results)):
        check(r is not None, f"{tag} /embed request {i} did not complete")
        emb = np.asarray(r[0]["embedding"])
        check(emb.shape == (m.embedding_size,) and np.all(np.isfinite(emb)),
              f"{tag} /embed {i}: embedding not finite or of size {emb.shape}")
        embs.append(emb)
        print(f"{tag} /embed {s:g} s audio ({r[0]['frames']} frames): {r[1]:.1f} ms")
    check(enroll["enrollments"] == 1, f"{tag} /enroll: {enroll}")
    check(verify["score"] >= 0.99 and verify["decision"], f"{tag} /verify of the same audio: {verify}")
    check(ident["speakers"][0]["speaker"] == "spk0", f"{tag} /identify: {ident}")
    print(f"{tag} /enroll {t_enroll:.1f} ms, /verify {t_verify:.1f} ms "
          f"(score {verify['score']:.6f}), /identify {t_ident:.1f} ms")
    print(f"{tag} health: requests={health['requests']} forwards={health['forwards']} "
          f"batched={health['batched']} errors={health['errors']}; "
          f"peak torch.cuda.max_memory_allocated = {peak_mib:.1f} MiB")
    print(f"{tag} kernel launches on the serving path: {json.dumps(launches)}")
    for name in expect:
        check(launches[name] > 0, f"kernel {name} was never launched on the {tag} path")
    state = model.quantize_calibration_state()
    check(quantize == "none" or state == "static", f"{tag} served in state {state!r}")
    if quantize == "int8_static":
        check_int8_served(model, calib, uploads, np.stack(embs), tag)

    x, lens = forward_batch(model)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model._embed(x, lens), 2, replays=3)
    print(f"{tag} one forward of 8 x 10 s features (B=8, T={x.shape[1]}): {fwd_ms:.3f} ms "
          f"device time (CUDA-graph replay); calibration state {state!r}")
    return launches, np.stack(embs), fwd_ms


def check_int8_served(model, calib, uploads, embs, tag):
    """Holds the served int8_static embeddings to the same model's static
    forward on the same uploads and scales with B3's plain version in B3's
    place, within TOL_INT8_SERVED: B3 at the serving shapes, the folded
    epilogues and the batching, which random (bias-dominated) embeddings
    hide from the cosine guard. The check fails too if the uploads'
    embeddings differ from each other by less than ten times its tolerance,
    where it could not tell a fault. Also holds the paper-width calibration scales of
    the card to the CPU's on the calibration upload."""
    import copy

    import torch

    from doubleattentionspeakerverification_tpu_torch.data.wav import decode_wav_bytes
    from doubleattentionspeakerverification_tpu_torch.models import quantized
    from doubleattentionspeakerverification_tpu_torch.ops import conv_int8

    mcfg = model.cfg.model
    with torch.inference_mode():
        card = quantized.calibrate_int8_scales(quantized.quantize_vgg(model.model.vgg),
                                               calib[None], None, mcfg)
        cpu_vgg = copy.deepcopy(model.model.vgg).cpu()
        cpu = quantized.calibrate_int8_scales(quantized.quantize_vgg(cpu_vgg),
                                              calib[None].cpu(), None, mcfg)
    check(card == cpu, f"{tag} paper-width scales differ between the card and the CPU: "
          f"{card} vs {cpu}")

    def plain_b3(q, w9, mult, bias, out_kind="int8", w_packed=None, use_kernel=True):
        return conv_int8.conv3x3_int8_plain(q, w9, mult, bias, out_kind)

    before, b3 = conv_int8.KERNEL.launches, quantized.conv3x3_int8
    quantized.conv3x3_int8 = plain_b3
    try:
        ref = np.stack([model.embed_wave(*decode_wav_bytes(u)) for u in uploads])
    finally:
        quantized.conv3x3_int8 = b3
    check(conv_int8.KERNEL.launches == before, f"{tag} the plain reference launched B3")
    err = float(np.abs(embs - ref).max())
    spread = float(np.abs(embs[:, None] - embs[None]).max())
    check(spread >= 10 * TOL_INT8_SERVED, f"{tag} the uploads' embeddings differ from each "
          f"other by only {spread:.3g}: a {TOL_INT8_SERVED} check could not see a fault")
    check(np.isfinite(err) and err <= TOL_INT8_SERVED,
          f"{tag} served embeddings vs the static forward with B3's plain version: "
          f"max|d| {err:.3g} > {TOL_INT8_SERVED}")
    print(f"{tag} {len(card)} calibration scales equal on card and CPU; served embeddings vs "
          f"the same model's static forward with B3's plain version, one upload at a time: "
          f"max|d|={err:.3g} (tol {TOL_INT8_SERVED}); the uploads' embeddings differ from each other "
          f"by up to {spread:.3g}")


def phase_rate_probe():
    """P1 against its plain version; then the probe's timing run, with its
    launch count read from 0 (eager calls: each call is one launch)."""
    from doubleattentionspeakerverification_tpu_torch.tools import rate_probe

    checks = rate_probe.check()
    for kind, c in checks.items():
        check(c["ok"], f"P1 {kind} disagrees with its plain version: max|d| {c['max_abs_err']:.3g}")
    rate_probe.KERNEL.launches = 0
    times = rate_probe.measure()
    launches = rate_probe.KERNEL.launches
    for kind, t in times.items():
        print(f"[P1 rate] {kind} {rate_probe.SIZE}^3: max|d|={checks[kind]['max_abs_err']:.3g} "
              f"kernel_ms={t['ms']:.4f} ({t['rate_tops']:.1f} TOP/s) plain_ms={t['plain_ms']:.4f} "
              f"library_ms={t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
    main = times["int8"]
    return dict(launches=launches, max_abs_err=checks["int8"]["max_abs_err"],
                **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})


def phase_conv_probe():
    """P2: full == B3 == plain at conv22's probe shape; then the three
    variants' timing run, with its launch count read from 0 (eager calls:
    each call is one launch)."""
    from doubleattentionspeakerverification_tpu_torch.tools import conv_int8_probe

    from doubleattentionspeakerverification_tpu_torch.ops import conv_int8

    c = conv_int8_probe.check()
    check(c["ok"], f"P2 full variant differs from B3 or the plain version: max|d| {c['max_abs_err']}")
    conv_int8.KERNEL.launches = 0    # the variants are entries of B3's library
    t = conv_int8_probe.measure()
    launches = conv_int8.KERNEL.launches
    print(f"[P2 micro] B,T,F,Cin,Cout={conv_int8_probe.SHAPE}: full == B3 == plain; "
          f"full_ms={t['full_ms']:.4f} dot_only_ms={t['dot_only_ms']:.4f} "
          f"copy_only_ms={t['copy_only_ms']:.4f} plain_ms={t['plain_ms']:.4f} "
          f"library_ms={t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
    return dict(launches=launches, max_abs_err=c["max_abs_err"], ms=t["full_ms"],
                **{k: t[k] for k in ("plain_ms", "library_ms", "bound_ms", "bound_by")})


def count_reset():
    from doubleattentionspeakerverification_tpu_torch import ops

    for k in ops.KERNELS:
        k.launches = 0


def counts():
    from doubleattentionspeakerverification_tpu_torch import ops

    return {k.name: k.launches for k in ops.KERNELS}


def run_cli(main, argv, tag):
    """A port CLI's ``main(argv)`` in process, with its stderr (the score
    CLI's summary) captured; fails the phase unless it returns 0. Returns
    the stderr text."""
    import contextlib
    import io

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    check(rc == 0, f"{tag} exited {rc}: {err.getvalue()[-2000:]}")
    return err.getvalue()


def summary_of(stderr):
    """The score CLI's summary line (its last stderr line) as a dict."""
    return dict(item.split("=", 1) for item in stderr.strip().splitlines()[-1].split())


def score_lines(path):
    """A score file -> [(utt1, utt2, score text, raw text or None, label)]."""
    rows = []
    with open(path) as f:
        for line in f:
            cols = line.split()
            raw = next((c[4:] for c in cols[3:] if c.startswith("raw=")), None)
            label = next((c for c in cols[3:] if not c.startswith("raw=")), "")
            rows.append((cols[0], cols[1], cols[2], raw, label))
    return rows


def wav_batches(paths, cfg, batch):
    """(utterances, bucketed batches, audio seconds) the extractor makes of
    ``paths``: one B1 launch a batch."""
    from doubleattentionspeakerverification_tpu_torch.data.wav import read_wav
    from doubleattentionspeakerverification_tpu_torch.dsp.features import num_frames
    from doubleattentionspeakerverification_tpu_torch.evaluation.embeddings import (
        DEFAULT_BUCKETS, bucket_for,
    )

    per_bucket, seconds = {}, 0.0
    for p in paths:
        wave, sr = read_wav(p)
        seconds += len(wave) / sr
        b = bucket_for(num_frames(len(wave), cfg.features), DEFAULT_BUCKETS)
        per_bucket[b] = per_bucket.get(b, 0) + 1
    return len(paths), sum(-(-n // batch) for n in per_bucket.values()), seconds


def input_driven_paper_model(cfg, train_dir):
    """The paper's model from seed 0 with its weights made input-driven, as
    a trained model's are: convolution and linear weights at He scale
    (torch's default init shrinks a signal about 2.4x per ReLU layer, and
    the random biases then dominate the embedding, so every cosine is about
    1), no biases, and ``b2``'s running statistics set to those of fc2's
    outputs over the training wavs (B2 and B1 on the card), as training
    leaves them. Cosines then spread over [-1, 1], and the score, cohort and
    PLDA checks below can see a wrong embedding."""
    import glob

    import torch

    from doubleattentionspeakerverification_tpu_torch.evaluation.embeddings import (
        EmbeddingExtractor, wav_feature_loader,
    )
    from doubleattentionspeakerverification_tpu_torch.models.classifier import SpeakerClassifier
    from doubleattentionspeakerverification_tpu_torch.models.init import init_parameters

    model = init_parameters(SpeakerClassifier(cfg.model), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.mul_(6 ** 0.5)
                m.bias.zero_()
    model = model.to(DEVICE).eval()
    ids = sorted(os.path.basename(p)[:-4] for p in glob.glob(os.path.join(train_dir, "*.wav")))
    ex = EmbeddingExtractor(model, wav_feature_loader(train_dir, cfg.features, "cmn",
                                                      device=DEVICE))
    emb = np.stack([ex.extract(ids)[u] for u in ids]).astype(np.float64)
    e2 = emb * math.sqrt(1.0 + cfg.model.bn_eps)     # b2 at mean 0, var 1 -> fc2's output
    with torch.no_grad():
        model.b2.running_mean.copy_(torch.from_numpy(e2.mean(0)))
        model.b2.running_var.copy_(torch.from_numpy(e2.var(0)))
    return model.cpu()


def phase_score_trials(root, smi):
    """``cli/score_trials.py`` and ``cli/train_plda.py`` at paper width on
    the ``[trainer]`` corpus (see the module docstring). Returns the fp
    run's launches."""
    import torch

    from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel
    from doubleattentionspeakerverification_tpu_torch.cli import score_trials, train_plda
    from doubleattentionspeakerverification_tpu_torch.data.manifest import load_trials
    from doubleattentionspeakerverification_tpu_torch.data.wav import read_wav
    from doubleattentionspeakerverification_tpu_torch.evaluation.eer import cosine_scores
    from doubleattentionspeakerverification_tpu_torch.evaluation.embeddings import (
        EmbeddingExtractor, load_embeddings, wav_feature_loader,
    )
    from doubleattentionspeakerverification_tpu_torch.evaluation.plda import PLDA
    from doubleattentionspeakerverification_tpu_torch.evaluation.snorm import asnorm_trial_scores
    from doubleattentionspeakerverification_tpu_torch.utils.checkpoint import save_checkpoint
    from doubleattentionspeakerverification_tpu_torch.utils.weights import train_state_to_jax

    cfg = paper_config()
    work = os.path.join(root, "score")
    os.makedirs(work)

    def at(name):
        return os.path.join(work, name)

    valid, train = os.path.join(root, "valid"), os.path.join(root, "train")
    t0 = time.perf_counter()
    model = input_driven_paper_model(cfg, train)
    ckpt = at("paper_0.npz")
    save_checkpoint(ckpt, train_state_to_jax(model.state_dict(), {}, cfg.train.optimizer, 0,
                                             cfg.train.learning_rate),
                    {"config": cfg.to_dict(), "step": 0})
    del model
    print(f"[score_trials] paper-width checkpoint (seed 0, input-driven) written in "
          f"{time.perf_counter() - t0:.1f} s: {os.path.getsize(ckpt) / 2**20:.0f} MiB")
    base = ["--modelCheckpoint", ckpt, "--data_source", "wav", "--device", DEVICE]
    labelled = ["--clients", os.path.join(root, "clients.ndx"),
                "--impostors", os.path.join(root, "impostors.ndx")]
    valid_ids = [f"v{j}" for j in range(TRAINER_VALID)]
    n_valid, batches, valid_s = wav_batches(
        [os.path.join(valid, u + ".wav") for u in valid_ids], cfg, 8)

    # 1. float32, wav mode: B2 once an utterance, B1 once a bucketed batch
    count_reset()
    t0 = time.perf_counter()
    err = run_cli(score_trials.main, base + [
        "--data_dir", valid, *labelled, "--output", at("fp.txt"),
        "--save_embeddings", at("valid_fp.npz")], "[score_trials] float32")
    cli_s = time.perf_counter() - t0
    fp_launches = counts()
    check(fp_launches["logmel"] == n_valid and fp_launches["mha_pool"] == batches
          and fp_launches["conv_int8"] == 0,
          f"[score_trials] float32 launches {fp_launches}: want logmel {n_valid}, "
          f"mha_pool {batches}, conv_int8 0")
    summary = summary_of(err)
    print(f"[score_trials] float32: {n_valid} utterances ({valid_s:.1f} s of audio) in "
          f"{batches} bucketed batches, launches {json.dumps(fp_launches)}; summary {summary}; "
          f"CLI wall {cli_s:.2f} s (checkpoint load included)")
    # the same extraction timed alone (warm), through the CLI's own extractor
    api = SpeakerEmbeddingModel.from_checkpoint(ckpt, device=DEVICE)
    rates = []
    for _ in range(2):
        ex = EmbeddingExtractor(api.model, wav_feature_loader(valid, cfg.features, "cmn",
                                                              device=DEVICE))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.extract(valid_ids)
        torch.cuda.synchronize()
        rates.append(time.perf_counter() - t0)
    print(f"[score_trials] extraction (wav decode, B2, bucketed forwards, one read back), "
          f"warm: {rates[-1]:.3f} s = {n_valid / rates[-1]:.1f} utterances/s, "
          f"{valid_s / rates[-1]:.1f} audio-seconds/s (first pass {rates[0]:.3f} s); on {smi}")
    # each score against embed_wave's cosine of the same two waves, one at a time
    embs = {u: api.embed_wave(*read_wav(os.path.join(valid, u + ".wav"))) for u in valid_ids}
    store = load_embeddings(at("valid_fp.npz"), expect_quantize="none")
    rows = score_lines(at("fp.txt"))
    want = cosine_scores(np.stack([embs[a] for a, *_ in rows]), np.stack([embs[b] for _, b, *_ in rows]))
    err_score = float(np.abs(np.array([float(r[2]) for r in rows]) - want).max())
    err_emb = max(float(np.abs(store[u] - embs[u]).max()) for u in valid_ids)
    check(len(rows) == 24 and err_score <= TOL_SCORE_EMBED,
          f"[score_trials] scores vs embed_wave's cosines: max|d| {err_score:.3g} over {len(rows)}")
    print(f"[score_trials] {len(rows)} scores (cosines {want.min():.4f} .. {want.max():.4f}) vs "
          f"embed_wave's cosines of the same waves: max|d| {err_score:.3g} (tol "
          f"{TOL_SCORE_EMBED}, 6 decimals written); bucketed vs single embeddings max|d| "
          f"{err_emb:.3g} (embedding values up to "
          f"{max(float(np.abs(e).max()) for e in embs.values()):.3g})")
    del api, ex

    # 2. int8_static: calibrated on a wav, scales written; then loaded again
    int8 = base + ["--data_dir", valid, *labelled, "--quantize", "int8_static",
                   "--int8_scales", at("scales.npz")]
    err = run_cli(score_trials.main, int8 + [
        "--calibration_wav", os.path.join(valid, "v5.wav"), "--output", at("int8_a.txt")],
        "[score_trials] int8_static")
    check("int8_static calibration: static" in err, f"[score_trials] calibration: {err[-500:]}")
    count_reset()
    run_cli(score_trials.main, int8 + ["--output", at("int8_b.txt")], "[score_trials] int8_static")
    q_launches = counts()
    check(q_launches["conv_int8"] == 7 * batches and q_launches["mha_pool"] == batches
          and q_launches["logmel"] == n_valid,
          f"[score_trials] int8_static launches {q_launches}: want conv_int8 {7 * batches}")
    with open(at("int8_a.txt")) as f, open(at("int8_b.txt")) as g:
        check(f.read() == g.read(), "[score_trials] int8_static: the run that loads the scales "
              "file writes other scores")
    drift = float(np.abs(np.array([float(r[2]) for r in score_lines(at("int8_b.txt"))])
                         - np.array([float(r[2]) for r in rows])).max())
    print(f"[score_trials] int8_static: launches {json.dumps(q_launches)} (7 B3 a forward, "
          f"{batches} forwards); the run loading the scales wrote the same bytes; scores vs "
          f"float32 max|d| {drift:.3g}")

    # 3. the training utterances' store, for the cohort and PLDA
    manifest = os.path.join(root, "labels.ndx")
    with open(manifest) as f:
        train_ids = [ln.split()[0] for ln in f if ln.strip()]
    with open(at("train_pairs.ndx"), "w") as f:
        f.writelines(f"{a} {b}\n" for a, b in zip(train_ids, train_ids[1:] + train_ids[:1]))
    n_train, train_batches, train_s = wav_batches(
        [os.path.join(train, u + ".wav") for u in train_ids], cfg, 8)
    count_reset()
    t0 = time.perf_counter()
    run_cli(score_trials.main, base + [
        "--data_dir", train, "--trials", at("train_pairs.ndx"), "--output", at("train.txt"),
        "--save_embeddings", at("train_fp.npz")], "[score_trials] training store")
    wall = time.perf_counter() - t0
    t_launches = counts()
    check(t_launches["logmel"] == n_train and t_launches["mha_pool"] == train_batches,
          f"[score_trials] training store launches {t_launches}")
    print(f"[score_trials] training store: {n_train} utterances ({train_s:.1f} s of audio), "
          f"{train_batches} batches, CLI wall {wall:.2f} s; launches {json.dumps(t_launches)}")

    # 4. AS-Norm against the training store: the written lines equal a host
    #    recomputation from the stores, formatted as the CLI writes them
    # (the CLI scores the client and the impostor list each on its own)
    lists = [load_trials(os.path.join(root, f)) for f in ("clients.ndx", "impostors.ndx")]
    trials = lists[0] + lists[1]
    cohort = np.stack(list(load_embeddings(at("train_fp.npz")).values()))

    def per_list(fn):
        return np.concatenate([fn(t) for t in lists])

    raw = per_list(lambda t: cosine_scores(np.stack([store[a] for a, _ in t]),
                                           np.stack([store[b] for _, b in t])))
    for k in SCORE_TOPK:
        count_reset()
        err = run_cli(score_trials.main, base + [
            "--data_dir", valid, *labelled, "--load_embeddings", at("valid_fp.npz"),
            "--cohort_embeddings", at("train_fp.npz"), "--snorm_topk", str(k),
            "--output", at(f"snorm{k}.txt")], f"[score_trials] --snorm_topk {k}")
        normed = per_list(lambda t: asnorm_trial_scores(t, store, cohort, k))
        got = score_lines(at(f"snorm{k}.txt"))
        want = [(a, b, f"{n:.6f}", f"{r:.6f}") for (a, b), n, r in zip(trials, normed, raw)]
        check([r[:4] for r in got] == want and sum(counts().values()) == 0,
              f"[score_trials] --snorm_topk {k}: lines differ from the host recomputation")
        s = summary_of(err)
        check(s["cohort_size"] == str(len(cohort)), f"[score_trials] cohort size {s}")
        print(f"[score_trials] AS-Norm top-{k} over {len(cohort)} cohort rows: {len(got)} lines "
              f"equal the host recomputation from the stores as written (6 decimals); "
              f"eer_exact_snorm {s['eer_exact_snorm']}, min_dcf_snorm {s['min_dcf_snorm']} "
              f"(raw: eer {s['eer']}, eer_exact {s['eer_exact']})")

    # 5. PLDA trained on the training store, then scoring with it
    t0 = time.perf_counter()
    err = run_cli(train_plda.main, ["--embeddings", at("train_fp.npz"), "--labels", manifest,
                                    "--output", at("plda.npz")], "[train_plda]")
    fit_s = time.perf_counter() - t0
    err_s = run_cli(score_trials.main, base + [
        "--data_dir", valid, *labelled, "--load_embeddings", at("valid_fp.npz"),
        "--plda", at("plda.npz"), "--output", at("plda.txt")], "[score_trials] --plda")
    plda = PLDA.load(at("plda.npz"))
    llr = per_list(lambda t: plda.score_trials(t, store))
    got = score_lines(at("plda.txt"))
    check(np.all(np.isfinite(llr)) and all(math.isfinite(float(r[2])) for r in got)
          and [r[:4] for r in got] == [(a, b, f"{n:.6f}", f"{r:.6f}")
                                       for (a, b), n, r in zip(trials, llr, raw)],
          "[score_trials] --plda: LLRs not finite or not PLDA.score_trials' on the store")
    s = summary_of(err_s)
    print(f"[train_plda] {err.strip()} in {fit_s:.2f} s; --plda: {len(got)} finite LLRs "
          f"({llr.min():.3f} .. {llr.max():.3f}) equal PLDA.load(...).score_trials on the store "
          f"as written; eer_exact_plda {s['eer_exact_plda']}, min_dcf_plda {s['min_dcf_plda']}")
    return fp_launches, dict(utt_per_s=n_valid / rates[-1], audio_s_per_s=valid_s / rates[-1])


def example_corpus(root):
    """The example corpus of ``examples/example_corpus.py`` (``make_wavs``
    and ``write_index_files`` at their defaults: 4 speakers x 5 FM harmonic
    stacks of 1.5 s, seed 0), written with the port's ``data/wav.py``, which
    encodes as the JAX package's writer does: the wavs the committed golden
    scores were made from."""
    from doubleattentionspeakerverification_tpu_torch.data.wav import encode_wav

    rng = np.random.default_rng(0)
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir)
    t = np.arange(int(1.5 * 16000)) / 16000
    names, labels = [], []
    for spk in range(4):
        f0, fm_rate, fm_depth = 150 + 110 * spk, 2.0 + 1.5 * spk, 60.0 + 25.0 * spk
        for i in range(5):
            phase = rng.uniform(0, 2 * np.pi)
            inst = f0 * t + (fm_depth / (2 * np.pi * fm_rate)) * np.sin(
                2 * np.pi * fm_rate * t + phase)
            y = (0.3 * np.sin(2 * np.pi * inst) + 0.15 * np.sin(2 * np.pi * 2.0 * inst + 0.3)
                 + 0.03 * rng.standard_normal(len(t)))
            name = f"spk{spk}_utt{i}"
            with open(os.path.join(wav_dir, name + ".wav"), "wb") as f:
                f.write(encode_wav(y, 16000))
            names.append(name)
            labels.append(spk)
    by = {s: [n for n, l in zip(names, labels) if l == s] for s in range(4)}
    with open(os.path.join(root, "clients.ndx"), "w") as f:
        for s in range(4):
            f.write(f"{by[s][0]} {by[s][1]}\n{by[s][2]} {by[s][3]}\n")
    with open(os.path.join(root, "impostors.ndx"), "w") as f:
        f.writelines(f"{by[a][0]} {by[b][0]}\n" for a in range(4) for b in range(4) if a != b)
    return wav_dir


def phase_score_trials_example(root):
    """The score CLI on ``example_model.npz`` over the example corpus, on the
    card and on the CPU: the two score files within TOL_SCORE_DEVICES, both
    within TOL_EMBED of the committed golden scores, EER 8.3334."""
    from doubleattentionspeakerverification_tpu_torch.cli import score_trials
    from doubleattentionspeakerverification_tpu_torch.data.manifest import load_trials

    work = os.path.join(root, "example")
    os.makedirs(work)
    wav_dir = example_corpus(work)
    ckpt = os.path.join(HERE, "examples", "pretrained", "example_model.npz")
    with open(os.path.join(HERE, "examples", "pretrained", "golden_scores.json")) as f:
        golden = json.load(f)
    golden = np.array(golden["clients"] + golden["impostors"])
    scores, eers, launches = {}, {}, {}
    for dev in (DEVICE, "cpu"):
        count_reset()
        err = run_cli(score_trials.main, [
            "--modelCheckpoint", ckpt, "--data_dir", wav_dir, "--data_source", "wav",
            "--clients", os.path.join(work, "clients.ndx"),
            "--impostors", os.path.join(work, "impostors.ndx"),
            "--output", os.path.join(work, f"{dev}.txt"), "--device", dev],
            f"[score_trials example] {dev}")
        launches[dev] = counts()
        rows = score_lines(os.path.join(work, f"{dev}.txt"))
        scores[dev] = np.array([float(r[2]) for r in rows])
        eers[dev] = summary_of(err)["eer"]
        check([r[4] for r in rows] == ["target"] * 8 + ["nontarget"] * 12,
              f"[score_trials example] {dev}: labels {[r[4] for r in rows]}")
    n_utts = len({u for name in ("clients.ndx", "impostors.ndx")
                  for pair in load_trials(os.path.join(work, name)) for u in pair})
    check(launches[DEVICE]["logmel"] == n_utts and launches[DEVICE]["mha_pool"] > 0
          and sum(launches["cpu"].values()) == 0,
          f"[score_trials example] launches {launches}: want logmel {n_utts}")
    d_dev = float(np.abs(scores[DEVICE] - scores["cpu"]).max())
    d_gold = max(float(np.abs(s - golden).max()) for s in scores.values())
    check(d_dev <= TOL_SCORE_DEVICES and d_gold <= TOL_EMBED
          and eers[DEVICE] == eers["cpu"] == "8.3334",
          f"[score_trials example] card vs CPU {d_dev:.3g}, vs golden {d_gold:.3g}, EER {eers}")
    print(f"[score_trials example] example_model.npz, 20 trials: card vs CPU scores max|d| "
          f"{d_dev:.3g} (tol {TOL_SCORE_DEVICES}); both vs golden_scores.json max|d| "
          f"{d_gold:.3g} (tol {TOL_EMBED}); EER {eers[DEVICE]} on both; card launches "
          f"{json.dumps(launches[DEVICE])} ({n_utts} utterances in trials), CPU none")
    return wav_dir


def phase_extract_features(root, smi):
    """``cli/extract_features.py`` over the 16 validation wavs on the card:
    B2 once a file; each pickle within TOL_LOGMEL of B2's plain version on
    the CPU."""
    import contextlib
    import io
    import pickle

    from doubleattentionspeakerverification_tpu_torch.cli import extract_features
    from doubleattentionspeakerverification_tpu_torch.config import FeatureConfig
    from doubleattentionspeakerverification_tpu_torch.data.wav import read_wav
    from doubleattentionspeakerverification_tpu_torch.dsp.features import make_device_logmel

    valid = os.path.join(root, "valid")
    paths = [os.path.join(valid, f"v{j}.wav") for j in range(TRAINER_VALID)]
    lst = os.path.join(root, "valid_files.lst")
    with open(lst, "w") as f:
        f.writelines(p + "\n" for p in paths)
    count_reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = extract_features.main(["-i", lst, "--device", DEVICE])
    wall = time.perf_counter() - t0
    launches = counts()
    check(rc == 0 and out.getvalue().split() == paths, f"[extract_features] exited {rc}")
    check(launches["logmel"] == len(paths) and launches["mha_pool"] == 0,
          f"[extract_features] launches {launches}: want logmel {len(paths)}")
    plain = make_device_logmel(FeatureConfig(), "cpu")
    worst, seconds = 0.0, 0.0
    for p in paths:
        wave, sr = read_wav(p)
        seconds += len(wave) / sr
        with open(p[:-4] + ".pickle", "rb") as f:
            got = pickle.load(f)
        want = plain(wave.astype(np.float32)).T
        check(got.shape == want.shape and got.shape[0] == 80, f"[extract_features] {p}: "
              f"shape {got.shape} vs {want.shape}")
        worst = max(worst, float(np.abs(got - want).max()))
    check(worst <= TOL_LOGMEL, f"[extract_features] pickles vs B2's plain version: {worst:.3g}")
    print(f"[extract_features] {len(paths)} wavs ({seconds:.1f} s of audio): launches "
          f"{json.dumps(launches)}; pickles (80, T) vs B2's plain version on the CPU max|d| "
          f"{worst:.3g} (tol {TOL_LOGMEL}); wall {wall:.3f} s (decode, B2, copy back, pickle) "
          f"= {len(paths) / wall:.1f} files/s, {seconds / wall:.1f} audio-seconds/s; on {smi}")


def phase_alignments(example_wavs):
    """``cli/alignments.py`` on the example checkpoint: the card's weights
    against the CPU's within TOL_ALIGN; each head's time weights, and the
    head weights, sum to 1."""
    from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel
    from doubleattentionspeakerverification_tpu_torch.cli import alignments

    ckpt = os.path.join(HERE, "examples", "pretrained", "example_model.npz")
    cpu = SpeakerEmbeddingModel.from_checkpoint(ckpt, device="cpu")
    worst, shapes = 0.0, []
    for name in ("spk0_utt0", "spk2_utt3", "spk3_utt4"):
        wav = os.path.join(example_wavs, name + ".wav")
        out = os.path.join(example_wavs, name + "_align.npz")
        count_reset()
        run_cli(alignments.main, ["--audioPath", wav, "--modelCheckpoint", ckpt,
                                  "--output", out, "--device", DEVICE], "[alignments]")
        check(counts()["logmel"] == 1, f"[alignments] launches {counts()}")
        want_t, want_h = alignments.alignments_for_wav(wav, cpu)
        with np.load(out) as z:
            got_t, got_h = z["time_alignment"], z["head_alignment"]
        check(got_t.shape == want_t.shape and got_h.shape == want_h.shape,
              f"[alignments] shapes {got_t.shape} {got_h.shape}")
        worst = max(worst, float(np.abs(got_t - want_t).max()), float(np.abs(got_h - want_h).max()))
        sums = np.concatenate([got_t.sum(axis=0) - 1.0, [got_h.sum() - 1.0]])
        check(float(np.abs(sums).max()) <= 1e-5, f"[alignments] weights do not sum to 1: {sums}")
        shapes.append(got_t.shape)
    check(worst <= TOL_ALIGN, f"[alignments] card vs CPU max|d| {worst:.3g}")
    print(f"[alignments] example_model.npz (DoubleMHA, 4 heads), 3 wavs: time weights "
          f"{shapes} and head weights (4,), card vs CPU max|d| {worst:.3g} (tol {TOL_ALIGN}); "
          f"each head's weights sum to 1")


def phase_export(root):
    """``cli/export_checkpoint.py`` on the ``[trainer]`` run's newest
    checkpoint: the ``.chkpt`` read back by ``utils/torch_import.py`` embeds
    on the card as the ``.npz`` does (TOL_EXPORT)."""
    import torch

    from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel
    from doubleattentionspeakerverification_tpu_torch.cli import export_checkpoint
    from doubleattentionspeakerverification_tpu_torch.utils.checkpoint import (
        latest_checkpoint, load_checkpoint,
    )
    from doubleattentionspeakerverification_tpu_torch.utils.torch_import import (
        load_torch_checkpoint,
    )

    npz = latest_checkpoint(os.path.join(root, "run"))
    out = os.path.join(root, "exported.chkpt")
    t0 = time.perf_counter()
    run_cli(export_checkpoint.main, ["--checkpoint", npz, "--out", out], "[export]")
    wall = time.perf_counter() - t0
    flat, meta = load_checkpoint(npz)
    state, cfg, epoch, step = load_torch_checkpoint(out)
    ckpt = torch.load(out, map_location="cpu", weights_only=False)
    check(step == int(flat["step"]) and cfg.model.num_spkrs == TRAINER_SPEAKERS
          and len(ckpt["optimizer"]["state"]) == 27,
          f"[export] step {step} vs {int(flat['step'])}, num_spkrs {cfg.model.num_spkrs}, "
          f"{len(ckpt['optimizer']['state'])} optimizer entries")
    models = {k: SpeakerEmbeddingModel.from_checkpoint(p, device=DEVICE)
              for k, p in (("npz", npz), ("chkpt", out))}
    rng = np.random.default_rng(9)
    waves = [seeded_speech(rng, s) for s in (2.0, 5.5, 9.0)]
    worst = max(float(np.abs(models["chkpt"].embed_wave(w) - models["npz"].embed_wave(w)).max())
                for w in waves)
    check(worst <= TOL_EXPORT, f"[export] .chkpt vs .npz embeddings on the card: {worst:.3g}")
    print(f"[export] {os.path.basename(npz)} (step {step}, epoch {epoch}) -> .chkpt "
          f"({os.path.getsize(out) / 2**20:.0f} MiB, {len(ckpt['model'])} tensors, Adam state "
          f"for {len(ckpt['optimizer']['state'])} parameters) in {wall:.2f} s; read back by "
          f"torch_import, embeddings of 3 waves on the card vs the .npz's max|d| {worst:.3g} "
          f"(tol {TOL_EXPORT})")


def phase_dispatch(cfg, smi):
    """The kernel dispatcher on the card: the paper config resolved from
    scratch (B2 and B1 behind their self-checks, whose launches are counted
    apart), a failing self-check raising, explicit False taking the plain
    versions with no launch, and the int8_static gate's verdict."""
    import torch

    from doubleattentionspeakerverification_tpu_torch import ops
    from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel
    from doubleattentionspeakerverification_tpu_torch.ops import logmel as logmel_ops
    from doubleattentionspeakerverification_tpu_torch.utils import kernel_auto

    kernel_auto._GATE_CACHE.clear()
    kernel_auto._DECISIONS.clear()
    before = {k.name: k.check_launches for k in ops.KERNELS}
    count_reset()
    r = kernel_auto.resolve_model_kernels(cfg.model, cfg.features, device=DEVICE)
    checked = {k.name: k.check_launches - before[k.name] for k in ops.KERNELS}
    check(r.use_pallas_dsp is True and r.use_pallas_pooling is True,
          f"[dispatch] auto resolved to {r.use_pallas_dsp}, {r.use_pallas_pooling}")
    check(not any(counts().values()), f"[dispatch] the self-checks moved the counts {counts()}")
    check(checked["logmel"] == 1 and checked["mha_pool"] == 1,
          f"[dispatch] self-check launches counted apart: {checked}")
    print(f"[dispatch] the paper config resolved on the card: {json.dumps(kernel_auto.decisions())}")
    for key, (diff, ms) in kernel_auto._GATE_CACHE.items():
        print(f"[dispatch] self-check {key[0]}: largest |kernel - plain| {diff:.3g}, {ms:.1f} ms "
              f"(launches counted apart: {json.dumps(checked)}; path counts still 0)")

    # a B2 off by 5e-4 fails its check: resolution raises, nothing falls back
    real = logmel_ops.log_mel_spectrogram_fused
    logmel_ops.log_mel_spectrogram_fused = (
        lambda w, c, use_kernel=True: real(w, c, use_kernel) + (5e-4 if use_kernel else 0.0))
    kernel_auto._GATE_CACHE.clear()
    try:
        kernel_auto.resolve_model_kernels(cfg.model, cfg.features, device=DEVICE)
        raised = "nothing"
    except RuntimeError as e:
        raised = str(e)
    finally:
        logmel_ops.log_mel_spectrogram_fused = real
    check(raised.startswith("kernel B2 (logmel) self-check FAILED"),
          f"[dispatch] a B2 off by 5e-4 raised {raised!r}")
    print(f"[dispatch] B2 made 5e-4 off: resolution raised RuntimeError({raised!r})")

    # explicit False: the plain versions, no launch, the same embedding
    plain = cfg.replace(model=dataclasses.replace(cfg.model, use_pallas_dsp=False,
                                                  use_pallas_pooling=False))
    wave = seeded_speech(np.random.default_rng(31), 4.0)
    runs = {}
    for name, c in (("default", cfg), ("plain", plain)):
        api = SpeakerEmbeddingModel.from_random_init(c, seed=0, device=DEVICE)
        count_reset()
        feats = api.features_of_wave(wave)
        emb = api.embed_features(feats)
        launched = counts()
        ctx = []
        hook = api.model.pooling.mha.register_forward_hook(lambda m, i, o: ctx.append(o))
        ref_feats = runs["default"][0] if runs else feats
        with torch.no_grad():
            api.model(ref_feats[None].to(DEVICE))
        hook.remove()
        runs[name] = (feats, emb, launched, ctx[0].cpu())
        del api
    (f_d, e_d, l_d, c_d), (f_p, e_p, l_p, c_p) = runs["default"], runs["plain"]
    check(l_d["mha_pool"] == 1 and l_d["logmel"] == 1, f"[dispatch] default path launches {l_d}")
    check(l_p["mha_pool"] == 0 and l_p["logmel"] == 0, f"[dispatch] plain path launches {l_p}")
    d_feat = float((f_d - f_p).abs().max())
    d_ctx = float((c_d - c_p).abs().max()) / float(c_p.abs().max())
    d_emb = float(np.abs(e_d - e_p).max())
    check(d_feat <= TOL_LOGMEL and d_ctx <= TOL_POOL and d_emb <= TOL_EMBED,
          f"[dispatch] explicit False vs default: log-mel {d_feat:.3g}, contexts {d_ctx:.3g}, "
          f"embedding {d_emb:.3g}")
    print(f"[dispatch] use_pallas_dsp=False, use_pallas_pooling=False on a 4 s upload: launches "
          f"{json.dumps(l_p)} (default {json.dumps(l_d)}); decisions "
          f"{json.dumps(kernel_auto.decisions())}; log-mel within {d_feat:.3g} (tol {TOL_LOGMEL}), "
          f"B1's contexts on the same features within {d_ctx:.3g} of their largest (tol "
          f"{TOL_POOL}), embedding within {d_emb:.3g} (tol {TOL_EMBED}) of the default path's")

    # the int8_static gate on its calibration upload
    kernel_auto._DECISIONS.pop("int8_pallas_conv", None)
    api = SpeakerEmbeddingModel.from_random_init(cfg, seed=0, device=DEVICE,
                                                 quantize="int8_static")
    state = api.calibrate_quantization(api.features_of_wave(seeded_speech(
        np.random.default_rng(32), 6.0)))
    verdict = kernel_auto.decisions().get("int8_pallas_conv", "")
    check(state == "static" and verdict.startswith("auto->True (B3 "),
          f"[dispatch] int8_static calibration {state}, gate {verdict!r}")
    print(f"[dispatch] int8_static gate on its 6 s calibration upload: {verdict}; on {smi}")


def profile_kernels(trace_path):
    """(total ms by kernel name, the kernels' busy ms and their span in ms)
    from a Chrome trace's device kernel events."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel" and "dur" in e]
    by_name = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    busy, end = 0.0, None
    for start, dur in sorted((e["ts"], e["dur"]) for e in events):
        stop = start + dur
        if end is None or start >= end:
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
            if events else 0.0)
    return by_name, busy / 1e3, span / 1e3


def phase_profile(root, smi):
    """``cli/train.py`` with ``--profile_dir`` (steps 2-3 of 4) and
    ``--tensorboard_dir`` on the [trainer] corpus: the trace holds B1's and
    B2's kernels, the scalars read back equal the JSONL losses; prints the
    window's kernels by total time."""
    from doubleattentionspeakerverification_tpu_torch.utils.tensorboard import read_scalars

    out, prof, tb = (os.path.join(root, d) for d in ("profile", "profile_trace", "profile_tb"))
    t0 = time.perf_counter()
    trainer_cli(trainer_argv(root, out, "--validate_every", "0", "--checkpoint_every", "0",
                             "--profile_dir", prof, "--profile_start_step",
                             str(PROFILE_WINDOW[0]), "--profile_steps", str(PROFILE_WINDOW[1]),
                             "--tensorboard_dir", tb), os.path.join(root, "console.log"))
    wall = time.perf_counter() - t0
    events = trainer_events(out)
    marks = [(e["event"], int(e["step"])) for e in events if e["event"].startswith("profile_")]
    stop = PROFILE_WINDOW[0] + PROFILE_WINDOW[1]
    check(marks == [("profile_started", PROFILE_WINDOW[0]), ("profile_stopped", stop)],
          f"[profile] profile events {marks}")
    (trace,) = [os.path.join(prof, f) for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    by_name, busy_ms, span_ms = profile_kernels(trace)
    for sym in ("mha_pool_kernel", "logmel_kernel"):
        check(any(sym in n for n in by_name), f"[profile] no {sym} in the trace's kernels")
    (tb_file,) = [os.path.join(tb, f) for f in os.listdir(tb) if f.startswith("events.out.")]
    scalars = {(step, tag): v for (_, step, tag, v) in read_scalars(tb_file)}
    train = [e for e in events if e["event"] == "train"]
    check(len(train) == 4 and all(scalars.get((int(e["step"]), "train/xent"))
                                  == np.float32(e["xent"]) for e in train),
          f"[profile] TensorBoard train/xent {sorted(scalars.items())[:8]} vs JSONL "
          f"{[e['xent'] for e in train]}")
    total = max(sum(by_name.values()), 1e-9)
    n = PROFILE_WINDOW[1]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"[profile] steps {PROFILE_WINDOW[0]}-{stop - 1} of the paper recipe traced "
          f"(torch.profiler, CUPTI): {len(by_name)} kernel names, {total:.1f} ms of kernel time "
          f"({total / n:.1f} ms a step), device busy {busy_ms:.1f} ms of the kernels' "
          f"{span_ms:.1f} ms span (idle share {1 - busy_ms / max(span_ms, 1e-9):.1%}); run wall "
          f"{wall:.1f} s; TensorBoard train/xent equal to the JSONL at steps 1-4; on {smi}")
    for name, ms in top:
        print(f"[profile]   {ms / n:9.3f} ms a step  {100 * ms / total:5.1f}%  {name[:150]}")
    split = {}
    for name, ms in by_name.items():
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)), "other")
        split[group] = split.get(group, 0.0) + ms
    print("[profile] split a step: " + "; ".join(
        f"{g} {split.get(g, 0.0) / n:.4f} ms ({100 * split.get(g, 0.0) / total:.2f}%)"
        for g in [g for g, _ in PROFILE_GROUPS] + ["other"]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import doubleattentionspeakerverification_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(os.path.join(HERE, PKG) + os.sep):
        print(f"chip_smoke: {PKG} must come from {HERE}, got {port.__file__}", file=sys.stderr)
        return 1
    from doubleattentionspeakerverification_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")    # float32 stays float32: TF32 off for convs and matmuls
    try:
        name, smi = phase_device()
        phase_build()
        logmel_stats = phase_logmel()
        pool_stats = phase_pool()
        pool_bwd_stats = phase_pool_backward()
        conv_stats = phase_conv_int8()
        rate_stats = phase_rate_probe()
        micro_stats = phase_conv_probe()
        phase_example_checkpoint()
        phase_example_int8()
        cfg = paper_config()
        launches, fp_embs, fp_ms = phase_serve(cfg)
        q_launches, q_embs, q_ms = phase_serve(cfg, "int8_static",
                                               expect=("conv_int8", "mha_pool", "logmel"))
        cos = cosines(fp_embs, q_embs)
        centred = cosines(fp_embs - fp_embs.mean(0), q_embs - q_embs.mean(0))
        print(f"[serve int8_static] cosine to the float32 server's embeddings of the same "
              f"{len(cos)} uploads: min {cos.min():.6f}, mean {cos.mean():.6f} "
              f"(bound {COSINE_GUARD}); max|d| {float(np.abs(fp_embs - q_embs).max()):.3g}; "
              f"centred on their mean (the input-dependent part): min {centred.min():.6f}, "
              f"mean {centred.mean():.6f}")
        check(cos.min() >= COSINE_GUARD, f"int8_static embeddings: min cosine {cos.min():.4f} "
              f"to the float32 server's < {COSINE_GUARD}")
        print(f"[forward] B=8 x 10 s: float32 {fp_ms:.3f} ms, int8_static {q_ms:.3f} ms "
              f"({fp_ms / q_ms:.2f}x) device time on {smi}")
        phase_dispatch(cfg, smi)
        train_launches = phase_train()
        root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
        try:
            phase_trainer(root, smi)
            phase_profile(root, smi)
            dist_launches = phase_distributed(root, smi)
            phase_score_trials(root, smi)
            example_wavs = phase_score_trials_example(root)
            phase_extract_features(root, smi)
            phase_alignments(example_wavs)
            phase_export(root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(f"[distributed] B1 and B2 launches a rank in one data-parallel step: "
              f"{json.dumps(dist_launches)}")
        print(f"[B1 backward] T'={POOL_MAIN}: " + json.dumps(dict(
            pool_bwd_stats, launches_per_train_step=train_launches["mha_pool"] // TRAIN_STEPS)))
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [
        dict(name="mha_pool", route="cuda", source=f"{PKG}/csrc/mha_pool.cu",
             replaces="doubleattentionspeakerverification_tpu/ops/pooling_pallas.py:35",
             launches=launches["mha_pool"], **pool_stats),
        dict(name="logmel", route="cuda", source=f"{PKG}/csrc/logmel.cu",
             replaces="doubleattentionspeakerverification_tpu/ops/logmel_pallas.py:32",
             launches=launches["logmel"], **logmel_stats),
        dict(name="conv_int8", route="cuda", source=f"{PKG}/csrc/conv_int8.cu",
             replaces="doubleattentionspeakerverification_tpu/ops/conv_int8_pallas.py:52",
             launches=q_launches["conv_int8"], **conv_stats),
        dict(name="mm_probe", route="cuda", source=f"{PKG}/csrc/mm_probe.cu",
             replaces="tools/_mxu_rate.py:20", **rate_stats),
        dict(name="conv_int8_probe", route="cuda", source=f"{PKG}/csrc/conv_int8.cu",
             replaces="tools/_pallas_micro.py:52", **micro_stats),
    ]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in order} for d in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
