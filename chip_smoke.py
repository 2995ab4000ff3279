#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``csrc/``, holds each one
against its plain PyTorch version on the card and times it beside its
bound, checks the card's path against the CPU path on the committed example
checkpoint, then serves HTTP requests with a paper-width model (VGG4L,
kernel_size 1024, 32 heads, DoubleMHA, embedding 400; random weights from a
fixed seed) and shows from the kernels' launch counts that the serving path
went through both kernels. Any failed phase exits non-zero. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "doubleattentionspeakerverification_tpu_torch"
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet; full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

TOL_LOGMEL = 2e-4        # JAX holds Pallas against XLA to this (tests/test_pallas_logmel.py)
TOL_POOL = 1e-5
TOL_EMBED = 1e-4         # golden-embedding tolerance (tests/test_example_artifact.py)

LOGMEL_CASES = ((1, 2.0), (1, 10.0), (1, 60.0), (8, 10.0))   # (batch, seconds)
LOGMEL_MAIN = (1, 10.0)                                        # reported in the kernels line
POOL_T = (7, 32, 63, 250)        # T' of the 100/500/1000/4000-frame serving buckets
POOL_MAIN = 63
POOL_B, POOL_H, POOL_DH = 8, 32, 160
SERVE_SECONDS = (1.0, 2.5, 4.0, 4.5, 8.0, 8.5, 9.0, 12.0)


class PhaseError(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseError(msg)


def cuda_ms(fn, iters: int, replays: int = 10) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's work between launches is not counted
    (inputs stay in L2 where they fit, as after the producing kernel)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def call_ms(fn, iters: int) -> float:
    """Time of one eager ``fn`` call as a caller sees it, host work included."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    t0 = time.perf_counter()
    logs = build_all(ops.KERNELS)
    print(f"[build] {len(logs)} kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or ("spill" in line and "0 bytes spill" not in line):
                print(f"[build] {name}: {line.strip()}")


def phase_logmel():
    import torch

    from doubleattentionspeakerverification_tpu_torch.config import FeatureConfig
    from doubleattentionspeakerverification_tpu_torch.dsp.features import (
        dft_mel_constants, num_frames, preemphasize,
    )
    from doubleattentionspeakerverification_tpu_torch.dsp.mel import padded_stft_window
    from doubleattentionspeakerverification_tpu_torch.ops import logmel

    cfg = FeatureConfig()
    rng = np.random.default_rng(0)
    n_bins = cfg.n_fft // 2 + 1
    const_elems = 2 * cfg.n_fft * n_bins + n_bins * cfg.n_mels
    window = torch.from_numpy(padded_stft_window(cfg.win_length, cfg.n_fft)).to(DEVICE)
    mel_t = torch.from_numpy(dft_mel_constants(cfg)[2]).to(DEVICE)

    def library(w):
        spec = torch.stft(preemphasize(w, cfg), cfg.n_fft, cfg.hop_length, cfg.n_fft, window,
                          center=False, return_complex=True)
        return torch.log(torch.clamp(spec.abs().transpose(1, 2) @ mel_t, min=cfg.log_floor))

    worst, main = 0.0, None
    for b, seconds in LOGMEL_CASES:
        n = int(seconds * cfg.sample_rate)
        wave = torch.from_numpy(np.stack([seeded_speech(rng, seconds) for _ in range(b)])).to(DEVICE)
        got = logmel.log_mel_cuda(wave, cfg)
        ref = logmel.log_mel_plain(wave, cfg)
        lib = library(wave)
        torch.cuda.synchronize()
        t = num_frames(n, cfg)
        check(got.shape == ref.shape == (b, t, cfg.n_mels), f"B2 shape {tuple(got.shape)}")
        err = float((got - ref).abs().max())
        check(math.isfinite(err) and err <= TOL_LOGMEL,
              f"B2 disagrees with its plain version at B={b}, {seconds} s: {err:.3g}")
        worst = max(worst, err)
        iters = 20 if b * seconds <= 10 else 5
        ms = cuda_ms(lambda: logmel.log_mel_cuda(wave, cfg), iters)
        eager = call_ms(lambda: logmel.log_mel_cuda(wave, cfg), 50)
        plain_ms = cuda_ms(lambda: logmel.log_mel_plain(wave, cfg), iters)
        library_ms = cuda_ms(lambda: library(wave), iters)
        b_ms, b_by = bound((b * n + b * t * cfg.n_mels + const_elems) * 4,
                           2.0 * b * t * (cfg.n_fft * 2 * n_bins + n_bins * cfg.n_mels))
        print(f"[B2 logmel] B={b} {seconds:g} s T={t}: max|d|={err:.3g} (tol {TOL_LOGMEL}); "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}); eager call {eager:.4f} ms; stft+matmul max|d|="
              f"{float((lib - ref).abs().max()):.3g}")
        if (b, seconds) == LOGMEL_MAIN:
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    # front-ends of other upload rates and hops (hop 41 takes the scalar-load path)
    for other in (FeatureConfig(sample_rate=8000), FeatureConfig(window_stride_s=0.0026)):
        wave = torch.from_numpy(np.stack([seeded_speech(rng, 3.0, other.sample_rate)
                                          for _ in range(2)])).to(DEVICE)
        err = float((logmel.log_mel_cuda(wave, other) - logmel.log_mel_plain(wave, other)).abs().max())
        check(math.isfinite(err) and err <= TOL_LOGMEL,
              f"B2 disagrees with its plain version at {other}: {err:.3g}")
        worst = max(worst, err)
        print(f"[B2 logmel] B=2 3 s at {other.sample_rate} Hz, hop {other.hop_length}: "
              f"max|d|={err:.3g} (tol {TOL_LOGMEL})")
    return dict(max_abs_err=worst, **main)


def phase_pool():
    import torch
    import torch.nn.functional as F

    from doubleattentionspeakerverification_tpu_torch.ops import mha_pool

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
        got = mha_pool.mha_pool_cuda(ht4, q_t, lens)
        ref = mha_pool.mha_pool_plain(ht4, q_t, lens)
        # yardstick: SDPA with one query per head and the length mask
        q4 = q_t[None, :, None, :].expand(POOL_B, -1, -1, -1).contiguous()
        kv = ht4.permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(tp, device=DEVICE)[None, :] < lens[:, None])[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(q4, kv, kv, attn_mask=mask, scale=1.0)

        lib = library()[:, :, 0]
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        check(math.isfinite(err) and err <= TOL_POOL,
              f"B1 disagrees with its plain version at T'={tp}: {err:.3g}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: mha_pool.mha_pool_cuda(ht4, q_t, lens), 50)
        eager = call_ms(lambda: mha_pool.mha_pool_cuda(ht4, q_t, lens), 100)
        plain_ms = cuda_ms(lambda: mha_pool.mha_pool_plain(ht4, q_t, lens), 20)
        library_ms = cuda_ms(library, 20)
        valid = int(np.minimum(lens_np, tp).sum())
        b_ms, b_by = bound(
            (valid * POOL_H * POOL_DH + q_t.numel() + POOL_B + POOL_B * POOL_H * POOL_DH) * 4,
            4.0 * valid * POOL_H * POOL_DH)
        print(f"[B1 mha_pool] B={POOL_B} T'={tp} H={POOL_H} d_h={POOL_DH} lengths={lens_np.tolist()}: "
              f"max|d|={err:.3g} (tol {TOL_POOL}); kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={b_ms:.5f} ({b_by}); "
              f"eager call {eager:.4f} ms; sdpa max|d|={float((lib - ref).abs().max()):.3g}")
        if tp == POOL_MAIN:
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    return dict(max_abs_err=worst, **main)


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


def paper_config():
    from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig()
    m = cfg.model
    check((m.front_end, m.kernel_size, m.heads_number, m.pooling_method, m.embedding_size)
          == ("VGG4L", 1024, 32, "DoubleMHA", 400), f"not the paper configuration: {m}")
    return cfg


def phase_serve(cfg):
    """The main path: an HTTP server of ``cfg``'s width answering requests."""
    import torch

    from doubleattentionspeakerverification_tpu_torch import ops
    from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel
    from doubleattentionspeakerverification_tpu_torch.data.wav import encode_wav
    from doubleattentionspeakerverification_tpu_torch.serving import make_server

    m = cfg.model
    model = SpeakerEmbeddingModel.from_random_init(cfg, seed=0, device=DEVICE)
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

    for i, (s, r) in enumerate(zip(SERVE_SECONDS, results)):
        check(r is not None, f"/embed request {i} did not complete")
        emb = np.asarray(r[0]["embedding"])
        check(emb.shape == (m.embedding_size,) and np.all(np.isfinite(emb)),
              f"/embed {i}: embedding not finite or of size {emb.shape}")
        print(f"[serve] /embed {s:g} s audio ({r[0]['frames']} frames): {r[1]:.1f} ms")
    check(enroll["enrollments"] == 1, f"/enroll: {enroll}")
    check(verify["score"] >= 0.99 and verify["decision"], f"/verify of the same audio: {verify}")
    check(ident["speakers"][0]["speaker"] == "spk0", f"/identify: {ident}")
    print(f"[serve] /enroll {t_enroll:.1f} ms, /verify {t_verify:.1f} ms "
          f"(score {verify['score']:.6f}), /identify {t_ident:.1f} ms")
    print(f"[serve] health: requests={health['requests']} forwards={health['forwards']} "
          f"batched={health['batched']} errors={health['errors']}; "
          f"peak torch.cuda.max_memory_allocated = {peak_mib:.1f} MiB")
    print(f"[serve] kernel launches on the serving path: {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched on the serving path")
    return launches


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
        name, _ = phase_device()
        phase_build()
        logmel_stats = phase_logmel()
        pool_stats = phase_pool()
        phase_example_checkpoint()
        launches = phase_serve(paper_config())
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
    ]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in order} for d in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
