"""The one traffic generator: every input of a run is made here from the
parameters of a traffic file and the run's seed, with numpy and the standard
library alone (the load generator's process imports nothing else).

- Audio: voiced, speech-like 16 kHz PCM16 (a harmonic tone at a random
  pitch under a syllable-rate envelope, plus noise), one stream a
  (seed, item) key, so any item can be made again without the others.
- The training corpus: ``classes`` speakers with ``utterances_per_class``
  utterances of ``min_s``..``max_s`` seconds from a fixed corpus seed,
  written once under the benchmark's cache with a manifest: as WAV files,
  or (``"format": "features"``) as the reference pipeline's pickles of raw
  (80, T) float32 log-mel, made from the same audio by a given front end.
- Serving: a pool of uploads whose lengths are the same quantiles of a
  shifted log-normal in every run (only their order follows the seed), and
  an open-loop schedule of Poisson arrivals whose gaps are the same
  quantiles of the exponential in every run, in an order drawn from the
  seed; each request names a pool item and an enrolled speaker.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import pickle
import shutil
import struct
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

SAMPLE_RATE = 16000


# ------------------------------------------------------------------ audio
def synth(seed: Tuple[int, ...], n: int) -> np.ndarray:
    """``n`` samples of PCM16 for the stream ``seed``."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(85.0, 255.0)
    period = max(2, int(round(SAMPLE_RATE / f0)))
    phase = 2.0 * np.pi * np.arange(period) / period
    amps = rng.uniform(0.2, 1.0, 8) / np.arange(1, 9)
    cycle = sum(a * np.sin((h + 1) * phase + rng.uniform(0, 2 * np.pi))
                for h, a in enumerate(amps)).astype(np.float32)
    tone = np.resize(cycle, n)
    env = np.repeat(rng.uniform(0.05, 1.0, n // 160 + 1).astype(np.float32), 160)[:n]
    x = env * tone + 0.03 * rng.standard_normal(n, dtype=np.float32)
    x *= 0.45 / max(1e-6, float(np.abs(x).max()))
    return np.round(x * 32767.0).astype(np.int16)


def wav_bytes(pcm: np.ndarray) -> bytes:
    """Mono PCM16 RIFF/WAVE at 16 kHz."""
    data = pcm.astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, SAMPLE_RATE, SAMPLE_RATE * 2, 2, 16)
    return hdr + b"data" + struct.pack("<I", len(data)) + data


def read_pcm(path: str) -> np.ndarray:
    """The samples of a file :func:`wav_bytes` wrote."""
    with open(path, "rb") as f:
        return np.frombuffer(f.read()[44:], "<i2")


def read_features(path: str) -> np.ndarray:
    """The raw (80, T) log-mel of a features corpus file."""
    with open(path, "rb") as f:
        return pickle.load(f)


# ----------------------------------------------------------------- corpus
def corpus_files(spec: Dict, classes: int) -> List[Tuple[str, int, int]]:
    """(name, label, samples) of every utterance."""
    rng = np.random.default_rng(spec["seed"])
    per = spec["utterances_per_class"]
    secs = rng.uniform(spec["min_s"], spec["max_s"], classes * per)
    return [(f"s{c:05d}_u{j}", c, int(secs[c * per + j] * SAMPLE_RATE))
            for c in range(classes) for j in range(per)]


def ensure_corpus(cache_root: str, spec: Dict, classes: int, featurize=None) -> Tuple[str, str]:
    """The corpus directory and its manifest, written on the first call in
    a checkout (the directory is named by the corpus's parameters, and a
    ``READY`` file marks it complete). A features corpus needs
    ``featurize(pcm) -> (T, 80) float32`` raw log-mel."""
    key = hashlib.sha1(json.dumps({**spec, "classes": classes}, sort_keys=True).encode())
    root = os.path.join(cache_root, f"corpus-{key.hexdigest()[:12]}")
    manifest = os.path.join(root, "train.ndx")
    if os.path.exists(os.path.join(root, "READY")):
        return root, manifest
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    lines = []
    for name, label, n in corpus_files(spec, classes):
        pcm = synth((spec["seed"], label, n), n)
        features = spec.get("format") == "features"
        with open(os.path.join(root, name + (".pickle" if features else ".wav")), "wb") as f:
            if features:
                pickle.dump(np.ascontiguousarray(featurize(pcm).T), f, protocol=4)
            else:
                f.write(wav_bytes(pcm))
            # written back now, in set-up, not during a later run's window
            f.flush()
            os.fsync(f.fileno())
        lines.append(f"{name} {label}\n")
    with open(manifest, "w") as f:
        f.writelines(lines)
    with open(os.path.join(root, "READY"), "w") as f:
        f.write("ok\n")
    return root, manifest


# ---------------------------------------------------------------- serving
def pool_seconds(spec: Dict) -> np.ndarray:
    """The pool's upload lengths: quantiles of min_s + LogNormal(mu, sigma),
    mu and sigma set by the median and mean of ``spec["lengths"]``, capped
    at max_s."""
    ln = spec["lengths"]
    shift = ln["min_s"]
    mu = math.log(ln["median_s"] - shift)
    sigma = math.sqrt(2.0 * math.log((ln["mean_s"] - shift) / (ln["median_s"] - shift)))
    n = spec["pool_size"]
    z = [NormalDist().inv_cdf((k + 0.5) / n) for k in range(n)]
    return np.minimum(shift + np.exp(mu + sigma * np.asarray(z)), ln["max_s"])


def pool_items(spec: Dict, seed: int) -> List[int]:
    """The sample count of each pool item: the fixed lengths in the
    seed's order."""
    secs = pool_seconds(spec)
    order = np.random.default_rng((seed, 1)).permutation(len(secs))
    return [int(secs[i] * SAMPLE_RATE) for i in order]


def upload(seed: int, item: int, samples: int) -> np.ndarray:
    return synth((seed, 2, item), samples)


def enrollments(spec: Dict) -> List[Tuple[str, int]]:
    """(speaker, pool item) of every enrollment upload: speaker s enrolls
    items ``s * k .. s * k + k - 1``."""
    k = spec["enroll_per_speaker"]
    return [(f"spk{s:04d}", s * k + j) for s in range(spec["speakers"]) for j in range(k)]


def schedule(spec: Dict, seed: int, seconds: float) -> List[Tuple[float, int, str]]:
    """(due second, pool item, claimed speaker) of every request of the
    window: ``rate_per_s * seconds`` arrivals whose gaps are quantiles of the
    exponential at that rate, in the seed's order; items cycle through the
    pool in the seed's orders, speakers are drawn uniformly."""
    rate = spec["rate_per_s"]
    n = max(1, int(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    order = np.random.default_rng((seed, 5)).permutation(n)
    due = np.cumsum(gaps[order]) - gaps.min()
    rng = np.random.default_rng((seed, 3))
    pool = spec["pool_size"]
    items = np.concatenate([rng.permutation(pool) for _ in range(-(-n // pool))])[:n]
    speakers = rng.integers(0, spec["speakers"], n)
    return [(float(d), int(i), f"spk{s:04d}") for d, i, s in zip(due, items, speakers)]
