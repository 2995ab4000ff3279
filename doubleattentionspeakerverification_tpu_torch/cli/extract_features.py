"""Feature-extraction CLI (JAX ``cli/extract_features.py``, reference
``featureExtractor.py:35-51``).

Reads a list of wav paths and writes ``<base>.pickle`` files holding the raw
(80, T) log-mel matrix, the on-disk format the reference training pipeline
reads (normalization happens at load time, ``data.py:21-30``). The log-mel
is kernel B2 on the card (one launch a file), its plain version with
``--device cpu``, or with ``--host_dsp`` the repo's native C++ kernel on the
host:

  python -m doubleattentionspeakerverification_tpu_torch.cli.extract_features \\
      -i wavs.txt [--device cpu | --host_dsp]

``--use_pallas_dsp`` / ``--no-use_pallas_dsp`` choose B2 or its plain
version on the card; without either, the kernel dispatcher runs B2 behind
its self-check (``utils/kernel_auto.py``; the JAX flag's store-true form is
kept, and its default is auto rather than the XLA path). The log-mel is
``center=False``, so a file's features do not depend on any padding after
its last sample: ``--bucket_seconds`` (the JAX package's padding grid, one
XLA compilation per bucket) is accepted and has no effect here. A path
ending in ``.wav`` loses that extension for the pickle's name; any other
keeps its whole name.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from ..config import FeatureConfig
from ..data.wav import read_wav
from ..dsp.features import make_device_logmel


def extract_file(audio_path: str, cfg: FeatureConfig, extractor) -> np.ndarray:
    """wav -> raw (n_mels, T) log-mel, the reference ``mfsc`` layout.

    ``extractor`` maps a wave (N,) float32 to (T, n_mels), as
    ``dsp/features.py:make_device_logmel`` builds it, or ``utils/native.py``'s
    host kernel."""
    wave, sr = read_wav(audio_path)
    if sr != cfg.sample_rate:
        raise ValueError(f"{audio_path}: sample rate {sr} != {cfg.sample_rate}")
    return extractor(wave.astype(np.float32)).T  # (T, 80) -> (80, T) on-disk layout


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Extract log-mel features from a list of wav files."
    )
    parser.add_argument("--audioFilesList", "-i", type=str, required=True,
                        help="text file with one wav path per line")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--bucket_seconds", type=float, default=2.0,
                        help="accepted for the JAX package's command lines; no "
                             "effect (nothing is compiled per length here)")
    parser.add_argument("--use_pallas_dsp", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="on the card: kernel B2 (--use_pallas_dsp), its plain "
                             "version (--no-use_pallas_dsp), or by default B2 behind "
                             "a one-time self-check")
    parser.add_argument("--host_dsp", action="store_true",
                        help="native C++ log-mel kernel on the host: no card "
                             "needed (raises if the library cannot be built)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="where the log-mel runs without --host_dsp")
    params = parser.parse_args(argv)

    cfg = FeatureConfig(sample_rate=params.sample_rate)
    if params.host_dsp:
        from ..utils.native import NativeLogmel

        extractor = NativeLogmel(cfg).compute
    else:
        from ..utils.device import resolve_device
        from ..utils.kernel_auto import resolve_dsp

        device = resolve_device(params.device)
        extractor = make_device_logmel(cfg, device,
                                       resolve_dsp(params.use_pallas_dsp, cfg, device=device))
    with open(params.audioFilesList, "r") as files:
        for line in files:
            path = line.strip()
            if not path:
                continue
            print(path)
            feats = extract_file(path, cfg, extractor)
            base = path[:-4] if path.endswith(".wav") else path
            with open(f"{base}.pickle", "wb") as handle:
                pickle.dump(feats, handle)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
