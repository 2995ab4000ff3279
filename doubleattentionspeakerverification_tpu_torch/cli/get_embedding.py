"""Embedding-inference CLI (reference ``scripts/getEmbeddingExample.py``).

Loads a checkpoint, the JAX package's ``.npz`` or a reference torch
``.chkpt`` (read by ``utils/torch_import.py``), extracts normalized log-mel
features from a wav and prints the scoring embedding, on the GPU unless
``--device cpu``:

  python -m doubleattentionspeakerverification_tpu_torch.cli.get_embedding \\
      --audioPath a.wav --modelCheckpoint models/run1/..._best_1234.npz

The checkpoint's embedded config wins, and normalization is CMN unless
overridden, as in the reference. Its kernel flags are resolved for the
device by ``api.py`` (``utils/kernel_auto.py``).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..api import QUANTIZE_MODES, SpeakerEmbeddingModel


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Print the speaker embedding of one audio file.")
    parser.add_argument("--audioPath", type=str, required=True)
    parser.add_argument("--modelCheckpoint", type=str, required=True,
                        help="a JAX package .npz or a reference torch .chkpt checkpoint")
    parser.add_argument("--normalization", type=str, default="cmn", choices=["cmn", "cmvn"])
    parser.add_argument("--quantize", type=str, default="none", choices=list(QUANTIZE_MODES),
                        help="int8 conv encoder (the serving schemes; embeddings "
                             "cosine-match fp to ~1e-3, so prefer fp for parity checks)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    params = parser.parse_args(argv)

    model = SpeakerEmbeddingModel.from_checkpoint(
        params.modelCheckpoint, params.normalization, device=params.device,
        quantize=params.quantize)
    emb = model.embed_wav(params.audioPath)
    np.set_printoptions(precision=6, suppress=False)
    print(emb)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
