"""Attention-alignment CLI (JAX ``cli/alignments.py``).

Prints, or saves as ``.npz``, the pooling's time weights of one audio file,
and for DoubleMHA also its head weights (reference ``getAlignments``,
``poolings.py:95-101,119-123``), under a JAX package ``.npz`` or a reference
``.chkpt`` checkpoint. On the card (the default) the log-mel is kernel B2;
the weights come from the pooling's plain masked softmax on either device:

  python -m doubleattentionspeakerverification_tpu_torch.cli.alignments \\
      --audioPath a.wav --modelCheckpoint m.npz [--output a.npz] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..api import SpeakerEmbeddingModel
from ..config import FeatureConfig
from ..data.wav import read_wav
from ..dsp.features import extract_normalized
from ..models.classifier import get_alignments


def alignments_for_wav(audio_path: str, model: SpeakerEmbeddingModel, normalization: str = "cmn"):
    """Returns (time_alignment, head_alignment | None).

    time_alignment: (T', H) softmax weights over encoder frames ((T',) for
    single-head 'Attention' pooling); head_alignment: (H,) weights over
    heads (DoubleMHA only). A wav at another rate than the model's gets the
    default front-end at its own rate, as in the JAX package."""
    wave, sr = read_wav(audio_path)
    cfg = model.cfg
    feat_cfg = cfg.features if sr == cfg.features.sample_rate else FeatureConfig(sample_rate=sr)
    with torch.no_grad():
        w = torch.from_numpy(wave.astype(np.float32)).to(model.device)
        feats = extract_normalized(w, feat_cfg, normalization)
        out = get_alignments(model.model, feats[None], None)
    if isinstance(out, tuple):
        time_w, head_w = out
        return time_w[0].cpu().numpy(), head_w[0].cpu().numpy()
    return out[0].cpu().numpy(), None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Print the pooling attention alignments of one audio file."
    )
    parser.add_argument("--audioPath", type=str, required=True)
    parser.add_argument("--modelCheckpoint", type=str, required=True,
                        help="a JAX package .npz or a reference torch .chkpt checkpoint")
    parser.add_argument("--normalization", type=str, default="cmn", choices=["cmn", "cmvn"])
    parser.add_argument("--output", type=str, default="",
                        help="write alignments to this .npz instead of printing "
                             "(keys: time_alignment, head_alignment)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    params = parser.parse_args(argv)

    model = SpeakerEmbeddingModel.from_checkpoint(params.modelCheckpoint, device=params.device)
    time_w, head_w = alignments_for_wav(params.audioPath, model, params.normalization)
    if params.output:
        payload = {"time_alignment": time_w}
        if head_w is not None:
            payload["head_alignment"] = head_w
        np.savez(params.output, **payload)
        print(f"wrote {params.output}: time_alignment {time_w.shape}"
              + (f", head_alignment {head_w.shape}" if head_w is not None else ""))
        return 0
    np.set_printoptions(precision=6, suppress=True)
    print("time_alignment", time_w.shape)
    print(time_w)
    if head_w is not None:
        print("head_alignment", head_w.shape)
        print(head_w)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
