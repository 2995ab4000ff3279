"""Batch trial-scoring CLI (JAX ``cli/score_trials.py``).

The standalone form of the reference's validation (``train.py:117-149``):
each unique utterance is embedded once, in length-bucketed batches
(``evaluation/embeddings.py``), then one ``utt1 utt2 score`` line is written
per trial, with an EER/minDCF summary on stderr when client and impostor
lists are given. Scores are raw cosines, AS-Norm/S-norm scores against a
cohort (``--cohort`` id list and/or ``--cohort_embeddings`` store,
``--snorm_topk``; ``evaluation/snorm.py``), or PLDA log-likelihood ratios
(``--plda``, a model from ``train_plda``; ``evaluation/plda.py``). On the
card (the default) a wav's log-mel is kernel B2, every forward pools in
kernel B1, and ``--quantize int8_static`` runs kernel B3 in each of the
encoder's int8 convolutions; ``--device cpu`` runs their plain versions.

  python -m doubleattentionspeakerverification_tpu_torch.cli.score_trials \\
      --modelCheckpoint run1/..._best.npz --data_dir feats/ \\
      --trials trials.ndx --output scores.txt
  # or labeled:
  ... --clients clients.ndx --impostors impostors.ndx

The checkpoint is the JAX package's ``.npz`` (written by either package), a
``.dcp`` directory of the port's multi-process trainer, or a reference
``.chkpt``; a JAX ``.orbax`` directory exits 2 with the way to convert it.
Embedding stores and PLDA files are the JAX package's formats, so either
package reads the other's.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..api import QUANTIZE_MODES, SpeakerEmbeddingModel
from ..data.manifest import load_trials
from ..evaluation.embeddings import (
    EmbeddingExtractor,
    load_embeddings,
    pickle_feature_loader,
    save_embeddings,
    score_trials,
    validate_eer,
    wav_feature_loader,
)
from ..evaluation.eer import eer_exact, min_dcf
from ..evaluation.plda import PLDA
from ..evaluation.snorm import asnorm_trial_scores
from ..utils import dist_ckpt


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Score speaker-verification trials.")
    p.add_argument("--modelCheckpoint", type=str, required=True,
                   help="a JAX package .npz or a reference torch .chkpt checkpoint")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--trials", type=str, default=None,
                   help="unlabeled trial list (utt1 utt2 per line)")
    p.add_argument("--clients", type=str, default=None)
    p.add_argument("--impostors", type=str, default=None)
    p.add_argument("--output", type=str, default="-",
                   help="scores file ('-' = stdout)")
    p.add_argument("--data_source", type=str, default="features",
                   choices=["features", "wav"])
    p.add_argument("--normalization", type=str, default="cmn",
                   choices=["cmn", "cmvn"])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--long_audio", type=str, default="chunk",
                   choices=["chunk", "pad"],
                   help="beyond ~2x the largest length bucket (160 s): "
                        "'chunk' (default) embeds largest-bucket chunks and "
                        "duration-weights their unit-embedding centroid, so "
                        "batch memory stays bounded for hour-long audio; 'pad' "
                        "keeps the reference's full-length semantics (one "
                        "padded row of the whole utterance)")
    p.add_argument("--long_audio_max_frames", type=int, default=None,
                   help="override the chunking cap in frames "
                        "(default 2x the largest bucket = 16000 = 160 s)")
    p.add_argument("--quantize", type=str, default="none", choices=list(QUANTIZE_MODES),
                   help="'int8': int8 conv encoder with dynamic activation "
                        "scales; 'int8_static': scales calibrated on the first "
                        "batch and baked in (kernel B3 in every int8 conv on "
                        "the card). Scores cosine-match fp to ~1e-3: prefer fp "
                        "when reporting parity EERs")
    p.add_argument("--calibration_wav", type=str, default=None,
                   help="int8_static only: calibrate the baked scales on this "
                        "wav file (path, not an utt id) before scoring "
                        "instead of on the first scoring batch")
    p.add_argument("--int8_scales", type=str, default=None,
                   help="int8_static only: persist/load baked scales at this "
                        ".npz (loaded if present, so runs are deterministic; "
                        "else written after calibration)")
    p.add_argument("--save_embeddings", type=str, default=None,
                   help="write every embedding computed during scoring to "
                        "this .npz (embedding store; reusable across runs)")
    p.add_argument("--load_embeddings", type=str, default=None,
                   help="seed the embedding cache from a previous "
                        "--save_embeddings store; only utterances missing "
                        "from it are run through the model")
    p.add_argument("--cohort", type=str, default=None,
                   help="AS-Norm cohort: file listing cohort utterance ids "
                        "(one per line, embedded from --data_dir). Scores "
                        "are adaptively normalized against cohort statistics")
    p.add_argument("--cohort_embeddings", type=str, default=None,
                   help="AS-Norm cohort as a precomputed embedding store "
                        "(.npz from --save_embeddings)")
    p.add_argument("--snorm_topk", type=int, default=0,
                   help="AS-Norm top-K cohort neighbours per utterance "
                        "(0 = full cohort, i.e. plain S-norm)")
    p.add_argument("--plda", type=str, default=None,
                   help="score with a PLDA backend (.npz from train_plda) "
                        "instead of AS-Norm; LLR scores replace the cosine "
                        "column (raw cosine kept as raw=)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.plda and (args.cohort or args.cohort_embeddings):
        p.error("--plda and --cohort/--cohort_embeddings are exclusive "
                "(PLDA LLRs are already calibrated against the model; "
                "normalize one backend at a time)")
    if (args.clients is None) != (args.impostors is None):
        p.error("--clients and --impostors must be given together")
    if args.trials is None and args.clients is None:
        p.error("give --trials, or --clients/--impostors")
    if args.quantize != "int8_static" and (args.calibration_wav or args.int8_scales):
        p.error("--calibration_wav/--int8_scales require --quantize int8_static")
    if dist_ckpt.is_orbax(args.modelCheckpoint):
        print(f"error: {dist_ckpt.ORBAX_REFUSAL.format(path=args.modelCheckpoint)}", file=sys.stderr)
        return 2

    model = SpeakerEmbeddingModel.from_checkpoint(
        args.modelCheckpoint, args.normalization, device=args.device,
        quantize=args.quantize, quantize_scales_path=args.int8_scales)
    cfg = model.cfg
    if args.data_source == "wav":
        loader = wav_feature_loader(args.data_dir, cfg.features, args.normalization,
                                    device=args.device)
    else:
        loader = pickle_feature_loader(args.data_dir, args.normalization)
    if args.calibration_wav and model.quantize_calibration_state() != "static":
        state = model.calibrate_quantization_wav(args.calibration_wav)
        print(f"int8_static calibration: {state}", file=sys.stderr)
    extractor = EmbeddingExtractor(
        model.model, loader, batch_size=args.batch_size,
        embed_fn=None if args.quantize == "none" else model.embed_fn,
        long_audio=args.long_audio, max_frames=args.long_audio_max_frames,
    )
    if args.load_embeddings:
        extractor.cache.update(load_embeddings(args.load_embeddings,
                                               expect_quantize=args.quantize))

    # AS-Norm cohort: rows from a store and/or an id list embedded through
    # the same extractor (shared cache and batching with the trials)
    cohort = None
    if args.cohort or args.cohort_embeddings:
        rows = []
        if args.cohort_embeddings:
            rows.extend(load_embeddings(args.cohort_embeddings,
                                        expect_quantize=args.quantize).values())
        if args.cohort:
            with open(args.cohort) as f:
                ids = [ln.strip().split()[0] for ln in f if ln.strip()]
            cache = extractor.extract(ids)
            rows.extend(cache[u] for u in ids)
        cohort = np.stack(rows)
    plda = PLDA.load(args.plda) if args.plda else None

    def trial_scores(trials):
        """Raw cosines, and the AS-Norm or PLDA scores when a cohort or a
        PLDA model is given (both unbounded: the reference's -1..1 grid EER
        applies to the raw column only)."""
        raw = score_trials(extractor, trials)
        if plda is not None:
            return raw, plda.score_trials(trials, extractor.cache)
        if cohort is None:
            return raw, None
        return raw, asnorm_trial_scores(trials, extractor.cache, cohort, args.snorm_topk)

    def write(trials, raw, normed, label=""):
        for i, (a, b) in enumerate(trials):
            cols = [a, b, f"{(raw if normed is None else normed)[i]:.6f}"]
            if normed is not None:
                cols.append(f"raw={raw[i]:.6f}")
            if label:
                cols.append(label)
            out.write(" ".join(cols) + "\n")

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        summary = {}
        if args.trials:
            trials = load_trials(args.trials)
            raw, normed = trial_scores(trials)
            write(trials, raw, normed)
            summary["n_trials"] = len(trials)
        if args.clients and args.impostors:
            cl_trials = load_trials(args.clients)
            im_trials = load_trials(args.impostors)
            cl_raw, cl_n = trial_scores(cl_trials)
            im_raw, im_n = trial_scores(im_trials)
            write(cl_trials, cl_raw, cl_n, "target")
            write(im_trials, im_raw, im_n, "nontarget")
            # training validation's metrics (the embeddings are cached, so
            # this recomputes only the cosines)
            summary.update(validate_eer(extractor, cl_trials, im_trials))
            summary.update(n_clients=len(cl_trials), n_impostors=len(im_trials))
            if cl_n is not None:
                backend = "plda" if plda is not None else "snorm"
                summary.update({
                    f"eer_exact_{backend}": eer_exact(cl_n, im_n),
                    f"min_dcf_{backend}": min_dcf(cl_n, im_n),
                })
                if cohort is not None:
                    summary.update(cohort_size=len(cohort), snorm_topk=args.snorm_topk)
        if args.save_embeddings:
            save_embeddings(args.save_embeddings, extractor.cache, quantize=args.quantize)
            summary["embeddings_saved"] = len(extractor.cache)
        print(" ".join(f"{k}={v}" for k, v in summary.items()), file=sys.stderr)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
