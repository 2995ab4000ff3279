"""Train a PLDA backend on labeled embeddings (JAX ``cli/train_plda.py``).

Pairs with the embedding store written by ``score_trials
--save_embeddings`` (or any ``evaluation.embeddings.save_embeddings`` npz):

  # 1. embed the PLDA training set (plda_utts.ndx pairs its utterances)
  python -m doubleattentionspeakerverification_tpu_torch.cli.score_trials \\
      --modelCheckpoint m.npz --data_dir feats/ --trials plda_utts.ndx \\
      --save_embeddings plda_embs.npz --output /dev/null
  # 2. fit (host numpy; no device)
  python -m doubleattentionspeakerverification_tpu_torch.cli.train_plda \\
      --embeddings plda_embs.npz --labels labels.ndx --output plda.npz
  # 3. score with it
  python -m doubleattentionspeakerverification_tpu_torch.cli.score_trials ... --plda plda.npz

``--labels`` uses the reference train-manifest format (``path label -1``,
``scripts/data.py:34-38``); rows whose path is missing from the embedding
store are skipped (reported on stderr).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..data.manifest import load_train_manifest
from ..evaluation.embeddings import load_embeddings
from ..evaluation.plda import PLDA


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Fit a two-covariance PLDA backend.")
    p.add_argument("--embeddings", type=str, required=True,
                   help="embedding store (.npz from --save_embeddings)")
    p.add_argument("--labels", type=str, required=True,
                   help="train manifest: 'utt_id label -1' per line")
    p.add_argument("--output", type=str, required=True, help="PLDA model .npz")
    p.add_argument("--n_iters", type=int, default=10, help="EM iterations")
    p.add_argument("--no_length_norm", action="store_true",
                   help="skip L2 length normalization (on by default)")
    args = p.parse_args(argv)

    store = load_embeddings(args.embeddings)
    manifest = load_train_manifest(args.labels)
    rows, labels, missing = [], [], 0
    for utt in manifest:
        emb = store.get(utt.path)
        if emb is None:
            missing += 1
            continue
        rows.append(emb)
        labels.append(utt.label)
    if missing:
        print(f"train_plda: {missing}/{len(manifest)} manifest rows missing "
              f"from the embedding store; skipped", file=sys.stderr)
    if not rows:
        p.error("no manifest rows found in the embedding store")

    plda = PLDA.fit(
        np.stack(rows), labels, n_iters=args.n_iters,
        length_norm=not args.no_length_norm,
    )
    plda.save(args.output)
    print(
        f"plda_trained embeddings={len(rows)} speakers={len(set(labels))} "
        f"dim={rows[0].shape[0]} iters={args.n_iters} -> {args.output}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
