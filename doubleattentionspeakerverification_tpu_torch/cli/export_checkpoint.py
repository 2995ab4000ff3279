"""Export a JAX-format ``.npz`` checkpoint (or a ``.dcp`` directory of the
port's multi-process trainer) as a reference torch ``.chkpt`` (JAX
``cli/export_checkpoint.py``).

The port reads the checkpoint (written by either package's trainer) into its
model and ``torch.optim`` optimizer (``utils/weights.py:load_train_state``)
and writes them in the reference's ``utils.py:23-40`` layout
(``utils/torch_export.py``), which its unmodified ``getEmbeddingExample.py``
and ``train.py --requeue`` load. Runs on the host; no card is needed:

  python -m doubleattentionspeakerverification_tpu_torch.cli.export_checkpoint \\
      --checkpoint models/run1/..._best_1234.npz --out model.chkpt
"""

from __future__ import annotations

import argparse
import sys

from ..api import empty_model
from ..config import ExperimentConfig
from ..training.optimizers import get_lr, make_optimizer
from ..utils import dist_ckpt
from ..utils.checkpoint import load_checkpoint
from ..utils.torch_export import save_torch_checkpoint
from ..utils.weights import load_train_state, optimizer_state_by_name


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert a framework checkpoint to a reference torch .chkpt."
    )
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="a JAX-format .npz checkpoint or a .dcp directory")
    parser.add_argument("--out", type=str, required=True, help="output .chkpt path")
    parser.add_argument("--no_optimizer", action="store_true",
                        help="skip moment export (a fresh, loadable optimizer "
                             "state_dict is still written: the reference's "
                             "requeue loads it unconditionally)")
    params = parser.parse_args(argv)
    if dist_ckpt.is_orbax(params.checkpoint):
        print(f"error: {dist_ckpt.ORBAX_REFUSAL.format(path=params.checkpoint)}", file=sys.stderr)
        return 2

    flat, meta = load_checkpoint(params.checkpoint)
    cfg = ExperimentConfig.from_dict(meta["config"])
    model = empty_model(cfg)
    optimizer = make_optimizer(cfg.train, model.parameters())
    step = load_train_state(flat, model, optimizer, cfg.train.optimizer)
    save_torch_checkpoint(
        params.out, model.state_dict(), cfg,
        opt_state=None if params.no_optimizer else optimizer_state_by_name(model, optimizer),
        lr=None if params.no_optimizer else get_lr(optimizer),
        epoch=int(meta.get("epoch", 0)), step=step,
    )
    print(f"wrote {params.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
