"""Checkpoint backend conversion: ``.npz`` <-> ``.dcp`` (JAX
``cli/convert_checkpoint.py``, whose other backend is ``.orbax``).

A run moves between one process (the ``.npz`` backend, a file either
package reads) and several (the sharded ``.dcp`` directories of
``utils/dist_ckpt.py``, which more than one process requires):

  python -m doubleattentionspeakerverification_tpu_torch.cli.convert_checkpoint \\
      --input run1/model_1200.npz                  # -> run1/model_1200.dcp
  python -m doubleattentionspeakerverification_tpu_torch.cli.convert_checkpoint \\
      --input pod/model_3000.dcp --output run1/model_3000.npz

The whole train state (parameters, optimizer moments, step, learning rate)
and the meta dict (config, epoch, best EER, stopping counter) convert
losslessly, leaf for leaf. Runs on the host in one process. The JAX
package's ``.orbax`` directories are refused: its own converter turns them
into ``.npz`` first.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..utils import dist_ckpt
from ..utils.checkpoint import load_checkpoint, save_checkpoint


def convert(input_path: str, output_path: str) -> str:
    flat, meta = load_checkpoint(input_path)
    if dist_ckpt.is_dcp(output_path):
        return dist_ckpt.save_checkpoint_dcp(output_path, flat, meta)
    return save_checkpoint(output_path, flat, meta)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert a checkpoint between the npz and dcp backends."
    )
    p.add_argument("--input", type=str, required=True, help=".npz file or .dcp directory")
    p.add_argument("--output", type=str, default=None,
                   help="output path; its suffix picks the format (.npz/.dcp). "
                        "Default: the input with the other backend's suffix")
    args = p.parse_args(argv)

    src = args.input.rstrip("/")
    if dist_ckpt.is_orbax(src):
        print(f"error: {dist_ckpt.ORBAX_REFUSAL.format(path=src)}", file=sys.stderr)
        return 2
    out = args.output
    if out is None:
        if dist_ckpt.is_dcp(src):
            out = src[: -len(dist_ckpt.SUFFIX)] + ".npz"
        elif src.endswith(".npz"):
            out = src[: -len(".npz")] + dist_ckpt.SUFFIX
        else:
            p.error(f"cannot infer output format from {src!r}; pass --output")
    if not (out.endswith(".npz") or dist_ckpt.is_dcp(out)):
        p.error(f"output {out!r}: give a .npz or .dcp path")
    if os.path.abspath(out) == os.path.abspath(src):
        p.error("input and output are the same path")
    path = convert(src, out)
    print(f"converted {src} -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
