"""How far the bfloat16 train step's gradients lie from the float32 step's,
beside the float32 step with the bfloat16 encoder's roundings emulated.

    python -m doubleattentionspeakerverification_tpu_torch.tools.bf16_drift \\
        [--kernel_size 256] [--heads 16] [--batch 8] [--frames 200] [--device cpu]

bfloat16 rounds to nearest at 8 significant bits, a relative error of at
most 2^-9 a rounding. At random weights the first convs' gradients are sums
that largely cancel, so bfloat16 moves them by far more than 2^-9 of their
size, and no fixed tolerance says whether a bfloat16 step is right. What
does: the float32 step run with the encoder's roundings emulated
(:func:`emulated_bf16_convs`: its input, weights and biases rounded to
bfloat16 as the bfloat16 step casts them, and its two roundings of computed
values, the conv's output and then its sum with the bias, replaced by
independent random relative errors of at most 2^-9). A bfloat16 step whose
convs accumulate in float32 and round once lands at about the emulated
step's distance from the float32 step; one that accumulated in bfloat16
would land far beyond it.
``chip_smoke.py`` ``[train bf16]`` holds the card's bfloat16 step to this.

The command runs one step of each (float32, bfloat16, emulated) from the
same seeded weights on one seeded batch of normal features (G=2, the second
microbatch ragged) and prints one JSON line: the losses and, for every
gradient, its L2 distance from the float32 step's over the float32
gradient's norm (``fc2.bias`` over ``fc2.weight``'s: ``b2`` removes any
constant before it, so its own gradient is a cancellation with no scale).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

ROUNDING = 2.0 ** -9     # round to nearest at bfloat16's 8 significant bits


def distances(grads: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each gradient's L2 distance from ``ref``'s over the norm of ``ref``'s
    (of ``fc2.weight``'s for ``fc2.bias``)."""
    def scale(k):
        return ref["fc2.weight" if k == "fc2.bias" else k]

    return {k: float((grads[k] - ref[k]).norm()) / max(float(scale(k).norm()), 1e-30)
            for k in ref}


@contextlib.contextmanager
def emulated_bf16_convs(seed: int, device="cpu") -> Iterator[None]:
    """While open, every VGG conv of a float32 model computes as the
    bfloat16 encoder does up to its two roundings of computed values: its
    input, weights and bias rounded to bfloat16, the conv in float32, its
    output and then its sum with the bias each times (1 + u 2^-9), u
    uniform in [-1, 1] from a generator on ``device`` seeded with ``seed``."""
    from ..models import vgg

    conv, gen = vgg.VGG._conv, torch.Generator(device).manual_seed(seed)

    def bf16(t):
        return t.to(torch.bfloat16).to(torch.float32)

    def err(t):
        u = torch.rand(t.shape, generator=gen, device=t.device) * 2 - 1
        return t * (1 + u * ROUNDING)

    def emulated(self, h, layer):
        y = F.conv2d(bf16(h), bf16(layer.weight), None, padding=1)
        return err(err(y) + bf16(layer.bias)[:, None, None])

    vgg.VGG._conv = emulated
    try:
        yield
    finally:
        vgg.VGG._conv = conv


def drift(kernel_size: int = 256, heads: int = 16, batch: int = 8, frames: int = 200,
          device: str = "cpu", seed: int = 0) -> Dict[str, object]:
    """One step each in float32, bfloat16 and float32 with the roundings
    emulated, from the same weights on the same batch: the losses and each
    gradient's distances from the float32 step's."""
    from ..config import ExperimentConfig, ModelConfig, TrainConfig
    from ..models.classifier import SpeakerClassifier
    from ..models.init import init_parameters
    from ..models.poolings import draw_head_keep
    from ..training.optimizers import make_optimizer
    from ..training.step import make_train_step

    g = 2
    cfg = ExperimentConfig(
        model=ModelConfig(kernel_size=kernel_size, heads_number=heads, embedding_size=64,
                          num_spkrs=200),
        train=TrainConfig(batch_size=batch, gradient_accumulation=g))
    state0 = init_parameters(SpeakerClassifier(cfg.model),
                             torch.Generator().manual_seed(seed)).state_dict()
    rng = np.random.default_rng(seed + 1)
    lengths = np.full((g, batch), frames, np.int32)
    lengths[1] = rng.integers(frames // 2, frames + 1, batch)
    data = {"inputs": rng.standard_normal((g, batch, frames, 80)).astype(np.float32),
            "lengths": lengths,
            "labels": rng.integers(0, cfg.model.num_spkrs, (g, batch)).astype(np.int32)}
    gen = torch.Generator().manual_seed(seed + 2)
    keep = [draw_head_keep(batch, heads, cfg.model.mask_prob, gen) for _ in range(g)]

    def run(c, emulate: Optional[int] = None):
        model = SpeakerClassifier(c.model)
        model.load_state_dict(state0)
        step = make_train_step(c, model, make_optimizer(c.train, model.parameters()), device)
        with emulated_bf16_convs(emulate, device) if emulate is not None else \
                contextlib.nullcontext():
            loss = float(step(data, keep=keep)["loss"])
        return loss, {n: p.grad.detach().cpu() for n, p in model.named_parameters()}

    bf16 = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    (l32, g32), (l16, g16), (lemu, gemu) = run(cfg), run(bf16), run(cfg, emulate=seed + 3)
    d16, demu = distances(g16, g32), distances(gemu, g32)
    ratio = {k: d16[k] / max(demu[k], 1e-30) for k in d16}
    return {"kernel_size": kernel_size, "heads": heads, "batch": batch, "frames": frames,
            "device": device, "loss": {"float32": l32, "bfloat16": l16, "emulated": lemu},
            "distance": {k: [d16[k], demu[k]] for k in d16},
            "max_ratio": max(ratio.values()), "max_ratio_at": max(ratio, key=ratio.get)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kernel_size", type=int, default=256)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    print(json.dumps(drift(a.kernel_size, a.heads, a.batch, a.frames, a.device, a.seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
