"""One optimizer step of the speaker classifier (JAX ``training/step.py``).

A step takes G microbatches (inputs or waves (G, B, ...), lengths (G, B),
labels (G, B)). For each microbatch it runs SpecAugment if it is on, the
train-mode forward (head dropout, batch statistics in ``b2``), the loss and
``backward()``. Torch adds each backward's gradients into ``.grad``, which
gives the reference's SUMMED microbatch gradients (``train.py:219-226``);
``b2``'s running statistics carry from one microbatch to the next. Then the
gradients are divided by G under ``grad_accum_mean``, the optimizer steps
once, and the step counter that annealing reads moves on.

In wav mode (``waves`` in the batch) the log-mel runs in the step: int16
PCM is divided by 32768, the log-mel is kernel B2 on the card, and the
normalization is masked by the valid frames. The MHA pooling is kernel B1
with its backward (``ops/mha_pool.py``). The step runs on the card unless
the caller asks for the CPU.

Random draws (head dropout, SpecAugment) come only from the step's
``torch.Generator``, reseeded before every optimizer step from
(``seed + 17``, step), as the JAX trainer folds the step into
``PRNGKey(seed + 17)``: a run resumed at any step draws what the
uninterrupted run drew there. The head-dropout keep masks can be passed in.

A parameter that no microbatch reached gets a zero gradient before the
optimizer steps, as optax decays and moves every leaf; torch would skip a
parameter whose ``.grad`` is None.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import ExperimentConfig
from ..dsp.augment import spec_augment
from ..dsp.features import frames_for_samples, normalize_features
from ..models.amsoftmax import cross_entropy, focal_cross_entropy
from ..models.classifier import SpeakerClassifier
from ..ops.chunked_amsoftmax import chunked_amsoftmax_ce
from ..ops.logmel import log_mel_spectrogram_fused
from ..utils.device import resolve_device

Batch = Dict[str, object]


def step_seed(seed: int, step: int) -> int:
    """The generator seed of optimizer step ``step`` of a run seeded with
    ``seed``: a pure function of the two."""
    return int(np.random.SeedSequence([seed + 17, step]).generate_state(1, np.uint64)[0])


def _tensor(x, device: torch.device) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(device)


@torch.no_grad()
def prepare_inputs(batch: Batch, cfg: ExperimentConfig, device: torch.device):
    """-> (features (G, B, T, F) float32, frame lengths (G, B) or None), as
    JAX ``_prepare_inputs``."""
    full = cfg.train.assume_full_lengths
    lengths = None if full else _tensor(batch["lengths"], device).to(torch.int64)
    if "waves" in batch:
        waves = _tensor(batch["waves"], device)
        if waves.dtype == torch.int16:      # PCM transfer: undo the host-side scale
            waves = waves.to(torch.float32) / 32768.0
        g, b = waves.shape[:2]
        feats = log_mel_spectrogram_fused(waves.reshape(g * b, -1).to(torch.float32),
                                          cfg.features).reshape(g, b, -1, cfg.features.n_mels)
        if lengths is not None:
            lengths = frames_for_samples(lengths, cfg.features)
        return normalize_features(feats, cfg.train.normalization, lengths=lengths), lengths
    return _tensor(batch["inputs"], device).to(torch.float32), lengths


class TrainStep:
    """``step(batch, keep=None) -> {"loss", "accuracy"}``: one optimizer step,
    the mean loss and accuracy over its G microbatches as 0-d tensors.
    ``keep`` is a sequence of G (B, heads) bool head-dropout masks; without
    it they are drawn from ``generator``, reseeded by :func:`step_seed` for
    each step. ``step`` counts optimizer updates; a resume sets it."""

    def __init__(self, cfg: ExperimentConfig, model: SpeakerClassifier,
                 optimizer: torch.optim.Optimizer, device: torch.device,
                 generator: torch.Generator):
        self.cfg, self.model, self.optimizer = cfg, model, optimizer
        self.device, self.generator = device, generator
        self.step = 0

    def _loss(self, f, lengths, labels, keep):
        mcfg, tcfg = self.cfg.model, self.cfg.train
        if mcfg.classifier_chunk > 0:
            e3 = self.model.classifier_features(f, lengths, keep, self.generator)
            return chunked_amsoftmax_ce(self.model.amsoftmax.W, e3, labels, self.step, mcfg,
                                        chunk=mcfg.classifier_chunk)
        costh, logits = self.model.classify(f, labels, self.step, lengths, keep, self.generator)
        if tcfg.criterion == "focal":
            loss = focal_cross_entropy(logits, labels, tcfg.focal_gamma)
        else:
            loss = cross_entropy(logits, labels)
        return loss, (costh.argmax(dim=-1) == labels).to(torch.float32).mean()

    def __call__(self, batch: Batch, keep: Optional[Sequence[torch.Tensor]] = None):
        tcfg = self.cfg.train
        feats, lengths = prepare_inputs(batch, self.cfg, self.device)
        labels = _tensor(batch["labels"], self.device).to(torch.int64)
        g = feats.shape[0]
        self.generator.manual_seed(step_seed(tcfg.seed, self.step))
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=self.device)
        acc_sum = torch.zeros((), device=self.device)
        for i in range(g):
            f = feats[i]
            if tcfg.specaugment:
                f = spec_augment(f, self.generator, tcfg.specaugment_time_masks,
                                 tcfg.specaugment_time_width, tcfg.specaugment_freq_masks,
                                 tcfg.specaugment_freq_width)
            loss, acc = self._loss(f, None if lengths is None else lengths[i], labels[i],
                                   None if keep is None else keep[i])
            loss.backward()
            loss_sum += loss.detach()
            acc_sum += acc
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif tcfg.grad_accum_mean:
                p.grad.div_(g)
        self.optimizer.step()
        self.step += 1
        return {"loss": loss_sum / g, "accuracy": acc_sum / g}


def make_train_step(cfg: ExperimentConfig, model: SpeakerClassifier,
                    optimizer: torch.optim.Optimizer, device="cuda",
                    generator: Optional[torch.Generator] = None) -> TrainStep:
    """The train step of ``model`` on ``device`` (the card unless "cpu").
    ``optimizer`` is built over ``model.parameters()``
    (``training.optimizers.make_optimizer``); the model is moved to the
    device in place. The generator defaults to a CPU one, so the same seed
    draws the same masks on either device."""
    if cfg.train.criterion not in ("cross_entropy", "focal"):
        raise ValueError(f"unknown criterion {cfg.train.criterion!r}")
    if cfg.train.criterion == "focal" and cfg.model.classifier_chunk > 0:
        raise ValueError("criterion='focal' needs full logits; incompatible with classifier_chunk")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator()
    return TrainStep(cfg, model.to(dev), optimizer, dev, generator)


def make_eval_loss_step(cfg: ExperimentConfig, model: SpeakerClassifier, device="cuda"):
    """``eval_step(batch) -> {"loss", "accuracy"}``: the eval-mode forward over
    all G x B windows at once (annealing at step 0, cross-entropy), changing
    no state."""
    dev = resolve_device(device)
    model = model.to(dev)

    @torch.no_grad()
    def eval_step(batch: Batch):
        feats, lengths = prepare_inputs(batch, cfg, dev)
        labels = _tensor(batch["labels"], dev).to(torch.int64).reshape(-1)
        was_training = model.training
        model.eval()
        try:
            costh, logits = model.classify(feats.reshape((-1,) + feats.shape[2:]), labels, 0,
                                           None if lengths is None else lengths.reshape(-1))
        finally:
            model.train(was_training)
        return {"loss": cross_entropy(logits, labels),
                "accuracy": (costh.argmax(dim=-1) == labels).to(torch.float32).mean()}

    return eval_step
