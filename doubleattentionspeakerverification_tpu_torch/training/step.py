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
with its backward (``ops/mha_pool.py``). A step (``TrainStep``, made by
``make_train_step``, and ``make_eval_loss_step``) resolves the tri-state
kernel flags for its device (``utils/kernel_auto.py``, as JAX resolves them
where it builds the step) and keeps the resolved config; the caller's stays
as it was. Where
the data config says the step sees features (B2 resolved as unused, with
no self-check) and a batch carries waves all the same, B2 is resolved then,
behind its self-check: on the card the log-mel never runs the plain version
unasked. The step runs on the card unless the caller asks for the CPU.

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
from ..models.amsoftmax import cross_entropy, focal_cross_entropy, focal_of
from ..models.classifier import SpeakerClassifier
from ..models.poolings import draw_head_keep
from ..ops.chunked_amsoftmax import chunked_amsoftmax_ce
from ..ops.logmel import log_mel_spectrogram_fused
from ..parallel.distributed import all_reduce_
from ..parallel.mesh import SHARDED, host_batch_rows
from ..parallel.sharded_amsoftmax import sharded_amsoftmax_ce
from ..utils.device import resolve_device
from ..utils.kernel_auto import resolve_fast_kernels, route_model

Batch = Dict[str, object]


def step_seed(seed: int, step: int) -> int:
    """The generator seed of optimizer step ``step`` of a run seeded with
    ``seed``: a pure function of the two."""
    return int(np.random.SeedSequence([seed + 17, step]).generate_state(1, np.uint64)[0])


def resolved_for(requested: ExperimentConfig, resolved: ExperimentConfig, batch: Batch,
                 device: torch.device) -> ExperimentConfig:
    """``resolved``, or, where it was resolved for features (the log-mel
    unused) and ``batch`` carries waves, ``requested`` resolved again with
    the log-mel in the step."""
    if ("waves" in batch and requested.model.use_pallas_dsp is None
            and not resolved.model.use_pallas_dsp):
        return resolve_fast_kernels(requested, device, need_dsp=True)
    return resolved


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
        feats = log_mel_spectrogram_fused(
            waves.reshape(g * b, -1).to(torch.float32), cfg.features,
            use_kernel=cfg.model.use_pallas_dsp is not False,
        ).reshape(g, b, -1, cfg.features.n_mels)
        if lengths is not None:
            lengths = frames_for_samples(lengths, cfg.features)
        return normalize_features(feats, cfg.train.normalization, lengths=lengths), lengths
    return _tensor(batch["inputs"], device).to(torch.float32), lengths


class TrainStep:
    """``step(batch, keep=None) -> {"loss", "accuracy"}``: one optimizer step,
    the mean loss and accuracy over its G microbatches (and over the data
    ranks) as 0-d tensors. ``keep`` is a sequence of G (B, heads) bool
    head-dropout masks for the global batch of B rows; without it they are
    drawn from ``generator``, reseeded by :func:`step_seed` for each step.
    ``step`` counts optimizer updates; a resume sets it.

    With a ``mesh`` over a process group (``parallel/mesh.py``) the batch
    holds this process's rows of the global batch. After the last
    microbatch the summed gradients are averaged over the processes in one
    all-reduce of one flat buffer (one reduction per optimizer step, as
    DDP's ``no_sync`` on the first G - 1 gives); ``b2``'s batch statistics
    are the global batch's. With ``W`` split over the model ranks the head
    is ``parallel/sharded_amsoftmax.py`` and ``W``'s gradient is averaged
    over the data ranks alone. Head dropout and SpecAugment are drawn for
    the global batch and each process takes its rows, so the step is the
    one-process step on the same global batch. Every process holds the same
    number of rows (``data/dataset.py``'s divisibility check), so the mean
    of the processes' means is the global mean."""

    def __init__(self, cfg: ExperimentConfig, model: SpeakerClassifier,
                 optimizer: torch.optim.Optimizer, device: torch.device,
                 generator: torch.Generator, mesh=None):
        self.requested = cfg
        self.cfg = resolve_fast_kernels(cfg, device)
        self.model, self.optimizer = route_model(model, self.cfg.model), optimizer
        self.device, self.generator = device, generator
        self.step = 0
        self.mesh = mesh
        batch = cfg.train.batch_size
        self.rows = (0, batch, batch)
        self.w_split = mesh is not None and mesh.model > 1
        self.data_group = None if mesh is None else mesh.data_group
        if mesh is not None:
            self.rows = host_batch_rows(mesh, batch) + (batch,)

    def _draw_keep(self) -> Optional[torch.Tensor]:
        head = getattr(self.model.pooling, "head_att", None)
        if head is None or head.mask_prob <= 0:
            return None
        return draw_head_keep(self.rows[2], self.cfg.model.heads_number, head.mask_prob,
                              self.generator)

    def _loss(self, f, lengths, labels, keep):
        mcfg, tcfg = self.cfg.model, self.cfg.train
        if self.w_split:
            e3 = self.model.classifier_features(f, lengths, keep, self.data_group)
            loss, acc = sharded_amsoftmax_ce(self.model.amsoftmax.W, e3, labels, self.step, mcfg,
                                             self.mesh)
            return (focal_of(loss, tcfg.focal_gamma) if tcfg.criterion == "focal" else loss), acc
        if mcfg.classifier_chunk > 0:
            e3 = self.model.classifier_features(f, lengths, keep, self.data_group)
            return chunked_amsoftmax_ce(self.model.amsoftmax.W, e3, labels, self.step, mcfg,
                                        chunk=mcfg.classifier_chunk)
        costh, logits = self.model.classify(f, labels, self.step, lengths, keep,
                                            self.data_group)
        if tcfg.criterion == "focal":
            loss = focal_cross_entropy(logits, labels, tcfg.focal_gamma)
        else:
            loss = cross_entropy(logits, labels)
        return loss, (costh.argmax(dim=-1) == labels).to(torch.float32).mean()

    def _average_gradients(self) -> None:
        """Every replicated parameter's gradient averaged over all the
        processes (the model ranks of one data index hold equal ones, so
        this is the data ranks' mean, and every replica stays equal bit for
        bit); ``W``'s columns over the data ranks."""
        mesh = self.mesh
        params = [p for n, p in self.model.named_parameters()
                  if not (self.w_split and n == SHARDED)]
        if mesh.world_group is not None:
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            all_reduce_(flat, mesh.world_group).div_(mesh.size)
            offset = 0
            for p in params:
                n = p.grad.numel()
                p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
                offset += n
        if self.w_split and mesh.data_group is not None:
            all_reduce_(self.model.amsoftmax.W.grad, mesh.data_group).div_(mesh.data)

    def __call__(self, batch: Batch, keep: Optional[Sequence[torch.Tensor]] = None):
        tcfg = self.cfg.train
        self.cfg = resolved_for(self.requested, self.cfg, batch, self.device)
        feats, lengths = prepare_inputs(batch, self.cfg, self.device)
        labels = _tensor(batch["labels"], self.device).to(torch.int64)
        g = feats.shape[0]
        lo, hi, _ = self.rows
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
                                 tcfg.specaugment_freq_width, rows=self.rows)
            k = self._draw_keep() if keep is None else keep[i]
            k = None if k is None else torch.as_tensor(k)[lo:hi]
            loss, acc = self._loss(f, None if lengths is None else lengths[i], labels[i], k)
            loss.backward()
            loss_sum += loss.detach()
            acc_sum += acc
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.mesh is not None:
            self._average_gradients()
        if tcfg.grad_accum_mean:
            for p in self.model.parameters():
                p.grad.div_(g)
        self.optimizer.step()
        self.step += 1
        metrics = torch.stack((loss_sum, acc_sum)) / g
        if self.mesh is not None and self.mesh.data_group is not None:
            all_reduce_(metrics, self.mesh.data_group).div_(self.mesh.data)
        return {"loss": metrics[0], "accuracy": metrics[1]}


def make_train_step(cfg: ExperimentConfig, model: SpeakerClassifier,
                    optimizer: torch.optim.Optimizer, device="cuda",
                    generator: Optional[torch.Generator] = None, mesh=None) -> TrainStep:
    """The train step of ``model`` on ``device`` (the card unless "cpu").
    ``optimizer`` is built over ``model.parameters()``
    (``training.optimizers.make_optimizer``); the model is moved to the
    device in place. The generator defaults to a CPU one, so the same seed
    draws the same masks on either device. With a ``mesh`` over a process
    group, ``model`` holds this rank's columns of ``W`` where they are split
    (``parallel/mesh.py:shard_model``) and the step is collective: every
    process calls it at the same point."""
    if cfg.train.criterion not in ("cross_entropy", "focal"):
        raise ValueError(f"unknown criterion {cfg.train.criterion!r}")
    if cfg.train.criterion == "focal" and cfg.model.classifier_chunk > 0:
        raise ValueError("criterion='focal' needs full logits; incompatible with classifier_chunk")
    if mesh is not None and mesh.model > 1 and cfg.model.classifier_chunk > 0:
        raise ValueError("classifier_chunk scans the whole W; incompatible with a model axis "
                         "above 1")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator()
    return TrainStep(cfg, model.to(dev), optimizer, dev, generator, mesh)


def make_eval_loss_step(cfg: ExperimentConfig, model: SpeakerClassifier, device="cuda"):
    """``eval_step(batch) -> {"loss", "accuracy"}``: the eval-mode forward over
    all G x B windows at once (annealing at step 0, cross-entropy), changing
    no state."""
    dev = resolve_device(device)
    box = {"cfg": resolve_fast_kernels(cfg, dev)}
    model = route_model(model.to(dev), box["cfg"].model)

    @torch.no_grad()
    def eval_step(batch: Batch):
        box["cfg"] = resolved_for(cfg, box["cfg"], batch, dev)
        feats, lengths = prepare_inputs(batch, box["cfg"], dev)
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
