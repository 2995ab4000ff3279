"""The rank side of the port's two-process CPU tests: each function runs in
every process of a gloo group started by
``doubleattentionspeakerverification_tpu_torch.tools.multihost_check``
and writes what the test in the pytest process compares. Imports only
torch, numpy and the port (no JAX), so the processes start quickly.

- :func:`parallel_cases` (``tests/test_torch_parallel.py``): the sharded
  AM-Softmax, the embedding all-gather, and one train step data-parallel
  and with ``W`` split over the two processes.
- :func:`trainer_cases` (``tests/test_torch_multiprocess.py``): the train
  CLI across the two processes, several runs on one process group.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal

import numpy as np
import torch
import torch.distributed as dist

from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig, MeshConfig
from doubleattentionspeakerverification_tpu_torch.config import ModelConfig
from doubleattentionspeakerverification_tpu_torch.models.amsoftmax import focal_of
from doubleattentionspeakerverification_tpu_torch.models.classifier import SpeakerClassifier
from doubleattentionspeakerverification_tpu_torch.parallel.mesh import (
    gather_columns,
    make_mesh,
    shard_columns,
    shard_model,
)
from doubleattentionspeakerverification_tpu_torch.parallel.sharded_amsoftmax import (
    sharded_amsoftmax_ce,
    sharded_cosine_scores_allgather,
)
from doubleattentionspeakerverification_tpu_torch.training.optimizers import make_optimizer
from doubleattentionspeakerverification_tpu_torch.training.step import make_train_step
from doubleattentionspeakerverification_tpu_torch.utils.weights import (
    optimizer_state_by_name,
    params_from_jax,
    train_state_to_jax,
)


def _step_leaves(cfg: ExperimentConfig, flat, batch, keep):
    """One train step of the port's model (from the JAX leaves ``flat``)
    on this process's rows, and the whole state after it as JAX leaves:
    ``W`` and its moments gathered from the model ranks."""
    mesh = make_mesh(cfg.mesh)
    model = SpeakerClassifier(cfg.model)
    model.load_state_dict({k: v for k, v in params_from_jax(flat).items()
                           if k in model.state_dict()})
    shard_model(model, mesh)
    opt = make_optimizer(cfg.train, model.parameters())
    step = make_train_step(cfg, model, opt, device="cpu", mesh=mesh)
    lo, hi, _ = step.rows
    metrics = step({k: v[:, lo:hi] for k, v in batch.items()}, keep=keep)
    state = dict(model.state_dict())
    state["amsoftmax.W"] = gather_columns(model.amsoftmax.W, mesh)
    moments = optimizer_state_by_name(model, opt)
    moments["amsoftmax.W"] = {k: gather_columns(v, mesh) if v.ndim == 2 else v
                              for k, v in moments["amsoftmax.W"].items()}
    leaves = train_state_to_jax(state, moments, cfg.train.optimizer, step.step,
                                opt.param_groups[0]["lr"])
    leaves["metrics/loss"] = metrics["loss"].numpy()
    leaves["metrics/accuracy"] = metrics["accuracy"].numpy()
    leaves["rows"] = np.asarray([lo, hi])
    return leaves


def parallel_cases(workdir: str) -> None:
    torch.set_num_threads(1)
    rank = dist.get_rank()
    z = np.load(os.path.join(workdir, "inputs.npz"))
    out = {}

    # the AM-Softmax with W split over the two processes (model axis 2)
    with open(os.path.join(workdir, "ce_model.json")) as f:
        mcfg = ModelConfig(**json.load(f))
    mesh = make_mesh(MeshConfig(model_axis=2))
    lo, hi = shard_columns(z["ce_w"].shape[1], mesh)
    w = torch.tensor(z["ce_w"][:, lo:hi], requires_grad=True)
    x = torch.tensor(z["ce_x"], requires_grad=True)
    loss, acc = sharded_amsoftmax_ce(w, x, torch.from_numpy(z["ce_y"]), int(z["ce_step"]),
                                     mcfg, mesh)
    loss.backward()
    out.update(ce_loss=loss.detach().numpy(), ce_acc=acc.numpy(),
               ce_focal=focal_of(loss.detach(), 2.0).numpy(),
               ce_dw=gather_columns(w.grad, mesh).numpy(), ce_dx=x.grad.numpy(),
               ce_cols=np.asarray([lo, hi]))

    # the embedding all-gather over the data axis
    mesh = make_mesh(MeshConfig())
    n = z["emb"].shape[0] // mesh.data
    mine = torch.from_numpy(z["emb"][rank * n:(rank + 1) * n])
    out["gathered"] = sharded_cosine_scores_allgather(mine, mesh).numpy()

    # one train step, data-parallel and with W split
    flat = {k[len("state/"):]: z[k] for k in z.files if k.startswith("state/")}
    batch = {k[len("batch/"):]: z[k] for k in z.files if k.startswith("batch/")}
    keep = [torch.from_numpy(k) for k in z["keep"]]
    with open(os.path.join(workdir, "step_config.json")) as f:
        base = ExperimentConfig.from_json(f.read())
    for tag, model_axis in (("dp", 1), ("mp", 2)):
        cfg = dataclasses.replace(base, mesh=MeshConfig(model_axis=model_axis))
        for k, v in _step_leaves(cfg, flat, batch, keep).items():
            out[f"{tag}/{k}"] = np.asarray(v)
    np.savez(os.path.join(workdir, f"parallel_rank{rank}.npz"), **out)


class _SignalAtStep:
    """A ``MetricLogger`` that raises SIGTERM in its own process when the
    ``train`` event of ``step`` is logged: the CLI's handler asks the
    trainer for a graceful stop, as a scheduler's notice would."""

    def __init__(self, step):
        from doubleattentionspeakerverification_tpu_torch.utils.logging import MetricLogger

        self.step, self.base = step, MetricLogger

    def __call__(self, *args, **kwargs):
        logger, step = self.base(*args, **kwargs), self.step
        inner = logger.log

        def log(event, **fields):
            inner(event, **fields)
            if event == "train" and int(fields["step"]) == step:
                signal.raise_signal(signal.SIGTERM)

        logger.log = log
        return logger


def trainer_cases(workdir: str) -> None:
    """The runs of ``tests/test_torch_multiprocess.py``, in order, each
    ``cli.train.main`` on this process group; ``argv.json`` holds their
    flags (``--distributed`` added here). Exit codes go to
    ``trainer_rank<r>.json``."""
    from doubleattentionspeakerverification_tpu_torch.cli import train as cli

    torch.set_num_threads(1)
    rank = dist.get_rank()
    with open(os.path.join(workdir, "argv.json")) as f:
        runs = json.load(f)
    rcs = {}
    for name, argv in runs:
        if name == "copy":      # argv = (source, target): rank 0 copies a run's directory
            if rank == 0:
                shutil.copytree(*argv)
            dist.barrier()
            continue
        if name == "stop":      # rank 1 alone is signalled, after step 1
            base = cli.MetricLogger
            if rank == 1:
                cli.MetricLogger = _SignalAtStep(1)
            try:
                rcs[name] = cli.main(argv + ["--distributed"])
            finally:
                cli.MetricLogger = base
            continue
        rcs[name] = cli.main(argv + ["--distributed"])
    with open(os.path.join(workdir, f"trainer_rank{rank}.json"), "w") as f:
        json.dump(rcs, f)
