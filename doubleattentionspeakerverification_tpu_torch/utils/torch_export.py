"""Write the port's model and ``torch.optim`` state as a reference ``.chkpt``
(the port's counterpart of the JAX package's ``utils/torch_export.py``).

The inverse of ``utils/torch_import.py``: the file has the reference's
``utils.py:23-40`` layout, ``{'model': state_dict, 'optimizer': state_dict,
'settings': Namespace, 'epoch', 'step'}``, so the reference's own tools
(``getEmbeddingExample.py``, ``train.py --requeue``) load it. The port's
tensors are already in torch's layouts (convolutions OIHW, linears
(out, in)); only the names change, by ``torch_import``'s renaming rules
read backwards. The reference's ``b1``/``b3`` BatchNorms (defined but never
applied, ``model.py:43-59``) are written at torch's defaults so a strict
``load_state_dict`` succeeds, and get no optimizer state, as torch keeps
none for a parameter that never had a gradient. Adam's and RMSprop's
moments are indexed by the reference module's ``named_parameters()`` order.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Mapping, Optional, Set, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig, ModelConfig
from .torch_import import RENAMES


def reference_name(name: str) -> Optional[str]:
    """A port state-dict key -> the reference module's (None for a key the
    reference has no place for)."""
    for theirs, ours in RENAMES:
        if name.startswith(ours):
            return theirs + name[len(ours):]
    return None


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def export_state_dict(model_state: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The port's ``SpeakerClassifier.state_dict()`` -> the reference
    ``state_dict`` (numpy), the dead ``b1``/``b3`` included."""
    if cfg.pooling_method == "StatisticalPooling":
        raise ValueError(
            "StatisticalPooling is an extension of this framework; the "
            "reference model has no equivalent module to export to")
    out: Dict[str, np.ndarray] = {}
    for name, value in model_state.items():
        theirs = reference_name(name)
        if theirs is None:
            raise KeyError(f"no reference name for {name!r}")
        a = _numpy(value)
        out[theirs] = np.array(a, np.int64 if name.endswith("num_batches_tracked") else np.float32)
    emb = cfg.embedding_size
    for dead in ("b1", "b3"):  # torch BatchNorm1d defaults; never applied
        out[f"{dead}.weight"] = np.ones((emb,), np.float32)
        out[f"{dead}.bias"] = np.zeros((emb,), np.float32)
        out[f"{dead}.running_mean"] = np.zeros((emb,), np.float32)
        out[f"{dead}.running_var"] = np.ones((emb,), np.float32)
        out[f"{dead}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
    return out


def reference_param_order(cfg: ModelConfig) -> Tuple[List[str], Set[int]]:
    """Keys of the reference module's ``named_parameters()`` in registration
    order (``model.py:10-21``: front_end, poolingLayer, fc1, b1, fc2, b2,
    preLayer, b3, predictionLayer), and the indices of ``b1``/``b3``, which
    never receive gradients."""
    order: List[str] = []
    n_blocks = 3 if cfg.front_end == "VGG3L" else 4
    for i in range(1, n_blocks + 1):
        for j in (1, 2):
            order += [f"front_end.conv{i}{j}.weight", f"front_end.conv{i}{j}.bias"]
    order += {"Attention": ["poolingLayer.att"],
              "MHA": ["poolingLayer.query"],
              "DoubleMHA": ["poolingLayer.utteranceAttention.query",
                            "poolingLayer.headsAttention.att"]}[cfg.pooling_method]
    order += ["fc1.weight", "fc1.bias"]
    dead = {len(order), len(order) + 1}
    order += ["b1.weight", "b1.bias", "fc2.weight", "fc2.bias", "b2.weight", "b2.bias",
              "preLayer.weight", "preLayer.bias"]
    dead |= {len(order), len(order) + 1}
    order += ["b3.weight", "b3.bias", "predictionLayer.W"]
    return order, dead


def _param_group(cfg: ExperimentConfig, lr: float, n_params: int) -> Dict[str, Any]:
    """The reference optimizer's param group (``train.py:82-88``: Adam, SGD
    or RMSprop at lr and weight decay, torch defaults otherwise)."""
    common = {"lr": lr, "weight_decay": cfg.train.weight_decay, "maximize": False,
              "foreach": None, "differentiable": False, "params": list(range(n_params))}
    opt = cfg.train.optimizer
    if opt == "Adam":
        return {**common, "betas": (0.9, 0.999), "eps": 1e-8, "amsgrad": False,
                "capturable": False, "fused": None}
    if opt == "SGD":
        return {**common, "momentum": 0, "dampening": 0, "nesterov": False, "fused": None}
    if opt == "RMSprop":
        return {**common, "momentum": 0, "alpha": 0.99, "eps": 1e-8, "centered": False,
                "capturable": False}
    raise ValueError(f"unknown optimizer {opt!r}")


def export_optimizer_state_dict(opt_state: Optional[Mapping[str, Mapping[str, Any]]],
                                cfg: ExperimentConfig, lr: Optional[float] = None,
                                step: int = 0) -> Dict[str, Any]:
    """-> a torch ``Optimizer.state_dict()`` for the reference's optimizer.
    Always loadable (the reference's requeue loads it unconditionally,
    ``train.py:42``); with ``opt_state``, the optimizer's state by port
    parameter name (``utils/weights.py:optimizer_state_by_name``), Adam's
    moments and step count, or RMSprop's ``square_avg`` at ``step``, are
    included for every parameter that has them. ``lr`` defaults to the
    config's."""
    order, dead = reference_param_order(cfg.model)
    group = _param_group(cfg, cfg.train.learning_rate if lr is None else lr, len(order))
    ours = {reference_name(n): s for n, s in (opt_state or {}).items()}
    state: Dict[int, Dict[str, Any]] = {}
    opt = cfg.train.optimizer
    for i, key in enumerate(order):
        entry = ours.get(key)
        if i in dead or not entry:
            continue
        if opt == "Adam" and "exp_avg" in entry:
            state[i] = {"step": int(float(entry["step"])), "exp_avg": _numpy(entry["exp_avg"]),
                        "exp_avg_sq": _numpy(entry["exp_avg_sq"])}
        elif opt == "RMSprop" and "square_avg" in entry:
            state[i] = {"step": step, "square_avg": _numpy(entry["square_avg"])}
    # SGD at the reference's momentum 0 keeps no per-parameter state
    return {"state": state, "param_groups": [group]}


def settings_namespace(cfg: ExperimentConfig) -> argparse.Namespace:
    """The config -> the reference's pickled argparse Namespace (the fields
    ``train.py:253-291`` defines; the inverse of
    ``torch_import.config_from_namespace``)."""
    m, t, d = cfg.model, cfg.train, cfg.data
    return argparse.Namespace(
        train_data_dir=d.train_data_dir,
        valid_data_dir=d.valid_data_dir,
        train_labels_path=d.train_labels_path,
        valid_clients=d.valid_clients,
        valid_impostors=d.valid_impostors,
        out_dir=cfg.out_dir,
        model_name=cfg.model_name,
        front_end=m.front_end,
        window_size=t.window_size,
        randomSlicing=t.random_slicing,
        normalization=t.normalization,
        kernel_size=m.kernel_size,
        embedding_size=m.embedding_size,
        heads_number=m.heads_number,
        pooling_method=m.pooling_method,
        mask_prob=m.mask_prob,
        scalingFactor=m.scaling_factor,
        marginFactor=m.margin_factor,
        annealing=m.annealing,
        optimizer=t.optimizer,
        data_mode="normal",
        learning_rate=t.learning_rate,
        weight_decay=t.weight_decay,
        batch_size=t.batch_size,
        gradientAccumulation=t.gradient_accumulation,
        max_epochs=t.max_epochs,
        early_stopping=t.early_stopping,
        print_every=t.print_every,
        requeue=False,
        validate_every=t.validate_every,
        num_workers=d.num_workers,
        num_spkrs=m.num_spkrs,
        feature_size=m.feature_size,
    )


def _tensor(v) -> torch.Tensor:
    if np.isscalar(v):
        return torch.tensor(float(v))
    return torch.from_numpy(np.ascontiguousarray(v).copy())


def save_torch_checkpoint(path: str, model_state: Mapping[str, Any], cfg: ExperimentConfig,
                          opt_state: Optional[Mapping[str, Mapping[str, Any]]] = None,
                          lr: Optional[float] = None, epoch: int = 0, step: int = 0) -> None:
    """Write a reference-layout ``.chkpt`` from a model's ``state_dict()``
    and, optionally, its optimizer's state by parameter name and its
    learning rate."""
    model_sd = {k: _tensor(v) for k, v in export_state_dict(model_state, cfg.model).items()}
    opt_sd = export_optimizer_state_dict(opt_state, cfg, lr=lr, step=step)
    opt_sd["state"] = {i: {k: _tensor(v) for k, v in entry.items()}
                       for i, entry in opt_sd["state"].items()}
    torch.save({"model": model_sd, "optimizer": opt_sd, "settings": settings_namespace(cfg),
                "epoch": epoch, "step": step}, path)
