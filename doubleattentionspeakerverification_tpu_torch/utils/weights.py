"""Carry the JAX package's train state into the port's modules and back.

``params_from_jax`` reads the parameters; ``train_state_to_jax`` writes the
model, the ``torch.optim`` state and the step counter as the flat leaves of
the JAX package's ``TrainState`` (its ``.npz`` checkpoint keys), and
``load_train_state`` reads those leaves into a model and an optimizer. A
model rank's ``W`` and its moments are its columns of the whole state's
(``slice_columns``); ``utils/dist_ckpt.py`` writes each rank's columns and
joins them on reading, so npz and ``.dcp`` checkpoints convert losslessly.

Layout rules (the JAX package's ``utils/torch_export.py:11-16``, kept here
as the port's own copy): convolution kernels go HWIO -> OIHW, linear
weights (in, out) -> (out, in); attention vectors keep the reference's
shapes; ``b2``'s scale/bias and the ``ModelState`` running statistics become
the BatchNorm's weight/bias and buffers.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# torch.optim state of each optimizer -> the optax moments it holds, under
# ``opt_state/inner_state/1/`` (optax.chain(add_decayed_weights, core, scale))
_MOMENTS = {"Adam": (("mu", "exp_avg"), ("nu", "exp_avg_sq")),
            "RMSprop": (("nu", "square_avg"),),
            "SGD": ()}
_BN_STATE = {"b2.running_mean": "bn_mean", "b2.running_var": "bn_var",
             "b2.num_batches_tracked": "bn_count"}


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX leaves (checkpoint keys ``params/...`` and ``model_state/...``)
    -> a state dict keyed by the port's module names, the training head's
    (``pre_layer``, ``amsoftmax/W``) included. The optimizer's leaves and the
    step counter are not read."""
    state: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "model_state":
            name = {"bn_mean": "b2.running_mean", "bn_var": "b2.running_var",
                    "bn_count": "b2.num_batches_tracked"}[parts[1]]
            state[name] = torch.from_numpy(np.array(arr, np.int64 if parts[1] == "bn_count" else np.float32))
            continue
        if parts[0] != "params":
            continue
        path, leaf = parts[1:-1], parts[-1]
        a = np.asarray(arr, np.float32)
        if path[0] == "vgg":
            name = {"w": "weight", "b": "bias"}[leaf]
            a = np.transpose(a, (3, 2, 0, 1)) if leaf == "w" else a      # HWIO -> OIHW
        elif path[0] in ("fc1", "fc2", "pre_layer"):
            name = {"w": "weight", "b": "bias"}[leaf]
            a = a.T if leaf == "w" else a                                 # (in, out) -> (out, in)
        elif path[0] == "b2":
            name = {"scale": "weight", "bias": "bias"}[leaf]
        else:
            name = leaf
        state[".".join(path + [name])] = torch.from_numpy(np.array(a, order="C"))
    return state


def jax_param_key(name: str) -> str:
    """A port parameter name -> its path under ``params/`` (the inverse of
    :func:`params_from_jax`'s naming)."""
    parts = name.split(".")
    path, leaf = parts[:-1], parts[-1]
    if path and path[0] in ("vgg", "fc1", "fc2", "pre_layer"):
        leaf = {"weight": "w", "bias": "b"}[leaf]
    elif path and path[0] == "b2":
        leaf = {"weight": "scale", "bias": "bias"}[leaf]
    return "/".join(path + [leaf])


def _to_jax_layout(name: str, a: np.ndarray) -> np.ndarray:
    """A float32 copy of ``a``: OIHW -> HWIO for convolution kernels,
    (out, in) -> (in, out) for linear weights; every other leaf keeps its
    shape."""
    top, leaf = name.split(".")[0], name.split(".")[-1]
    if top == "vgg" and leaf == "weight":
        a = np.transpose(a, (2, 3, 1, 0))
    elif top in ("fc1", "fc2", "pre_layer") and leaf == "weight":
        a = a.T
    return np.array(a, np.float32, order="C")


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def optimizer_state_by_name(model: torch.nn.Module,
                            optimizer: torch.optim.Optimizer) -> Dict[str, Dict[str, torch.Tensor]]:
    """The optimizer's per-parameter state keyed by parameter name."""
    return {n: dict(optimizer.state[p]) for n, p in model.named_parameters() if p in optimizer.state}


def train_state_to_jax(model_state: Mapping[str, torch.Tensor],
                       opt_state: Mapping[str, Mapping[str, torch.Tensor]],
                       optimizer: str, step: int, lr: float) -> Dict[str, np.ndarray]:
    """The flat leaves of the JAX package's ``TrainState`` from a model's
    ``state_dict()``, its optimizer's state by parameter name
    (:func:`optimizer_state_by_name`), the optimizer's name, the step counter
    and the learning rate. Every leaf is a host copy. A parameter the
    optimizer holds no state for yet (before its first step) gets the zero
    moments optax starts from; the learning rate is float32, as optax holds
    it."""
    if optimizer not in _MOMENTS:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    flat: Dict[str, np.ndarray] = {}
    params = {n: t for n, t in model_state.items() if n not in _BN_STATE}
    counts = []
    for name, t in params.items():
        key = jax_param_key(name)
        flat[f"params/{key}"] = _to_jax_layout(name, _numpy(t))
        state = opt_state.get(name, {})
        if "step" in state:
            counts.append(int(float(state["step"])))
        for moment, torch_key in _MOMENTS[optimizer]:
            m = state.get(torch_key)
            m = np.zeros(tuple(t.shape), np.float32) if m is None else _numpy(m)
            flat[f"opt_state/inner_state/1/{moment}/{key}"] = _to_jax_layout(name, m)
    for name, leaf in _BN_STATE.items():
        dtype = np.int32 if leaf == "bn_count" else np.float32
        flat[f"model_state/{leaf}"] = np.array(_numpy(model_state[name]), dtype)
    flat["opt_state/count"] = np.asarray(step, np.int32)
    flat["opt_state/hyperparams/learning_rate"] = np.asarray(lr, np.float32)
    if optimizer == "Adam":
        flat["opt_state/inner_state/1/count"] = np.asarray(max(counts, default=0), np.int32)
    flat["step"] = np.asarray(step, np.int32)
    return flat


def is_w_leaf(key: str) -> bool:
    """A leaf of the AM-Softmax ``W`` or of one of its optimizer moments:
    the leaves split by columns over the model ranks."""
    return key.split("/")[-2:] == ["amsoftmax", "W"]


def slice_columns(flat: Mapping[str, np.ndarray], lo: int, hi: int) -> Dict[str, np.ndarray]:
    """``flat`` with ``W`` and its moments cut to columns [lo, hi): a model
    rank's leaves from the whole state's."""
    return {k: (np.ascontiguousarray(np.asarray(v)[:, lo:hi]) if is_w_leaf(k) else v)
            for k, v in flat.items()}


def load_train_state(flat: Mapping[str, np.ndarray], model: torch.nn.Module,
                     optimizer: Optional[torch.optim.Optimizer] = None,
                     optimizer_name: str = "Adam",
                     columns: Optional[Tuple[int, int]] = None) -> int:
    """Read the flat leaves of a JAX-format ``TrainState`` into ``model``
    and ``optimizer`` (in place, on their devices); returns the step. Adam's
    and RMSprop's moments take the parameters' layouts; the learning rate
    is set from ``opt_state/hyperparams/learning_rate`` as float32. With
    ``columns`` the model holds only those columns of ``W`` (a model rank),
    and ``W`` and its moments are cut to them."""
    if columns is not None:
        flat = slice_columns(flat, *columns)
    state = params_from_jax(dict(flat))
    missing = set(model.state_dict()) - set(state)
    if missing:
        raise KeyError(f"train state lacks {sorted(missing)}")
    model.load_state_dict(state)
    step = int(flat["step"])
    if optimizer is None:
        return step
    if optimizer_name not in _MOMENTS:
        raise ValueError(f"unknown optimizer {optimizer_name!r}")
    lr = float(np.float32(flat["opt_state/hyperparams/learning_rate"]))
    for group in optimizer.param_groups:
        group["lr"] = lr
    count = int(flat.get("opt_state/inner_state/1/count", flat["opt_state/count"]))
    # each moment is a tree shaped like params/: params_from_jax lays it out
    moments = {}
    for moment, torch_key in _MOMENTS[optimizer_name]:
        prefix = f"opt_state/inner_state/1/{moment}/"
        moments[torch_key] = params_from_jax(
            {"params/" + k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)})
    optimizer.state.clear()
    if moments:
        for name, p in model.named_parameters():
            entry = {"step": torch.tensor(float(count), dtype=torch.float32)}
            entry.update({k: m[name].to(p.device) for k, m in moments.items()})
            optimizer.state[p] = entry
    return step
