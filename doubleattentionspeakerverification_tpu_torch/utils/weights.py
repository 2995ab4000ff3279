"""Carry the JAX package's parameters into the port's modules.

Layout rules (the JAX package's ``utils/torch_export.py:11-16``, kept here
as the port's own copy): convolution kernels go HWIO -> OIHW, linear
weights (in, out) -> (out, in); attention vectors keep the reference's
shapes; ``b2``'s scale/bias and the ``ModelState`` running statistics become
the BatchNorm's weight/bias and buffers.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


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
