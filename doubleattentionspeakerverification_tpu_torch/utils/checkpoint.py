"""Read the JAX package's ``.npz`` checkpoints with numpy alone.

The format (JAX ``utils/checkpoint.py:28-58``): one ``.npz`` whose entries
are the leaves of the saved tree, keyed by their path joined with "/"
(``params/vgg/conv11/w``, ``model_state/bn_mean``, ``opt_state/...``), plus
``__meta__``, a uint8 array holding the UTF-8 JSON of the run's metadata,
whose ``config`` is the full ``ExperimentConfig``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """-> (flat leaves keyed by path, meta)."""
    with np.load(path, allow_pickle=False) as z:
        if "__meta__" not in z.files:
            raise ValueError(f"{path} has no __meta__ entry; not a checkpoint of this format")
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    return flat, meta
