"""Read the reference's PyTorch ``.chkpt`` files (the port's own copy of the
JAX package's ``utils/torch_import.py``).

The reference saves ``{'model': state_dict, 'optimizer': ..., 'settings':
argparse.Namespace, 'epoch', 'step'}`` (``utils.py:23-40``). Its tensors are
already in torch's layouts (convolutions OIHW, linears (out, in), the
AM-Softmax ``W`` (in_feats, n_classes)), so nothing is transposed; only the
names change to the port's modules. The ``b1``/``b3`` BatchNorms, defined
but never applied by the reference (``model.py:43-59``), are skipped.
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import torch

from ..config import ExperimentConfig, ModelConfig, TrainConfig

# reference name prefix -> the port's, longest first; a key that matches none
# (b1.*, b3.*) is skipped
RENAMES = (
    ("poolingLayer.utteranceAttention.", "pooling.mha."),
    ("poolingLayer.headsAttention.", "pooling.head_att."),
    ("poolingLayer.", "pooling."),
    ("front_end.", "vgg."),
    ("preLayer.", "pre_layer."),
    ("predictionLayer.", "amsoftmax."),
    ("fc1.", "fc1."),
    ("fc2.", "fc2."),
    ("b2.", "b2."),
)


def import_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference ``SpeakerClassifier.state_dict()`` -> the port's
    ``SpeakerClassifier`` state dict (float32; ``b2.num_batches_tracked``
    int64, 0 where the file has none)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        for old, new in RENAMES:
            if key.startswith(old):
                t = torch.as_tensor(value).detach().cpu()
                out[new + key[len(old):]] = t.to(torch.int64 if key.endswith(
                    "num_batches_tracked") else torch.float32).clone()
                break
    out.setdefault("b2.num_batches_tracked", torch.zeros((), dtype=torch.int64))
    return out


def config_from_namespace(ns) -> ExperimentConfig:
    """The reference's pickled argparse Namespace (``train.py:294-303``) -> config."""
    def g(k, d):
        return getattr(ns, k, d)

    model = ModelConfig(
        front_end=g("front_end", "VGG4L"),
        kernel_size=g("kernel_size", 1024),
        embedding_size=g("embedding_size", 400),
        heads_number=g("heads_number", 32),
        pooling_method=g("pooling_method", "DoubleMHA"),
        mask_prob=g("mask_prob", 0.3),
        num_spkrs=g("num_spkrs", 5994),
        scaling_factor=g("scalingFactor", 30.0),
        margin_factor=g("marginFactor", 0.4),
        annealing=g("annealing", False),
    )
    train = TrainConfig(
        window_size=g("window_size", 3.5),
        normalization=g("normalization", "cmn"),
        optimizer=g("optimizer", "Adam"),
        learning_rate=g("learning_rate", 1e-4),
        weight_decay=g("weight_decay", 1e-3),
        batch_size=g("batch_size", 64),
        gradient_accumulation=g("gradientAccumulation", 2),
    )
    return ExperimentConfig(model_name=g("model_name", "CNN"), model=model, train=train)


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], ExperimentConfig, int, int]:
    """A reference ``.chkpt`` -> (the port's state dict, config, epoch, step).

    Loaded with ``weights_only=True``, which refuses pickled objects beyond
    tensors and plain containers; the one other class the format holds,
    ``argparse.Namespace`` under ``settings``, is allowed by name."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    cfg = config_from_namespace(ckpt["settings"])
    return import_state_dict(ckpt["model"]), cfg, ckpt.get("epoch", 0), ckpt.get("step", 0)
