"""The embedding trunk of the speaker classifier (reference ``model.py:8-71``).

VGG -> pooling -> fc1+ReLU -> fc2+ReLU -> BatchNorm ``b2`` -> the scoring
embedding the reference taps in ``getEmbedding`` (``model.py:52-59``; JAX
``models/classifier.py:116-147``). The reference's b1/b3 BatchNorms are
never applied and are not built. The training head (preLayer, AM-Softmax)
comes with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from .poolings import make_pooling, pooled_dim
from .vgg import VGG, vgg_output_dim


def encoder_dim(cfg: ModelConfig) -> int:
    return vgg_output_dim(cfg.front_end, cfg.kernel_size, cfg.feature_size)


class SpeakerClassifier(nn.Module):
    """Eval-mode embedding model; ``b2`` has torch ``BatchNorm1d`` semantics
    and, in ``eval()``, normalizes with its running statistics."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        enc = encoder_dim(cfg)
        emb = cfg.embedding_size
        self.vgg = VGG(cfg)
        self.pooling = make_pooling(cfg, enc)
        self.fc1 = nn.Linear(pooled_dim(cfg.pooling_method, enc, cfg.heads_number), emb)
        self.fc2 = nn.Linear(emb, emb)
        self.b2 = nn.BatchNorm1d(emb, eps=cfg.bn_eps, momentum=cfg.bn_momentum)

    def tail(self, enc: torch.Tensor, enc_len: Optional[torch.Tensor]) -> torch.Tensor:
        """Everything after the encoder (JAX ``trunk_tail``): pooling -> fc1
        -> fc2 -> ``b2``. The int8 encoders (``models/quantized.py``) share it."""
        pooled = self.pooling(enc, enc_len)
        e1 = F.relu(self.fc1(pooled))
        e2 = F.relu(self.fc2(e1))
        return self.b2(e2)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, F) normalized log-mel (+ valid lengths) -> (B, emb)."""
        return self.tail(*self.vgg(x, lengths))
