"""The speaker classifier (reference ``model.py:8-71``).

VGG -> pooling -> fc1+ReLU -> fc2+ReLU -> BatchNorm ``b2`` -> the scoring
embedding the reference taps in ``getEmbedding`` (``model.py:52-59``; JAX
``models/classifier.py:116-147``) -> preLayer -> AM-Softmax, the training
head (``model.py:61-71``; JAX ``:190-222``). The reference's b1/b3
BatchNorms are never applied and are not built.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..parallel.distributed import all_reduce_sum
from .amsoftmax import AMSoftmax
from .poolings import DoubleMHAPooling, make_pooling, pooled_dim
from .vgg import VGG, vgg_output_dim


def encoder_dim(cfg: ModelConfig) -> int:
    return vgg_output_dim(cfg.front_end, cfg.kernel_size, cfg.feature_size)


class BatchNorm(nn.BatchNorm1d):
    """``BatchNorm1d`` whose ``train()`` forward is the JAX package's
    ``_batch_norm``: normalize by the biased batch variance, move the running
    mean and variance by ``momentum`` toward the batch mean and the unbiased
    variance (var * n / max(1, n - 1), so a batch of one item gives variance 0
    and the output is the bias, where torch's own raises), and count the
    batch in ``num_batches_tracked``. ``eval()`` is torch's.

    With ``group`` (the data ranks' process group, given by the train step)
    the batch is the global one, as under JAX's data sharding (JAX
    ``models/classifier.py:10-12``): the count and the sum, then the sum of
    squared deviations from the global mean, are summed over the group by
    differentiable all-reduces, and every rank moves its running statistics
    by the same global moments."""

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if group is None:
            mean = x.mean(dim=0)
            var = ((x - mean) ** 2).mean(dim=0)
            n = x.shape[0]
            unbias = n / max(1, n - 1)
        else:
            stats = all_reduce_sum(torch.cat([x.sum(dim=0), x.new_full((1,), x.shape[0])]), group)
            n = stats[-1]
            mean = stats[:-1] / n
            var = all_reduce_sum(((x - mean) ** 2).sum(dim=0), group) / n
            unbias = n / torch.clamp(n - 1, min=1)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * (var * unbias))
            self.num_batches_tracked.add_(1)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class SpeakerClassifier(nn.Module):
    """The embedding trunk and the training head. ``forward`` is the
    scoring embedding (``eval()`` for serving: ``b2`` normalizes with its
    running statistics); ``classify`` is the training forward."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        enc = encoder_dim(cfg)
        emb = cfg.embedding_size
        self.vgg = VGG(cfg)
        self.pooling = make_pooling(cfg, enc)
        self.fc1 = nn.Linear(pooled_dim(cfg.pooling_method, enc, cfg.heads_number), emb)
        self.fc2 = nn.Linear(emb, emb)
        self.b2 = BatchNorm(emb, eps=cfg.bn_eps, momentum=cfg.bn_momentum)
        self.pre_layer = nn.Linear(emb, emb)
        self.amsoftmax = AMSoftmax(emb, cfg.num_spkrs)

    def tail(self, enc: torch.Tensor, enc_len: Optional[torch.Tensor],
             keep: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
        """Everything after the encoder (JAX ``trunk_tail``): pooling -> fc1
        -> fc2 -> ``b2``. The int8 encoders (``models/quantized.py``) share it.
        In ``train()``, ``keep`` is DoubleMHA's head-dropout mask and ``group``
        the data ranks over which ``b2`` takes its batch statistics."""
        if isinstance(self.pooling, DoubleMHAPooling):
            pooled = self.pooling(enc, enc_len, keep)
        else:
            pooled = self.pooling(enc, enc_len)
        e1 = F.relu(self.fc1(pooled))
        e2 = F.relu(self.fc2(e1))
        return self.b2(e2, group)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, F) normalized log-mel (+ valid lengths) -> (B, emb)."""
        return self.tail(*self.vgg(x, lengths))

    def classifier_features(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                            keep: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
        """Trunk + preLayer: the (B, emb) vector the AM-Softmax head takes."""
        return self.pre_layer(self.tail(*self.vgg(x, lengths), keep, group))

    def classify(self, x: torch.Tensor, labels: torch.Tensor, step,
                 lengths: Optional[torch.Tensor] = None, keep: Optional[torch.Tensor] = None,
                 group=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full forward (JAX ``speaker_classifier_apply``): (costh, scaled
        margin logits), (B, num_spkrs) each."""
        return self.amsoftmax(self.classifier_features(x, lengths, keep, group), labels,
                              step, self.cfg)


@torch.no_grad()
def get_alignments(model: SpeakerClassifier, x: torch.Tensor,
                   lengths: Optional[torch.Tensor] = None):
    """The pooling's attention weights (JAX ``models/classifier.py:150``;
    reference ``DoubleMHA.getAlignments`` / ``MultiHeadAttention.getAlignments``,
    ``poolings.py:95-101,119-123``): the time weights (B, T', H), or (B, T')
    for single-head ``Attention``, and for DoubleMHA also the head weights
    (B, H). Always the plain masked softmax: kernel B1 returns the contexts,
    not the weights."""
    alignments = getattr(model.pooling, "alignments", None)
    if alignments is None:
        raise ValueError(f"no alignments for pooling_method {model.cfg.pooling_method!r}")
    return alignments(*model.vgg(x, lengths))
