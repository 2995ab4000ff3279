"""Analytic FLOP accounting for the model (JAX ``models/flops.py``), on the
port's ``vgg`` and ``poolings`` helpers.

Counts multiply-adds as 2 FLOPs. Conv: H*W*Cin*Cout*9*2 per sample (3x3,
stride 1, SAME). Pooling, the fully connected layers and AM-Softmax are
included; the VGG stack is almost all of it at the paper's configuration
(about 45.6 GFLOP for one 3.5 s sample's forward).
"""

from __future__ import annotations

import math

from ..config import ModelConfig
from .poolings import pooled_dim
from .vgg import vgg_channel_plan, vgg_output_dim


def vgg_forward_flops(cfg: ModelConfig, t: int, f: int = 80) -> float:
    plan = vgg_channel_plan(cfg.front_end, cfg.kernel_size)
    total = 0.0
    ct, cf = t, f
    for cin, cout in plan:
        total += ct * cf * cin * cout * 9 * 2   # convN1
        total += ct * cf * cout * cout * 9 * 2  # convN2
        ct, cf = math.ceil(ct / 2), math.ceil(cf / 2)
    return total


def head_forward_flops(cfg: ModelConfig, t: int, f: int = 80) -> float:
    n_blocks = 3 if cfg.front_end == "VGG3L" else 4
    t_out = t
    for _ in range(n_blocks):
        t_out = math.ceil(t_out / 2)
    d = vgg_output_dim(cfg.front_end, cfg.kernel_size, f)
    pool = 2 * t_out * d * 2                      # scores + weighted sum
    vec = pooled_dim(cfg.pooling_method, d, cfg.heads_number)
    emb = cfg.embedding_size
    fc = 2 * (vec * emb + emb * emb + emb * emb)  # fc1, fc2, preLayer
    ams = 2 * emb * cfg.num_spkrs
    return pool + fc + ams


def forward_flops_per_sample(cfg: ModelConfig, t: int, f: int = 80) -> float:
    """Total forward FLOPs for one sample of t frames."""
    return vgg_forward_flops(cfg, t, f) + head_forward_flops(cfg, t, f)


def train_flops_per_sample(cfg: ModelConfig, t: int, f: int = 80) -> float:
    """fwd + bwd ~ 3x fwd (standard conv dL/dx + dL/dw accounting)."""
    return 3.0 * forward_flops_per_sample(cfg, t, f)
