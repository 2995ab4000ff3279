"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the card's data-sheet peaks, the model's analytic FLOPs and
the bytes kernels B1 and B2 must move.

Copied from the port: the peaks and ``bound_ms`` from
``tools/timing.py``, the FLOP count from ``models/flops.py`` (a multiply-add
is 2 FLOPs; training is 3 forwards), and the byte counts that
``chip_smoke.py`` sets B1's and B2's bounds by. B2's FFT plan for
``n_fft`` 512 (four radix-4 stages on a packed 256-point transform) is held
as the numbers it gives, so this file needs nothing of the port.
"""

from __future__ import annotations

import math
from typing import Tuple

# NVIDIA's data sheet, H100 SXM at its full 700 W, dense
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12        # CUDA cores, outside the tensor cores
BF16_OPS_PER_S = 989e12       # tensor cores

PEAK_BY_DTYPE = {"float32": FP32_OPS_PER_S, "bfloat16": BF16_OPS_PER_S}


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float) -> Tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- FLOPs
def vgg_channel_plan(kernel_size: int, front_end: str = "VGG4L"):
    k = kernel_size
    chans = [k // 4, k // 2, k] if front_end == "VGG3L" else [k // 8, k // 4, k // 2, k]
    plan, prev = [], 1
    for c in chans:
        plan.append((prev, c))
        prev = c
    return plan


def conv_forward_flops(kernel_size: int, t: int, f: int = 80, front_end: str = "VGG4L") -> float:
    """Direct-form 3x3 SAME convolutions of the VGG stack for one sample of
    ``t`` frames."""
    total, ct, cf = 0.0, t, f
    for cin, cout in vgg_channel_plan(kernel_size, front_end):
        total += ct * cf * cin * cout * 9 * 2
        total += ct * cf * cout * cout * 9 * 2
        ct, cf = math.ceil(ct / 2), math.ceil(cf / 2)
    return total


def tail_forward_flops(kernel_size: int, heads: int, embedding: int, t: int, f: int = 80,
                       num_spkrs: int = 0, front_end: str = "VGG4L") -> float:
    """DoubleMHA pooling (scores and weighted sum), fc1, fc2, preLayer and,
    where ``num_spkrs`` is given, the AM-Softmax product."""
    blocks = 3 if front_end == "VGG3L" else 4
    t_out, f_out = t, f
    for _ in range(blocks):
        t_out, f_out = math.ceil(t_out / 2), math.ceil(f_out / 2)
    d = f_out * kernel_size
    pool = 2 * t_out * d * 2
    vec = d // heads
    fc = 2 * (vec * embedding + embedding * embedding + embedding * embedding)
    return pool + fc + 2 * embedding * num_spkrs


def forward_flops(m: dict, t: int, head: bool = True) -> float:
    """One sample's forward at the configuration ``m`` (the config file's
    keys); ``head`` counts the AM-Softmax product, which serving skips."""
    return conv_forward_flops(m["kernel_size"], t, 80, m["front_end"]) + tail_forward_flops(
        m["kernel_size"], m["heads_number"], m["embedding_size"], t, 80,
        m["num_spkrs"] if head else 0, m["front_end"])


def train_step_flops(m: dict, frames: int) -> float:
    """A train step of ``batch_size * gradientAccumulation`` windows: three
    forwards each (the backward's two products a layer)."""
    return 3.0 * m["batch_size"] * m["gradientAccumulation"] * forward_flops(m, frames)


def train_step_conv_flops(m: dict, frames: int) -> float:
    return 3.0 * m["batch_size"] * m["gradientAccumulation"] * conv_forward_flops(
        m["kernel_size"], frames, 80, m["front_end"])


# ------------------------------------------------------------------ bytes
N_FFT, HOP, N_MELS = 512, 160, 80
B2_BAND_BINS = 500          # nonzero bins of the 80 Slaney mel filters at n_fft 512
B2_PLAN_BYTES = 72 + 4904 + 640   # plan header, twiddle table, mel bands


def frames_of(samples: int) -> int:
    return max(0, 1 + (samples - N_FFT) // HOP)


def b2_bytes(samples: int, batch: int = 1) -> float:
    """B2 for ``batch`` uploads of ``samples``: audio in, features out, its
    window, mel weights and plan read once."""
    t = frames_of(samples)
    return float(4 * (batch * samples + batch * t * N_MELS + N_FFT + B2_BAND_BINS)
                 + B2_PLAN_BYTES)


def pooled_steps(frames: int, blocks: int = 4) -> int:
    for _ in range(blocks):
        frames = (frames + 1) // 2
    return frames


def b1_bytes(valid_steps: int, rows: int, heads: int, d_h: int) -> float:
    """B1 for one launch: the valid rows of ht once, the scaled query, the
    lengths and the (rows, heads, d_h) contexts, float32."""
    return float((valid_steps * heads * d_h + heads * d_h + rows + rows * heads * d_h) * 4)
