"""Kernel B1: fused masked multi-head attention pooling (``csrc/mha_pool.cu``).

The counterpart of the forward of ``ops/pooling_pallas.py`` in the JAX
package: per-head scores, a masked softmax over time and the per-head
weighted sum in one pass over the encoder output, with nothing but the
(B, H, d_h) contexts written back. The plain version is the einsum + masked
softmax of ``models/poolings.py:mha_pool`` (JAX ``:115-123``), written in
torch.

``MhaPoolFunction`` gives the pooling its gradient: its forward is the
kernel on CUDA and the plain version on the CPU, and its backward
(:func:`mha_pool_backward`) is torch ops, the same on both devices, as the
JAX package's backward (``ops/pooling_pallas.py:_bwd``) is XLA ops. The
backward recomputes the weights with ``masked_softmax``, so a row of length
0 gets zero gradient, the derivative of the zero context both forwards
give (the JAX ``_bwd`` instead softmaxes such a row to uniform weights).

``mha_pool`` takes the plain version for tensors on the CPU, and on the
card where its caller passes ``use_kernel=False`` (the kernel dispatcher's
explicit plain choice, ``utils/kernel_auto.py``); otherwise a CUDA tensor
launches the kernel or raises. ``mha_pool_split_plain`` models the
kernel's own decomposition (each batch row's valid steps split over the
ranks of a cluster and the warp chains of a rank, partial states combined)
for the tests; no path runs it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from .kernels import CudaKernel
from .masked_ops import NEG_INF, length_mask, masked_softmax

_p, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "mha_pool", "mha_pool.cu", "mha_pool_fwd",
    [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _p],
)
MAX_HEAD_SIZE = 512  # csrc/mha_pool.cu: MAX_HEAD
# csrc/mha_pool.cu's constants: warps a block, partial states combined
# (R * S), G * d_h a block
MAX_WARPS, MAX_PARTS, MAX_WIDTH = 8, 16, 1280
# The plan's choices, from B1's times on an H100 (chip_smoke.py's sweep,
# PERF.md): a row gets one chain of steps for every STEPS_PER_CHAIN of T, in
# at most MAX_WARPS warps; a block holds HEADS_PER_BLOCK warps' worth of
# heads; and a row is split over a cluster of CLUSTER_RANKS ranks, each with
# the warps a rank would have alone, only above CLUSTER_ABOVE steps and
# when the launch would otherwise have at most CLUSTER_BLOCKS blocks (one or
# two long utterances), where the cluster's fixed cost (its barrier and the
# stores into the finalising rank) pays for itself by spreading the rows
# over twice the SMs.
STEPS_PER_CHAIN, HEADS_PER_BLOCK = 4, 4
CLUSTER_ABOVE, CLUSTER_RANKS, CLUSTER_BLOCKS = 192, 2, 64


def _align16(x: int) -> int:
    return (x + 15) & ~15


def chain_lanes(d_h: int, vec: int) -> int:
    """Lanes of one chain of steps (csrc/mha_pool.cu ``pick``): 8 or 16
    (four or two chains a warp) while a lane's pieces of one step stay few,
    else 32."""
    pieces = d_h // vec
    if pieces <= 16:
        return 8
    return 16 if pieces <= {4: 48, 8: 32, 1: 64}[vec] else 32


def launch_plan(b: int, t: int, heads: int, d_h: int, elt: int, ht_ptr: int = 0,
                q_ptr: int = 0) -> Dict[str, int]:
    """The kernel's launch for ht (b, t, heads, d_h) of ``elt``-byte values
    at ``ht_ptr`` and q at ``q_ptr``: R ranks a cluster (one cluster per
    head group and batch row, each rank taking 1/R of a row's valid steps),
    S warps a head (each taking every S-th group of its rank's steps, split
    over its chains of ``chain_lanes`` lanes), G heads a block, ``vec`` the
    values of a lane's piece (16 bytes' worth where ht and q are 16-byte
    aligned and a head's values are whole 16-byte pieces, else 1), and the
    dynamic shared memory a block (csrc/mha_pool.cu ``layout``: the
    combine's buffers)."""
    vec = 16 // elt if ht_ptr % 16 == 0 and q_ptr % 16 == 0 and (d_h * elt) % 16 == 0 else 1
    lanes = chain_lanes(d_h, vec)
    chains = max(1, -(-t // STEPS_PER_CHAIN))
    warps = min(MAX_WARPS, 1 << (-(-chains * lanes // 32) - 1).bit_length())
    g = max(1, min(heads, HEADS_PER_BLOCK // warps, MAX_WIDTH // d_h))
    r = CLUSTER_RANKS if t > CLUSTER_ABOVE and b * -(-heads // g) <= CLUSTER_BLOCKS else 1
    s = warps
    share = -(-(g * d_h // vec) // r)
    smem = 16 + _align16(r * s * share * vec * 4) + r * s * g * 8
    return dict(ranks=r, warps_per_head=s, heads_per_block=g, vec=vec, chain_lanes=lanes,
                smem=smem, blocks=r * -(-heads // g) * b)


def mha_pool_weights(ht4: torch.Tensor, q_t: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The masked softmax weights over time (B, T, H) of float32 ht4
    (B, T, H, d_h) and q_t (H, d_h) with the scale folded in."""
    scores = torch.einsum("bthd,hd->bth", ht4, q_t)
    return masked_softmax(scores, length_mask(lengths, ht4.shape[1])[..., None], dim=1)


def mha_pool_plain(ht4: torch.Tensor, q_t: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """ht4 (B, T, H, d_h), q_t (H, d_h) with the scale folded in, lengths
    (B,) -> contexts (B, H, d_h) float32."""
    ht4 = ht4.to(torch.float32)
    w = mha_pool_weights(ht4, q_t, lengths)
    return torch.einsum("bth,bthd->bhd", w, ht4)


def mha_pool_split_plain(ht4: torch.Tensor, q_t: torch.Tensor, lengths: torch.Tensor,
                         ranks: int, chains: int = 1) -> torch.Tensor:
    """:func:`mha_pool_plain` as the kernel decomposes it: batch row b's
    len_b valid steps (lengths clamped to [0, T]) split into ``ranks``
    consecutive runs of ceil(len_b / ranks) steps, each run split again
    into ``chains`` interleaved chains (chain s takes the run's steps s,
    s + chains, ...), a partial (m, l, acc) per chain (m = -1e30, l = 0,
    acc = 0 for an empty one), and all ranks * chains partials combined by
    exp(m_i - M), divided by max(L, 1e-30)."""
    ht4 = ht4.to(torch.float32)
    t = ht4.shape[1]
    scores = torch.einsum("bthd,hd->bth", ht4, q_t)
    length = lengths.to(torch.int64).clamp(0, t)
    per = (length + ranks - 1) // ranks
    steps = torch.arange(t, device=ht4.device)
    parts = []
    for r in range(ranks):
        t0 = torch.minimum(length, r * per)
        t1 = torch.minimum(length, t0 + per)
        for c in range(chains):
            own = steps[None, :] - t0[:, None]
            mask = ((own >= c) & (own % chains == c) & (steps[None, :] < t1[:, None]))[..., None]
            s = torch.where(mask, scores, NEG_INF)
            m = s.amax(dim=1)                                           # (B, H)
            e = torch.where(mask, torch.exp(s - m[:, None]), 0.0)
            parts.append((m, e.sum(dim=1), torch.einsum("bth,bthd->bhd", e, ht4)))
    big_m = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    den = torch.zeros_like(big_m)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        c = torch.exp(m - big_m)
        den = den + l * c
        acc = acc + a * c[..., None]
    return acc / torch.clamp(den, min=1e-30)[..., None]


def mha_pool_cuda(ht4: torch.Tensor, q_t: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors; same arguments as :func:`mha_pool_plain`."""
    if not (ht4.device.type == q_t.device.type == lengths.device.type == "cuda"):
        raise ValueError("mha_pool_cuda needs CUDA tensors")
    if ht4.dim() != 4 or ht4.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ht4 must be (B, T, H, d_h) float32/bfloat16, got {tuple(ht4.shape)} {ht4.dtype}")
    b, t, heads, d_h = ht4.shape
    if q_t.shape != (heads, d_h) or q_t.dtype != torch.float32:
        raise ValueError(f"q_t must be ({heads}, {d_h}) float32, got {tuple(q_t.shape)} {q_t.dtype}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be ({b},) int32, got {tuple(lengths.shape)} {lengths.dtype}")
    if d_h > MAX_HEAD_SIZE:
        raise ValueError(f"head size {d_h} exceeds the kernel's {MAX_HEAD_SIZE}")
    if not (ht4.is_contiguous() and q_t.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("mha_pool_cuda takes contiguous tensors")
    out = torch.empty((b, heads, d_h), dtype=torch.float32, device=ht4.device)
    if b == 0 or heads == 0 or d_h == 0:
        return out
    plan = launch_plan(b, t, heads, d_h, ht4.element_size(), ht4.data_ptr(), q_t.data_ptr())
    KERNEL.launch(
        ht4.data_ptr(), q_t.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, t, heads, d_h, int(ht4.dtype == torch.bfloat16), plan["heads_per_block"],
        plan["warps_per_head"], plan["ranks"], plan["vec"],
        torch.cuda.current_stream(ht4.device).cuda_stream,
    )
    return out


def mha_pool_backward(ht4: torch.Tensor, q_t: torch.Tensor, lengths: torch.Tensor,
                      g: torch.Tensor):
    """The gradient of :func:`mha_pool_plain` for the upstream g (B, H, d_h):
    (d_ht4 in ht4's dtype, d_q_t), in float32. With w the masked softmax
    weights and gv = <g, ht>: ds = w * (gv - sum_t w * gv),
    d_ht = w * g + ds * q_t, d_q_t = sum_{b,t} ds * ht."""
    x = ht4.to(torch.float32)
    g = g.to(torch.float32)
    w = mha_pool_weights(x, q_t, lengths)
    gv = torch.einsum("bthd,bhd->bth", x, g)
    ds = w * (gv - (w * gv).sum(dim=1, keepdim=True))
    d_ht = w[..., None] * g[:, None] + ds[..., None] * q_t
    d_q = torch.einsum("bth,bthd->hd", ds, x)
    return d_ht.to(ht4.dtype), d_q


class MhaPoolFunction(torch.autograd.Function):
    """B1 with a gradient: (ht4, q_t, lengths, use_kernel) -> contexts
    (B, H, d_h); the plain forward on the CPU or where ``use_kernel`` is
    False, the same backward either way."""

    @staticmethod
    def forward(ctx, ht4, q_t, lengths, use_kernel=True):
        ctx.save_for_backward(ht4, q_t, lengths)
        if ht4.device.type == "cpu" or not use_kernel:
            return mha_pool_plain(ht4, q_t, lengths)
        return mha_pool_cuda(ht4.contiguous(), q_t, lengths.contiguous())

    @staticmethod
    def backward(ctx, g):
        ht4, q_t, lengths = ctx.saved_tensors
        d_ht, d_q = mha_pool_backward(ht4, q_t, lengths, g)
        return (d_ht if ctx.needs_input_grad[0] else None,
                d_q if ctx.needs_input_grad[1] else None, None, None)


def _operands(ht: torch.Tensor, query: torch.Tensor, lengths: Optional[torch.Tensor],
              heads: int, dk_is_heads: bool):
    """(ht4, q_t, int32 lengths) of ht (B, T, D) and query (d_h, H): the
    score scale, 1/sqrt(heads) under the reference's ``d_k = heads`` quirk,
    else 1/sqrt(d_h), folded into the query."""
    b, t, d = ht.shape
    d_h = d // heads
    scale = 1.0 / math.sqrt(float(heads if dk_is_heads else d_h))
    q_t = (query.t() * scale).to(torch.float32).contiguous()
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int32, device=ht.device)
    return ht.reshape(b, t, heads, d_h), q_t, lengths.to(torch.int32)


def mha_pool(
    ht: torch.Tensor,
    query: torch.Tensor,
    lengths: Optional[torch.Tensor],
    heads: int,
    dk_is_heads: bool = True,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Counterpart of ``mha_pool_pallas``: ht (B, T, D), query (d_h, H) as in
    the reference -> (B, H, d_h). Autograd carries the folded scale and the
    transpose back to ``query``. ``use_kernel=False`` takes the plain
    version on the card too."""
    return MhaPoolFunction.apply(*_operands(ht, query, lengths, heads, dk_is_heads),
                                 use_kernel)


def mha_pool_alignments(ht: torch.Tensor, query: torch.Tensor, lengths: Optional[torch.Tensor],
                        heads: int, dk_is_heads: bool = True) -> torch.Tensor:
    """The time weights (B, T, H) that :func:`mha_pool` pools with, from the
    plain version on any device: B1 returns the contexts, not the weights
    (the JAX package takes its XLA path here, ``models/classifier.py:150``)."""
    ht4, q_t, lengths = _operands(ht, query, lengths, heads, dk_is_heads)
    return mha_pool_weights(ht4.to(torch.float32), q_t, lengths)
