"""Kernel B1: fused masked multi-head attention pooling (``csrc/mha_pool.cu``).

The counterpart of the forward of ``ops/pooling_pallas.py`` in the JAX
package: per-head scores, a masked softmax over time and the per-head
weighted sum in one pass over the encoder output, with nothing but the
(B, H, d_h) contexts written back. The plain version is the einsum + masked
softmax of ``models/poolings.py:mha_pool`` (JAX ``:115-123``), written in
torch. The backward comes with the training slice.

``mha_pool`` takes the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .kernels import CudaKernel
from .masked_ops import length_mask, masked_softmax

_p, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "mha_pool", "mha_pool.cu", "mha_pool_fwd",
    [_p, _p, _p, _p, _i, _i, _i, _i, _i, _p],
)
MAX_HEAD_SIZE = 512  # csrc/mha_pool.cu: 32 lanes x MAX_PL values


def mha_pool_plain(ht4: torch.Tensor, q_t: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """ht4 (B, T, H, d_h), q_t (H, d_h) with the scale folded in, lengths
    (B,) -> contexts (B, H, d_h) float32."""
    ht4 = ht4.to(torch.float32)
    t = ht4.shape[1]
    scores = torch.einsum("bthd,hd->bth", ht4, q_t)
    mask = length_mask(lengths, t)[..., None]
    w = masked_softmax(scores, mask, dim=1)
    return torch.einsum("bth,bthd->bhd", w, ht4)


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
    KERNEL.launch(
        ht4.data_ptr(), q_t.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, t, heads, d_h, int(ht4.dtype == torch.bfloat16),
        torch.cuda.current_stream(ht4.device).cuda_stream,
    )
    return out


def mha_pool(
    ht: torch.Tensor,
    query: torch.Tensor,
    lengths: Optional[torch.Tensor],
    heads: int,
    dk_is_heads: bool = True,
) -> torch.Tensor:
    """Counterpart of ``mha_pool_pallas``: ht (B, T, D), query (d_h, H) as in
    the reference -> (B, H, d_h). The score scale is 1/sqrt(heads) under the
    reference's ``d_k = heads`` quirk, else 1/sqrt(d_h); it is folded into
    the query."""
    b, t, d = ht.shape
    d_h = d // heads
    scale = 1.0 / math.sqrt(float(heads if dk_is_heads else d_h))
    ht4 = ht.reshape(b, t, heads, d_h)
    q_t = (query.t() * scale).to(torch.float32).contiguous()
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int32, device=ht.device)
    lengths = lengths.to(torch.int32)
    if ht.device.type == "cpu":
        return mha_pool_plain(ht4, q_t, lengths)
    return mha_pool_cuda(ht4.contiguous(), q_t, lengths.contiguous())
