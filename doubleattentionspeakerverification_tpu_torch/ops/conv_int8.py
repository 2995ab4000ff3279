"""Kernel B3: SAME 3x3 int8 convolution with a fused requantize epilogue
(``csrc/conv_int8.cu``).

The counterpart of ``conv3x3_int8_fused`` in the JAX package's
``ops/conv_int8_pallas.py``: q (B, T, F, Cin) int8, channels last, and the
taps w9 (9, Cin, Cout) int8 give the exact int32 sums of the 3x3 window;
the epilogue ``v = float(acc) * mult + bias`` (a multiply and an add, each
rounded to nearest, no FMA) then writes

- ``out_kind="int8"``: ``clip(round_half_even(v), 0, 127)``, the next
  conv's input already on its scale;
- ``"float32"`` / ``"bfloat16"``: ``relu(v)`` in that type.

The plain version computes the sums as an exact float64 convolution (nine
shifted float64 products: every partial sum is an integer below
9·Cin·127² < 2⁵³, so no algorithm can round it; float32 would round for
Cin ≥ 128) and applies the same epilogue in torch.

``conv3x3_int8`` takes the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .kernels import CudaKernel

_p, _i = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p]
KERNEL = CudaKernel("conv_int8", "conv_int8.cu", "conv3x3_int8_fused", ARGTYPES)
KC = 32  # input channels per chunk of the packed weights (csrc/conv_int8.cu)
OUT_KINDS = {"int8": (torch.int8, 0), "float32": (torch.float32, 1),
             "bfloat16": (torch.bfloat16, 2)}


def _out_dtype(out_kind: str) -> torch.dtype:
    if out_kind not in OUT_KINDS:
        raise ValueError(f"out_kind must be one of {sorted(OUT_KINDS)}, got {out_kind!r}")
    return OUT_KINDS[out_kind][0]


def pack_weights(w9: torch.Tensor) -> torch.Tensor:
    """(9, Cin, Cout) int8 taps -> the kernel's (ceil(Cin/32), 9, Cout, 32)
    layout, input channels past Cin zero. Made once per conv."""
    nine, cin, cout = w9.shape
    n_chunks = -(-cin // KC)
    padded = torch.zeros((nine, n_chunks * KC, cout), dtype=torch.int8, device=w9.device)
    padded[:, :cin] = w9
    return padded.reshape(nine, n_chunks, KC, cout).permute(1, 0, 3, 2).contiguous()


def conv3x3_int8_sums(q: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """The exact window sums (B, T, F, Cout) as float64."""
    b, t, f, _ = q.shape
    x = F.pad(q.to(torch.float64), (0, 0, 1, 1, 1, 1))
    w = w9.to(torch.float64)
    acc = None
    for k in range(9):
        dt, df = divmod(k, 3)
        term = x[:, dt:dt + t, df:df + f, :] @ w[k]
        acc = term if acc is None else acc.add_(term)
    return acc


def requantize(acc: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
               out_kind: str = "int8") -> torch.Tensor:
    """The fused epilogue on float32 sums: a separate multiply and add."""
    v = acc * mult
    v = v + bias
    if out_kind == "int8":
        return torch.clamp(torch.round(v), 0, 127).to(torch.int8)
    return torch.relu(v).to(_out_dtype(out_kind))


def conv3x3_int8_plain(q: torch.Tensor, w9: torch.Tensor, mult: torch.Tensor,
                       bias: torch.Tensor, out_kind: str = "int8") -> torch.Tensor:
    """q (B, T, F, Cin) int8, w9 (9, Cin, Cout) int8, mult and bias (Cout,)
    float32 -> (B, T, F, Cout) of ``out_kind``."""
    _out_dtype(out_kind)
    acc = conv3x3_int8_sums(q, w9).to(torch.float32)   # round to nearest even
    return requantize(acc, mult.to(torch.float32), bias.to(torch.float32), out_kind)


def conv3x3_int8_cuda(q: torch.Tensor, w_packed: torch.Tensor, mult: torch.Tensor,
                      bias: torch.Tensor, out_kind: str = "int8",
                      symbol: Optional[str] = None) -> torch.Tensor:
    """The kernel on CUDA tensors: q (B, T, F, Cin) int8, ``w_packed`` from
    :func:`pack_weights`. ``symbol`` selects one of the library's timing
    variants (``tools/conv_int8_probe.py``)."""
    dtype = _out_dtype(out_kind)
    tensors = (q, w_packed, mult, bias)
    if any(x.device.type != "cuda" for x in tensors):
        raise ValueError("conv3x3_int8_cuda needs CUDA tensors")
    if q.dim() != 4 or q.dtype != torch.int8:
        raise ValueError(f"q must be (B, T, F, Cin) int8, got {tuple(q.shape)} {q.dtype}")
    b, t, f, cin = q.shape
    n_chunks = -(-cin // KC)
    if (w_packed.dim() != 4 or w_packed.dtype != torch.int8
            or w_packed.shape[0] != n_chunks or w_packed.shape[1] != 9 or w_packed.shape[3] != KC):
        raise ValueError(f"w_packed must be ({n_chunks}, 9, Cout, {KC}) int8, "
                         f"got {tuple(w_packed.shape)} {w_packed.dtype}")
    cout = w_packed.shape[2]
    for name, v in (("mult", mult), ("bias", bias)):
        if v.shape != (cout,) or v.dtype != torch.float32:
            raise ValueError(f"{name} must be ({cout},) float32, got {tuple(v.shape)} {v.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("conv3x3_int8_cuda takes contiguous tensors")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    out = torch.empty((b, t, f, cout), dtype=dtype, device=q.device)
    if out.numel() == 0:
        return out
    KERNEL.launch(
        q.data_ptr(), w_packed.data_ptr(), mult.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, t, f, cin, cout, OUT_KINDS[out_kind][1],
        torch.cuda.current_stream(q.device).cuda_stream,
        symbol=symbol,
    )
    return out


def conv3x3_int8(q: torch.Tensor, w9: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
                 out_kind: str = "int8", w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Counterpart of ``conv3x3_int8_fused``: the plain version on the CPU,
    the kernel on the card (``w_packed``, when given, is
    ``pack_weights(w9)`` made once at fold time)."""
    if q.device.type == "cpu":
        return conv3x3_int8_plain(q, w9, mult, bias, out_kind)
    if w_packed is None:
        w_packed = pack_weights(w9)
    return conv3x3_int8_cuda(q.contiguous(), w_packed, mult.contiguous(), bias.contiguous(),
                             out_kind)
