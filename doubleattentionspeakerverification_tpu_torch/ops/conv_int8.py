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
# the kernel's tiling (csrc/conv_int8.cu): positions and output channels per
# block, input channels per chunk of the packed weights
BM, BN, KC = 256, 128, 32
OUT_KINDS = {"int8": (torch.int8, 0), "float32": (torch.float32, 1),
             "bfloat16": (torch.bfloat16, 2)}


def _out_dtype(out_kind: str) -> torch.dtype:
    if out_kind not in OUT_KINDS:
        raise ValueError(f"out_kind must be one of {sorted(OUT_KINDS)}, got {out_kind!r}")
    return OUT_KINDS[out_kind][0]


def packed_shape(cin: int, cout: int):
    """(N tiles, chunks, tap, 8-row group, K half, row, byte): one contiguous
    block of 9 x 128 x 32 bytes per N tile and chunk, each tap in wgmma's
    no-swizzle K-major core-matrix order."""
    return (-(-cout // BN), -(-cin // KC), 9, BN // 8, 2, 8, 16)


def pack_weights(w9: torch.Tensor) -> torch.Tensor:
    """(9, Cin, Cout) int8 taps -> the kernel's :func:`packed_shape` layout,
    input channels past Cin and outputs past Cout zero. Made once per conv."""
    nine, cin, cout = w9.shape
    n_tiles, n_chunks = packed_shape(cin, cout)[:2]
    padded = torch.zeros((nine, n_chunks * KC, n_tiles * BN), dtype=torch.int8, device=w9.device)
    padded[:, :cin, :cout] = w9
    # (tap, chunk, half, byte, tile, group, row) -> (tile, chunk, tap, group, half, row, byte)
    return padded.reshape(nine, n_chunks, 2, 16, n_tiles, BN // 8, 8).permute(
        4, 1, 0, 5, 2, 6, 3).contiguous()


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


def _check(q: torch.Tensor, w_packed: torch.Tensor, mult: torch.Tensor,
           bias: torch.Tensor) -> None:
    """Raises on the types and shapes the kernel does not take (on any device)."""
    if q.dim() != 4 or q.dtype != torch.int8:
        raise ValueError(f"q must be (B, T, F, Cin) int8, got {tuple(q.shape)} {q.dtype}")
    cout = mult.shape[0] if mult.dim() == 1 else -1
    for name, v in (("mult", mult), ("bias", bias)):
        if v.dim() != 1 or v.shape[0] != cout or v.dtype != torch.float32:
            raise ValueError(f"mult and bias must be (Cout,) float32, got {name} "
                             f"{tuple(v.shape)} {v.dtype}")
    want = packed_shape(q.shape[3], cout) if cout > 0 else None
    if want is None or tuple(w_packed.shape) != want or w_packed.dtype != torch.int8:
        raise ValueError(f"w_packed must be {want} int8 (pack_weights), "
                         f"got {tuple(w_packed.shape)} {w_packed.dtype}")


def conv3x3_int8_cuda(q: torch.Tensor, w_packed: torch.Tensor, mult: torch.Tensor,
                      bias: torch.Tensor, out_kind: str = "int8",
                      symbol: Optional[str] = None) -> torch.Tensor:
    """The kernel on CUDA tensors: q (B, T, F, Cin) int8, ``w_packed`` from
    :func:`pack_weights`, Cout from ``mult``. ``symbol`` selects one of the
    library's timing modes (``tools/conv_int8_probe.py``)."""
    dtype = _out_dtype(out_kind)
    tensors = (q, w_packed, mult, bias)
    if any(x.device.type != "cuda" for x in tensors):
        raise ValueError("conv3x3_int8_cuda needs CUDA tensors")
    _check(q, w_packed, mult, bias)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("conv3x3_int8_cuda takes contiguous tensors")
    if w_packed.data_ptr() % 16:
        raise ValueError("w_packed must be 16-byte aligned")
    b, t, f, cin = q.shape
    cout = mult.shape[0]
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


def conv3x3_int8_tiled(q: torch.Tensor, w_packed: torch.Tensor, mult: torch.Tensor,
                       bias: torch.Tensor, out_kind: str = "int8") -> torch.Tensor:
    """The kernel's tiling in int64 torch, for the tests (nothing on the
    main path calls it): blocks of BM positions and BN channels, the halo
    patch of each 32-channel chunk as ``csrc/conv_int8.cu`` lays it out
    (bands of cells BS = min(F, BM + 2) apart, zero outside 0..T*F-1 and
    past Cin), the nine taps as shifted views of it with the F-edge masks,
    the packed weights read in their block order, the N tail cut at the
    store, and the same epilogue."""
    _out_dtype(out_kind)
    _check(q, w_packed, mult, bias)
    b, t, f, cin = q.shape
    cout = mult.shape[0]
    n_tiles, n_chunks = w_packed.shape[:2]
    tf = t * f
    bs = min(f, BM + 2)
    m_blocks = -(-tf // BM)
    p0 = torch.arange(m_blocks)[:, None] * BM
    x = torch.arange(2 * bs + BM + 2)
    dt = torch.clamp(x // bs, max=2)
    pos = p0 + (dt - 1) * f - 1 + (x - dt * bs)                 # (m_blocks, cells)
    inside = (pos >= 0) & (pos < tf)
    rows = torch.arange(BM)
    f_of = (p0 + rows) % f                                       # (m_blocks, BM)
    edge = {0: f_of != 0, 2: f_of != f - 1}
    flat = q.reshape(b, tf, cin).to(torch.int64)
    acc = torch.zeros((b, m_blocks, BM, n_tiles * BN), dtype=torch.int64)
    for ch in range(n_chunks):
        c = torch.arange(ch * KC, (ch + 1) * KC)
        patch = flat[:, pos.clamp(0, tf - 1)][..., c.clamp(max=cin - 1)]
        patch = patch * (inside[..., None] & (c < cin))          # (b, m_blocks, cells, 32)
        # (tile, tap, group, half, row, byte) -> (tap, half*16 + byte, tile*128 + group*8 + row)
        w = w_packed[:, ch].to(torch.int64).permute(1, 3, 5, 0, 2, 4).reshape(9, KC, n_tiles * BN)
        for tap in range(9):
            dt_, df = divmod(tap, 3)
            a = patch[:, :, dt_ * bs + df + rows]
            if df != 1:
                a = a * edge[df][None, :, :, None]
            acc += a @ w[tap]
    acc = acc.reshape(b, m_blocks * BM, -1)[:, :tf, :cout].reshape(b, t, f, cout)
    return requantize(acc.to(torch.float32), mult, bias, out_kind)


def conv3x3_int8(q: torch.Tensor, w9: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
                 out_kind: str = "int8", w_packed: Optional[torch.Tensor] = None,
                 use_kernel: bool = True) -> torch.Tensor:
    """Counterpart of ``conv3x3_int8_fused``: the plain version on the CPU
    or where ``use_kernel`` is False (the ``int8_static`` self-check's
    reference, ``models/quantized.py``), the kernel on the card
    (``w_packed``, when given, is ``pack_weights(w9)`` made once at fold
    time)."""
    if q.device.type == "cpu" or not use_kernel:
        return conv3x3_int8_plain(q, w9, mult, bias, out_kind)
    if w_packed is None:
        w_packed = pack_weights(w9)
    return conv3x3_int8_cuda(q.contiguous(), w_packed, mult.contiguous(), bias.contiguous(),
                             out_kind)
