"""Probe P1: the card's int8 and bf16 matrix-product rates (``csrc/mm_probe.cu``).

The counterpart of the JAX package's ``tools/_mxu_rate.py``, which timed a
tiled Pallas matmul on the TPU's matrix unit at M = K = N = 4096. Here a
hand-written ``wgmma`` GEMM fed by TMA through a ring of K slabs,
``c = a @ bt^T``, runs int8 -> int32
and bf16 -> float32 at the same size, timed beside its plain version (a
float64 ``torch.matmul``: exact for int8, since every sum is an integer
below 4096·127² < 2⁵³) and beside one PyTorch call (``torch._int_mm``, or
``torch.matmul`` in bf16):

    python -m doubleattentionspeakerverification_tpu_torch.tools.rate_probe

prints one JSON line per type. Needs a CUDA card; ``mm_probe`` on CPU
tensors takes the plain version.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np
import torch

from ..ops.kernels import CudaKernel
from .timing import BF16_OPS_PER_S, INT8_OPS_PER_S, bound_ms, cuda_ms, eager_ms

_p, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("mm_probe", "mm_probe.cu", "mm_probe", [_p, _p, _p, _i, _i, _i, _i, _p])
SIZE = 4096
BM, BN, BK_BYTES = 128, 256, 128   # the kernel's tile of c and its K slab (csrc/mm_probe.cu)
KINDS = ("int8", "bfloat16")


def mm_probe_plain(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (N, K)^T in float64 -> int32 for int8, float32 for bf16."""
    c = a.to(torch.float64) @ bt.to(torch.float64).t()
    return c.to(torch.int32 if a.dtype == torch.int8 else torch.float32)


def _check(a: torch.Tensor, bt: torch.Tensor) -> None:
    """Raises on the types and shapes the kernel does not take (on any
    device: the tests hold it to that on ``meta`` tensors)."""
    if a.dtype != bt.dtype or a.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"a and bt must both be int8 or bfloat16, got {a.dtype}, {bt.dtype}")
    if a.dim() != 2 or bt.dim() != 2 or a.shape[1] != bt.shape[1]:
        raise ValueError(f"a (M, K) and bt (N, K) expected, got {tuple(a.shape)}, {tuple(bt.shape)}")
    m, k = a.shape
    if m % BM or bt.shape[0] % BN or (k * a.element_size()) % BK_BYTES or not (m and k and bt.shape[0]):
        raise ValueError(f"M must be a multiple of {BM}, N of {BN} and K of {BK_BYTES} bytes, "
                         f"got M={m}, N={bt.shape[0]}, K={k} ({a.dtype})")


def mm_probe_cuda(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    if a.device.type != "cuda" or bt.device.type != "cuda":
        raise ValueError("mm_probe_cuda needs CUDA tensors")
    _check(a, bt)
    if not (a.is_contiguous() and bt.is_contiguous()) or a.data_ptr() % 16 or bt.data_ptr() % 16:
        raise ValueError("mm_probe_cuda takes contiguous, 16-byte aligned tensors")
    m, k = a.shape
    n = bt.shape[0]
    is_int8 = a.dtype == torch.int8
    c = torch.empty((m, n), dtype=torch.int32 if is_int8 else torch.float32, device=a.device)
    KERNEL.launch(a.data_ptr(), bt.data_ptr(), c.data_ptr(), m, n, k, int(is_int8),
                  torch.cuda.current_stream(a.device).cuda_stream)
    return c


def mm_probe(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """The kernel on the card, its plain version on the CPU."""
    if a.device.type == "cpu":
        return mm_probe_plain(a, bt)
    return mm_probe_cuda(a, bt)


def library(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """One PyTorch call for the same product (the yardstick, not used by the port)."""
    if a.dtype == torch.int8:
        return torch._int_mm(a, bt.t())
    return torch.matmul(a, bt.t()).to(torch.float32)


def inputs(kind: str, device, n: int = SIZE, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "int8":
        a = torch.from_numpy(rng.integers(-127, 128, (n, n), dtype=np.int8))
        bt = torch.from_numpy(rng.integers(-127, 128, (n, n), dtype=np.int8))
    else:
        a = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32)).to(torch.bfloat16)
        bt = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32)).to(torch.bfloat16)
    return a.to(device), bt.to(device)


def check(device="cuda", n: int = SIZE) -> dict:
    """The kernel against its plain version. int8 must be exact; bf16
    products are exact in float32, so the float32 sums may differ from the
    float64 ones by at most (K - 1)·2⁻²⁴·Σ|a·b| (any summation order)."""
    out = {}
    for kind in KINDS:
        a, bt = inputs(kind, device, n)
        got = mm_probe(a, bt).to(torch.float64)
        ref = mm_probe_plain(a, bt).to(torch.float64)
        err = (got - ref).abs()
        if kind == "int8":
            ok = bool((err == 0).all())
        else:
            mag = a.to(torch.float64).abs() @ bt.to(torch.float64).abs().t()
            ok = bool((err <= (n - 1) * 2.0 ** -24 * mag).all())
        out[kind] = {"max_abs_err": float(err.max()), "ok": ok}
    return out


def measure(device="cuda", n: int = SIZE) -> dict:
    """Device times of the kernel (eager calls: each about half a
    millisecond, far above the host's launch work, so ``KERNEL.launches``
    moves by exactly the launches made), its plain version and the library
    call, with the bound of each type."""
    out = {}
    for kind in KINDS:
        a, bt = inputs(kind, device, n)
        el = a.element_size()
        out_bytes = 4 * n * n
        b_ms, b_by = bound_ms(2 * n * n * el + out_bytes, 2.0 * n ** 3,
                              INT8_OPS_PER_S if kind == "int8" else BF16_OPS_PER_S)
        out[kind] = {
            "ms": eager_ms(lambda: mm_probe_cuda(a, bt), 10),
            "plain_ms": cuda_ms(lambda: mm_probe_plain(a, bt), 2, replays=3),
            "library_ms": cuda_ms(lambda: library(a, bt), 10),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        out[kind]["rate_tops"] = 2.0 * n ** 3 / out[kind]["ms"] / 1e9
    return out


def main() -> int:
    from ..utils.device import resolve_device

    resolve_device("cuda")
    checks, times = check(), measure()
    for kind in KINDS:
        print(json.dumps({"kind": kind, "n": SIZE, "device": torch.cuda.get_device_name(0),
                          **checks[kind], **times[kind]}))
    return 0 if all(c["ok"] for c in checks.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
