"""Probe P2: where kernel B3's time goes, at conv22's shape.

The counterpart of the JAX package's ``tools/_pallas_micro.py``, which split
the Pallas int8 conv into full / dot-only / copy-only variants to weigh the
im2col copies against the matrix products. Here the library built from
``csrc/conv_int8.cu`` exports, beside kernel B3, the same kernel template in
three modes:

- ``full``: kernel B3 itself (int8 out), bit for bit;
- ``dot_only``: the ``wgmma`` products with the weights fetched but the
  halo patch never filled (the result means nothing; only its time counts);
- ``copy_only``: the producer's staging of weights and patches through the
  ring, each slot released with no products.

They are timed at B=16, T=500, F=40, C=256 -> 256 beside the plain version
and one library route (im2col + ``torch._int_mm`` + the torch epilogue). The
variants are timed by eager calls (each about a millisecond, far above the
host's launch work), so B3's launch count (``conv_int8.KERNEL``) moves by
exactly the launches the timing made:

    python -m doubleattentionspeakerverification_tpu_torch.tools.conv_int8_probe
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import conv_int8
from .timing import INT8_OPS_PER_S, bound_ms, cuda_ms, eager_ms

VARIANTS = {"full": "conv3x3_int8_full", "dot_only": "conv3x3_int8_dot_only",
            "copy_only": "conv3x3_int8_copy_only"}
SHAPE = (16, 500, 40, 256, 256)   # B, T, F, Cin, Cout


def variant(name: str, q, w_packed, mult, bias) -> torch.Tensor:
    return conv_int8.conv3x3_int8_cuda(q, w_packed, mult, bias, "int8", symbol=VARIANTS[name])


def im2col_int_mm(q: torch.Tensor, w9: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
                  out_kind: str = "int8") -> torch.Tensor:
    """The library route to B3's function (a yardstick, not used by the
    port): the nine shifted taps concatenated along channels, one
    ``torch._int_mm`` of K = 9·Cin, then the torch epilogue. Needs
    9·Cin and Cout multiples of 8."""
    b, t, f, cin = q.shape
    cout = w9.shape[2]
    x = F.pad(q, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([x[:, dt:dt + t, df:df + f] for dt in range(3) for df in range(3)], -1)
    wt = w9.reshape(9 * cin, cout).t().contiguous()
    acc = torch._int_mm(cols.reshape(b * t * f, 9 * cin), wt.t())
    return conv_int8.requantize(acc.to(torch.float32), mult, bias, out_kind).reshape(b, t, f, cout)


def inputs(device, shape=SHAPE, seed=0):
    b, t, f, cin, cout = shape
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-127, 128, (b, t, f, cin), dtype=np.int8))
    w9 = torch.from_numpy(rng.integers(-127, 128, (9, cin, cout), dtype=np.int8))
    mult = torch.from_numpy((rng.uniform(0.5, 2.0, cout) * 1e-4).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    return tuple(x.to(device) for x in (q, w9, mult, bias))


def bound(shape=SHAPE):
    b, t, f, cin, cout = shape
    return bound_ms(b * t * f * (cin + cout) + 9 * cin * cout + 8 * cout,
                    2.0 * b * t * f * 9 * cin * cout, INT8_OPS_PER_S)


def check(device="cuda") -> dict:
    """``full`` against kernel B3 and against the plain version: equal, bit
    for bit. Returns the largest difference and whether all were equal."""
    q, w9, mult, bias = inputs(device)
    wp = conv_int8.pack_weights(w9)
    full = variant("full", q, wp, mult, bias)
    b3 = conv_int8.conv3x3_int8_cuda(q, wp, mult, bias, "int8")
    ref = conv_int8.conv3x3_int8_plain(q, w9, mult, bias, "int8")
    err = max(int((full.int() - ref.int()).abs().max()), int((full.int() - b3.int()).abs().max()))
    return {"max_abs_err": float(err), "ok": err == 0}


def measure(device="cuda") -> dict:
    """Device times of the three variants, the plain version and the
    library route, with the bound at this shape."""
    q, w9, mult, bias = inputs(device)
    wp = conv_int8.pack_weights(w9)
    out = {f"{name}_ms": eager_ms(lambda name=name: variant(name, q, wp, mult, bias), 10)
           for name in VARIANTS}
    out["plain_ms"] = cuda_ms(lambda: conv_int8.conv3x3_int8_plain(q, w9, mult, bias), 1,
                              replays=3)
    out["library_ms"] = cuda_ms(lambda: im2col_int_mm(q, w9, mult, bias), 5)
    out["bound_ms"], out["bound_by"] = bound()
    return out


def main() -> int:
    from ..utils.device import resolve_device

    resolve_device("cuda")
    c, m = check(), measure()
    print(json.dumps({"shape": dict(zip("B T F Cin Cout".split(), SHAPE)),
                      "device": torch.cuda.get_device_name(0), **c, **m}))
    return 0 if c["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
