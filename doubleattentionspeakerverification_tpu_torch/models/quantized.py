"""int8-quantized inference encoder (the JAX package's ``models/quantized.py``).

The conv weights are quantized once, symmetric per output channel, and each
conv sums int8 x int8 in int32; pooling and the fp tail
(``SpeakerClassifier.tail``) are the fp model's, so quantization error
enters only through the conv stack. Two activation schemes, as in JAX:

- ``dynamic`` (no calibration): every conv input is quantized with the
  per-tensor scale ``amax / 127`` measured on the device in that forward.
- ``static`` (one-batch calibration): per-conv input scales are measured
  once (:func:`calibrate_int8_scales`) and folded into each conv's epilogue
  (:func:`fold_static_scales`): dequantize, bias, ReLU and requantize for
  the next conv become ``clip(round(acc * mult + bias), 0, 127)``, so every
  intermediate activation lives as int8, and masking and the ceil-mode pool
  run on int8 (requantizing commutes with max; quantize(0) = 0 keeps pad
  frames exact).

On the card every conv after the first is kernel B3 (``ops/conv_int8.py``),
in both schemes: the static scheme writes int8 (float for the last conv);
the dynamic scheme writes ``relu(acc * (sx * w_s) + b)`` in the compute
dtype, with ``sx`` kept on the device (no host sync per conv). For
``compute_dtype="bfloat16"`` B3 rounds that once, where the JAX dynamic path
rounds the product, the scale and the sum in bf16 each. The first conv
(Cin = 1) stays outside the kernel, as in JAX: it is an exact float32
product of the nine int8 taps (every sum is an integer below
9·127² < 2²⁴), on the CPU and on the card alike.

The ``int8_static`` gate (JAX ``_static_pallas_gate``): on the card, once a
calibration bakes its scales, :func:`_static_kernel_gate` runs the static
conv stack on the calibration batch with B3 and with B3's plain version,
requires every int8 activation equal (B3 is bit-exact) and the last conv's
float output within :data:`TOL_STATIC_FLOAT`, and records both times in
``utils/kernel_auto.py``'s ``decisions()["int8_pallas_conv"]``, as JAX's
string does. Where JAX falls back to XLA on a mismatch or a slower kernel,
the port raises on a mismatch and keeps B3 either way: the plain version
never serves on the card (B3's seven paper convs take about 1.6 ms against
68 ms for the plain version, PERF.md). Restored scales come with no
calibration batch and go unchecked, as in JAX.

Bit-exact where JAX is: weights are quantized on the CPU with IEEE float32
divisions; activations are divided by their scale (a device tensor, never a
reciprocal multiply, which PyTorch does on CUDA for a host scalar); the
folded ``mult = (s_in · w_s) / s_next`` is computed in float32 in JAX's
order; rounding is half to even. A static forward on the card gives the
same int8 activations as on the CPU, conv for conv.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.conv_int8 import conv3x3_int8, pack_weights, requantize
from ..ops.masked_ops import length_mask, mask_time

log = logging.getLogger(__name__)

# A batch whose feature abs-max is below this cannot be a calibration batch:
# real CMN'd log-mel speech has abs-max O(1..20); all-zeros (serving warmup)
# or digital silence sit at exactly 0. Calibrating on one would bake scales
# ~1e-14 and saturate every later real input at +/-127.
DEGENERATE_CALIBRATION_AMAX = 1e-3

Scale = Union[float, torch.Tensor]

# the int8_static gate: the last conv's float output, kernel vs plain,
# relative to its largest value (the int8 activations must be equal)
TOL_STATIC_FLOAT = 1e-6


def _conv_order(cfg: ModelConfig) -> List[str]:
    n_blocks = 3 if cfg.front_end == "VGG3L" else 4
    return [f"conv{i + 1}{j}" for i in range(n_blocks) for j in (1, 2)]


def _scalar(x: Scale, device) -> torch.Tensor:
    """A float32 0-dim tensor on ``device``: dividing by it is a true
    division on the card too. Made by a fill, so the host does not wait."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def quantize_vgg(vgg: torch.nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """fp VGG -> int8 parameters: per-output-channel symmetric weights.

    Returns ``{name: {"w_q": int8 (3, 3, Cin, Cout) HWIO, "w_s": f32 (Cout,),
    "b": f32 (Cout,), "w_packed": B3's layout (CUDA only, else None)}}`` on
    the weights' device. The arithmetic runs on the CPU."""
    q = {}
    for name, conv in vgg.named_children():
        w = conv.weight.detach().to("cpu", torch.float32).permute(2, 3, 1, 0)   # OIHW -> HWIO
        s = torch.clamp(w.abs().amax(dim=(0, 1, 2)) / 127.0, min=1e-12)
        w_q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8).contiguous()
        dev = conv.weight.device
        q[name] = {"w_q": w_q.to(dev), "w_s": s.to(dev),
                   "b": conv.bias.detach().to(torch.float32).to(dev)}
        q[name]["w_packed"] = _packed(q[name]["w_q"])
    return q


def _w9(w_q: torch.Tensor) -> torch.Tensor:
    return w_q.reshape(9, w_q.shape[2], w_q.shape[3])


def _packed(w_q: torch.Tensor) -> Optional[torch.Tensor]:
    return pack_weights(_w9(w_q)) if w_q.device.type == "cuda" and w_q.shape[2] > 1 else None


def _conv_cin1(q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The first conv (Cin = 1): (B, T, F, 1) int8 -> exact float32 window
    sums (B, T, F, Cout), as one product of the nine shifted taps."""
    b, t, f, _ = q.shape
    x = torch.nn.functional.pad(q[..., 0].to(torch.float32), (1, 1, 1, 1))
    taps = torch.stack([x[:, dt:dt + t, df:df + f] for dt in range(3) for df in range(3)], -1)
    return taps @ w_q.reshape(9, w_q.shape[3]).to(torch.float32)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _conv3x3_int8(x: torch.Tensor, qp, compute_dtype: str) -> torch.Tensor:
    """(B, T, F, C) -> dynamically quantized int8 conv -> ``relu`` of the
    dequantized, biased result in ``compute_dtype`` ('float32' or
    'bfloat16')."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax()
    sx = torch.clamp(amax / _scalar(127.0, x.device), min=1e-12)
    x_q = _quantize(xf, sx)
    w_q = qp["w_q"]
    if w_q.shape[2] == 1:
        cd = getattr(torch, compute_dtype)
        y = _conv_cin1(x_q, w_q)
        scale = (sx * qp["w_s"]).to(cd)
        return torch.relu(y.to(cd) * scale + qp["b"].to(cd))
    return conv3x3_int8(x_q, _w9(w_q), sx * qp["w_s"], qp["b"], out_kind=compute_dtype,
                        w_packed=qp["w_packed"])


def _ceil_half(lengths: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if lengths is None else torch.div(lengths + 1, 2, rounding_mode="floor")


def _ceil_maxpool2(h: torch.Tensor, fill) -> torch.Tensor:
    """2x2 stride-2 ceil-mode max-pool over (T, F) of (B, T, F, C), the odd
    edge padded with ``fill``."""
    b, t, f, c = h.shape
    if t % 2 or f % 2:
        h = torch.nn.functional.pad(h, (0, 0, 0, f % 2, 0, t % 2), value=fill)
    t2, f2 = h.shape[1] // 2, h.shape[2] // 2
    return h.reshape(b, t2, 2, f2, 2, c).amax(dim=(2, 4))


def _ceil_maxpool2_int8(q: torch.Tensor) -> torch.Tensor:
    """int8 ceil-mode pool, padded with -128."""
    return _ceil_maxpool2(q, -128)


def _mask_time_int8(q: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """int8 twin of ``mask_time`` (whose 0.0 fill would promote to float)."""
    if lengths is None:
        return q
    return q.masked_fill(~length_mask(lengths, q.shape[1])[:, :, None, None], 0)


def _flatten(h: torch.Tensor) -> torch.Tensor:
    """(B, T', F', C) -> the reference's channel-major (B, T', C*F'), float32."""
    b, t, f, c = h.shape
    return h.permute(0, 1, 3, 2).reshape(b, t, c * f).to(torch.float32)


def quantized_vgg_apply(qparams, x: torch.Tensor, lengths: Optional[torch.Tensor],
                        cfg: ModelConfig) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """int8 twin of ``VGG.forward`` with dynamic activation scales: the same
    blocks, masks and ceil-mode pools; (B, T, F) -> (B, T', C*F') float32."""
    h = mask_time(x.to(getattr(torch, cfg.compute_dtype)), lengths)[..., None]
    cur_len = lengths
    for i in range(3 if cfg.front_end == "VGG3L" else 4):
        for j in (1, 2):
            h = mask_time(_conv3x3_int8(h, qparams[f"conv{i + 1}{j}"], cfg.compute_dtype),
                          cur_len)
        h = _ceil_maxpool2(h, float("-inf"))
        cur_len = _ceil_half(cur_len)
    return _flatten(h), cur_len


def collect_int8_amaxes(qparams, x: torch.Tensor, lengths: Optional[torch.Tensor],
                        cfg: ModelConfig) -> torch.Tensor:
    """Per-conv INPUT abs-maxes along the dynamic int8 forward (the
    distribution static scales must cover), as a float32 tensor."""
    h = mask_time(x.to(getattr(torch, cfg.compute_dtype)), lengths)[..., None]
    cur_len = lengths
    amaxes = []
    for i in range(3 if cfg.front_end == "VGG3L" else 4):
        for j in (1, 2):
            amaxes.append(h.to(torch.float32).abs().amax())
            h = mask_time(_conv3x3_int8(h, qparams[f"conv{i + 1}{j}"], cfg.compute_dtype),
                          cur_len)
        h = _ceil_maxpool2(h, float("-inf"))
        cur_len = _ceil_half(cur_len)
    return torch.stack(amaxes)


def calibrate_int8_scales(qparams, x: torch.Tensor, lengths: Optional[torch.Tensor],
                          cfg: ModelConfig) -> List[float]:
    """One-batch calibration -> per-conv static activation scales
    ``amax / 127`` (Python floats; the JAX package's ``margin`` = 1). The
    ceil max-pool keeps the abs-max, so conv i's post-ReLU amax is conv
    i+1's input amax."""
    am = collect_int8_amaxes(qparams, x, lengths, cfg).cpu().numpy()
    return [max(float(a), 1e-12) / 127.0 for a in am]


def fold_static_scales(qparams, act_scales: Sequence[float], cfg: ModelConfig):
    """Fold the inter-conv chain into per-channel constants: conv i's int8
    output is ``round(relu(acc * mult + bias))`` with ``mult = s_in * w_s /
    s_next`` and ``bias = b / s_next`` (float32, computed on the CPU in
    JAX's order); the last conv keeps ``s_next = 1``."""
    order = _conv_order(cfg)
    if len(act_scales) != len(order):
        raise ValueError(f"{len(act_scales)} scales for {len(order)} convs")
    folded = {}
    for k, name in enumerate(order):
        qp = qparams[name]
        dev = qp["w_q"].device
        s_in = torch.tensor(act_scales[k], dtype=torch.float32)
        s_next = torch.tensor(act_scales[k + 1] if k + 1 < len(order) else 1.0, dtype=torch.float32)
        mult = (s_in * qp["w_s"].cpu()) / s_next
        folded[name] = {"w_q": qp["w_q"], "w_packed": qp["w_packed"],
                        "mult": mult.to(dev), "bias": (qp["b"].cpu() / s_next).to(dev)}
    return folded


def quantized_vgg_apply_static(folded, act_scale0: Scale, x: torch.Tensor,
                               lengths: Optional[torch.Tensor], cfg: ModelConfig,
                               intermediates: Optional[list] = None, use_kernel: bool = True,
                               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Static-scale int8 VGG forward: every intermediate activation is int8
    (one fused epilogue per conv, B3 on the card for every conv after the
    first, or its plain version where ``use_kernel`` is False); masking and
    the ceil-mode pool run on the int8 tensor. ``intermediates``, when
    given, receives each conv's masked output."""
    order = _conv_order(cfg)
    h0 = mask_time(x.to(torch.float32), lengths)[..., None]
    q = _quantize(h0, _scalar(act_scale0, x.device))
    cur_len = lengths
    h = None
    k = 0
    for _ in range(len(order) // 2):
        for _ in (1, 2):
            p = folded[order[k]]
            last = k == len(order) - 1
            if k == 0:   # Cin = 1, never the last conv
                y = requantize(_conv_cin1(q, p["w_q"]), p["mult"], p["bias"], "int8")
            else:
                y = conv3x3_int8(q, _w9(p["w_q"]), p["mult"], p["bias"],
                                 out_kind=cfg.compute_dtype if last else "int8",
                                 w_packed=p["w_packed"], use_kernel=use_kernel)
            if last:
                h = mask_time(y, cur_len)
            else:
                q = _mask_time_int8(y, cur_len)
            if intermediates is not None:
                intermediates.append(h if last else q)
            k += 1
        if k == len(order):
            h = _ceil_maxpool2(h, float("-inf"))
        else:
            q = _ceil_maxpool2_int8(q)
        cur_len = _ceil_half(cur_len)
    return _flatten(h), cur_len


def get_embedding_int8(model, qvgg, x, lengths, cfg: ModelConfig) -> torch.Tensor:
    """Eval-mode scoring embedding with the dynamic int8 encoder and the fp
    tail of ``model`` (a ``SpeakerClassifier``)."""
    return model.tail(*quantized_vgg_apply(qvgg, x, lengths, cfg))


def get_embedding_int8_static(model, folded, act_scale0: Scale, x, lengths,
                              cfg: ModelConfig) -> torch.Tensor:
    return model.tail(*quantized_vgg_apply_static(folded, act_scale0, x, lengths, cfg))


def _static_kernel_gate(folded, act_scale0: Scale, x: torch.Tensor,
                        lengths: Optional[torch.Tensor], cfg: ModelConfig) -> str:
    """Hold the static conv stack with B3 to the same stack with B3's plain
    version on the calibration batch (on the card; off it only the decision
    is recorded), time both, record the verdict in
    ``kernel_auto.decisions()["int8_pallas_conv"]`` and return it. Raises on
    a mismatch: the static path keeps B3."""
    import time

    from ..ops.kernels import uncounted
    from ..utils import kernel_auto

    if kernel_auto._card(x.device) is None:
        kernel_auto._DECISIONS.setdefault("int8_pallas_conv", "auto->False (not on the card)")
        return kernel_auto._DECISIONS["int8_pallas_conv"]

    def run(use_kernel: bool, acts: Optional[list] = None):
        return quantized_vgg_apply_static(folded, act_scale0, x, lengths, cfg, acts,
                                          use_kernel=use_kernel)[0]

    def sync():
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)

    def chain_ms(use_kernel: bool, k: int = 3) -> float:
        sync()
        t0 = time.perf_counter()
        for _ in range(k):
            run(use_kernel)
        sync()
        return (time.perf_counter() - t0) / k * 1e3

    with uncounted():
        acts_k, acts_p = [], []
        run(True, acts_k)
        run(False, acts_p)
        differ = [i for i, (a, b) in enumerate(zip(acts_k[:-1], acts_p[:-1]))
                  if not torch.equal(a, b)]
        last_k, last_p = acts_k[-1].to(torch.float32), acts_p[-1].to(torch.float32)
        last_d = float((last_k - last_p).abs().max()) / max(1.0, float(last_p.abs().max()))
        if differ or not last_d <= TOL_STATIC_FLOAT:
            raise RuntimeError(
                f"kernel B3 (conv_int8) int8_static self-check FAILED on the calibration "
                f"batch {tuple(x.shape)}: int8 activations of convs {differ} differ from the "
                f"plain version's; the last conv's float output within {last_d:.3g} of its "
                f"largest (tolerance {TOL_STATIC_FLOAT})")
        t_kernel = min(chain_ms(True) for _ in range(2))
        t_plain = min(chain_ms(False) for _ in range(2))
    verdict = (f"auto->True (B3 {t_kernel:.2f} ms vs plain {t_plain:.2f} ms at the "
               f"calibration batch shape {tuple(x.shape)}; {len(acts_k) - 1} int8 "
               f"activations equal, the last conv within {last_d:.3g})")
    kernel_auto._DECISIONS["int8_pallas_conv"] = verdict
    return verdict


def _weights_fingerprint(qvgg) -> str:
    """sha256 over the quantized conv weights in HWIO, in sorted-name order,
    as the JAX package computes it: a scales file written by either package
    loads in the other, and never against other weights."""
    h = hashlib.sha256()
    for name in sorted(qvgg):
        h.update(name.encode())
        h.update(qvgg[name]["w_q"].cpu().numpy().tobytes())
    return h.hexdigest()


def save_int8_scales(path: str, scales, cfg: ModelConfig, weights_sha: str = "") -> None:
    """Persist baked static activation scales (the JAX package's format,
    with its ``margin`` field at 1), so serving restarts are deterministic."""
    np.savez(
        path,
        scales=np.asarray(scales, np.float64),
        margin=np.float64(1.0),
        front_end=np.asarray(cfg.front_end),
        kernel_size=np.int64(cfg.kernel_size),
        feature_size=np.int64(cfg.feature_size),
        weights_sha=np.asarray(weights_sha),
    )


def load_int8_scales(path: str, cfg: ModelConfig, weights_sha: str = "") -> List[float]:
    """Load :func:`save_int8_scales` output; raises on a model or weights
    mismatch (stale scales must never silently serve)."""
    with np.load(path, allow_pickle=False) as z:
        scales = [float(s) for s in z["scales"]]
        fe = str(z["front_end"])
        ks, fs = int(z["kernel_size"]), int(z["feature_size"])
        stored_sha = str(z["weights_sha"]) if "weights_sha" in z.files else ""
    if (fe, ks, fs) != (cfg.front_end, cfg.kernel_size, cfg.feature_size):
        raise ValueError(
            f"int8 scales at {path!r} were calibrated for {fe}/k={ks}/f={fs}, but the "
            f"model is {cfg.front_end}/k={cfg.kernel_size}/f={cfg.feature_size}")
    if len(scales) != len(_conv_order(cfg)):
        raise ValueError(f"int8 scales at {path!r} hold {len(scales)} entries, model "
                         f"has {len(_conv_order(cfg))} convs")
    if weights_sha and stored_sha and stored_sha != weights_sha:
        raise ValueError(
            f"int8 scales at {path!r} were calibrated against DIFFERENT model weights "
            "(fingerprint mismatch): delete the file to recalibrate, or point "
            "--int8_scales elsewhere")
    return scales


def _cosines(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    a = a.cpu().numpy().astype(np.float64)
    b = b.cpu().numpy().astype(np.float64)
    denom = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return (a * b).sum(-1) / np.maximum(denom, 1e-12)


def make_int8_embed_fn(model, cfg: ModelConfig, scheme: str = "dynamic",
                       scales_path: Optional[str] = None,
                       cosine_guard: float = 0.98):
    """The int8 path of ``model`` (a ``SpeakerClassifier`` in eval mode):
    quantizes its conv weights once and returns ``embed(x, lengths) ->
    (B, emb)``, a drop-in for ``model(x, lengths)``.

    ``scheme='dynamic'``: per-forward activation scales, no calibration.
    ``scheme='static'``: the first NON-DEGENERATE batch runs the dynamic
    path and doubles as the calibration batch; every later call runs the
    static program. Hardening, as in the JAX package:

    - batches whose feature abs-max is at most
      :data:`DEGENERATE_CALIBRATION_AMAX` (all-zeros warmup, silence) are
      served dynamically WITHOUT baking;
    - exactly one request may calibrate (a lock), so a restart cannot bake
      whichever thread's scales won a race;
    - after baking, a one-shot guard compares the static embeddings with the
      fp model's on the calibration batch; if any row's cosine is below
      ``cosine_guard`` the scheme falls back to the dynamic path for good
      (state ``fallback_dynamic``);
    - ``scales_path``: an existing file is loaded (refused if it belongs to
      another model or other weights) and serves at once; otherwise the
      first successful calibration writes it.

    The callable exposes ``calibrate(x, lengths=None)`` (an explicit
    calibration batch; raises ``ValueError`` on a degenerate one) and
    ``calibration_state() -> 'dynamic' | 'uncalibrated' | 'static' |
    'fallback_dynamic'``."""
    from ..utils.kernel_auto import resolve_model_kernels, route_model

    route_model(model, resolve_model_kernels(cfg, need_dsp=False,
                                             device=next(model.parameters()).device))
    qvgg = quantize_vgg(model.vgg)

    def dynamic(x, lens):
        return get_embedding_int8(model, qvgg, x, lens, cfg)

    if scheme == "dynamic":
        def embed_dynamic(x, lens=None):
            return dynamic(x, lens)

        embed_dynamic.calibration_state = lambda: "dynamic"
        return embed_dynamic
    if scheme != "static":
        raise ValueError(f"unknown int8 scheme {scheme!r}")

    box: dict = {"state": "uncalibrated"}
    calib_lock = threading.Lock()
    device = qvgg[_conv_order(cfg)[0]]["w_q"].device

    def _bake(scales, calibration=None):
        """The static embed function of ``scales``; with the calibration
        batch ``(x, lens)``, B3 is first held to its plain version on it."""
        folded = fold_static_scales(qvgg, scales, cfg)
        s0 = _scalar(scales[0], device)
        if calibration is not None:
            _static_kernel_gate(folded, s0, *calibration, cfg)
        return lambda x, lens: get_embedding_int8_static(model, folded, s0, x, lens, cfg)

    if scales_path and os.path.exists(scales_path):
        scales = load_int8_scales(scales_path, cfg, weights_sha=_weights_fingerprint(qvgg))
        box["fn"] = _bake(scales)
        box["state"] = "static"
        if device.type == "cuda":
            from ..utils.kernel_auto import _DECISIONS

            _DECISIONS["int8_pallas_conv"] = ("auto->True (restored scales: no calibration "
                                              "batch to check B3 on)")
        log.info("int8_static: restored %d baked scales from %s", len(scales), scales_path)

    def _calibrate_locked(x, lens) -> str:
        """Calibrate on (x, lens); the caller holds calib_lock and has
        checked that the batch is not degenerate. Returns the new state."""
        scales = calibrate_int8_scales(qvgg, x, lens, cfg)
        fn = _bake(scales, calibration=(x, lens))
        cos = _cosines(model(x, lens), fn(x, lens))
        worst = float(cos.min()) if cos.size else 1.0
        if worst < cosine_guard:
            box["state"] = "fallback_dynamic"
            log.warning("int8_static calibration REJECTED: static-vs-fp cosine %.4f < %.4f "
                        "on the calibration batch; falling back to the dynamic int8 path "
                        "for this process", worst, cosine_guard)
            return box["state"]
        box["fn"] = fn
        box["state"] = "static"
        if scales_path:
            save_int8_scales(scales_path, scales, cfg, weights_sha=_weights_fingerprint(qvgg))
            log.info("int8_static: baked scales persisted to %s", scales_path)
        return box["state"]

    def _amax(x) -> float:
        return float(x.abs().max()) if x.numel() else 0.0

    def embed(x, lens=None):
        fn = box.get("fn")
        if fn is not None:
            return fn(x, lens)
        if box["state"] == "fallback_dynamic":
            return dynamic(x, lens)
        with calib_lock:
            if box.get("fn") is None and box["state"] == "uncalibrated":
                emb = dynamic(x, lens)
                amax = _amax(x)
                if amax <= DEGENERATE_CALIBRATION_AMAX:
                    if not box.get("degenerate_logged"):
                        box["degenerate_logged"] = True
                        log.info("int8_static: batch abs-max %.2g is degenerate "
                                 "(warmup/silence): served dynamically, still waiting "
                                 "for a real calibration batch", amax)
                else:
                    _calibrate_locked(x, lens)
                return emb
        # calibrated (or fell back) while we waited on the lock
        return embed(x, lens)

    def calibrate(x, lens=None) -> str:
        """Explicit calibration batch; raises on a degenerate batch instead
        of skipping it. Overwrites any earlier calibration."""
        amax = _amax(x)
        if amax <= DEGENERATE_CALIBRATION_AMAX:
            raise ValueError(f"calibration batch abs-max {amax:.3g} <= "
                             f"{DEGENERATE_CALIBRATION_AMAX}: all-zeros/silence cannot "
                             "calibrate int8 scales")
        with calib_lock:
            box.pop("fn", None)
            box["state"] = "uncalibrated"
            return _calibrate_locked(x, lens)

    embed.calibrate = calibrate
    embed.calibration_state = lambda: box["state"]
    return embed
