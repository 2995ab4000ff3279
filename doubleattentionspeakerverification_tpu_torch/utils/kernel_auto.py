"""The kernel dispatcher: kernels B1 and B2 behind a one-time self-check
(JAX ``utils/kernel_auto.py``).

``ModelConfig.use_pallas_dsp`` (B2, the fused log-mel) and
``use_pallas_pooling`` (B1, the MHA pooling) are tri-state, as in the JAX
package:

- ``True``: the kernel on the card (the plain version on the CPU).
- ``False``: the plain version, chosen explicitly, on either device.
- ``None`` (auto): on the card, a one-time parity self-check per process
  (B2 against its plain version on 4 x 1 s of seeded noise at ``atol=1e-4,
  rtol=1e-5``; B1's value and gradient of ``sum(mha_pool(...)**2)`` through
  ``MhaPoolFunction`` against autograd through the plain version, B=4,
  T=96, lengths 96/50/17/96, d_h 16, at ``atol=rtol=1e-4``); if it passes,
  the kernel runs. On the CPU auto resolves to the plain version, as JAX
  resolves it to its XLA path off a TPU.

How this differs from the JAX module, on purpose: a failed or crashed
self-check raises ``RuntimeError`` naming the kernel and the largest
difference, where the JAX gate logs a warning and falls back to XLA. On the
card nothing quietly gives way to the plain version; only an explicit
``False`` selects it. The self-checks' launches are counted apart
(``ops/kernels.py:uncounted``), so a path's launch counts are its own.

Resolution happens where a model is run (the train and eval steps, the
trainer's validation, ``EmbeddingExtractor``, ``api.py``, the CLIs,
``make_int8_embed_fn``), not at config creation: configs and checkpoints keep
the tri-state. A site passes the resolved choice on explicitly: B1's through
:func:`route_model`, which sets ``use_kernel`` on the model's MHA poolings;
B2's as the ``use_kernel`` argument of ``ops/logmel.py``'s wrapper. A model
no site has routed takes the kernels on the card, as the port did before
the dispatcher. Decisions and self-check results are cached per process and
reported by :func:`decisions`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig, FeatureConfig, ModelConfig
from ..ops import logmel as logmel_ops
from ..ops import mha_pool as mha_ops
from ..ops.kernels import uncounted

_DECISIONS: Dict[str, str] = {}
# (gate, ...) -> (largest |kernel - plain|, milliseconds the check took)
_GATE_CACHE: Dict[tuple, Tuple[float, float]] = {}

DSP_ATOL, DSP_RTOL = 1e-4, 1e-5
POOL_TOL = 1e-4


def decisions() -> Dict[str, str]:
    """How each flag resolved in this process (for chip_smoke and debug
    output)."""
    return dict(_DECISIONS)


def _card(device=None) -> Optional[torch.device]:
    """The CUDA device a site runs on, or None off the card. ``device=None``
    means the card when there is one."""
    if device is None:
        return torch.device("cuda") if torch.cuda.is_available() else None
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def _max_diff(got: torch.Tensor, ref: torch.Tensor) -> float:
    if got.shape != ref.shape:
        return float("nan")
    return float((got.to(torch.float64) - ref.to(torch.float64)).abs().max())


def _run_check(key: tuple, kernel: str, body) -> Tuple[float, float]:
    """Run ``body() -> (ok, largest difference)`` once per key; raise unless
    it passes."""
    if key in _GATE_CACHE:
        return _GATE_CACHE[key]
    t0 = time.perf_counter()
    try:
        with uncounted(), torch.inference_mode(False):
            ok, diff = body()
    except Exception as e:
        raise RuntimeError(f"kernel {kernel} self-check crashed: {e!r}; set its flag to "
                           "False to run the plain version") from e
    ms = (time.perf_counter() - t0) * 1e3
    if not ok:
        raise RuntimeError(f"kernel {kernel} self-check FAILED: largest |kernel - plain| = "
                           f"{diff:.3g}; set its flag to False to run the plain version")
    _GATE_CACHE[key] = (diff, ms)
    return diff, ms


def _dsp_check(feat_cfg: FeatureConfig, dev: torch.device) -> Tuple[float, float]:
    def body():
        rng = np.random.default_rng(0)
        waves = torch.from_numpy(
            rng.standard_normal((4, feat_cfg.sample_rate), np.float32) * np.float32(0.1)
        ).to(dev)
        ref = logmel_ops.log_mel_spectrogram_fused(waves, feat_cfg, use_kernel=False).cpu()
        fast = logmel_ops.log_mel_spectrogram_fused(waves, feat_cfg, use_kernel=True).cpu()
        # the kernel's accuracy class with a margin: a regression of one
        # class must not pass (rtol stays tiny: log-mel values are O(10))
        ok = fast.shape == ref.shape and bool(
            torch.allclose(fast, ref, atol=DSP_ATOL, rtol=DSP_RTOL))
        return ok, _max_diff(fast, ref)

    return _run_check(("dsp", dataclasses.astuple(feat_cfg), str(dev)), "B2 (logmel)", body)


def _pooling_check(mcfg: ModelConfig, dev: torch.device) -> Tuple[float, float]:
    heads, dk_is_heads = mcfg.heads_number, mcfg.mha_dk_is_heads

    def body():
        d_h = 16
        rng = np.random.default_rng(1)
        ht0 = rng.standard_normal((4, 96, heads * d_h)).astype(np.float32)
        q0 = rng.standard_normal((d_h, heads)).astype(np.float32)
        lengths = torch.tensor([96, 50, 17, 96], dtype=torch.int32, device=dev)

        def value_and_grads(pool):
            ht = torch.tensor(ht0, device=dev, requires_grad=True)
            query = torch.tensor(q0, device=dev, requires_grad=True)
            v = (pool(ht, query) ** 2).sum()
            g_ht, g_q = torch.autograd.grad(v, (ht, query))
            return v.detach().cpu(), g_ht.cpu(), g_q.cpu()

        def plain(ht, query):
            return mha_ops.mha_pool_plain(*mha_ops._operands(ht, query, lengths, heads,
                                                             dk_is_heads))

        with torch.enable_grad():
            ref = value_and_grads(plain)
            fast = value_and_grads(lambda ht, query: mha_ops.mha_pool(
                ht, query, lengths, heads, dk_is_heads, use_kernel=True))
        ok = fast[0].shape == ref[0].shape and bool(
            torch.allclose(fast[0], ref[0], rtol=POOL_TOL))
        for f, r in zip(fast[1:], ref[1:]):
            ok = ok and f.shape == r.shape and bool(
                torch.allclose(f, r, atol=POOL_TOL, rtol=POOL_TOL))
        return ok, max(_max_diff(f, r) for f, r in zip(fast, ref))

    return _run_check(("pool", heads, dk_is_heads, str(dev)), "B1 (mha_pool)", body)


def resolve_dsp(flag: Optional[bool], feat_cfg: Optional[FeatureConfig] = None,
                need_dsp: bool = True, device=None) -> bool:
    """B2's concrete choice (``use_pallas_dsp``) for a site on ``device``."""
    if flag is not None:
        _DECISIONS["use_pallas_dsp"] = f"explicit->{flag}"
        return flag
    if not need_dsp:
        _DECISIONS.setdefault("use_pallas_dsp", "auto->False (DSP unused here)")
        return False
    card = _card(device)
    if card is None:
        _DECISIONS["use_pallas_dsp"] = "auto->False"
        return False
    diff, ms = _dsp_check(feat_cfg or FeatureConfig(), card)
    _DECISIONS["use_pallas_dsp"] = (f"auto->True (self-check: largest difference {diff:.3g}, "
                                    f"{ms:.1f} ms)")
    return True


def resolve_pooling(mcfg: ModelConfig, device=None) -> bool:
    """B1's concrete choice (``use_pallas_pooling``) for a site on ``device``."""
    if mcfg.use_pallas_pooling is not None:
        _DECISIONS["use_pallas_pooling"] = f"explicit->{mcfg.use_pallas_pooling}"
        return mcfg.use_pallas_pooling
    card = _card(device)
    if card is None:
        _DECISIONS["use_pallas_pooling"] = "auto->False"
        return False
    diff, ms = _pooling_check(mcfg, card)
    _DECISIONS["use_pallas_pooling"] = (f"auto->True (self-check: largest difference "
                                        f"{diff:.3g}, {ms:.1f} ms)")
    return True


def resolve_model_kernels(mcfg: ModelConfig, feat_cfg: Optional[FeatureConfig] = None,
                          need_dsp: bool = True, device=None) -> ModelConfig:
    """Concrete ``use_pallas_*`` flags for a site running on ``device`` (the
    card when there is one, by default); see the module docstring.

    ``need_dsp=False`` marks sites that never run the log-mel on the device
    (feature-mode training, embedding from features): the DSP flag then
    resolves to False without running B2's self-check, as in JAX."""
    dsp = resolve_dsp(mcfg.use_pallas_dsp, feat_cfg, need_dsp, device)
    pool = resolve_pooling(mcfg, device)
    if dsp == mcfg.use_pallas_dsp and pool == mcfg.use_pallas_pooling:
        return mcfg
    return dataclasses.replace(mcfg, use_pallas_dsp=dsp, use_pallas_pooling=pool)


def resolve_fast_kernels(cfg: ExperimentConfig, device=None,
                         need_dsp: Optional[bool] = None) -> ExperimentConfig:
    """``cfg`` with concrete kernel flags for a train or eval step on
    ``device`` (checkpoint configs keep the tri-state). The step runs B2 only
    when its batches carry waves: by default as ``DataConfig.step_sees_waves``
    says (the same rule the trainer's loader follows)."""
    if need_dsp is None:
        need_dsp = cfg.data.step_sees_waves()
    resolved = resolve_model_kernels(cfg.model, cfg.features, need_dsp=need_dsp, device=device)
    if resolved is cfg.model:
        return cfg
    return dataclasses.replace(cfg, model=resolved)


def route_model(model: torch.nn.Module, mcfg: ModelConfig) -> torch.nn.Module:
    """Set the resolved pooling choice of ``mcfg`` on ``model``'s MHA
    poolings (B1 unless ``use_pallas_pooling`` is False); returns the
    model."""
    from ..models.poolings import MHAPooling

    for m in model.modules():
        if isinstance(m, MHAPooling):
            m.use_kernel = mcfg.use_pallas_pooling is not False
    return model
