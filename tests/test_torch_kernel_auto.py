"""The port's kernel dispatcher (``utils/kernel_auto.py``) against the JAX
package's (``tests/test_kernel_auto.py``'s cases, where they apply), on the
CPU with tiny models (k=16, 4 heads).

There is no card here, so "on the card" is played by patching
``kernel_auto._card`` to hand the self-checks the CPU: the kernel route of a
wrapper then takes the plain version (CPU tensors never launch), and a
faulty kernel is played by patching the wrapper the check calls. The one
deliberate difference from JAX is pinned: a failing self-check raises in
the port where JAX's gate falls back to XLA.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu.config import DataConfig as JaxDataConfig
from doubleattentionspeakerverification_tpu.config import ExperimentConfig as JaxExperimentConfig
from doubleattentionspeakerverification_tpu.config import FeatureConfig as JaxFeatureConfig
from doubleattentionspeakerverification_tpu.config import ModelConfig as JaxModelConfig
from doubleattentionspeakerverification_tpu.utils import kernel_auto as jka
from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel
from doubleattentionspeakerverification_tpu_torch.cli import extract_features as pextract
from doubleattentionspeakerverification_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    FeatureConfig,
    ModelConfig,
)
from doubleattentionspeakerverification_tpu_torch.data.wav import write_wav
from doubleattentionspeakerverification_tpu_torch.models import quantized as pq
from doubleattentionspeakerverification_tpu_torch.models.classifier import SpeakerClassifier
from doubleattentionspeakerverification_tpu_torch.models.init import init_parameters
from doubleattentionspeakerverification_tpu_torch.models.poolings import MHAPooling
from doubleattentionspeakerverification_tpu_torch.ops import kernels
from doubleattentionspeakerverification_tpu_torch.ops import logmel as logmel_ops
from doubleattentionspeakerverification_tpu_torch.ops import mha_pool as mha_ops
from doubleattentionspeakerverification_tpu_torch.training.optimizers import make_optimizer
from doubleattentionspeakerverification_tpu_torch.training.step import (
    make_eval_loss_step,
    make_train_step,
)
from doubleattentionspeakerverification_tpu_torch.utils import kernel_auto

TINY = dict(kernel_size=16, heads_number=4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_gate_cache():
    for mod in (kernel_auto, jka):
        mod._GATE_CACHE.clear()
        mod._DECISIONS.clear()
    yield
    for mod in (kernel_auto, jka):
        mod._GATE_CACHE.clear()
        mod._DECISIONS.clear()


@pytest.fixture
def on_card(monkeypatch):
    """The self-checks run as on the card, on CPU tensors."""
    monkeypatch.setattr(kernel_auto, "_card", lambda device=None: torch.device("cpu"))


def _uses_kernel(model):
    return [m.use_kernel for m in model.modules() if isinstance(m, MHAPooling)]


def test_auto_resolves_off_on_cpu():
    mcfg = ModelConfig(**TINY)
    assert mcfg.use_pallas_dsp is None and mcfg.use_pallas_pooling is None
    r = kernel_auto.resolve_model_kernels(mcfg, FeatureConfig())
    assert r.use_pallas_dsp is False and r.use_pallas_pooling is False
    jr = jka.resolve_model_kernels(JaxModelConfig(**TINY), JaxFeatureConfig())
    assert (jr.use_pallas_dsp, jr.use_pallas_pooling) == (False, False)
    assert kernel_auto.decisions() == jka.decisions() == {
        "use_pallas_dsp": "auto->False",
        "use_pallas_pooling": "auto->False",
    }
    assert not kernel_auto._GATE_CACHE


def test_explicit_choice_is_honored(on_card):
    """An explicit choice runs no self-check, even on the card, and is
    recorded (JAX records nothing for it)."""
    mcfg = ModelConfig(**TINY, use_pallas_dsp=True, use_pallas_pooling=False)
    r = kernel_auto.resolve_model_kernels(mcfg, FeatureConfig())
    assert r is mcfg
    assert not kernel_auto._GATE_CACHE
    assert kernel_auto.decisions() == {"use_pallas_dsp": "explicit->True",
                                       "use_pallas_pooling": "explicit->False"}
    jcfg = JaxModelConfig(**TINY, use_pallas_dsp=True, use_pallas_pooling=False)
    assert jka.resolve_model_kernels(jcfg, JaxFeatureConfig()) is jcfg
    assert jka.decisions() == {}
    model = kernel_auto.route_model(SpeakerClassifier(ModelConfig(**TINY)), r)
    assert _uses_kernel(model) == [False]


def test_auto_enables_when_gates_pass(on_card, monkeypatch):
    """Both self-checks pass (the kernel routes take the plain forward on CPU
    tensors, and B1's gradient is ``MhaPoolFunction``'s own backward against
    autograd through the plain version); their launches are counted apart."""
    real_pool = mha_ops.mha_pool
    monkeypatch.setattr(mha_ops.KERNEL, "_function", lambda symbol=None: lambda *a: 0)

    def launching_pool(*args, use_kernel=True, **kw):
        if use_kernel:
            mha_ops.KERNEL.launch()
        return real_pool(*args, use_kernel=use_kernel, **kw)

    monkeypatch.setattr(mha_ops, "mha_pool", launching_pool)
    before = (mha_ops.KERNEL.launches, mha_ops.KERNEL.check_launches)
    r = kernel_auto.resolve_model_kernels(ModelConfig(**TINY), FeatureConfig())
    assert r.use_pallas_pooling is True and r.use_pallas_dsp is True
    assert (mha_ops.KERNEL.launches, mha_ops.KERNEL.check_launches) == (before[0], before[1] + 1)
    d = kernel_auto.decisions()
    assert d["use_pallas_dsp"].startswith("auto->True (self-check: largest difference")
    assert d["use_pallas_pooling"].startswith("auto->True (self-check: largest difference")
    keys = {k[0] for k in kernel_auto._GATE_CACHE}
    assert keys == {"dsp", "pool"}
    for diff, ms in kernel_auto._GATE_CACHE.values():
        assert 0.0 <= diff <= 1e-4 and ms > 0
    # cached: a second resolution runs no check
    kernel_auto.resolve_model_kernels(ModelConfig(**TINY), FeatureConfig())
    assert mha_ops.KERNEL.check_launches == before[1] + 1


def test_launches_inside_uncounted_are_counted_apart(monkeypatch):
    k = kernels.CudaKernel("fake", "mha_pool.cu", "fake", [])
    monkeypatch.setattr(k, "_function", lambda symbol=None: lambda *a: 0)
    k.launch()
    with kernels.uncounted():
        k.launch()
        k.launch()
        other = threading.Thread(target=k.launch)   # another thread counts as usual
        other.start()
        other.join()
    k.launch()
    assert (k.launches, k.check_launches) == (3, 2)


def test_gate_failure_raises_where_jax_falls_back(on_card, monkeypatch):
    """A B1 that gives wrong values makes resolution raise, naming the kernel
    and the largest difference; JAX's gate falls back to XLA instead."""
    real_pool = mha_ops.mha_pool

    def broken(ht, query, lengths, heads, dk_is_heads=True, use_kernel=True):
        out = real_pool(ht, query, lengths, heads, dk_is_heads, use_kernel)
        return out * 0 + 1 if use_kernel else out

    monkeypatch.setattr(mha_ops, "mha_pool", broken)
    with pytest.raises(RuntimeError, match=r"B1 \(mha_pool\) self-check FAILED: largest"):
        kernel_auto.resolve_model_kernels(ModelConfig(**TINY, use_pallas_dsp=False))
    assert "use_pallas_pooling" not in kernel_auto.decisions()
    assert not kernel_auto._GATE_CACHE

    def crashing(*a, use_kernel=True, **kw):
        raise ValueError("launch refused")

    monkeypatch.setattr(mha_ops, "mha_pool", crashing)
    with pytest.raises(RuntimeError, match=r"B1 \(mha_pool\) self-check crashed"):
        kernel_auto.resolve_model_kernels(ModelConfig(**TINY, use_pallas_dsp=False))

    # the JAX package, the same fault: a logged fallback
    from jax.experimental.pallas import tpu as pltpu

    from doubleattentionspeakerverification_tpu.ops import pooling_pallas

    def jax_broken(params, ht, lengths, heads, dk_is_heads):
        import jax.numpy as jnp

        b, _, d = ht.shape
        return jnp.ones((b, heads, d // heads), ht.dtype)

    monkeypatch.setattr(jka, "_on_tpu", lambda: True)
    monkeypatch.setattr(pooling_pallas, "mha_pool_pallas", jax_broken)
    with pltpu.force_tpu_interpret_mode():
        jr = jka.resolve_model_kernels(JaxModelConfig(**TINY, use_pallas_dsp=False))
    assert jr.use_pallas_pooling is False
    assert jka.decisions()["use_pallas_pooling"] == "auto->False"


def test_dsp_gate_rejects_accuracy_class_regression(on_card, monkeypatch):
    """B2 off by 5e-4 (about fifty times its accuracy class) must not pass:
    the port raises, naming B2 and the difference."""
    real = logmel_ops.log_mel_spectrogram_fused

    def degraded(wave, cfg, use_kernel=True):
        out = real(wave, cfg, use_kernel)
        return out + 5e-4 if use_kernel else out

    monkeypatch.setattr(logmel_ops, "log_mel_spectrogram_fused", degraded)
    mcfg = ModelConfig(**TINY, use_pallas_pooling=False)
    with pytest.raises(RuntimeError, match=r"B2 \(logmel\) self-check FAILED: largest "
                                           r"\|kernel - plain\| = 0.0005"):
        kernel_auto.resolve_model_kernels(mcfg, FeatureConfig())
    assert "use_pallas_dsp" not in kernel_auto.decisions()


def test_pooling_gate_passes_textbook_dk_scaling(on_card):
    mcfg = ModelConfig(**TINY, mha_dk_is_heads=False, use_pallas_dsp=False)
    r = kernel_auto.resolve_model_kernels(mcfg, FeatureConfig())
    assert r.use_pallas_pooling is True
    # the cache keys on the toggle: the default convention runs its own check
    assert ("pool", 4, False, "cpu") in kernel_auto._GATE_CACHE
    kernel_auto.resolve_model_kernels(dataclasses.replace(mcfg, mha_dk_is_heads=True))
    assert ("pool", 4, True, "cpu") in kernel_auto._GATE_CACHE


def test_need_dsp_follows_source_mode(on_card):
    """The step's DSP flag follows ``DataConfig.step_sees_waves()``, as in
    JAX; where the step sees no waves B2's check never runs."""
    cases = [
        (dict(source="features"), "features", False),
        (dict(source="wav"), "wav_pcm", True),
        (dict(source="wav", host_dsp=True), "wav_host_dsp", False),
        (dict(source="wav", train_feature_cache_mb=64), "wav_cache", False),
        (dict(source="wav", host_dsp=True, train_feature_cache_dir="/tmp/x"),
         "wav_cache", False),
    ]
    for kw, mode, sees_waves in cases:
        dcfg, jdcfg = DataConfig(**kw), JaxDataConfig(**kw)
        assert dcfg.source_mode() == jdcfg.source_mode() == mode
        assert dcfg.step_sees_waves() is jdcfg.step_sees_waves() is sees_waves
        kernel_auto._GATE_CACHE.clear()
        kernel_auto._DECISIONS.clear()
        cfg = ExperimentConfig(model=ModelConfig(**TINY), data=dcfg)
        r = kernel_auto.resolve_fast_kernels(cfg)
        assert r.model.use_pallas_dsp is sees_waves and r.model.use_pallas_pooling is True
        assert any(k[0] == "dsp" for k in kernel_auto._GATE_CACHE) is sees_waves
        if not sees_waves:
            assert kernel_auto.decisions()["use_pallas_dsp"] == "auto->False (DSP unused here)"


def test_tristate_survives_config_roundtrip():
    """Either package reads the other's config with the tri-state intact."""
    for dsp, pool in ((None, None), (False, True), (True, False)):
        cfg = ExperimentConfig(model=ModelConfig(**TINY, use_pallas_dsp=dsp,
                                                 use_pallas_pooling=pool))
        jcfg = JaxExperimentConfig(model=JaxModelConfig(**TINY, use_pallas_dsp=dsp,
                                                        use_pallas_pooling=pool))
        for rt in (ExperimentConfig.from_json(cfg.to_json()),
                   ExperimentConfig.from_json(jcfg.to_json()),
                   JaxExperimentConfig.from_json(cfg.to_json())):
            assert (rt.model.use_pallas_dsp, rt.model.use_pallas_pooling) == (dsp, pool)


def test_resolution_is_site_local_not_baked(on_card):
    """Each site resolves for itself and routes its model; the caller's
    config keeps the tri-state (checkpoints stay portable)."""
    cfg = ExperimentConfig(model=ModelConfig(**TINY, embedding_size=16, num_spkrs=2))
    model = SpeakerClassifier(cfg.model)
    model.pooling.mha.use_kernel = False
    step = make_train_step(cfg, model, make_optimizer(cfg.train, model.parameters()),
                           device="cpu")
    assert cfg.model.use_pallas_dsp is None and cfg.model.use_pallas_pooling is None
    assert step.cfg.model.use_pallas_pooling is True and _uses_kernel(model) == [True]
    plain = cfg.replace(model=dataclasses.replace(cfg.model, use_pallas_pooling=False))
    make_eval_loss_step(plain, model, device="cpu")
    assert _uses_kernel(model) == [False]
    assert kernel_auto.decisions()["use_pallas_pooling"] == "explicit->False"
    # the inference API resolves both kernels for its device
    api = SpeakerEmbeddingModel(SpeakerClassifier(plain.model), plain, device="cpu")
    assert _uses_kernel(api.model) == [False] and api._dsp_kernel is True


def test_a_wave_batch_resolves_b2_where_the_config_says_features(on_card):
    """A step built from a features config (B2 resolved as unused, no
    check) that is fed waves resolves B2 then, behind its self-check,
    rather than running the plain log-mel unasked; the caller's config and
    an explicit choice stay as they were."""
    cfg = ExperimentConfig(model=ModelConfig(**TINY, embedding_size=16, num_spkrs=2,
                                             mask_prob=0.0))
    model = SpeakerClassifier(cfg.model)
    step = make_train_step(cfg, model, make_optimizer(cfg.train, model.parameters()),
                           device="cpu")
    assert step.cfg.model.use_pallas_dsp is False and not any(
        k[0] == "dsp" for k in kernel_auto._GATE_CACHE)
    rng = np.random.default_rng(0)
    batch = {"waves": rng.integers(-3000, 3000, (1, 2, 8000)).astype(np.int16),
             "lengths": np.full((1, 2), 8000, np.int32), "labels": np.zeros((1, 2), np.int32)}
    step(batch)
    assert step.cfg.model.use_pallas_dsp is True and cfg.model.use_pallas_dsp is None
    assert any(k[0] == "dsp" for k in kernel_auto._GATE_CACHE)
    explicit = cfg.replace(model=dataclasses.replace(cfg.model, use_pallas_dsp=False))
    evaluate = make_eval_loss_step(explicit, model, device="cpu")
    evaluate(batch)
    assert kernel_auto.decisions()["use_pallas_dsp"] == "explicit->False"


def test_pooling_choice_reaches_the_wrapper(monkeypatch):
    """A model's routed choice travels into B1's wrapper as ``use_kernel``,
    which takes the plain forward where it is False on any device."""
    seen = []
    real_apply = mha_ops.MhaPoolFunction.apply
    monkeypatch.setattr(mha_ops.MhaPoolFunction, "apply",
                        lambda *a: seen.append(a[-1]) or real_apply(*a))
    cfg = ModelConfig(**TINY, embedding_size=16, num_spkrs=2)
    model = init_parameters(SpeakerClassifier(cfg), torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 40, 80)
    with torch.no_grad():
        for flag in (False, True):
            kernel_auto.route_model(model, dataclasses.replace(cfg, use_pallas_pooling=flag))
            model(x)
    assert seen == [False, True]


def test_int8_static_gate(on_card, monkeypatch):
    """On the card the ``int8_static`` calibration holds B3 to its plain
    version on the calibration batch and records both times; a mismatch
    raises. Off the card only the decision is recorded."""
    cfg = ModelConfig(**TINY, embedding_size=16, num_spkrs=2)
    model = init_parameters(SpeakerClassifier(cfg), torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 40, 80)).astype(np.float32))
    lens = torch.tensor([40, 29])
    with torch.no_grad():
        fn = pq.make_int8_embed_fn(model, cfg, scheme="static")
        assert fn.calibrate(x, lens) == "static"
        verdict = kernel_auto.decisions()["int8_pallas_conv"]
        assert verdict.startswith("auto->True (B3 ") and " ms vs plain " in verdict
        assert "(2, 40, 80)" in verdict and "7 int8 activations equal" in verdict

        real = pq.conv3x3_int8

        def off_by_one(q, w9, mult, bias, out_kind="int8", w_packed=None, use_kernel=True):
            y = real(q, w9, mult, bias, out_kind, w_packed, use_kernel)
            return y + 1 if use_kernel and y.dtype == torch.int8 else y

        monkeypatch.setattr(pq, "conv3x3_int8", off_by_one)
        with pytest.raises(RuntimeError, match=r"B3 \(conv_int8\) int8_static self-check "
                                               r"FAILED"):
            fn.calibrate(x, lens)
        monkeypatch.undo()
        kernel_auto._DECISIONS.clear()
        assert pq.make_int8_embed_fn(model, cfg, scheme="static").calibrate(x, lens) == "static"
        assert kernel_auto.decisions()["int8_pallas_conv"] == "auto->False (not on the card)"


def test_extract_features_flag_routes_b2(on_card, monkeypatch, tmp_path):
    """``cli/extract_features.py``'s ``--use_pallas_dsp`` reaches B2's
    wrapper: on, off (``--no-``), or auto behind the self-check."""
    wav = tmp_path / "a.wav"
    write_wav(str(wav), 0.1 * np.sin(np.arange(8000) / 7.0), 16000)
    (tmp_path / "list.txt").write_text(f"{wav}\n")
    seen = []
    real = logmel_ops.log_mel_spectrogram_fused

    def spy(wave, cfg, use_kernel=True):
        if wave.dim() == 2:     # a 1-D wave comes back through here as (1, N)
            seen.append(use_kernel)
        return real(wave, cfg, use_kernel)

    monkeypatch.setattr(logmel_ops, "log_mel_spectrogram_fused", spy)
    for flags, want in ((["--use_pallas_dsp"], [True]), (["--no-use_pallas_dsp"], [False]),
                        ([], [False, True, True])):
        seen.clear()
        assert pextract.main(["-i", str(tmp_path / "list.txt"), "--device", "cpu",
                              *flags]) == 0
        assert seen == want, flags
    assert (tmp_path / "a.pickle").exists()
