"""The port's offline tools against the JAX package's on the CPU:
``cli/extract_features.py`` (the log-mel on the device path, here kernel B2's
plain version, and the native host kernel), ``models/classifier.py``
``get_alignments`` and ``cli/alignments.py`` for MHA, DoubleMHA and
Attention pooling, ``utils/torch_export.py`` and
``cli/export_checkpoint.py`` (every tensor, the optimizer state, the
settings, epoch and step of the JAX export of the same checkpoint),
``data/vad.py`` and ``models/flops.py``.

Tiny models (VGG4L k=16, 4 heads); their weights are the port's seeded
init, written as JAX-format ``.npz`` files. The JAX CLIs' checkpoint loader
gets its template from ``jax.eval_shape`` (``test_torch_scoring.py``).
"""

import contextlib
import dataclasses
import io
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu import config as jconfig
from doubleattentionspeakerverification_tpu.cli import alignments as jalign
from doubleattentionspeakerverification_tpu.cli import export_checkpoint as jexport
from doubleattentionspeakerverification_tpu.cli import extract_features as jextract
from doubleattentionspeakerverification_tpu.data import vad as jvad
from doubleattentionspeakerverification_tpu.models import classifier as jclassifier
from doubleattentionspeakerverification_tpu.models import flops as jflops
from doubleattentionspeakerverification_tpu_torch import config as pconfig
from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel
from doubleattentionspeakerverification_tpu_torch.cli import alignments as palign
from doubleattentionspeakerverification_tpu_torch.cli import export_checkpoint as pexport
from doubleattentionspeakerverification_tpu_torch.cli import extract_features as pextract
from doubleattentionspeakerverification_tpu_torch.data import vad as pvad
from doubleattentionspeakerverification_tpu_torch.data.wav import encode_wav
from doubleattentionspeakerverification_tpu_torch.models import flops as pflops
from doubleattentionspeakerverification_tpu_torch.models.classifier import (
    SpeakerClassifier,
    get_alignments,
)
from doubleattentionspeakerverification_tpu_torch.models.init import init_parameters
from doubleattentionspeakerverification_tpu_torch.training.optimizers import make_optimizer
from doubleattentionspeakerverification_tpu_torch.utils import native as pnative
from doubleattentionspeakerverification_tpu_torch.utils import torch_import as pimport
from doubleattentionspeakerverification_tpu_torch.utils.checkpoint import save_checkpoint
from doubleattentionspeakerverification_tpu_torch.utils.weights import (
    optimizer_state_by_name,
    train_state_to_jax,
)
from test_torch_scoring import _shape_only_jax_init

TOL_LOGMEL = 2e-4     # B2's plain version against JAX's XLA log-mel (test_torch_logmel.py)
TOL_ALIGN = 1e-5
MODEL = dict(kernel_size=16, heads_number=4, embedding_size=16, num_spkrs=5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _wav(path, seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    y = 0.3 * np.sin(2 * np.pi * (150 + 60 * seed) * t + 3 * np.sin(2 * np.pi * 2 * t))
    with open(path, "wb") as f:
        f.write(encode_wav((y + 0.02 * rng.standard_normal(n)).astype(np.float32), 16000))
    return str(path)


def _checkpoint(path, cfg, seed=0, optimizer=None, steps=0, epoch=0):
    """The port's seeded init (and ``steps`` optimizer steps on seeded
    gradients) as a JAX-format ``.npz``; returns the model."""
    model = init_parameters(SpeakerClassifier(cfg.model), torch.Generator().manual_seed(seed))
    opt_state, name = {}, optimizer or cfg.train.optimizer
    if steps:
        opt = make_optimizer(cfg.train, model.parameters())
        g = torch.Generator().manual_seed(seed + 1)
        for _ in range(steps):
            for p in model.parameters():
                p.grad = torch.randn(p.shape, generator=g)
            opt.step()
        opt_state = optimizer_state_by_name(model, opt)
    save_checkpoint(path, train_state_to_jax(model.state_dict(), opt_state, name, steps,
                                             cfg.train.learning_rate),
                    {"config": cfg.to_dict(), "step": steps, "epoch": epoch})
    return model


# ------------------------------------------------------------ extract_features
@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    paths = [_wav(d / f"a{i}.wav", s, i) for i, s in enumerate((0.7, 1.3, 1.9))]
    # a path without the .wav extension keeps its whole name
    os.rename(paths[2], str(d / "a2"))
    paths[2] = str(d / "a2")
    (d / "files.lst").write_text("".join(p + "\n" for p in paths) + "\n")
    return d, paths


def _pickles(paths):
    out = []
    for p in paths:
        base = p[:-4] if p.endswith(".wav") else p
        with open(base + ".pickle", "rb") as f:
            out.append(pickle.load(f))
    return out


def test_extract_features_device_path_equals_jax(wavs):
    """Default path on ``--device cpu`` (B2's plain version) against JAX's
    bucketed XLA log-mel; the paths and their order printed alike."""
    d, paths = wavs
    lst = str(d / "files.lst")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jextract.main(["-i", lst, "--bucket_seconds", "1.0"]) == 0
    want = _pickles(paths)
    with contextlib.redirect_stdout(out):
        assert pextract.main(["-i", lst, "--device", "cpu", "--bucket_seconds", "1.0",
                              "--use_pallas_dsp"]) == 0
    got = _pickles(paths)
    assert out.getvalue().splitlines() == paths * 2
    for g, w, p in zip(got, want, paths):
        assert g.shape == w.shape and g.shape[0] == 80 and g.dtype == w.dtype, p
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=TOL_LOGMEL, err_msg=p)


def test_extract_features_host_dsp_equals_jax(wavs):
    """``--host_dsp``: both packages' native builds of ``native/logmel.cpp``,
    bit for bit."""
    if pnative.get_lib() is None:
        pytest.skip("no C++ toolchain for the native host kernel")
    d, paths = wavs
    lst = str(d / "files.lst")
    with contextlib.redirect_stdout(io.StringIO()):
        assert jextract.main(["-i", lst, "--host_dsp"]) == 0
        want = _pickles(paths)
        assert pextract.main(["-i", lst, "--host_dsp"]) == 0
    for g, w in zip(_pickles(paths), want):
        np.testing.assert_array_equal(g, w)


def test_extract_file_refuses_another_rate(wavs, tmp_path):
    d, paths = wavs
    cfg = pconfig.FeatureConfig(sample_rate=8000)
    with pytest.raises(ValueError, match="sample rate 16000 != 8000"):
        pextract.extract_file(paths[0], cfg, lambda w: w)


# ---------------------------------------------------------------- alignments
def _cfg(pooling, **model):
    return pconfig.ExperimentConfig(model=pconfig.ModelConfig(
        **{**MODEL, "pooling_method": pooling, **model}))


def _jax_params(model, cfg):
    """The port model's weights as JAX params and ModelState."""
    flat = train_state_to_jax(model.state_dict(), {}, "SGD", 0, 0.1)
    params = {}
    for key, value in flat.items():
        if key.startswith("params/"):
            node = params
            *path, leaf = key.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = value
    state = jclassifier.ModelState(*(flat[f"model_state/{k}"]
                                     for k in ("bn_mean", "bn_var", "bn_count")))
    return params, state, jconfig.ModelConfig(**dataclasses.asdict(cfg.model))


@pytest.mark.parametrize("pooling", ["MHA", "DoubleMHA", "Attention"])
def test_get_alignments_equals_jax(pooling):
    """A padded batch (lengths 47 and 30): time weights (B, T', H), or
    (B, T') for Attention, and DoubleMHA's head weights (B, H), against
    JAX's XLA path at 1e-5; each head's weights sum to 1 over the valid
    frames."""
    cfg = _cfg(pooling)
    model = init_parameters(SpeakerClassifier(cfg.model), torch.Generator().manual_seed(2)).eval()
    x = np.random.default_rng(0).standard_normal((2, 47, 80)).astype(np.float32)
    lens = np.array([47, 30], np.int32)
    got = get_alignments(model, torch.from_numpy(x), torch.from_numpy(lens).long())
    params, state, jcfg = _jax_params(model, cfg)
    want = jax.jit(jclassifier.get_alignments, static_argnums=4)(params, state, x, lens, jcfg)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == (2 if pooling == "DoubleMHA" else 1)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL_ALIGN)
    time_w = got[0].numpy()
    np.testing.assert_allclose(time_w.sum(axis=1), 1.0, atol=1e-5)
    assert np.all(time_w[1, -(-30 // 16):] == 0)


def test_get_alignments_refuse_statistical_pooling():
    cfg = _cfg("StatisticalPooling")
    model = SpeakerClassifier(cfg.model).eval()
    with pytest.raises(ValueError, match="no alignments for pooling_method 'StatisticalPooling'"):
        get_alignments(model, torch.zeros(1, 20, 80))


def test_alignments_cli_equals_jax(wavs, tmp_path):
    """The CLI on a DoubleMHA checkpoint: the ``--output`` npz keys and
    values, and the printed form, against JAX's CLI on the same file."""
    cfg = _cfg("DoubleMHA")
    ckpt = str(tmp_path / "m.npz")
    _checkpoint(ckpt, cfg, seed=4)
    audio = wavs[1][1]
    args = ["--audioPath", audio, "--modelCheckpoint", ckpt]
    with _shape_only_jax_init(), contextlib.redirect_stdout(io.StringIO()):
        assert jalign.main(args + ["--output", str(tmp_path / "j.npz")]) == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert palign.main(args + ["--output", str(tmp_path / "p.npz"), "--device", "cpu"]) == 0
    assert out.getvalue().startswith(f"wrote {tmp_path / 'p.npz'}: time_alignment (")
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert set(p.files) == set(j.files) == {"time_alignment", "head_alignment"}
        for k in j.files:
            assert p[k].shape == j[k].shape
            np.testing.assert_allclose(p[k], j[k], rtol=0, atol=TOL_ALIGN, err_msg=k)
        np.testing.assert_allclose(p["time_alignment"].sum(axis=0), 1.0, atol=1e-5)
        np.testing.assert_allclose(p["head_alignment"].sum(), 1.0, atol=1e-5)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert palign.main(args + ["--device", "cpu"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("time_alignment (") and "head_alignment (4,)" in lines


def test_alignments_for_wav_attention_is_one_dimensional(wavs, tmp_path):
    cfg = _cfg("Attention")
    ckpt = str(tmp_path / "a.npz")
    _checkpoint(ckpt, cfg, seed=5)
    model = SpeakerEmbeddingModel.from_checkpoint(ckpt, device="cpu")
    time_w, head_w = palign.alignments_for_wav(wavs[1][0], model)
    assert head_w is None and time_w.ndim == 1
    assert time_w.sum() == pytest.approx(1.0, abs=1e-5)


# -------------------------------------------------------------------- export
def _export_pair(tmp_path, cfg, steps, extra=()):
    ckpt = str(tmp_path / "m_3.npz")
    _checkpoint(ckpt, cfg, seed=6, steps=steps, epoch=2)
    out = io.StringIO()
    with _shape_only_jax_init(), contextlib.redirect_stdout(out):
        assert jexport.main(["--checkpoint", ckpt, "--out", str(tmp_path / "j.chkpt"),
                             *extra]) == 0
        assert pexport.main(["--checkpoint", ckpt, "--out", str(tmp_path / "p.chkpt"),
                             *extra]) == 0
    assert out.getvalue().splitlines()[1] == f"wrote {tmp_path / 'p.chkpt'}"
    load = lambda p: torch.load(p, map_location="cpu", weights_only=False)  # noqa: E731
    return ckpt, load(str(tmp_path / "p.chkpt")), load(str(tmp_path / "j.chkpt"))


def _assert_same(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype, where
        assert torch.equal(got, want), where
    else:
        assert got == want and type(got) is type(want), where


@pytest.mark.parametrize("optimizer, no_optimizer", [
    ("Adam", False), ("Adam", True), ("RMSprop", False), ("SGD", False)])
def test_export_checkpoint_equals_jax(tmp_path, optimizer, no_optimizer):
    """Every model tensor (the dead b1/b3 included), the optimizer's
    state and param group, the settings, epoch and step: equal to the JAX
    export of the same checkpoint, dtypes too."""
    cfg = pconfig.ExperimentConfig(
        model=pconfig.ModelConfig(**MODEL, mask_prob=0.2, annealing=True),
        train=pconfig.TrainConfig(optimizer=optimizer, learning_rate=3e-3, weight_decay=1e-2),
        model_name="tiny")
    _, got, want = _export_pair(tmp_path, cfg, steps=2,
                                extra=["--no_optimizer"] if no_optimizer else [])
    assert set(got) == set(want) == {"model", "optimizer", "settings", "epoch", "step"}
    _assert_same(got["model"], want["model"], "model")
    _assert_same(got["optimizer"], want["optimizer"], "optimizer")
    assert vars(got["settings"]) == vars(want["settings"])
    assert (got["epoch"], got["step"]) == (want["epoch"], want["step"]) == (2, 2)
    n_state = len(got["optimizer"]["state"])
    assert n_state == (0 if no_optimizer or optimizer == "SGD" else 16 + 2 + 4 * 2 + 1)


def test_exported_chkpt_reads_back_through_torch_import(tmp_path):
    """The port's ``.chkpt`` read by the port's ``torch_import`` gives the
    checkpoint's weights, config, epoch and step, and embeds as the
    ``.npz`` does."""
    cfg = _cfg("DoubleMHA")
    ckpt, _, _ = _export_pair(tmp_path, cfg, steps=1)
    state, rcfg, epoch, step = pimport.load_torch_checkpoint(str(tmp_path / "p.chkpt"))
    assert (epoch, step) == (2, 1)
    assert rcfg.model == cfg.model
    npz = SpeakerEmbeddingModel.from_checkpoint(ckpt, device="cpu")
    want = npz.model.state_dict()
    assert set(state) == set(want)
    for k in want:
        # both packages write num_batches_tracked as a 1-element vector
        # (np.ascontiguousarray of a 0-d array), which torch BatchNorm loads
        assert torch.equal(state[k].reshape(want[k].shape), want[k]), k
    chkpt = SpeakerEmbeddingModel.from_checkpoint(str(tmp_path / "p.chkpt"), device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 90, 80)).astype(np.float32)
    np.testing.assert_array_equal(chkpt.embed_features(x), npz.embed_features(x))


def test_export_refuses_orbax_and_statistical_pooling(tmp_path):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert pexport.main(["--checkpoint", "run/m_1.orbax", "--out", "x.chkpt"]) == 2
    assert "doubleattentionspeakerverification_tpu.cli.convert_checkpoint" in err.getvalue()
    ckpt = str(tmp_path / "s.npz")
    _checkpoint(ckpt, _cfg("StatisticalPooling"))
    with pytest.raises(ValueError, match="StatisticalPooling"):
        pexport.main(["--checkpoint", ckpt, "--out", str(tmp_path / "s.chkpt")])


# -------------------------------------------------------------- VAD, flops
def test_energy_vad_and_feature_reader_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    feats = np.concatenate([rng.uniform(5, 10, (80, 60)), rng.uniform(0.0, 0.2, (80, 40)),
                            rng.uniform(4, 9, (80, 25))], axis=1).astype(np.float32)
    silent = np.full((80, 30), 0.1, np.float32)
    for kw in ({}, dict(threshold_db=10), dict(threshold_db=1, min_frames=50)):
        got, want = pvad.EnergyVAD(**kw), jvad.EnergyVAD(**kw)
        for f in (feats, silent):
            np.testing.assert_array_equal(got.frame_mask(f), want.frame_mask(f))
            np.testing.assert_array_equal(got.filter(f), want.filter(f))
    path = str(tmp_path / "f.pickle")
    with open(path, "wb") as f:
        pickle.dump(feats, f)
    for v in (None, (pvad.EnergyVAD(threshold_db=10), jvad.EnergyVAD(threshold_db=10))):
        got = pvad.feature_reader(path, v and v[0])
        want = jvad.feature_reader(path, v and v[1])
        np.testing.assert_array_equal(got, want)
    assert pvad.feature_reader(path, pvad.EnergyVAD(threshold_db=10)).shape[1] == 80


@pytest.mark.parametrize("front_end, pooling, heads", [
    ("VGG4L", "DoubleMHA", 32), ("VGG3L", "MHA", 8), ("VGG4L", "Attention", 1),
    ("VGG3L", "StatisticalPooling", 4)])
def test_flops_equal_jax(front_end, pooling, heads):
    kw = dict(front_end=front_end, pooling_method=pooling, heads_number=heads,
              kernel_size=1024 if pooling == "DoubleMHA" else 64, num_spkrs=5994)
    got, want = pconfig.ModelConfig(**kw), jconfig.ModelConfig(**kw)
    for t in (350, 351, 1000):
        for name in ("vgg_forward_flops", "head_forward_flops", "forward_flops_per_sample",
                     "train_flops_per_sample"):
            assert getattr(pflops, name)(got, t) == getattr(jflops, name)(want, t), (name, t)
    if pooling == "DoubleMHA":
        # the paper's model, one 3.5 s window: about 45.6 GFLOP forward
        assert pflops.forward_flops_per_sample(got, 350) == pytest.approx(45.6e9, rel=0.01)
