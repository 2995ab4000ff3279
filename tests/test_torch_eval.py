"""The port's scoring leftovers and reference checkpoints against the JAX
package: the EER sweeps and minDCF, a reference ``.chkpt`` written by the
JAX package's own exporter read through ``api.from_checkpoint`` and the
embedding CLI, and ``score_wavs`` / ``verify``."""

import argparse
import datetime
import json
import os

import jax
import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu.api import SpeakerEmbeddingModel as JaxModel
from doubleattentionspeakerverification_tpu.cli import get_embedding as jax_cli
from doubleattentionspeakerverification_tpu.config import ExperimentConfig as JaxExperimentConfig
from doubleattentionspeakerverification_tpu.config import ModelConfig as JaxModelConfig
from doubleattentionspeakerverification_tpu.evaluation import eer as jeer
from doubleattentionspeakerverification_tpu.models.classifier import (
    get_embedding,
    init_speaker_classifier,
)
from doubleattentionspeakerverification_tpu.utils import torch_import as jimport
from doubleattentionspeakerverification_tpu.utils.torch_export import save_torch_checkpoint
from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel
from doubleattentionspeakerverification_tpu_torch.cli.get_embedding import main as get_embedding_cli
from doubleattentionspeakerverification_tpu_torch.data.wav import encode_wav
from doubleattentionspeakerverification_tpu_torch.evaluation import eer as peer
from doubleattentionspeakerverification_tpu_torch.utils import torch_import as pimport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_SCORES = os.path.join(REPO, "examples", "pretrained", "golden_scores.json")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------------ EER
def _scores(seed, n_cl, n_im, sep):
    rng = np.random.default_rng(seed)
    return (np.clip(rng.normal(sep, 0.2, n_cl), -1, 1), np.clip(rng.normal(0.0, 0.2, n_im), -1, 1))


@pytest.mark.parametrize("seed, n_cl, n_im, sep", [
    (0, 40, 60, 0.5), (1, 7, 13, 0.3), (2, 200, 300, 0.1),
    # a set with no crossing on the reference grid (the 50.0 fallback)
    (3, 5, 5, -3.0),
])
def test_eer_sweeps_match_jax(seed, n_cl, n_im, sep):
    clients, impostors = _scores(seed, n_cl, n_im, sep)
    assert peer.eer_reference(clients, impostors) == jeer.eer_reference(clients, impostors)
    assert peer.eer_exact(clients, impostors) == pytest.approx(
        jeer.eer_exact(clients, impostors), rel=1e-12)
    for kw in ({}, dict(p_target=0.05, c_miss=10.0)):
        assert peer.min_dcf(clients, impostors, **kw) == pytest.approx(
            jeer.min_dcf(clients, impostors, **kw), rel=1e-12)
    th = np.linspace(-1, 1, 17)
    for got, want in zip(peer.far_frr(clients, th), jeer.far_frr(clients, th)):
        np.testing.assert_array_equal(got, want)
    if sep < -1:
        assert peer.eer_reference(clients, impostors) == 50.0


def test_eer_reference_reproduces_golden_scores():
    with open(GOLDEN_SCORES) as f:
        golden = json.load(f)
    assert peer.eer_reference(golden["clients"], golden["impostors"]) == golden["eer"] == 8.3334


# ------------------------------------------------------- reference .chkpt
def _jax_model():
    cfg = JaxExperimentConfig(model=JaxModelConfig(
        kernel_size=16, heads_number=4, embedding_size=24, num_spkrs=6,
        use_pallas_pooling=False, use_pallas_dsp=False))
    params, state = jax.eval_shape(lambda k: init_speaker_classifier(k, cfg.model),
                                   jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)

    def fill(s):
        std = 0.1 if len(s.shape) < 2 else 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    params = jax.tree.map(fill, params)
    emb = cfg.model.embedding_size
    state = state._replace(bn_mean=rng.standard_normal(emb).astype(np.float32) * 0.1,
                           bn_var=rng.uniform(0.5, 2.0, emb).astype(np.float32),
                           bn_count=np.asarray(7, np.int32))
    return params, state, cfg


def _wav(path, seed, hz):
    rng = np.random.default_rng(seed)
    t = np.arange(24000) / 16000
    y = 0.3 * np.sin(2 * np.pi * hz * t) + 0.1 * np.sin(2 * np.pi * 3 * hz * t)
    path.write_bytes(encode_wav((y + 0.02 * rng.standard_normal(len(t))).astype(np.float32),
                                16000))
    return str(path)


@pytest.fixture(scope="module")
def chkpt(tmp_path_factory):
    """A tiny model written as a reference ``.chkpt`` by the JAX package's
    ``save_torch_checkpoint``, two wavs, and JAX's reading of the file."""
    d = tmp_path_factory.mktemp("chkpt")
    params, state, cfg = _jax_model()
    path = str(d / "tiny.chkpt")
    save_torch_checkpoint(path, params, state, cfg, epoch=3, step=11)
    jparams, jstate, jcfg, _, _ = jimport.load_torch_checkpoint(path)
    return dict(path=path, wavs=(_wav(d / "a.wav", 1, 170), _wav(d / "b.wav", 2, 230)),
                params=jparams, state=jstate, cfg=jcfg)


def test_from_checkpoint_reads_reference_chkpt(chkpt):
    """Embeddings of the port's ``from_checkpoint`` on the ``.chkpt`` equal
    JAX ``load_torch_checkpoint``'s at 1e-5; config, epoch and step carry."""
    model = SpeakerEmbeddingModel.from_checkpoint(chkpt["path"], device="cpu")
    state, cfg, epoch, step = pimport.load_torch_checkpoint(chkpt["path"])
    assert (epoch, step) == (3, 11)
    jm = chkpt["cfg"].model
    assert cfg.model == model.cfg.model
    assert (cfg.model.kernel_size, cfg.model.heads_number, cfg.model.embedding_size,
            cfg.model.num_spkrs, cfg.model.mask_prob) == (
        jm.kernel_size, jm.heads_number, jm.embedding_size, jm.num_spkrs, jm.mask_prob)
    assert cfg.train.optimizer == chkpt["cfg"].train.optimizer
    assert int(model.model.b2.num_batches_tracked) == 7
    np.testing.assert_array_equal(model.model.amsoftmax.W.detach().numpy(),
                                  np.asarray(chkpt["params"]["amsoftmax"]["W"]))
    x = np.random.default_rng(5).standard_normal((3, 57, 80)).astype(np.float32)
    ref = np.asarray(jax.jit(get_embedding, static_argnums=4)(
        chkpt["params"], chkpt["state"], x, None, chkpt["cfg"].model))
    np.testing.assert_allclose(model.embed_features(x), ref, atol=1e-5)


def test_get_embedding_cli_reads_reference_chkpt(chkpt, capsys):
    """The CLI takes the ``.chkpt`` and prints the API's embedding of the
    wav; the JAX package's CLI prints the same at 1e-5."""
    def printed():
        out = capsys.readouterr().out
        return np.array(out.replace("[", " ").replace("]", " ").split(), np.float32)

    args = ["--audioPath", chkpt["wavs"][0], "--modelCheckpoint", chkpt["path"]]
    assert get_embedding_cli(args + ["--device", "cpu"]) == 0
    got = printed()
    api = SpeakerEmbeddingModel.from_checkpoint(chkpt["path"], device="cpu")
    np.testing.assert_allclose(got, api.embed_wav(chkpt["wavs"][0]), rtol=1e-5, atol=1e-6)
    assert jax_cli.main(args) == 0
    want = printed()
    assert got.shape == want.shape == (24,)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_score_wavs_and_verify(chkpt):
    model = SpeakerEmbeddingModel.from_checkpoint(chkpt["path"], device="cpu")
    a, b = chkpt["wavs"]
    score = model.score_wavs(a, b)
    assert score == pytest.approx(model.score(model.embed_wav(a), model.embed_wav(b)), abs=1e-7)
    jax_model = JaxModel(chkpt["params"], chkpt["state"], chkpt["cfg"])
    assert score == pytest.approx(jax_model.score_wavs(a, b), abs=1e-5)
    assert model.score_wavs(a, a) == pytest.approx(1.0, abs=1e-6)
    assert model.verify(a, a) and model.verify(a, a, threshold=0.999)
    assert model.verify(a, b, threshold=score - 1e-4)
    assert not model.verify(a, b, threshold=score + 1e-4)


def test_config_from_namespace_matches_jax():
    ns = argparse.Namespace(front_end="VGG3L", kernel_size=32, embedding_size=48,
                            heads_number=8, pooling_method="MHA", mask_prob=0.2, num_spkrs=11,
                            scalingFactor=20.0, marginFactor=0.3, annealing=True,
                            optimizer="RMSprop", learning_rate=3e-3, weight_decay=0.0,
                            batch_size=16, gradientAccumulation=3, window_size=2.0,
                            normalization="cmvn", model_name="m")
    got, want = pimport.config_from_namespace(ns), jimport.config_from_namespace(ns)
    for section in ("model", "train"):
        mine = getattr(got, section)
        for k, v in vars(mine).items():
            assert v == getattr(getattr(want, section), k), (section, k)
    assert got.model_name == want.model_name == "m"


def test_chkpt_with_other_pickled_objects_is_refused(tmp_path):
    """``weights_only`` loading allows ``argparse.Namespace`` and nothing else
    beyond tensors and plain containers."""
    path = str(tmp_path / "odd.chkpt")
    torch.save({"model": {}, "settings": argparse.Namespace(), "when": datetime.date(2020, 1, 2)},
               path)
    with pytest.raises(Exception, match="[Ww]eights only"):
        pimport.load_torch_checkpoint(path)
