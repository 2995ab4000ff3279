"""The port's encoder and embedding trunk against the JAX package: VGG on
padded batches, ``get_embedding`` through ``params_from_jax`` for every
pooling method, and the committed example checkpoint's golden embeddings."""

import os

import jax
import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu.config import ExperimentConfig as JaxExperimentConfig
from doubleattentionspeakerverification_tpu.config import ModelConfig as JaxModelConfig
from doubleattentionspeakerverification_tpu.models.classifier import (
    get_embedding,
    init_speaker_classifier,
)
from doubleattentionspeakerverification_tpu.models.vgg import output_lengths as jax_output_lengths
from doubleattentionspeakerverification_tpu.models.vgg import vgg_apply
from doubleattentionspeakerverification_tpu.utils.checkpoint import _flatten
from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel
from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig, ModelConfig
from doubleattentionspeakerverification_tpu_torch.models.vgg import VGG, output_lengths
from doubleattentionspeakerverification_tpu_torch.utils.checkpoint import load_checkpoint
from doubleattentionspeakerverification_tpu_torch.utils.weights import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "examples", "pretrained")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_model(seed=0, **model_kw):
    jcfg = JaxExperimentConfig(
        model=JaxModelConfig(kernel_size=16, heads_number=4, embedding_size=24,
                             num_spkrs=4, use_pallas_pooling=False, **model_kw)
    )
    # the JAX model's structure, filled from numpy: fan-in-scaled weights,
    # small biases, and non-trivial b2 running statistics so the eval-mode
    # BatchNorm is exercised
    params, state = jax.eval_shape(
        lambda k: init_speaker_classifier(k, jcfg.model), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(s):
        std = 0.1 if len(s.shape) < 2 else 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    params = jax.tree.map(fill, params)
    emb = jcfg.model.embedding_size
    state = state._replace(
        bn_mean=rng.standard_normal(emb).astype(np.float32) * 0.1,
        bn_var=rng.uniform(0.5, 2.0, emb).astype(np.float32),
        bn_count=np.zeros((), np.int32),
    )
    flat = _flatten({"params": params, "model_state": state})
    return params, state, jcfg, flat


def _padded_batch(lens, seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((n, 80)).astype(np.float32) for n in lens]
    padded = np.zeros((len(lens), max(lens), 80), np.float32)
    for i, x in enumerate(xs):
        padded[i, : len(x)] = x
    return xs, padded, np.asarray(lens, np.int32)


@pytest.mark.parametrize("front_end", ["VGG3L", "VGG4L"])
def test_vgg_padded_batch_matches_jax(front_end):
    params, _, jcfg, flat = _jax_model(front_end=front_end)
    xs, padded, lens = _padded_batch([37, 50, 21], seed=1)
    ref, ref_len = jax.jit(vgg_apply, static_argnums=3)(params["vgg"], padded, lens, jcfg.model)

    vgg = VGG(ExperimentConfig.from_dict(jcfg.to_dict()).model)
    state = params_from_jax(flat)
    vgg.load_state_dict({k[4:]: v for k, v in state.items() if k.startswith("vgg.")})
    with torch.no_grad():
        got, got_len = vgg(torch.from_numpy(padded), torch.from_numpy(lens))
        single, _ = vgg(torch.from_numpy(xs[2])[None], None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    # padded == unpadded on the valid frames
    n = int(got_len[2])
    np.testing.assert_allclose(got[2, :n].numpy(), single[0, :n].numpy(), atol=3e-5)
    np.testing.assert_array_equal(
        output_lengths(torch.from_numpy(lens), front_end).numpy(),
        np.asarray(jax_output_lengths(lens, front_end)),
    )


@pytest.mark.parametrize("pooling", ["DoubleMHA", "MHA", "Attention", "StatisticalPooling"])
def test_get_embedding_through_params_from_jax(pooling):
    params, state, jcfg, flat = _jax_model(seed=2, pooling_method=pooling)
    xs, padded, lens = _padded_batch([45, 30, 17], seed=3)
    ref = np.asarray(jax.jit(get_embedding, static_argnums=4)(params, state, padded, lens, jcfg.model))

    model = SpeakerEmbeddingModel.from_jax(flat, ExperimentConfig.from_dict(jcfg.to_dict()),
                                           device="cpu")
    got = model.embed_features(padded, lens)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # padded == unpadded
    for i, x in enumerate(xs):
        np.testing.assert_allclose(model.embed_features(x), got[i], atol=3e-5)


def test_example_checkpoint_reproduces_golden_embeddings(tmp_path):
    """The gate: the port, on the CPU, reproduces every golden embedding of
    the committed example model at the JAX package's own tolerance
    (tests/test_example_artifact.py)."""
    from examples.example_corpus import make_wavs

    paths, _ = make_wavs(str(tmp_path))
    model = SpeakerEmbeddingModel.from_checkpoint(
        os.path.join(ART, "example_model.npz"), device="cpu")
    with np.load(os.path.join(ART, "golden_embeddings.npz")) as z:
        goldens = {k: z[k] for k in z.files}
    assert len(goldens) == len(paths)
    for p in paths:
        emb = model.embed_wav(p)
        np.testing.assert_allclose(emb, goldens[os.path.basename(p)[:-4]], atol=1e-4, rtol=1e-4)


def test_checkpoint_reader_and_config():
    flat, meta = load_checkpoint(os.path.join(ART, "example_model.npz"))
    assert flat["params/vgg/conv11/w"].shape == (3, 3, 1, 4)
    cfg = ExperimentConfig.from_dict(meta["config"])
    assert cfg.model == ModelConfig(kernel_size=32, embedding_size=64, heads_number=4)
    state = params_from_jax(flat)
    assert state["vgg.conv11.weight"].shape == (4, 1, 3, 3)          # OIHW
    assert state["fc1.weight"].shape == (64, 40)                      # (out, in)
    np.testing.assert_array_equal(state["fc1.weight"].numpy(), flat["params/fc1/w"].T)
    assert state["b2.num_batches_tracked"].dtype == torch.int64
    assert ExperimentConfig().model.kernel_size == 1024               # paper defaults


def test_random_init_is_seeded():
    cfg = ExperimentConfig(model=ModelConfig(kernel_size=16, heads_number=4, embedding_size=24))
    a = SpeakerEmbeddingModel.from_random_init(cfg, seed=4, device="cpu").model.state_dict()
    b = SpeakerEmbeddingModel.from_random_init(cfg, seed=4, device="cpu").model.state_dict()
    c = SpeakerEmbeddingModel.from_random_init(cfg, seed=5, device="cpu").model.state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["vgg.conv42.weight"], c["vgg.conv42.weight"])
    bound = 1.0 / np.sqrt(8 * 9)   # kaiming_uniform(a=sqrt(5)) on fan_in = 8*3*3
    assert float(a["vgg.conv32.weight"].abs().max()) <= bound
    assert torch.all(a["b2.running_var"] == 1) and torch.all(a["b2.running_mean"] == 0)


def test_cuda_requested_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ExperimentConfig(model=ModelConfig(kernel_size=16, heads_number=4, embedding_size=24))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpeakerEmbeddingModel.from_random_init(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpeakerEmbeddingModel.from_checkpoint(os.path.join(ART, "example_model.npz"),
                                              device="cuda")
