"""The port's int8 serving surface on the CPU: the micro-batcher's warmup and
chunked long audio under ``int8_static``, the serve CLI's quantize flags,
and ``cli/get_embedding`` against the JAX package's."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu.cli import get_embedding as jax_cli
from doubleattentionspeakerverification_tpu.config import ExperimentConfig as JaxExperimentConfig
from doubleattentionspeakerverification_tpu.models.classifier import init_speaker_classifier
from doubleattentionspeakerverification_tpu.utils.checkpoint import load_checkpoint
from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel
from doubleattentionspeakerverification_tpu_torch.cli.get_embedding import main as get_embedding
from doubleattentionspeakerverification_tpu_torch.cli.serve import build_server
from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig, ModelConfig
from doubleattentionspeakerverification_tpu_torch.data.wav import encode_wav
from doubleattentionspeakerverification_tpu_torch.evaluation.embeddings import (
    split_long_audio,
    weighted_unit_centroid,
)
from doubleattentionspeakerverification_tpu_torch.serving import MicroBatcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "pretrained", "example_model.npz")
TINY = ExperimentConfig(model=ModelConfig(kernel_size=16, heads_number=4, embedding_size=16))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def fp_model():
    return SpeakerEmbeddingModel.from_random_init(TINY, seed=3, device="cpu")


def _static_twin(fp_model):
    return SpeakerEmbeddingModel(fp_model.model, TINY, device="cpu", quantize="int8_static")


def _feats(t, seed=0):
    return np.random.default_rng(seed).standard_normal((t, 80)).astype(np.float32)


def _cos(a, b):
    return float(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    rng = np.random.default_rng(21)
    t = np.arange(24000) / 16000
    y = 0.3 * np.sin(2 * np.pi * 180 * t) + 0.1 * np.sin(2 * np.pi * 540 * t)
    y = (y + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
    path = tmp_path_factory.mktemp("wav") / "utt.wav"
    path.write_bytes(encode_wav(y, 16000))
    return str(path)


def test_warmup_int8_static_not_poisoned(fp_model):
    """Warmup's all-zeros batches must not become the int8_static
    calibration batch; the first real request calibrates, and its
    embeddings cosine-match the fp model's."""
    q_model = _static_twin(fp_model)
    batcher = MicroBatcher(q_model, max_batch=2, max_wait_ms=1.0, buckets=(64, 128))
    try:
        batcher.warmup([50, 100])
        assert q_model.quantize_calibration_state() == "uncalibrated"
        f = _feats(50, seed=7)
        got = batcher.embed(f)
        assert q_model.quantize_calibration_state() == "static"
        fp = fp_model.embed_features(f[None], np.array([50]))[0]
        assert np.isfinite(got).all()
        assert _cos(fp, batcher.embed(f)) > 0.98
    finally:
        batcher.close()


def test_long_audio_chunk_with_int8_static(fp_model):
    """Chunked long audio over int8_static: the first chunk calibrates,
    later chunks run the static path, and the centroid stays close to the
    fp centroid."""
    q_model = _static_twin(fp_model)
    batcher = MicroBatcher(q_model, max_batch=2, max_wait_ms=1.0, buckets=(64, 128),
                           long_audio="chunk")
    try:
        f = _feats(310, seed=13)
        got = batcher.embed(f, timeout=120)
        assert q_model.quantize_calibration_state() == "static"
        segs = split_long_audio(torch.from_numpy(f), 128)
        fp = weighted_unit_centroid(
            [fp_model.embed_features(s[None], np.array([s.shape[0]]))[0] for s in segs],
            [s.shape[0] for s in segs])
        assert _cos(fp, got) > 0.95
        assert batcher.stats()["pending"] == 0
    finally:
        batcher.close()


@pytest.mark.parametrize("flag", ["--calibration_wav", "--int8_scales"])
def test_serve_refuses_calibration_flags_without_int8_static(flag, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        build_server(["--modelCheckpoint", EXAMPLE, "--device", "cpu", "--port", "0",
                      flag, str(tmp_path / "x")])
    assert e.value.code == 2
    assert "require --quantize int8_static" in capsys.readouterr().err


def test_serve_int8_static_calibrates_before_serving(wav_path, tmp_path):
    scales = str(tmp_path / "scales.npz")
    server = build_server(["--modelCheckpoint", EXAMPLE, "--device", "cpu", "--port", "0",
                           "--quantize", "int8_static", "--calibration_wav", wav_path,
                           "--int8_scales", scales])
    try:
        assert server.batcher.model.quantize_calibration_state() == "static"
        assert os.path.exists(scales)
    finally:
        server.server_close()
        server.batcher.close()


def _printed_embedding(capsys):
    text = capsys.readouterr().out.strip()
    return np.array(text.strip("[]").split(), dtype=np.float64)


def _jax_load_model(path):
    """The JAX CLI's ``load_model`` restores the checkpoint into a freshly
    initialized training state, op by op (about 13 s on one core); this
    restores the same ``params`` and ``model_state`` leaves into a
    shape-only template."""
    with np.load(path) as z:
        cfg = JaxExperimentConfig.from_dict(json.loads(bytes(z["__meta__"].tobytes()))["config"])
    template = jax.eval_shape(lambda: dict(zip(
        ("params", "model_state"), init_speaker_classifier(jax.random.PRNGKey(0), cfg.model))))
    tree, _ = load_checkpoint(path, template)
    return tree["params"], tree["model_state"], cfg


def test_get_embedding_cli_matches_jax(wav_path, capsys, monkeypatch):
    args = ["--audioPath", wav_path, "--modelCheckpoint", EXAMPLE]
    assert get_embedding(args + ["--device", "cpu"]) == 0
    got = _printed_embedding(capsys)
    monkeypatch.setattr(jax_cli, "load_model", _jax_load_model)
    assert jax_cli.main(args) == 0
    want = _printed_embedding(capsys)
    assert got.shape == want.shape == (64,)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_get_embedding_cli_int8_is_the_api_path(wav_path, capsys):
    """``--quantize int8`` prints the API's int8 embedding (the API's int8
    path is held against JAX's in tests/test_torch_quantized.py)."""
    assert get_embedding(["--audioPath", wav_path, "--modelCheckpoint", EXAMPLE,
                          "--quantize", "int8", "--device", "cpu"]) == 0
    got = _printed_embedding(capsys)
    want = SpeakerEmbeddingModel.from_checkpoint(EXAMPLE, device="cpu",
                                                 quantize="int8").embed_wav(wav_path)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
