"""The plain reference (``harness/reference.py``) held to the port's
outputs at a tiny size on the CPU. The test imports the port; the reference
itself does not."""

import ast
import os

import numpy as np
import pytest
import torch

from harness import common, reference, traffic

TINY = {**common.load_json(common.ROOT, "portbench", "configs", "vgg4l-dmha-paper-f32.json"),
        **common.SMOKE_CONFIG}


def _cfg(conf=TINY):
    from doubleattentionspeakerverification_tpu_torch.config import (
        ExperimentConfig, ModelConfig, TrainConfig)

    return ExperimentConfig(
        model=ModelConfig(kernel_size=conf["kernel_size"], heads_number=conf["heads_number"],
                          embedding_size=conf["embedding_size"], num_spkrs=conf["num_spkrs"],
                          compute_dtype=conf["compute_dtype"]),
        train=TrainConfig(batch_size=conf["batch_size"], window_size=conf["window_size"],
                          seed=11, assume_full_lengths=conf["assume_full_lengths"]))


def _model(cfg, seed=5):
    from doubleattentionspeakerverification_tpu_torch.models.classifier import SpeakerClassifier

    model = SpeakerClassifier(cfg.model)
    return model, common.fill_weights(model, seed, torch.device("cpu"))


def test_reference_imports_nothing_of_the_program():
    src = open(os.path.join(common.HERE, "harness", "reference.py")).read()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "math", "dataclasses", "typing", "numpy", "torch"}


def test_log_mel_matches_the_port():
    from doubleattentionspeakerverification_tpu_torch.config import FeatureConfig
    from doubleattentionspeakerverification_tpu_torch.dsp.features import log_mel_spectrogram

    pcm = traffic.synth((1, 2), 16000 * 3)
    ours = reference.FrontEnd("cpu").log_mel(torch.from_numpy(pcm[None].astype(np.int16)))
    port = log_mel_spectrogram(torch.from_numpy(pcm.astype(np.float32) / 32768.0)[None],
                               FeatureConfig())
    assert ours.shape == port.shape
    assert float((ours - port.double()).abs().max()) < 2e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_matches_the_port(dtype):
    cfg = _cfg({**TINY, "compute_dtype": dtype})
    model, p = _model(cfg)
    model.eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 120, 80)).astype(np.float32))
    lengths = torch.tensor([120, 77, 31])
    with torch.no_grad():
        port = model(x, lengths)
    ours = reference.embedding(p, x, lengths, {**TINY, "compute_dtype": dtype},
                               reference.PRECISIONS[dtype])
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert float((ours - port).abs().max() / port.abs().max()) < tol


def test_three_train_steps_match_the_port():
    from doubleattentionspeakerverification_tpu_torch.training.optimizers import make_optimizer
    from doubleattentionspeakerverification_tpu_torch.training.step import make_train_step

    cfg = _cfg()
    model, p0 = _model(cfg)
    opt = make_optimizer(cfg.train, model.parameters())
    step = make_train_step(cfg, model, opt, device="cpu")
    rng = np.random.default_rng(1)
    samples = 512 + 99 * 160
    batches, losses, grad1 = [], [], None
    for k in range(3):
        waves = rng.integers(-9000, 9000, (2, TINY["batch_size"], samples)).astype(np.int16)
        b = {"waves": torch.from_numpy(waves),
             "lengths": torch.full((2, TINY["batch_size"]), samples, dtype=torch.int32),
             "labels": torch.from_numpy(rng.integers(0, TINY["num_spkrs"], (2, TINY["batch_size"])))}
        batches.append(b)
        losses.append(float(step(b)["loss"]))
        if k == 0:
            grad1 = {n: opt.state[q]["exp_avg"] / 0.1 for n, q in model.named_parameters()}
    params = {n: q.detach() for n, q in model.named_parameters()}
    ref = reference.train_steps(p0, batches, 11, TINY, reference.PRECISIONS["float32"],
                                reference.FrontEnd("cpu"))
    assert np.allclose(losses, ref["losses"], rtol=1e-5)
    for n in grad1:
        scale = float(ref["grad1"][n].abs().max()) + 1e-12
        assert float((grad1[n] - ref["grad1"][n]).abs().max()) / scale < 1e-3, n
        # an element whose gradient is nought to rounding (a bias under the
        # batch norm) takes an Adam step of any size on either side
        raw = ref["raw1"][n].abs()
        moved = raw > 1e-5 * float(raw.max())
        assert float((params[n] - ref["params"][n])[moved].abs().max()) < 1e-6, n


def test_verify_score_matches_the_enrollment_store():
    from doubleattentionspeakerverification_tpu_torch.serving import EnrollmentDB

    rng = np.random.default_rng(2)
    embs = [rng.standard_normal(32) for _ in range(4)]
    db = EnrollmentDB()
    for e in embs[:3]:
        db.enroll("a", e.astype(np.float32))
    port = db.score(embs[3].astype(np.float32), "a")
    ours = reference.verify_score(torch.from_numpy(embs[3]), [torch.from_numpy(e) for e in embs[:3]])
    assert abs(port - ours) < 1e-6


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -10, -3.14159265])
    r = reference.round_tf32(x)
    assert r.tolist()[:3] == [1.0, 1.0 + 2.0 ** -9, 1.0 + 2.0 ** -10]
    assert abs(float(r[3]) + 3.14159265) < 2.0 ** -9 * 4
