"""``correct`` comes out false where it must: the control (the reference one
precision step below the configuration's, put in the program's place) and
each fault the cells can have, planted under a run at tiny size on the CPU
that skips only the look for a card."""

import json

import pytest
import torch

from conftest import load_run_module
from harness import common


def _run(capsys, cell, *extra):
    run = load_run_module()
    rc = run.main(["--workload", cell, "--seed", "2147483701", "--seconds", "2",
                   "--cpu-smoke", *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["train-paper-f32", "train-paper-bf16-full", "verify-f32-steady"])
def test_the_control_is_not_correct(capsys, cell):
    last = _run(capsys, cell, "--control", "1")
    assert last["correct"] is False
    limits = common.load_cell(cell, smoke=True).limits
    checks = last["checks"]
    assert any(checks[k]["value"] > checks[k]["limit"] for k in limits), checks


def test_a_step_that_leaves_the_state_unchanged(capsys, monkeypatch):
    from doubleattentionspeakerverification_tpu_torch.training.step import TrainStep

    real = TrainStep.__call__

    def unchanged(self, batch, keep=None):
        before = [p.detach().clone() for p in self.model.parameters()]
        out = real(self, batch, keep)
        with torch.no_grad():
            for p, b in zip(self.model.parameters(), before):
                p.copy_(b)
        return out

    monkeypatch.setattr(TrainStep, "__call__", unchanged)
    last = _run(capsys, "train-paper-f32")
    assert last["correct"] is False
    assert last["checks"]["change_gap"]["value"] > last["checks"]["change_gap"]["limit"]


def test_half_the_batch_left_out(capsys, monkeypatch):
    from doubleattentionspeakerverification_tpu_torch.models import amsoftmax
    from doubleattentionspeakerverification_tpu_torch.training import step

    def half(logits, labels):
        n = logits.shape[0] // 2
        return amsoftmax.cross_entropy(logits[:n], labels[:n])

    monkeypatch.setattr(step, "cross_entropy", half)
    last = _run(capsys, "train-paper-bf16-full")
    assert last["correct"] is False


def test_an_answer_altered_where_it_is_produced(capsys, monkeypatch):
    from doubleattentionspeakerverification_tpu_torch import serving

    real = serving.EnrollmentDB.score
    monkeypatch.setattr(serving.EnrollmentDB, "score",
                        lambda self, emb, speaker: real(self, emb, speaker) - 1e-3)
    last = _run(capsys, "verify-f32-steady")
    assert last["correct"] is False
    assert last["checks"]["score_gap"]["value"] > last["checks"]["score_gap"]["limit"]


def test_an_embedding_from_another_upload(capsys, monkeypatch):
    from doubleattentionspeakerverification_tpu_torch import api

    real = api.SpeakerEmbeddingModel.features_of_wave

    def shifted(self, wave, sample_rate=16000):
        return real(self, wave[len(wave) // 3:], sample_rate)

    monkeypatch.setattr(api.SpeakerEmbeddingModel, "features_of_wave", shifted)
    last = _run(capsys, "verify-f32-steady")
    assert last["correct"] is False
