"""The port's scoring backends and trial-scoring CLIs against the JAX
package's on the CPU: ``evaluation/snorm.py`` and ``evaluation/plda.py``
exactly, ``cli/score_trials.py`` and ``cli/train_plda.py`` on one tiny
checkpoint (VGG4L k=16, 4 heads, embedding 16) in features and wav mode,
with AS-Norm cohorts, PLDA models, embedding stores and PLDA files crossing
between the packages, and ``int8_static``; and the golden scores of the
committed example checkpoint.

The JAX CLIs run once per module (``world``). Their checkpoint loader builds
its template by initializing a model, about sixty compiled random programs
on the CPU; the template is built here by ``jax.eval_shape`` instead
(shapes only, nothing compiled), and every value still comes from the file.
"""

import contextlib
import functools
import glob
import io
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import doubleattentionspeakerverification_tpu.models.classifier as jclassifier
import doubleattentionspeakerverification_tpu.training.step as jstep
from doubleattentionspeakerverification_tpu.cli import score_trials as jscore
from doubleattentionspeakerverification_tpu.cli import train_plda as jtrain_plda
from doubleattentionspeakerverification_tpu.evaluation import plda as jplda
from doubleattentionspeakerverification_tpu.evaluation import snorm as jsnorm
from doubleattentionspeakerverification_tpu_torch import config as pconfig
from doubleattentionspeakerverification_tpu_torch.cli import score_trials as pscore
from doubleattentionspeakerverification_tpu_torch.cli import train_plda as ptrain_plda
from doubleattentionspeakerverification_tpu_torch.data.wav import encode_wav
from doubleattentionspeakerverification_tpu_torch.evaluation import plda as pplda
from doubleattentionspeakerverification_tpu_torch.evaluation import snorm as psnorm
from doubleattentionspeakerverification_tpu_torch.evaluation.embeddings import (
    load_embeddings,
    pickle_feature_loader,
)
from doubleattentionspeakerverification_tpu_torch.models.classifier import SpeakerClassifier
from doubleattentionspeakerverification_tpu_torch.models.init import init_parameters
from doubleattentionspeakerverification_tpu_torch.utils.checkpoint import save_checkpoint
from doubleattentionspeakerverification_tpu_torch.utils.weights import train_state_to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAINED = os.path.join(REPO, "examples", "pretrained")
MODEL = dict(kernel_size=16, heads_number=4, embedding_size=16, num_spkrs=8)
# The two packages' CLIs on one checkpoint: cosines within TOL_SCORE; the
# AS-Norm z-scores and PLDA LLRs built on them within TOL_SCORE of
# max(1, |score|) (they carry the cosines' float32 differences, ~2e-6 here,
# divided by a cohort's spread or scaled by the PLDA precision; measured
# 9.3e-6 of |score| at top-3); the summaries' EER and minDCF within
# TOL_SUMMARY.
TOL_SCORE = 1e-5
TOL_SUMMARY = 1e-6
# int8_static on the same baked scales: each package's int8 activations can
# differ by one step where a value lies on a rounding tie
TOL_INT8 = 2e-4
TOL_GOLDEN = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------------ backends
@pytest.mark.parametrize("topk", [0, 3, 12, 17])
def test_cohort_stats_and_asnorm_equal_jax(topk):
    """topk 0, 3, N (12) and N+5: each package's statistics and trial
    scores, bit for bit."""
    rng = np.random.default_rng(topk)
    embs, cohort = rng.standard_normal((7, 24)), rng.standard_normal((12, 24)).astype(np.float32)
    for got, want in zip(psnorm.cohort_stats(embs, cohort, topk),
                         jsnorm.cohort_stats(embs, cohort, topk)):
        np.testing.assert_array_equal(got, want)
    store = {f"u{i}": e.astype(np.float32) for i, e in enumerate(embs)}
    trials = [("u0", "u1"), ("u2", "u6"), ("u3", "u3"), ("u5", "u4")]
    np.testing.assert_array_equal(psnorm.asnorm_trial_scores(trials, store, cohort, topk),
                                  jsnorm.asnorm_trial_scores(trials, store, cohort, topk))


@pytest.mark.parametrize("length_norm", [True, False])
def test_plda_fit_score_and_files_equal_jax(length_norm, tmp_path):
    """EM on unequal utterance counts per speaker, pair LLRs, and each
    package's file loaded by the other, all bit for bit."""
    rng = np.random.default_rng(7)
    counts = (3, 5, 2, 7, 4, 6)
    centers = rng.standard_normal((len(counts), 10)) * 2
    x = np.concatenate([c + 0.5 * rng.standard_normal((n, 10)) for c, n in zip(centers, counts)])
    labels = np.repeat([f"spk{i}" for i in range(len(counts))], counts)
    got = pplda.PLDA.fit(x, labels, n_iters=4, length_norm=length_norm)
    want = jplda.PLDA.fit(x, labels, n_iters=4, length_norm=length_norm)
    for k in ("mu", "between", "within"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    a, b = rng.standard_normal((9, 10)), rng.standard_normal((9, 10))
    np.testing.assert_array_equal(got.score_pairs(a, b), want.score_pairs(a, b))
    got.save(str(tmp_path / "p.npz"))
    want.save(str(tmp_path / "j.npz"))
    for back in (jplda.PLDA.load(str(tmp_path / "p.npz")), pplda.PLDA.load(str(tmp_path / "j.npz"))):
        assert back.length_norm is length_norm
        np.testing.assert_array_equal(back.score_pairs(a, b), want.score_pairs(a, b))
    with pytest.raises(ValueError, match="2 speakers"):
        pplda.PLDA.fit(x[:3], labels[:3])


# ------------------------------------------------------------------ the CLIs
def _run(main, argv):
    """main(argv) with stderr captured -> the stderr text; rc must be 0."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main(argv) == 0
    return err.getvalue()


def _summary(stderr):
    """The last stderr line's ``key=value`` pairs, numbers as floats."""
    out = {}
    for item in stderr.strip().splitlines()[-1].split():
        k, v = item.split("=", 1)
        out[k] = float(v)
    return out


def _lines(path):
    """Score lines -> [(utt1, utt2, score, raw or None, label or None)]."""
    rows = []
    with open(path) as f:
        for line in f:
            cols = line.split()
            raw = next((float(c[4:]) for c in cols[3:] if c.startswith("raw=")), None)
            label = next((c for c in cols[3:] if not c.startswith("raw=")), None)
            rows.append((cols[0], cols[1], float(cols[2]), raw, label))
    return rows


def _assert_scores_close(got_path, want_path, tol):
    """Same trials, labels and columns; cosines within ``tol``, normalized
    scores (lines with a ``raw=`` cosine) within ``tol`` of max(1, |score|)."""
    got, want = _lines(got_path), _lines(want_path)
    assert [(r[0], r[1], r[4], r[3] is None) for r in got] == \
        [(r[0], r[1], r[4], r[3] is None) for r in want]
    score, ref = np.array([r[2] for r in got]), np.array([r[2] for r in want])
    if got[0][3] is None:
        np.testing.assert_allclose(score, ref, rtol=0, atol=tol)
    else:
        assert np.all(np.abs(score - ref) <= tol * np.maximum(1.0, np.abs(ref))), \
            np.abs(score - ref).max()
        np.testing.assert_allclose([r[3] for r in got], [r[3] for r in want], rtol=0, atol=tol)


def _assert_summaries_close(got, want, tol=TOL_SCORE):
    assert set(got) == set(want)
    for k in want:
        if k.startswith(("eer", "min_dcf")):
            assert got[k] == pytest.approx(want[k], abs=TOL_SUMMARY), k
        elif k.startswith("mean_"):
            assert got[k] == pytest.approx(want[k], abs=tol), k
        else:
            assert got[k] == want[k], k


def _write_pickle(path, feats):
    with open(path, "wb") as f:
        pickle.dump(feats.astype(np.float32), f)


def _speaker_feats(rng, spectrum, period, t):
    """(80, t) log-mel-like features whose speaker shows after CMN: the
    speaker's spectral pattern modulated in time at the speaker's period,
    plus noise."""
    phase = rng.uniform(0, 2 * np.pi)
    wave = np.sin(2 * np.pi * np.arange(t) / period + phase)
    return 3.0 * spectrum[:, None] * wave[None] + 0.5 * rng.standard_normal((80, t))


def _corpus(d):
    """Feature pickles (80, 60-190 frames: one length bucket) of 8 training
    speakers x 4 utterances, 10 validation utterances of 5 of those speakers
    and 8 cohort utterances of 8 others; the validation ones also as wavs of
    1.2-1.9 s; manifests and trial lists."""
    rng = np.random.default_rng(0)
    feats, wavs = d / "feats", d / "wavs"
    feats.mkdir()
    wavs.mkdir()
    spectra, periods = rng.standard_normal((16, 80)), rng.uniform(6, 40, 16)

    def pickle_of(name, s):
        _write_pickle(feats / f"{name}.pickle",
                      _speaker_feats(rng, spectra[s], periods[s], int(rng.integers(60, 190))))

    labels, train_pairs = [], []
    for s in range(8):
        for i in range(4):
            pickle_of(f"s{s}_u{i}", s)
            labels.append(f"s{s}_u{i} {s} -1\n")
            train_pairs.append(f"s{s}_u{i} s{s}_u{(i + 1) % 4}\n")
    for j in range(10):
        pickle_of(f"v{j}", j // 2)
        n = int(rng.integers(19200, 30400))
        t = np.arange(n) / 16000
        y = 0.3 * np.sin(2 * np.pi * (140 + 45 * (j // 2)) * t + 2 * np.sin(2 * np.pi * 3 * t))
        (wavs / f"v{j}.wav").write_bytes(encode_wav(
            (y + 0.02 * rng.standard_normal(n)).astype(np.float32), 16000))
    for c in range(8):
        pickle_of(f"c{c}", 8 + c)
    (d / "labels.ndx").write_text("".join(labels))
    (d / "train.ndx").write_text("".join(train_pairs))
    (d / "clients.ndx").write_text("".join(f"v{j} v{j + 1}\n" for j in range(0, 10, 2)))
    (d / "impostors.ndx").write_text("v0 v3\nv1 v4\nv2 v5\nv3 v8\nv6 v9\nv7 v0\nv9 v2\n")
    (d / "cohort.ndx").write_text("".join(f"c{c}\n" for c in range(8)))


def _input_driven(model, feats_dir):
    """Make a random model's embedding depend on its input, as a trained
    one's does: convolution and linear weights at He scale (torch's default
    init shrinks a signal about 2.4x per ReLU layer) and no biases (which
    would then dominate fc2's output); ``b2``'s running statistics set to
    those of the corpus's fc2 outputs, as training leaves them, so the
    embeddings are centred and their cosines spread over [-1, 1]."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.mul_(6 ** 0.5)
                m.bias.zero_()
        loader = pickle_feature_loader(feats_dir)
        model.eval()
        e2 = torch.cat([model(torch.from_numpy(loader(os.path.basename(p)[:-7]))[None])
                        for p in sorted(glob.glob(os.path.join(feats_dir, "*.pickle")))])
        model.b2.running_mean.copy_(e2.mean(0))
        model.b2.running_var.copy_(e2.var(0))


@contextlib.contextmanager
def _shape_only_jax_init():
    """The JAX checkpoint loader's template from ``jax.eval_shape``."""
    init_model, init_state = jclassifier.init_speaker_classifier, jstep.init_train_state
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jclassifier, "init_speaker_classifier",
                   lambda key, cfg: jax.eval_shape(functools.partial(init_model, cfg=cfg), key))
        mp.setattr(jstep, "init_train_state",
                   lambda p, ms, cfg: jax.eval_shape(functools.partial(init_state, cfg=cfg), p, ms))
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The checkpoint (the port's seeded init as a JAX-format ``.npz``), the
    corpus, and every JAX CLI run the tests compare with."""
    d = tmp_path_factory.mktemp("scoring")
    cfg = pconfig.ExperimentConfig(model=pconfig.ModelConfig(**MODEL))
    model = init_parameters(SpeakerClassifier(cfg.model), torch.Generator().manual_seed(3))
    _corpus(d)
    _input_driven(model, str(d / "feats"))
    ckpt = str(d / "m_1.npz")
    save_checkpoint(ckpt, train_state_to_jax(model.state_dict(), {}, "Adam", 1, 1e-3),
                    {"config": cfg.to_dict(), "step": 1})

    def argv(*extra, data="feats", labelled=True):
        base = ["--modelCheckpoint", ckpt, "--data_dir", str(d / data)]
        if labelled:
            base += ["--clients", str(d / "clients.ndx"), "--impostors", str(d / "impostors.ndx")]
        return base + list(extra)

    def out(name):
        return str(d / name)

    cohort3 = ["--cohort", out("cohort.ndx"), "--snorm_topk", "3"]
    runs = {}
    with _shape_only_jax_init():
        runs["cohort3"] = _run(jscore.main, argv(
            "--trials", out("train.ndx"), *cohort3, "--save_embeddings", out("j_store.npz"),
            "--output", out("j_cohort3.txt")))
        # the port's store (the one port run the JAX side reads) first
        runs["p_cohort3"] = _run(pscore.main, argv(
            "--trials", out("train.ndx"), *cohort3, "--save_embeddings", out("p_store.npz"),
            "--output", out("p_cohort3.txt"), "--device", "cpu"))
        runs["cohort0"] = _run(jscore.main, argv(
            "--load_embeddings", out("p_store.npz"), "--cohort", out("cohort.ndx"),
            "--output", out("j_cohort0.txt")))
        runs["train_plda"] = _run(jtrain_plda.main, [
            "--embeddings", out("j_store.npz"), "--labels", out("labels.ndx"),
            "--output", out("j_plda.npz"), "--n_iters", "6"])
        runs["plda"] = _run(jscore.main, argv(
            "--load_embeddings", out("j_store.npz"), "--plda", out("j_plda.npz"),
            "--output", out("j_plda.txt")))
        runs["wav"] = _run(jscore.main, argv(
            "--data_source", "wav", "--output", out("j_wav.txt"), data="wavs"))
        # the port calibrates on the first batch and writes the scales; JAX
        # loads them (so it compiles only its static forward)
        runs["p_int8_static"] = _run(pscore.main, argv(
            "--quantize", "int8_static", "--int8_scales", out("scales.npz"),
            "--output", out("p_int8.txt"), "--device", "cpu"))
        runs["int8_static"] = _run(jscore.main, argv(
            "--quantize", "int8_static", "--int8_scales", out("scales.npz"),
            "--output", out("j_int8.txt")))
    return dict(d=d, ckpt=ckpt, argv=argv, out=out, runs=runs)


def test_score_trials_features_with_cohort_equals_jax(world):
    """Features mode, AS-Norm over an id-list cohort at top-3, trials and
    labelled lists in one run: every line's score and raw cosine, the
    summary, and the store's rows."""
    out = world["out"]
    _assert_scores_close(out("p_cohort3.txt"), out("j_cohort3.txt"), TOL_SCORE)
    got, want = _summary(world["runs"]["p_cohort3"]), _summary(world["runs"]["cohort3"])
    _assert_summaries_close(got, want)
    assert want["cohort_size"] == 8 and want["snorm_topk"] == 3
    assert want["embeddings_saved"] == 32 + 10 + 8
    p, j = load_embeddings(out("p_store.npz")), load_embeddings(out("j_store.npz"))
    assert set(p) == set(j)
    scale = max(np.abs(e).max() for e in j.values())
    for u in j:
        np.testing.assert_allclose(p[u], j[u], rtol=0, atol=1e-5 * scale, err_msg=u)
    # on JAX's embeddings (its store) the port's CLI writes JAX's lines
    _run(pscore.main, world["argv"](
        "--trials", out("train.ndx"), "--cohort", out("cohort.ndx"), "--snorm_topk", "3",
        "--load_embeddings", out("j_store.npz"), "--output", out("p_cohort3_j.txt"),
        "--device", "cpu"))
    with open(out("p_cohort3_j.txt")) as f, open(out("j_cohort3.txt")) as g:
        assert f.read() == g.read()


def test_score_trials_reads_the_other_packages_store(world):
    """Full-cohort S-norm from a store: the port reading JAX's store, JAX
    reading the port's (no forward in either run), and the port's scores
    equal to a recomputation from the store with the port's own
    ``asnorm_trial_scores``."""
    out = world["out"]
    err = _run(pscore.main, world["argv"](
        "--load_embeddings", out("j_store.npz"), "--cohort", out("cohort.ndx"),
        "--output", out("p_cohort0.txt"), "--device", "cpu"))
    _assert_scores_close(out("p_cohort0.txt"), out("j_cohort0.txt"), TOL_SCORE)
    _assert_summaries_close(_summary(err), _summary(world["runs"]["cohort0"]))
    store = load_embeddings(out("j_store.npz"))
    cohort = np.stack([store[f"c{c}"] for c in range(8)])
    rows = _lines(out("p_cohort0.txt"))
    want = psnorm.asnorm_trial_scores([(r[0], r[1]) for r in rows], store, cohort, 0)
    np.testing.assert_allclose([r[2] for r in rows], want, rtol=0, atol=5e-7)


def test_train_plda_and_plda_scoring_equal_jax(world):
    """The port's ``train_plda`` on JAX's store writes JAX's model; scoring
    with it from that store gives JAX's lines exactly; and the port's own
    embeddings with JAX's PLDA model score within TOL_SCORE."""
    out = world["out"]
    err = _run(ptrain_plda.main, [
        "--embeddings", out("j_store.npz"), "--labels", out("labels.ndx"),
        "--output", out("p_plda.npz"), "--n_iters", "6"])
    assert err.replace("p_plda", "j_plda") == world["runs"]["train_plda"]
    with np.load(out("p_plda.npz")) as p, np.load(out("j_plda.npz")) as j:
        assert set(p.files) == set(j.files)
        for k in j.files:
            np.testing.assert_array_equal(p[k], j[k])
    err = _run(pscore.main, world["argv"](
        "--load_embeddings", out("j_store.npz"), "--plda", out("p_plda.npz"),
        "--output", out("p_plda.txt"), "--device", "cpu"))
    with open(out("p_plda.txt")) as f, open(out("j_plda.txt")) as g:
        assert f.read() == g.read()
    assert _summary(err) == _summary(world["runs"]["plda"])
    assert "eer_exact_plda" in _summary(err)
    _run(pscore.main, world["argv"](
        "--load_embeddings", out("p_store.npz"), "--plda", out("j_plda.npz"),
        "--output", out("p_plda_own.txt"), "--device", "cpu"))
    _assert_scores_close(out("p_plda_own.txt"), out("j_plda.txt"), TOL_SCORE)


def test_train_plda_reports_skipped_rows(world, tmp_path):
    out = world["out"]
    labels = tmp_path / "labels.ndx"
    labels.write_text(open(out("labels.ndx")).read() + "missing_a 0 -1\nmissing_b 1 -1\n")
    args = ["--embeddings", out("j_store.npz"), "--labels", str(labels),
            "--output", str(tmp_path / "x.npz"), "--n_iters", "1"]
    got, want = _run(ptrain_plda.main, args), _run(jtrain_plda.main, args)
    assert got == want
    assert got.splitlines()[0] == ("train_plda: 2/34 manifest rows missing from the "
                                   "embedding store; skipped")
    labels.write_text("missing_a 0 -1\n")
    with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(io.StringIO()):
        ptrain_plda.main(args)
    assert e.value.code == 2


def test_score_trials_wav_mode_equals_jax(world):
    """Wav mode: the log-mel on the CPU (kernel B2's plain version) against
    JAX's bucketed XLA log-mel, then the forward."""
    out = world["out"]
    err = _run(pscore.main, world["argv"](
        "--data_source", "wav", "--output", out("p_wav.txt"), "--device", "cpu", data="wavs"))
    _assert_scores_close(out("p_wav.txt"), out("j_wav.txt"), TOL_SCORE)
    _assert_summaries_close(_summary(err), _summary(world["runs"]["wav"]))


def test_score_trials_int8_static_equals_jax_on_shared_scales(world):
    """``--quantize int8_static --int8_scales``: the port calibrates on the
    first scoring batch and writes the scales; JAX loads that file and
    scores as the port did; the port run again on the same file writes the
    same bytes."""
    out = world["out"]
    assert "int8_static calibration" not in world["runs"]["p_int8_static"]
    _assert_scores_close(out("p_int8.txt"), out("j_int8.txt"), TOL_INT8)
    _assert_summaries_close(_summary(world["runs"]["p_int8_static"]),
                            _summary(world["runs"]["int8_static"]), TOL_INT8)
    _run(pscore.main, world["argv"](
        "--quantize", "int8_static", "--int8_scales", out("scales.npz"),
        "--output", out("p_int8_again.txt"), "--device", "cpu"))
    with open(out("p_int8.txt")) as f, open(out("p_int8_again.txt")) as g:
        assert f.read() == g.read()


def test_score_trials_int8_static_calibrates_on_a_wav(world, tmp_path):
    """Wav mode without a scales file: ``--calibration_wav`` calibrates
    first (state printed) and the file is written; the scores stay within
    the int8 encoder's drift of the fp run's."""
    scales = str(tmp_path / "s.npz")
    err = _run(pscore.main, world["argv"](
        "--data_source", "wav", "--quantize", "int8_static", "--int8_scales", scales,
        "--calibration_wav", str(world["d"] / "wavs" / "v3.wav"),
        "--device", "cpu", "--output", str(tmp_path / "a.txt"), data="wavs"))
    assert "int8_static calibration: static" in err
    assert os.path.exists(scales)
    _run(pscore.main, world["argv"]("--data_source", "wav", "--device", "cpu",
                                    "--output", str(tmp_path / "fp.txt"), data="wavs"))
    np.testing.assert_allclose([r[2] for r in _lines(str(tmp_path / "a.txt"))],
                               [r[2] for r in _lines(str(tmp_path / "fp.txt"))],
                               rtol=0, atol=5e-2)


@pytest.mark.parametrize("extra, message", [
    (["--plda", "x.npz", "--cohort", "c.ndx"], "exclusive"),
    (["--clients", "c.ndx"], "must be given together"),
    ([], "give --trials"),
    (["--trials", "t.ndx", "--int8_scales", "s.npz"], "require --quantize int8_static"),
])
def test_score_trials_usage_errors_exit_2(world, extra, message):
    """The JAX CLI's ``p.error`` cases, in both packages."""
    argv = ["--modelCheckpoint", world["ckpt"], "--data_dir", "d"] + extra
    with _shape_only_jax_init():
        for main in (pscore.main, jscore.main):
            err = io.StringIO()
            with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(err):
                main(argv)
            assert e.value.code == 2 and message in err.getvalue()


def test_score_trials_refuses_orbax_with_exit_2():
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = pscore.main(["--modelCheckpoint", "run/m_1.orbax", "--data_dir", "d",
                          "--trials", "t.ndx", "--device", "cpu"])
    assert rc == 2 and "doubleattentionspeakerverification_tpu.cli.convert_checkpoint" \
        in err.getvalue()


def test_score_trials_reproduces_golden_scores(tmp_path):
    """``example_model.npz`` over the seeded example corpus (as
    ``examples/make_pretrained.py`` writes it) in wav mode: the 20 committed
    scores within 1e-4 and the reference-grid EER 8.3334."""
    from examples.example_corpus import make_wavs, write_index_files

    wav_dir = str(tmp_path / "wavs")
    paths, labels = make_wavs(wav_dir)
    write_index_files(str(tmp_path), wav_dir, paths, labels)
    err = _run(pscore.main, [
        "--modelCheckpoint", os.path.join(PRETRAINED, "example_model.npz"),
        "--data_dir", wav_dir, "--data_source", "wav", "--device", "cpu",
        "--clients", str(tmp_path / "clients.ndx"), "--impostors", str(tmp_path / "impostors.ndx"),
        "--output", str(tmp_path / "scores.txt")])
    with open(os.path.join(PRETRAINED, "golden_scores.json")) as f:
        golden = json.load(f)
    rows = _lines(str(tmp_path / "scores.txt"))
    assert [r[4] for r in rows] == ["target"] * 8 + ["nontarget"] * 12
    np.testing.assert_allclose([r[2] for r in rows], golden["clients"] + golden["impostors"],
                               rtol=0, atol=TOL_GOLDEN)
    assert "eer=8.3334 " in err and _summary(err)["eer"] == golden["eer"] == 8.3334
