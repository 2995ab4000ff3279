"""The port's trainer (``training/trainer.py``, ``cli/train.py``) against the
JAX package's on the CPU, at a tiny config: VGG4L k=16, 4 heads, DoubleMHA,
embedding 32, synthetic feature pickles (``_corpus``), 2 epochs x 2
optimizer steps (batch 6 x accumulation 2 over 24 utterances), a validation
every 2 steps and a checkpoint every step.

One JAX ``Trainer`` is built per module. Its ``init_speaker_classifier`` is
replaced by the port's seeded init carried over through
``utils/weights.py:train_state_to_jax``: JAX's own init compiles about sixty
random programs (20 s on one core), and what the tests need is only that
both packages start from one state. That state is written with JAX's
``save_checkpoint`` as the step-0 file the port's CLI resumes from
(``--requeue``); its meta says epoch -1 (no epoch finished), so the resume
starts at epoch 0. Later JAX runs reuse the module's compiled step on a
shallow copy of the trainer. Both CLIs keep 3 periodic checkpoints (neither
has a flag for it), so of the step-0 file and the four periodic ones the
prune leaves steps 2-4.
"""

import copy
import dataclasses
import io
import json
import os
import pickle
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import doubleattentionspeakerverification_tpu.training.trainer as jtrainer
from doubleattentionspeakerverification_tpu.cli.train import build_config as jax_build_config
from doubleattentionspeakerverification_tpu.cli.train import make_parser as jax_parser
from doubleattentionspeakerverification_tpu.config import ExperimentConfig as JaxExperimentConfig
from doubleattentionspeakerverification_tpu.utils import checkpoint as jckpt
from doubleattentionspeakerverification_tpu.utils import native as jnative
from doubleattentionspeakerverification_tpu.utils.logging import MetricLogger as JaxLogger
from doubleattentionspeakerverification_tpu_torch.cli import train as pcli
from doubleattentionspeakerverification_tpu_torch.config import (
    ExperimentConfig as PortExperimentConfig,
)
from doubleattentionspeakerverification_tpu_torch.training import device_prefetch as pprefetch
from doubleattentionspeakerverification_tpu_torch.training.trainer import Trainer
from doubleattentionspeakerverification_tpu_torch.utils.checkpoint import load_checkpoint
from doubleattentionspeakerverification_tpu_torch.utils.logging import MetricLogger
from doubleattentionspeakerverification_tpu_torch.utils.tensorboard import read_scalars
from doubleattentionspeakerverification_tpu_torch.utils.watchdog import THREAD_NAME as WATCHDOG_THREAD
from doubleattentionspeakerverification_tpu_torch.utils.watchdog import Watchdog
from test_data import make_synthetic_features
from test_torch_data import jax_state_from_port

# Per-step loss (train-mode b2 divides by the batch's standard deviation,
# small in this random tiny model, so float32 rounding before it shows in
# the loss at a few 1e-6); accuracy (a float32 mean of 0/1 hits: equal up to
# its last bit); each final leaf against its largest value: parameters and
# BatchNorm statistics, Adam's moments, and the moments of fc1's and fc2's
# biases, whose gradient is the weight decay plus the rounding of b2's
# backward (``_initial_state``).
TOL_STEP = 5e-5
TOL_ACC = 1e-6
TOL_LEAF = 1e-3
TOL_MOMENT = 5e-3
TOL_SHADOWED = 5e-2


def _assert_leaves_close(got, ref):
    assert set(got) == set(ref)
    for key, r in ref.items():
        g = got[key]
        assert g.dtype == r.dtype and g.shape == r.shape, key
        if np.issubdtype(r.dtype, np.integer):
            assert np.array_equal(g, r), key
            continue
        tol = TOL_LEAF
        if key.startswith("opt_state/inner_state"):
            tol = TOL_SHADOWED if key.endswith(("fc1/b", "fc2/b")) else TOL_MOMENT
        scale = max(float(np.abs(r).max()), 1e-30)
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * scale, err_msg=key)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _corpus(root):
    """Training: 24 feature pickles of ``make_synthetic_features`` (4
    speakers, 0.6-1.2 s). Validation: 24 utterances whose speaker pattern
    repeats every 8 frames, so it survives CMN (the constant speaker centers
    of the training set vanish under it), at an amplitude (1000, noise 300)
    that outweighs the random init's biases in the tiny VGG's output. Its
    scores then spread over 0.89-0.996, no two within 3e-5, so the EERs (a
    threshold sweep and an interpolation over sorted scores) are not decided
    by float32 rounding; on the training set every score is 1 - 1e-5. The
    training set keeps the steps well conditioned: at the validation set's
    amplitude, Adam's first steps turn gradients within rounding of zero
    into whole learning-rate steps of either sign."""
    lines = make_synthetic_features(str(root / "feats"), 4, 6)
    (root / "labels.ndx").write_text("".join(lines))
    rng = np.random.default_rng(0)
    (root / "valid").mkdir()
    patterns = rng.standard_normal((4, 80, 8)) * 1000.0
    names = []
    for spk in range(4):
        for i in range(6):
            t = int(rng.integers(60, 120))
            feats = np.tile(patterns[spk], (1, t // 8 + 1))[:, :t]
            feats = feats + 300.0 * rng.standard_normal((80, t))
            names.append(f"spk{spk}_utt{i}")
            with open(root / "valid" / f"{names[-1]}.pickle", "wb") as f:
                pickle.dump(feats.astype(np.float32), f)
    clients = [f"{names[s * 6 + i]} {names[s * 6 + j]}\n"
               for s in range(4) for i in range(3) for j in range(i + 1, 4)]
    impostors = [f"{names[a * 6 + i]} {names[b * 6 + i]}\n"
                 for a in range(4) for b in range(a + 1, 4) for i in range(3)]
    (root / "clients.ndx").write_text("".join(clients))
    (root / "impostors.ndx").write_text("".join(impostors))


def _initial_state(mcfg):
    """The step-0 state both packages start from: the port's seeded init
    (``jax_state_from_port``), with fc1's and fc2's biases moved at least
    0.05 away from zero. b2's batch statistics remove any constant shift of
    its input, so in exact arithmetic those biases get no gradient but the
    weight decay; Adam's first steps move each element by the learning rate
    times the sign of its gradient, so where the decay is below the
    rounding of the backward the sign is a coin toss, different in each
    package, and the eval-mode embeddings (b2 on running statistics) then
    differ by whole steps. Biases away from zero and a weight decay of 0.1
    let the decay decide the sign in both."""
    params, ms = jax_state_from_port(mcfg, seed=5)
    for layer in ("fc1", "fc2"):
        b = params[layer]["b"]
        params[layer]["b"] = jnp.where(b < 0, b - 0.05, b + 0.05)
    return params, ms


def _argv(root, out_dir, *extra):
    return [
        "--train_data_dir", str(root / "feats"), "--valid_data_dir", str(root / "valid"),
        "--train_labels_path", str(root / "labels.ndx"),
        "--valid_clients", str(root / "clients.ndx"),
        "--valid_impostors", str(root / "impostors.ndx"),
        "--out_dir", str(out_dir), "--model_name", "tiny",
        "--kernel_size", "16", "--heads_number", "4", "--embedding_size", "32",
        "--mask_prob", "0", "--window_size", "0.8", "--batch_size", "6",
        "--gradientAccumulation", "2", "--learning_rate", "0.002", "--weight_decay", "0.1",
        "--max_epochs", "2",
        "--validate_every", "2", "--checkpoint_every", "1", "--print_every", "1",
        "--num_workers", "1", "--seed", "3", *extra,
    ]


def _events(path, kind):
    with open(path) as f:
        return [e for e in map(json.loads, f) if e["event"] == kind]


def _metrics_path(out_dir):
    (name,) = [f for f in os.listdir(out_dir) if f.endswith("_metrics.jsonl")]
    return os.path.join(out_dir, name)


def _npz_files(out_dir):
    return sorted(f for f in os.listdir(out_dir) if f.endswith(".npz"))


class _Run:
    """What a module-level run left: its trainer, out_dir and metrics."""

    def __init__(self, trainer, out_dir, metrics):
        self.trainer, self.out_dir, self.metrics = trainer, str(out_dir), str(metrics)

    def events(self, kind):
        return _events(self.metrics, kind)

    def leaves(self, step):
        (name,) = [f for f in os.listdir(self.out_dir)
                   if f.endswith(f"_{step}.npz") and "_best_" not in f]
        return load_checkpoint(os.path.join(self.out_dir, name))[0]


def _jax_run(jtr, state0, out_dir, overrides=None, start_from=None, tensorboard_dir=None):
    """A JAX ``Trainer.train()`` on a shallow copy of ``jtr`` (its compiled
    step and embedding function reused) from the host state ``state0``, or
    resumed from the newest checkpoint in ``start_from`` copied to
    ``out_dir``; its logger also writes TensorBoard scalars to
    ``tensorboard_dir`` where one is given."""
    j = copy.copy(jtr)
    cfg = jtr.cfg.replace(out_dir=str(out_dir))
    if overrides:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **overrides))
    os.makedirs(out_dir, exist_ok=True)
    j.cfg = cfg
    metrics = os.path.join(str(out_dir), "jax_metrics.jsonl")
    j.log = JaxLogger(jsonl_path=metrics, stream=io.StringIO(),
                      tensorboard_dir=None if tensorboard_dir is None else str(tensorboard_dir))
    j.state = jax.tree.map(jnp.asarray, state0)
    j._checkpointer = jckpt.AsyncCheckpointer()
    j._watchdog, j._pending_val, j.best_ckpt_path = None, None, None
    j.best_eer, j.stopping, j.starting_epoch, j._resume_skip_steps = 50.0, 0, 0, 0
    j.preempted, j._stop_requested = False, False
    if start_from is not None:
        shutil.copy(jckpt.latest_checkpoint(str(start_from)), str(out_dir))
        assert j.resume()
    j.train()
    j.log.close()
    # the JAX trainer prunes before its asynchronous write lands, so which
    # files it leaves depends on the disk; its rule applied once more on the
    # finished directory is what the port's writer-side prune leaves
    jckpt.prune_checkpoints(str(out_dir), j.model_name, cfg.train.keep_checkpoints,
                            protect=(j.best_ckpt_path,) if j.best_ckpt_path else ())
    return _Run(j, out_dir, metrics)


def _write_step0(jtr, state0, out_dir):
    """The step-0 file, written by the JAX package, that a port run resumes
    from."""
    os.makedirs(out_dir, exist_ok=True)
    state = jax.tree.map(jnp.asarray, state0)
    meta = jtr._meta(state)
    meta["epoch"] = -1
    jckpt.save_checkpoint(os.path.join(str(out_dir), f"{jtr.model_name}_0.npz"), state, meta)


def _port_run(root, out_dir, *extra):
    assert pcli.main(_argv(root, out_dir, "--requeue", "--device", "cpu", *extra)) == 0
    return _Run(None, out_dir, _metrics_path(out_dir))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    _corpus(root)
    jcfg = jax_build_config(jax_parser().parse_args(_argv(root, root / "jax")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "init_speaker_classifier",
                   lambda key, mcfg: _initial_state(mcfg))
        jtr = jtrainer.Trainer(jcfg, logger=JaxLogger(stream=io.StringIO()))
    jtr._watchdog.stop()
    state0 = jax.tree.map(np.array, jtr.state)
    port_dir = root / "port"
    _write_step0(jtr, state0, port_dir)
    return {
        "root": root, "jtr": jtr, "state0": state0,
        "jax": _jax_run(jtr, state0, root / "jax", tensorboard_dir=root / "jax_tb"),
        "port": _port_run(root, port_dir, "--tensorboard_dir", str(root / "port_tb")),
    }


def _step_metrics(run):
    return [(e["step"], e["xent"], e["accuracy"]) for e in run.events("train")]


def test_trajectory_matches_jax(runs):
    """From one step-0 checkpoint the port's CLI run takes JAX's steps:
    per-step loss and accuracy, validation EERs, the files it leaves, and
    its final train state, leaf by leaf."""
    jax_run, port = runs["jax"], runs["port"]
    ref, got = _step_metrics(jax_run), _step_metrics(port)
    assert [s for s, _, _ in got] == [s for s, _, _ in ref] == [1, 2, 3, 4]
    for (_, xent, acc), (_, rx, ra) in zip(got, ref):
        assert xent == pytest.approx(rx, rel=TOL_STEP)
        assert acc == pytest.approx(ra, rel=TOL_ACC)
    ref_v, got_v = jax_run.events("validate"), port.events("validate")
    assert [e["step"] for e in got_v] == [e["step"] for e in ref_v] == [2, 4]
    for g, r in zip(got_v, ref_v):
        assert g["eer"] == r["eer"]
        assert g["eer_exact"] == pytest.approx(r["eer_exact"], abs=1e-6)
    name = runs["jtr"].model_name
    # the first validation improves on the initial 50% and saves a best file
    assert ref_v[0]["eer"] < 50.0
    assert _npz_files(port.out_dir) == _npz_files(jax_run.out_dir) == sorted(
        [f"{name}_{s}.npz" for s in (2, 3, 4)] + [f"{name}_best_2.npz"])
    assert os.path.exists(os.path.join(port.out_dir, f"{name}_config.json"))
    _assert_leaves_close(port.leaves(4), jax_run.leaves(4))


def test_async_validation_equals_sync(runs, tmp_path):
    """Validation on a snapshot in a background thread decides as serial
    validation does: the same EERs, losses and final state."""
    _write_step0(runs["jtr"], runs["state0"], tmp_path)
    sync = _port_run(runs["root"], tmp_path, "--sync_validation")
    port = runs["port"]
    assert _step_metrics(sync) == _step_metrics(port)
    for key in ("step", "eer", "eer_exact"):
        assert [e[key] for e in sync.events("validate")] == [
            e[key] for e in port.events("validate")]
    a, b = sync.leaves(4), port.leaves(4)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_jax_resumes_from_port_checkpoint(runs, tmp_path):
    """The JAX trainer resumes from the port's step-2 file and takes the
    port's steps 3 and 4."""
    port = runs["port"]
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(os.path.join(port.out_dir, f"{runs['jtr'].model_name}_2.npz"), src)
    resumed = _jax_run(runs["jtr"], runs["state0"], tmp_path / "jax", start_from=src)
    (event,) = resumed.events("resume")
    assert (event["step"], event["epoch"], event["in_epoch_skip"]) == (2, 1, 0)
    got, ref = _step_metrics(resumed), _step_metrics(port)[2:]
    assert [s for s, _, _ in got] == [3, 4]
    for (_, xent, acc), (_, rx, ra) in zip(got, ref):
        assert xent == pytest.approx(rx, rel=TOL_STEP)
        assert acc == pytest.approx(ra, rel=TOL_ACC)
    _assert_leaves_close(resumed.leaves(4), port.leaves(4))


class _StopAt(MetricLogger):
    """A logger that asks its trainer for a graceful stop when the ``train``
    event of ``step`` is logged (a SIGTERM handler's call, made at a known
    step)."""

    def __init__(self, path, step):
        super().__init__(jsonl_path=path, stream=io.StringIO())
        self.trainer, self.stop_step = None, step

    def log(self, event, **fields):
        super().log(event, **fields)
        if event == "train" and fields["step"] == self.stop_step and self.trainer:
            self.trainer.request_stop("test")


def _port_cfg(root, out_dir, **train):
    cfg = pcli.build_config(pcli.make_parser().parse_args(_argv(root, out_dir)))
    return cfg.replace(train=dataclasses.replace(cfg.train, **train))


def test_stop_mid_epoch_and_resume_equals_uninterrupted(runs, tmp_path):
    """With head dropout and SpecAugment on, a run stopped by
    ``request_stop`` after step 3 (mid-epoch 1) and resumed equals the
    uninterrupted run exactly: the loader skips the consumed step and every
    random draw is keyed by the step. The uninterrupted run's post-step
    bench leaves its state as it was."""
    root = runs["root"]
    cfg = _port_cfg(root, tmp_path / "full", specaugment=True, post_step_bench=2)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, mask_prob=0.3))
    full_log = MetricLogger(jsonl_path=str(tmp_path / "full.jsonl"), stream=io.StringIO())
    full = Trainer(cfg, logger=full_log, device="cpu")
    full.train()
    full_log.close()
    assert len(_events(tmp_path / "full.jsonl", "step_bench")) == 1

    cfg = cfg.replace(out_dir=str(tmp_path / "stopped"),
                      train=dataclasses.replace(cfg.train, post_step_bench=0))
    stop_log = _StopAt(str(tmp_path / "stopped.jsonl"), 3)
    stopped = Trainer(cfg, logger=stop_log, device="cpu")
    stop_log.trainer = stopped
    stopped.train()
    assert stopped.preempted and stopped.step == 3
    (ckpt,) = _events(tmp_path / "stopped.jsonl", "preempt_checkpoint")
    assert ckpt["step"] == 3 and os.path.exists(ckpt["path"])
    resumed = Trainer(cfg, logger=stop_log, device="cpu")
    stop_log.trainer = None
    assert resumed.resume()
    assert (resumed.starting_epoch, resumed._resume_skip_steps) == (1, 1)
    resumed.train()
    stop_log.close()

    def steps(path):
        return {e["step"]: (e["xent"], e["accuracy"]) for e in _events(path, "train")}

    assert steps(tmp_path / "stopped.jsonl") == steps(tmp_path / "full.jsonl")
    a = load_checkpoint(os.path.join(full.cfg.out_dir, f"{full.model_name}_4.npz"))[0]
    b = load_checkpoint(os.path.join(cfg.out_dir, f"{full.model_name}_4.npz"))[0]
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    for name, t in full.model.state_dict().items():
        assert torch.equal(t, resumed.model.state_dict()[name]), name


@pytest.mark.parametrize("optimizer", ["Adam", "SGD", "RMSprop"])
def test_lr_halving_follows_jax(runs, optimizer, tmp_path):
    """Epoch-end halving after every ``lr_halving_patience`` stagnant
    validations, RMSprop excluded, on the float32 learning rate, as JAX's
    ``_halve_lr_if_stagnant`` decides on a copy of the module's trainer."""
    j = copy.copy(runs["jtr"])
    j.cfg = j.cfg.replace(train=dataclasses.replace(j.cfg.train, optimizer=optimizer,
                                                    lr_halving_patience=3))
    j.log = JaxLogger(stream=io.StringIO())
    j.state = jax.tree.map(jnp.asarray, runs["state0"])
    cfg = _port_cfg(runs["root"], tmp_path, optimizer=optimizer, lr_halving_patience=3)
    tr = Trainer(cfg, logger=MetricLogger(stream=io.StringIO()), device="cpu")
    tr._watchdog.stop()
    got, ref = [], []
    for stopping in range(9):
        j.stopping = tr.stopping = stopping
        j._halve_lr_if_stagnant()
        tr._halve_lr_if_stagnant()
        ref.append(float(jtrainer.get_lr(j.state.opt_state)))
        got.append(tr.optimizer.param_groups[0]["lr"])
    assert got == ref
    halvings = 0 if optimizer == "RMSprop" else 3
    assert got[-1] == float(np.float32(0.002)) / 2 ** halvings


def test_early_stopping_follows_jax(runs, tmp_path):
    """With ``early_stopping`` 0 both trainers stop after the first epoch
    whose validation does not improve, with the same validations."""
    overrides = dict(early_stopping=0, max_epochs=5)
    ref = _jax_run(runs["jtr"], runs["state0"], tmp_path / "jax", overrides)
    out = tmp_path / "port"
    _write_step0(runs["jtr"], runs["state0"], out)
    log = MetricLogger(jsonl_path=str(tmp_path / "port.jsonl"), stream=io.StringIO())
    tr = Trainer(_port_cfg(runs["root"], out, **overrides), logger=log, device="cpu")
    assert tr.resume()
    tr.train()
    log.close()
    got = tmp_path / "port.jsonl"
    assert len(_events(got, "early_stop")) == len(ref.events("early_stop")) == 1
    assert 0 < tr.epoch == ref.trainer.epoch < 4
    for kind in ("validate", "new_best", "no_improvement"):
        assert len(_events(got, kind)) == len(ref.events(kind)), kind
    assert [e["eer"] for e in _events(got, "validate")] == [
        e["eer"] for e in ref.events("validate")]


def test_cli_config_equals_jax_build_config(runs, tmp_path):
    """``main([... "--device", "cpu"])`` writes a config JSON that JAX's
    ``ExperimentConfig.from_json`` reads equal to JAX's ``build_config`` of
    the same arguments (flags off their defaults included), and logs the
    source mode with the host loader path the JAX package takes (native or
    python); without ``--device cpu`` a machine with no CUDA raises."""
    root = runs["root"]
    extra = ["--max_epochs", "0", "--normalization", "cmvn", "--optimizer", "RMSprop",
             "--randomSlicing", "--annealing", "--specaugment", "--transfer_dtype",
             "bfloat16", "--device_prefetch", "2", "--valid_long_audio", "pad",
             "--sync_validation", "--no-use_pallas_dsp", "--data_source", "wav",
             "--wav_mode", "host_dsp", "--feature_cache_mb", "64", "--classifier_chunk", "2"]
    argv = _argv(root, tmp_path / "out", *extra)
    assert pcli.main(argv + ["--device", "cpu"]) == 0
    (path,) = [p for p in os.listdir(tmp_path / "out") if p.endswith("_config.json")]
    with open(tmp_path / "out" / path) as f:
        written = JaxExperimentConfig.from_json(f.read())
    jcfg = jax_build_config(jax_parser().parse_args(argv))
    assert written == jcfg
    assert PortExperimentConfig.from_json(jcfg.to_json()) == pcli.build_config(
        pcli.make_parser().parse_args(argv))
    (mode,) = _events(_metrics_path(tmp_path / "out"), "source_mode")
    assert mode["mode"] == "wav_cache" and mode["native"] == float(jnative.native_available())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pcli.main(argv)


def _watchdogs():
    return {t for t in threading.enumerate() if t.name == WATCHDOG_THREAD}


def test_resume_step(runs, tmp_path):
    """``--resume_step`` resumes from the file of that step (here the port's
    step 3, mid-epoch 1, so one step is left) and exits 1 where none is,
    leaving no stall watchdog running (the JAX CLI leaves its trainer's)."""
    name = runs["jtr"].model_name
    shutil.copy(os.path.join(runs["port"].out_dir, f"{name}_3.npz"), tmp_path)
    before = _watchdogs()
    assert pcli.main(_argv(runs["root"], tmp_path, "--device", "cpu", "--resume_step", "9")) == 1
    assert _watchdogs() <= before
    assert pcli.main(_argv(runs["root"], tmp_path, "--device", "cpu", "--resume_step", "3")) == 0
    (resume,) = _events(_metrics_path(tmp_path), "resume")
    assert (resume["step"], resume["epoch"], resume["in_epoch_skip"]) == (3, 1, 1)
    assert [e["step"] for e in _events(_metrics_path(tmp_path), "train")] == [4]


def _tb_scalars(logdir):
    (path,) = [os.path.join(logdir, f) for f in os.listdir(logdir)
               if f.startswith("events.out.tfevents.")]
    return {(step, tag): value for (_, step, tag, value) in read_scalars(path)}


def test_tensorboard_scalars_follow_jax(runs):
    """``--tensorboard_dir``: the port's run writes the scalar tags the JAX
    trainer writes for the same run, at the same steps; each train loss
    equals the port's JSONL value (as float32) and JAX's to the step
    tolerance of ``test_trajectory_matches_jax``. The port's run adds two events of its own: ``resume`` (it
    starts from the step-0 file) and ``ckpt_save`` (the port times its npz
    saves; JAX logs the event for orbax saves only)."""
    port, jax_tb = _tb_scalars(runs["root"] / "port_tb"), _tb_scalars(runs["root"] / "jax_tb")
    own = {k for k in port if k[1].split("/")[0] in ("resume", "ckpt_save")}
    assert {t for (_, t) in own} == {"resume/epoch", "resume/in_epoch_skip",
                                     "ckpt_save/blocked_s"}
    assert set(port) - own == set(jax_tb)
    train = runs["port"].events("train")
    assert [e["step"] for e in train] == [1, 2, 3, 4]
    for e in train:
        assert port[(e["step"], "train/xent")] == np.float32(e["xent"])
        assert port[(e["step"], "train/xent")] == pytest.approx(
            jax_tb[(e["step"], "train/xent")], rel=TOL_STEP)
    assert {t for (_, t) in port} >= {"train/xent", "train/accuracy", "validate/eer"}


def test_profile_window_from_the_cli(runs, tmp_path):
    """``--profile_dir``: a 4-step run traced over steps 1 and 2 logs both
    events and writes one readable ``torch.profiler`` trace holding the
    steps' convolutions."""
    prof = tmp_path / "prof"
    out = tmp_path / "out"
    assert pcli.main(_argv(runs["root"], out, "--device", "cpu", "--profile_dir", str(prof),
                           "--profile_start_step", "1", "--profile_steps", "2",
                           "--validate_every", "0", "--checkpoint_every", "0")) == 0
    metrics = _metrics_path(out)
    assert [(e["step"], e["dir"]) for e in _events(metrics, "profile_started")] == [(1, str(prof))]
    assert [e["step"] for e in _events(metrics, "profile_stopped")] == [3]
    (name,) = os.listdir(prof)
    with open(prof / name) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::conv2d" in names


@pytest.mark.parametrize("flags, message", [
    (["--distributed"], "needs a coordinator"),
    (["--coordinator_address", "localhost:1234"], "needs the process count"),
    (["--distributed", "--num_processes", "2", "--process_id", "2",
      "--coordinator_address", "localhost:1234"], "process id 2 outside 0..1"),
    (["--coordinator_address", "localhost", "--num_processes", "2", "--process_id", "0"],
     "give host:port"),
])
def test_refused_flags_exit_nonzero(runs, tmp_path, flags, message, capsys):
    """A multi-process launch without its topology exits 2 before anything
    is written or any process is contacted."""
    assert pcli.main(_argv(runs["root"], tmp_path, "--device", "cpu", *flags)) == 2
    assert message in capsys.readouterr().err
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("where", ["train", "constructor"])
def test_no_watchdog_outlives_a_trainer_that_raises(runs, tmp_path, where, monkeypatch):
    """A ``train()`` that raises, and a constructor that raises after
    starting the watchdog (here the loader finds no manifest), stop it; the
    error comes through unchanged. ``close()`` may be called again."""
    cfg = _port_cfg(runs["root"], tmp_path)
    before = _watchdogs()
    if where == "constructor":
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   train_labels_path=str(tmp_path / "none.ndx")))
        with pytest.raises(FileNotFoundError):
            Trainer(cfg, logger=MetricLogger(stream=io.StringIO()), device="cpu")
    else:
        trainer = Trainer(cfg, logger=MetricLogger(stream=io.StringIO()), device="cpu")
        assert _watchdogs() - before

        def fail(step, batch, keep=None):
            raise RuntimeError("step failed")

        monkeypatch.setattr(type(trainer.train_step), "__call__", fail)
        with pytest.raises(RuntimeError, match="step failed"):
            trainer.train()
        trainer.close()
    assert _watchdogs() <= before


def test_watchdog_reports_a_stall():
    """The stall watchdog calls its handler once no beat came for its
    timeout (waited on with an event, not a sleep)."""
    fired = threading.Event()
    seen = []

    def on_stall(age, step):
        seen.append((age, step))
        fired.set()

    dog = Watchdog(timeout_s=0.01, on_stall=on_stall, poll_s=0.01).start()
    dog.beat(7)
    try:
        assert fired.wait(timeout=30)
    finally:
        dog.stop()
    assert seen[0][1] == 7 and seen[0][0] > 0.01


@pytest.mark.parametrize("depth", [0, 2])
def test_device_prefetch_on_the_cpu(depth):
    batches = [{"inputs": np.full((2, 3), i, np.float32), "labels": np.arange(2, dtype=np.int32)}
               for i in range(4)]
    out = list(pprefetch.device_prefetch(iter(batches), depth=depth, device="cpu"))
    assert len(out) == 4
    for i, b in enumerate(out):
        assert isinstance(b["inputs"], torch.Tensor) and float(b["inputs"][0, 0]) == i
        assert b["labels"].dtype == torch.int32
