"""The port's train CLI across two processes against its one-process
trainer (which ``tests/test_torch_trainer.py`` holds to the JAX package's),
in three of the JAX package's two-process scenarios
(``tools/multihost_trainer_check.py``) at their tolerances, on their
corpus:

- A: a data-parallel SGD run's losses within 1e-3 of one process's, its
  EERs within 0.51;
- C then T: ``--model_parallel 2`` with ``.dcp`` checkpoints, stopped after
  epoch 1 and resumed by the two processes, and by one process from a copy
  of the same checkpoint, each continuing the one-process run to 1e-3;
- D: sharded validation (each process embeds ceil(n / 2) utterances) gives
  the EER of unsharded validation exactly;

and a stop requested on process 1 alone (SIGTERM), after which both stop
at the next agreement step, write the checkpoint and exit 0. One gloo
group of two processes (a ``file://`` store under ``tmp_path``) runs every
two-process run (``tests/torch_rank_cases.py:trainer_cases``). Then the
checkpoints: ``.dcp`` <-> npz lossless, a JAX-written npz through the
port's ``convert_checkpoint`` and back leaf for leaf, and a JAX ``.orbax``
directory (written by the JAX package here) refused with the way across.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from doubleattentionspeakerverification_tpu.config import ExperimentConfig as JaxExperimentConfig
from doubleattentionspeakerverification_tpu.config import ModelConfig as JaxModelConfig
from doubleattentionspeakerverification_tpu.models.classifier import init_speaker_classifier
from doubleattentionspeakerverification_tpu.training.step import init_train_state
from doubleattentionspeakerverification_tpu.utils import checkpoint as jckpt
from doubleattentionspeakerverification_tpu_torch.cli import convert_checkpoint as pconvert
from doubleattentionspeakerverification_tpu_torch.cli import export_checkpoint as pexport
from doubleattentionspeakerverification_tpu_torch.cli import score_trials as pscore
from doubleattentionspeakerverification_tpu_torch.cli import train as pcli
from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig, TrainConfig
from doubleattentionspeakerverification_tpu_torch.tools.multihost_check import call_argv, launch
from doubleattentionspeakerverification_tpu_torch.training.trainer import Trainer
from doubleattentionspeakerverification_tpu_torch.utils import checkpoint as pckpt
from doubleattentionspeakerverification_tpu_torch.utils import dist_ckpt
from tools.multihost_trainer_check import make_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_LOSS, TOL_EER = 1e-3, 0.51   # JAX scenario A's (tools/multihost_trainer_check.py:292)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _argv(root, out, epochs, *extra):
    """JAX's scenario flags (``train_argv``): VGG4L k=16, 4 heads, emb 32,
    8 x 2 windows of 0.8 s, 2 steps an epoch, SGD, a checkpoint every step
    in the .dcp backend, serial validation every 2 steps."""
    return ["--optimizer", "SGD",
            "--train_data_dir", os.path.join(root, "feats"),
            "--valid_data_dir", os.path.join(root, "feats"),
            "--train_labels_path", os.path.join(root, "labels.ndx"),
            "--valid_clients", os.path.join(root, "clients.ndx"),
            "--valid_impostors", os.path.join(root, "impostors.ndx"),
            "--out_dir", os.path.join(root, out), "--model_name", "mh",
            "--front_end", "VGG4L", "--kernel_size", "16", "--heads_number", "4",
            "--embedding_size", "32", "--window_size", "0.8",
            "--batch_size", "8", "--gradientAccumulation", "2",
            "--learning_rate", "2e-3", "--max_epochs", str(epochs),
            "--print_every", "1", "--validate_every", "2",
            "--checkpoint_every", "1", "--checkpoint_backend", "orbax",
            "--sync_validation", "--num_workers", "1", "--device", "cpu", *extra]


def _events(out_dir, kind=None):
    (name,) = [f for f in os.listdir(out_dir) if f.endswith("_metrics.jsonl")]
    with open(os.path.join(out_dir, name)) as f:
        events = [json.loads(line) for line in f]
    return [e for e in events if kind is None or e["event"] == kind]


def _losses(out_dir):
    return {int(e["step"]): e["xent"] for e in _events(out_dir, "train")}


def _eers(out_dir):
    return {int(e["step"]): e["eer"] for e in _events(out_dir, "validate")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("multiprocess"))
    make_corpus(root)
    mp = ("--model_parallel", "2")
    plan = [
        ["A2", _argv(root, "A2", 2)],
        ["C1", _argv(root, "C", 1, *mp)],
        # C1 again with every .dcp written synchronously
        ["C1sync", _argv(root, "Csync", 1, *mp, "--no-checkpoint_async")],
        ["copy", [os.path.join(root, "C"), os.path.join(root, "T")]],
        ["C2", _argv(root, "C", 2, *mp, "--requeue")],
        # unsharded validation; process 1 alone is signalled after step 1
        ["stop", _argv(root, "S", 2, "--no-shard_validation", "--preempt_sync_every", "2")],
    ]
    with open(os.path.join(root, "argv.json"), "w") as f:
        json.dump(plan, f)
    results = launch(call_argv("torch_rank_cases:trainer_cases", root), 2, timeout=600,
                     env={"PYTHONPATH": os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
                          "OMP_NUM_THREADS": "1"},
                     cwd=REPO, workdir=os.path.join(root, "group"))
    for r in results:
        assert r.returncode == 0, f"rank {r.rank}: {r.stdout[-3000:]}{r.stderr[-3000:]}"
    rcs = []
    for r in range(2):
        with open(os.path.join(root, f"trainer_rank{r}.json")) as f:
            rcs.append(json.load(f))
    # one process: the reference run, and T's resume from C's step-2 copy
    with contextlib.redirect_stdout(io.StringIO()):
        assert pcli.main(_argv(root, "A1", 2)) == 0
        assert pcli.main(_argv(root, "T", 2, *mp, "--requeue")) == 0
    return dict(root=root, results=results, rcs=rcs)


def test_two_processes_joined_and_exited_zero(runs):
    for r in runs["results"]:
        assert f"process {r.rank} of 2, backend gloo, device cpu" in r.stdout
    assert runs["rcs"] == [{"A2": 0, "C1": 0, "C1sync": 0, "C2": 0, "stop": 0}] * 2


def test_scenario_A_losses_and_eers(runs):
    """2 processes x 4 rows against one process x 8 rows, one loss a step
    (both the global batch's)."""
    root = runs["root"]
    one, two = _losses(os.path.join(root, "A1")), _losses(os.path.join(root, "A2"))
    assert sorted(one) == sorted(two) == [1, 2, 3, 4]
    for s in one:
        assert abs(one[s] - two[s]) <= TOL_LOSS, (s, one[s], two[s])
    e1, e2 = _eers(os.path.join(root, "A1")), _eers(os.path.join(root, "A2"))
    assert sorted(e1) == sorted(e2) == [2, 4]
    for s in e1:
        assert abs(e1[s] - e2[s]) <= TOL_EER, (s, e1[s], e2[s])


def test_scenario_C_model_parallel_resumed_by_two_processes(runs):
    """``W`` split over the two processes: stopped after epoch 1 (step 2),
    resumed with ``--requeue`` from the finished .dcp, whose ``W`` leaves
    are the two processes' columns."""
    root = runs["root"]
    ref, got = _losses(os.path.join(root, "A1")), _losses(os.path.join(root, "C"))
    assert sorted(got) == [1, 2, 3, 4]
    for s in got:
        assert abs(got[s] - ref[s]) <= TOL_LOSS, (s, got[s], ref[s])
    (resume,) = _events(os.path.join(root, "C"), "resume")
    assert resume["step"] == 2 and resume["path"].endswith("_2.dcp")
    from torch.distributed.checkpoint import FileSystemReader

    keys = FileSystemReader(resume["path"]).read_metadata().state_dict_metadata
    assert {"params/amsoftmax/W@0:2", "params/amsoftmax/W@2:4"} <= set(keys)
    assert "params/amsoftmax/W" not in keys
    assert all(os.path.exists(os.path.join(root, "C", d, "meta.json"))
               for d in os.listdir(os.path.join(root, "C")) if d.endswith(".dcp"))


def test_async_and_sync_dcp_saves_leave_equal_leaves(runs):
    """The runs take the asynchronous ``.dcp`` path by default (``ckpt_save``
    mode ``async``, every directory finalized by the run's end); C1 with
    ``--no-checkpoint_async`` logs ``sync`` and leaves the same leaves at
    step 2, ``W``'s columns included."""
    root = runs["root"]
    for run, mode, steps in (("C", "async", [1, 2, 3, 4]), ("Csync", "sync", [1, 2]),
                             ("A2", "async", [1, 2, 3, 4])):
        saves = _events(os.path.join(root, run), "ckpt_save")
        assert [e["step"] for e in saves] == steps, run
        assert {(e["backend"], e["mode"]) for e in saves} == {("dcp", mode)}, run
        assert all(e["blocked_s"] >= 0 for e in saves)
    a, b = (dist_ckpt.load_checkpoint_dcp(os.path.join(root, run, name))[0]
            for run in ("C", "Csync") for name in os.listdir(os.path.join(root, run))
            if name.endswith("_2.dcp") and "_best_" not in name)
    assert set(a) == set(b) and "params/amsoftmax/W" in a
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_scenario_T_model_parallel_resumed_by_one_process(runs):
    """The same step-2 checkpoint resumed by one process (``W`` whole):
    steps 3 and 4 continue the one-process run (JAX scenario T's
    model-parallel 2 -> 1 case)."""
    root = runs["root"]
    ref, got = _losses(os.path.join(root, "A1")), _losses(os.path.join(root, "T"))
    assert sorted(got) == [1, 2, 3, 4]
    for s in got:
        assert abs(got[s] - ref[s]) <= TOL_LOSS, (s, got[s], ref[s])
    resumes = _events(os.path.join(root, "T"), "resume")
    assert [e["step"] for e in resumes] == [2]


def test_scenario_D_sharded_validation_gives_the_unsharded_eer(runs):
    """Step 2's EER of the sharded run (A2) equals the unsharded run's (the
    same two-process program up to its validation) exactly; each process
    embedded ceil(n / 2) of the n utterances."""
    root = runs["root"]
    sharded, whole = _eers(os.path.join(root, "A2")), _eers(os.path.join(root, "S"))
    assert whole[2] == sharded[2]
    shards = _events(os.path.join(root, "A2"), "validate_shard")
    assert len(shards) == 2
    for e in shards:
        assert e["n_local"] == -(-e["n_total"] // 2) == e["n_embedded"] and e["n_total"] > 4
    assert not _events(os.path.join(root, "S"), "validate_shard")


def test_stop_requested_on_one_process(runs):
    """SIGTERM reached process 1 after step 1; at step 2, the agreement step
    (``--preempt_sync_every 2``), both stopped, the checkpoint of step 2 was
    finished, and both exited 0 (``test_two_processes_joined_and_exited_zero``)."""
    out = os.path.join(runs["root"], "S")
    assert sorted(_losses(out)) == [1, 2]
    (stop,) = _events(out, "preempt_stop")
    assert stop["step"] == 2 and stop["reason"] == "peer-host signal"
    (ck,) = _events(out, "preempt_checkpoint")
    assert ck["step"] == 2 and ck["path"].endswith("_2.dcp")
    assert os.path.exists(os.path.join(ck["path"], "meta.json"))
    assert dist_ckpt.latest_dcp_checkpoint(out) == ck["path"]


def test_dcp_npz_round_trip_is_lossless(runs, tmp_path):
    """A two-process .dcp (``W`` in columns) -> npz -> .dcp -> npz: every
    leaf and the meta unchanged; the one-process .dcp of the same step has
    the same leaf set."""
    src = dist_ckpt.latest_dcp_checkpoint(os.path.join(runs["root"], "C"))
    flat, meta = pckpt.load_checkpoint(src)
    with contextlib.redirect_stdout(io.StringIO()):
        assert pconvert.main(["--input", src, "--output", str(tmp_path / "a.npz")]) == 0
        assert pconvert.main(["--input", str(tmp_path / "a.npz")]) == 0   # -> a.dcp
        assert pconvert.main(["--input", str(tmp_path / "a.dcp"),
                              "--output", str(tmp_path / "b.npz")]) == 0
    for path in ("a.npz", "a.dcp", "b.npz"):
        got, got_meta = pckpt.load_checkpoint(str(tmp_path / path))
        assert got_meta == meta and set(got) == set(flat)
        for k in flat:
            assert got[k].dtype == flat[k].dtype and np.array_equal(got[k], flat[k]), (path, k)
    assert flat["params/amsoftmax/W"].shape == (32, 4)
    one = dist_ckpt.latest_dcp_checkpoint(os.path.join(runs["root"], "A1"))
    assert set(pckpt.load_checkpoint(one)[0]) == set(flat)


def test_dcp_feeds_export_and_the_api(runs, tmp_path):
    """A two-process .dcp (``W`` in columns) loads where an npz does: the
    export CLI writes its reference .chkpt, and ``from_checkpoint`` (the
    score and embedding CLIs' loader) embeds as from the converted npz."""
    from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel

    src = dist_ckpt.latest_dcp_checkpoint(os.path.join(runs["root"], "C"))
    with contextlib.redirect_stdout(io.StringIO()):
        assert pexport.main(["--checkpoint", src, "--out", str(tmp_path / "m.chkpt")]) == 0
        assert pconvert.main(["--input", src, "--output", str(tmp_path / "m.npz")]) == 0
    x = np.random.default_rng(2).standard_normal((2, 90, 80)).astype(np.float32)
    embs = [SpeakerEmbeddingModel.from_checkpoint(p, device="cpu").embed_features(x)
            for p in (src, str(tmp_path / "m.npz"), str(tmp_path / "m.chkpt"))]
    np.testing.assert_array_equal(embs[0], embs[1])
    np.testing.assert_array_equal(embs[0], embs[2])


def _jax_state():
    """A JAX ``TrainState`` of the scenarios' model filled from numpy (its
    template from ``jax.eval_shape``: nothing random compiles)."""
    jcfg = JaxExperimentConfig(model=JaxModelConfig(kernel_size=16, heads_number=4,
                                                    embedding_size=32, num_spkrs=4))
    template = jax.eval_shape(lambda k: init_train_state(
        *init_speaker_classifier(k, jcfg.model), jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    state = jax.tree.map(lambda s: jnp.asarray(
        np.asarray(3, s.dtype) if s.dtype == jnp.int32 and not s.shape
        else rng.standard_normal(s.shape).astype(s.dtype)), template)
    return jcfg, state


def test_jax_npz_converts_and_back(tmp_path):
    """A JAX-written npz -> the port's .dcp -> npz: equal to JAX's file leaf
    for leaf, and JAX reads the result back."""
    jcfg, state = _jax_state()
    src = str(tmp_path / "m_3.npz")
    jckpt.save_checkpoint(src, state, {"config": jcfg.to_dict(), "step": 3})
    with contextlib.redirect_stdout(io.StringIO()):
        assert pconvert.main(["--input", src]) == 0
        assert pconvert.main(["--input", str(tmp_path / "m_3.dcp"),
                              "--output", str(tmp_path / "back.npz")]) == 0
    want, meta = pckpt.load_checkpoint(src)
    got, got_meta = pckpt.load_checkpoint(str(tmp_path / "back.npz"))
    assert got_meta == meta and set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    restored, _ = jckpt.load_checkpoint(str(tmp_path / "back.npz"), state)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(restored),
                                                    jax.tree.leaves(state)))


def test_jax_orbax_directory_is_refused(tmp_path):
    """The JAX package's own .orbax directory: every reader of the port
    refuses it (exit 2, or ValueError) naming JAX's convert_checkpoint."""
    from doubleattentionspeakerverification_tpu.utils.orbax_ckpt import save_checkpoint_orbax

    jcfg, state = _jax_state()
    path = save_checkpoint_orbax(str(tmp_path / "m_3.orbax"), state, {"step": 3})
    assert os.path.exists(os.path.join(path, "meta.json"))
    with pytest.raises(ValueError, match="cli.convert_checkpoint"):
        pckpt.load_checkpoint(path)
    for main, argv in ((pconvert.main, ["--input", path]),
                       (pexport.main, ["--checkpoint", path, "--out", str(tmp_path / "x.chkpt")]),
                       (pscore.main, ["--modelCheckpoint", path, "--data_dir", "d",
                                      "--trials", "t.ndx", "--device", "cpu"])):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert main(argv) == 2
        assert "doubleattentionspeakerverification_tpu.cli.convert_checkpoint" in err.getvalue()


def test_several_processes_require_the_dcp_backend(monkeypatch):
    # the trainer reads its rank and the world size from torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    cfg = ExperimentConfig(train=TrainConfig(checkpoint_backend="npz"))
    with pytest.raises(ValueError, match="requires checkpoint_backend='orbax'"):
        Trainer(cfg, device="cpu")
