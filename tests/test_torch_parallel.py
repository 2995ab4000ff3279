"""The port's parallel modules across two processes against the JAX
package's on its 8-device virtual mesh (``tests/conftest.py``), as
``tests/test_parallel.py`` builds it: the AM-Softmax with ``W`` split over
the model axis (loss, accuracy with a tied row, gradients of ``W`` and of
the embeddings), the embedding all-gather, and one train step,
data-parallel and with ``W`` split, against JAX ``make_train_step`` after
``shard_train_state`` (loss, accuracy, parameters, Adam moments and
``b2``'s running statistics). One gloo group of two processes
(``tools/multihost_check.py``, a ``file://`` store under ``tmp_path``) runs
every rank-side case (``tests/torch_rank_cases.py``); JAX compiles one
train step. ``make_mesh``'s errors and ``host_batch_rows``' ranges are held
to JAX's in this process."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu.config import DataConfig as JaxDataConfig
from doubleattentionspeakerverification_tpu.config import ExperimentConfig as JaxExperimentConfig
from doubleattentionspeakerverification_tpu.config import MeshConfig as JaxMeshConfig
from doubleattentionspeakerverification_tpu.config import ModelConfig as JaxModelConfig
from doubleattentionspeakerverification_tpu.config import TrainConfig as JaxTrainConfig
from doubleattentionspeakerverification_tpu.models import amsoftmax as jam
from doubleattentionspeakerverification_tpu.models.classifier import (
    ModelState,
    init_speaker_classifier,
)
from doubleattentionspeakerverification_tpu.parallel import mesh as jmesh
from doubleattentionspeakerverification_tpu.parallel import sharded_amsoftmax as jsa
from doubleattentionspeakerverification_tpu.training import step as jstep
from doubleattentionspeakerverification_tpu.utils.checkpoint import _flatten
from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig, MeshConfig
from doubleattentionspeakerverification_tpu_torch.config import ModelConfig, TrainConfig
from doubleattentionspeakerverification_tpu_torch.parallel import mesh as pmesh
from doubleattentionspeakerverification_tpu_torch.tools.multihost_check import call_argv, launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
G, B, T, HEADS, N_SPK = 2, 4, 60, 4, 10
CE = dict(b=6, emb=12, n=10, step=100)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _step_configs():
    model = dict(front_end="VGG3L", kernel_size=16, heads_number=HEADS, embedding_size=24,
                 num_spkrs=N_SPK, mask_prob=0.3, annealing=True)
    train = dict(optimizer="Adam", learning_rate=1e-4, weight_decay=1e-3, batch_size=B,
                 gradient_accumulation=G)
    jcfg = JaxExperimentConfig(
        model=JaxModelConfig(use_pallas_pooling=False, use_pallas_dsp=False, **model),
        train=JaxTrainConfig(**train), data=JaxDataConfig(source="features"),
        mesh=JaxMeshConfig(model_axis=2))
    return jcfg, ExperimentConfig(model=ModelConfig(**model), train=TrainConfig(**train))


def _jax_state(jcfg):
    """The JAX model's structure filled from numpy, with non-trivial
    ``b2`` running statistics (no JAX random program compiles)."""
    params, _ = jax.eval_shape(lambda k: init_speaker_classifier(k, jcfg.model),
                               jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)

    def fill(s):
        std = 0.1 if len(s.shape) < 2 else 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return jnp.asarray((rng.standard_normal(s.shape) * std).astype(np.float32))

    emb = jcfg.model.embedding_size
    return jax.tree.map(fill, params), ModelState(jnp.full((emb,), 0.1), jnp.full((emb,), 2.0),
                                                  jnp.zeros((), jnp.int32))


def _ce_inputs():
    """x (6, 12), W (12, 10) with columns 2 and 7 (one in each model
    shard) equal, and rows 0 and 1 pointing at them: an exact tie across
    the shards, which the lowest owning index wins (row 0's label is 2,
    row 1's is 7)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((CE["b"], CE["emb"])).astype(np.float32)
    w = rng.standard_normal((CE["emb"], CE["n"])).astype(np.float32)
    w[:, 7] = w[:, 2]
    x[0] = 3.0 * w[:, 2]
    x[1] = 2.0 * w[:, 7]
    y = rng.integers(0, CE["n"], CE["b"]).astype(np.int32)
    y[0], y[1] = 2, 7
    w[:, y[2:4]] = x[2:4].T          # two more rows right
    return x, w, y


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("parallel"))
    inputs = {}

    # the sharded AM-Softmax on JAX's virtual mesh
    x, w, y = _ce_inputs()
    jmcfg = JaxModelConfig(annealing=True)
    mesh = jmesh.make_mesh(JaxMeshConfig(model_axis=2))
    ce = jax.jit(jax.value_and_grad(
        lambda ww, xx: jsa.sharded_amsoftmax_ce({"W": ww}, xx, y, CE["step"], jmcfg, mesh),
        argnums=(0, 1), has_aux=True))
    (ce_loss, ce_acc), (ce_dw, ce_dx) = ce(w, x)
    ce_focal = jax.jit(lambda ww, xx: jam.focal_cross_entropy(
        jam.amsoftmax_apply({"W": ww}, xx, y, CE["step"], jmcfg)[1], y, 2.0))(w, x)
    inputs.update(ce_x=x, ce_w=w, ce_y=y, ce_step=np.asarray(CE["step"]))
    with open(os.path.join(work, "ce_model.json"), "w") as f:
        json.dump({"annealing": True}, f)

    emb = np.random.default_rng(4).standard_normal((8, 5)).astype(np.float32)
    gathered = np.asarray(jsa.sharded_cosine_scores_allgather(
        jnp.asarray(emb), jmesh.make_mesh(JaxMeshConfig(model_axis=1))))
    inputs["emb"] = emb

    # one train step on the (4 data x 2 model) mesh, W sharded
    jcfg, cfg = _step_configs()
    params, ms = _jax_state(jcfg)
    rng = np.random.default_rng(5)
    batch = {"inputs": rng.standard_normal((G, B, T, 80)).astype(np.float32),
             "lengths": np.array([[T, 41, T, 33], [T, T, 47, 52]], np.int32),
             "labels": rng.integers(0, N_SPK, (G, B)).astype(np.int32)}
    key = jax.random.PRNGKey(7)
    state0 = jstep.init_train_state(params, ms, jcfg)
    smesh = jmesh.make_mesh(jcfg.mesh)
    new_state, metrics = jstep.make_train_step(jcfg, donate=False)(
        jmesh.shard_train_state(state0, smesh), jmesh.shard_batch(batch, smesh), key)
    n_levels = int(1 / jcfg.model.mask_prob)
    keep = np.stack([np.asarray(jax.random.randint(jax.random.fold_in(key, i), (B, HEADS), 0,
                                                   n_levels) > 0) for i in range(G)])
    inputs.update({f"state/{k}": v for k, v in _flatten({"params": params,
                                                         "model_state": ms}).items()})
    inputs.update({f"batch/{k}": v for k, v in batch.items()}, keep=keep)
    with open(os.path.join(work, "step_config.json"), "w") as f:
        f.write(cfg.to_json())
    np.savez(os.path.join(work, "inputs.npz"), **inputs)

    results = launch(call_argv("torch_rank_cases:parallel_cases", work), 2, timeout=300,
                     env={"PYTHONPATH": os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
                          "OMP_NUM_THREADS": "1"},
                     cwd=REPO, workdir=os.path.join(work, "group"))
    for r in results:
        assert r.returncode == 0, f"rank {r.rank}: {r.stdout[-3000:]}{r.stderr[-3000:]}"
    ranks = [dict(np.load(os.path.join(work, f"parallel_rank{r}.npz"))) for r in range(2)]
    return dict(ranks=ranks, results=results,
                ce=dict(loss=float(ce_loss), acc=float(ce_acc), dw=np.asarray(ce_dw),
                        dx=np.asarray(ce_dx), focal=float(ce_focal)),
                gathered=gathered, step=_flatten(new_state),
                metrics={k: float(v) for k, v in metrics.items()}, params0=_flatten(state0))


def test_ranks_joined_one_gloo_group(world):
    for r in world["results"]:
        assert f"process {r.rank} of 2, backend gloo, device cpu" in r.stdout


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_amsoftmax_matches_jax(world, rank):
    """Loss, accuracy and the gradients of ``W`` (its two shards gathered)
    and of the embeddings, which ``copy_to`` makes whole on each rank; the
    focal loss of the sharded cross-entropy against JAX's dense one."""
    got, ref = world["ranks"][rank], world["ce"]
    assert tuple(got["ce_cols"]) == ((0, 5), (5, 10))[rank]
    np.testing.assert_allclose(float(got["ce_loss"]), ref["loss"], rtol=TOL)
    np.testing.assert_allclose(float(got["ce_focal"]), ref["focal"], rtol=TOL)
    # rows 0, 2, 3 (and 4, by its draw) right; row 1's tie goes to
    # column 2, not to its label 7
    assert float(got["ce_acc"]) == ref["acc"] == np.float32(4 / 6)
    np.testing.assert_allclose(got["ce_dw"], ref["dw"], rtol=0, atol=TOL * np.abs(ref["dw"]).max())
    np.testing.assert_allclose(got["ce_dx"], ref["dx"], rtol=0, atol=TOL * np.abs(ref["dx"]).max())


def test_embedding_allgather_matches_jax(world):
    for got in world["ranks"]:
        np.testing.assert_array_equal(got["gathered"], world["gathered"])


@pytest.mark.parametrize("tag", ["dp", "mp"], ids=["data_parallel", "w_split"])
@pytest.mark.parametrize("rank", [0, 1])
def test_train_step_matches_jax_sharded_step(world, tag, rank):
    """One Adam step (G=2, B=4 with ragged lengths, head dropout fed JAX's
    draws, annealing) on two processes: data-parallel (rows 0-1 and 2-3)
    and with ``W`` split (every row, columns 0-4 and 5-9), against JAX's
    step on its 4 x 2 mesh. Loss and accuracy at 1e-5 (relative), every
    leaf of the state after the step, parameters, Adam's moments, ``b2``'s
    running statistics and counts, within 1e-5 of max(1, its largest
    value): weight decay 1e-3 on parameters of size 0.1 sets the sign of
    the first Adam update where a gradient is rounding alone."""
    got = {k[len(tag) + 1:]: v for k, v in world["ranks"][rank].items() if k.startswith(tag + "/")}
    assert tuple(got["rows"]) == ({"dp": ((0, 2), (2, 4)), "mp": ((0, 4), (0, 4))}[tag][rank])
    m = world["metrics"]
    np.testing.assert_allclose(float(got["metrics/loss"]), m["loss"], rtol=TOL)
    np.testing.assert_allclose(float(got["metrics/accuracy"]), m["accuracy"], atol=TOL)
    ref = world["step"]
    assert set(ref) <= set(got)
    moved = 0
    for k, want in ref.items():
        want = np.asarray(want)
        assert got[k].shape == want.shape and got[k].dtype == want.dtype, k
        np.testing.assert_allclose(got[k], want, rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=k)
        moved += not np.array_equal(want, world["params0"].get(k, want))
    assert moved > 30 and int(got["step"]) == 1


@pytest.mark.parametrize("n, model_axis, data_axis", [
    (8, 2, -1), (8, 1, -1), (8, 8, -1), (8, 3, -1), (8, 2, 2), (6, 4, -1), (4, 2, 2),
])
def test_make_mesh_matches_jax(n, model_axis, data_axis):
    """Shapes, and the two errors word for word."""
    jcfg = JaxMeshConfig(model_axis=model_axis, data_axis=data_axis)
    pcfg = MeshConfig(model_axis=model_axis, data_axis=data_axis)
    try:
        ref = jmesh.make_mesh(jcfg, devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmesh.make_mesh(pcfg, world_size=n, rank=0)
        assert str(got.value) == str(e)
        return
    got = pmesh.make_mesh(pcfg, world_size=n, rank=0)
    assert dict(zip(got.axis_names, got.processes.shape)) == dict(ref.shape)


@pytest.mark.parametrize("model_axis, batch", [(1, 8), (2, 8), (4, 16)])
def test_host_batch_rows_match_jax(model_axis, batch):
    """JAX's single process owns every device of the virtual mesh, so it
    takes all rows; so does the port's mesh whose devices all belong to
    process 0. One device a process (the port's layout), each data index
    takes its slice, and a process whose devices sit on non-adjacent data
    indices is refused as JAX refuses it."""
    jm = jmesh.make_mesh(JaxMeshConfig(model_axis=model_axis))
    ref = jmesh.host_batch_rows(jm, batch)
    pm = pmesh.make_mesh(MeshConfig(model_axis=model_axis), world_size=8, processes=[0] * 8)
    assert pmesh.host_batch_rows(pm, batch) == ref == (0, batch)
    per = batch // (8 // model_axis)
    for r in range(8):
        m = pmesh.make_mesh(MeshConfig(model_axis=model_axis), world_size=8, rank=r)
        d = r // model_axis
        assert pmesh.host_batch_rows(m, batch) == (d * per, (d + 1) * per)
        assert m.processes[d, r % model_axis] == r and m.model_index == r % model_axis
    split = pmesh.make_mesh(MeshConfig(model_axis=1), world_size=4, processes=[0, 1, 0, 1])
    with pytest.raises(ValueError, match="owns non-contiguous batch rows"):
        pmesh.host_batch_rows(split, batch)
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        pmesh.host_batch_rows(m, batch + 1)

