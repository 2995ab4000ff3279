"""The port's train step and its parts against the JAX package on the CPU:
head dropout fed JAX's keep masks, train-mode BatchNorm ``b2`` (a
microbatch of one item included), the AM-Softmax head and its losses, the
chunked head, the optimizers, SpecAugment's masks, and whole steps
(``make_train_step``) in feature and wav mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu.config import DataConfig as JaxDataConfig
from doubleattentionspeakerverification_tpu.config import ExperimentConfig as JaxExperimentConfig
from doubleattentionspeakerverification_tpu.config import ModelConfig as JaxModelConfig
from doubleattentionspeakerverification_tpu.config import TrainConfig as JaxTrainConfig
from doubleattentionspeakerverification_tpu.dsp import augment as jaug
from doubleattentionspeakerverification_tpu.dsp.features import num_samples_for_frames
from doubleattentionspeakerverification_tpu.models import amsoftmax as jam
from doubleattentionspeakerverification_tpu.models.classifier import (
    ModelState,
    _batch_norm,
    init_speaker_classifier,
)
from doubleattentionspeakerverification_tpu.models.poolings import head_attention_pool
from doubleattentionspeakerverification_tpu.ops.chunked_amsoftmax import (
    chunked_amsoftmax_ce as jax_chunked,
)
from doubleattentionspeakerverification_tpu.training import optimizers as jopt
from doubleattentionspeakerverification_tpu.training import step as jstep
from doubleattentionspeakerverification_tpu.utils.checkpoint import _flatten
from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig, ModelConfig
from doubleattentionspeakerverification_tpu_torch.config import TrainConfig
from doubleattentionspeakerverification_tpu_torch.dsp import augment as paug
from doubleattentionspeakerverification_tpu_torch.dsp import features as pfeat
from doubleattentionspeakerverification_tpu_torch.models import amsoftmax as pam
from doubleattentionspeakerverification_tpu_torch.models.classifier import (
    BatchNorm,
    SpeakerClassifier,
)
from doubleattentionspeakerverification_tpu_torch.models.poolings import (
    HeadAttention,
    draw_head_keep,
)
from doubleattentionspeakerverification_tpu_torch.ops.chunked_amsoftmax import (
    chunked_amsoftmax_ce,
)
from doubleattentionspeakerverification_tpu_torch.training import optimizers as popt
from doubleattentionspeakerverification_tpu_torch.training import step as pstep
from doubleattentionspeakerverification_tpu_torch.training.step import (
    make_eval_loss_step,
    make_train_step,
)
from doubleattentionspeakerverification_tpu_torch.utils.weights import params_from_jax

TOL = 1e-5
G, B, T, HEADS = 2, 4, 80, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


# --------------------------------------------------------------- head dropout
def _all_dropped_key(b, heads, n_levels):
    """The first key whose (b, heads) draw drops every head of some row."""
    for seed in range(1000):
        key = jax.random.PRNGKey(seed)
        keep = np.asarray(jax.random.randint(key, (b, heads), 0, n_levels) > 0)
        if (~keep.any(-1)).any() and keep.any():
            return key, keep
    raise AssertionError("no key drops a whole row")


@pytest.mark.parametrize("mask_prob", [0.3, 0.5])
def test_head_dropout_matches_jax(mask_prob):
    b, heads, d_h = 8, 4, 6
    rng = np.random.default_rng(1)
    ctx = rng.standard_normal((b, heads, d_h)).astype(np.float32)
    att = rng.standard_normal((d_h, 1)).astype(np.float32)
    cfg = JaxModelConfig(heads_number=heads, mask_prob=mask_prob)
    key, keep = _all_dropped_key(b, heads, int(1 / mask_prob))
    ref = np.asarray(head_attention_pool({"att": att}, ctx, cfg, train=True, rng=key)[0])
    layer = HeadAttention(d_h, mask_prob)
    with torch.no_grad():
        layer.att.copy_(torch.from_numpy(att))
        got = layer(torch.from_numpy(ctx), torch.from_numpy(keep)).numpy()
        np.testing.assert_allclose(got, ref, atol=TOL)
        # the all-dropped row keeps every head: it equals the eval-mode output
        row = int(np.flatnonzero(~keep.any(-1))[0])
        evaluated = layer.eval()(torch.from_numpy(ctx)).numpy()
        np.testing.assert_allclose(got[row], evaluated[row], atol=1e-7)
        # mask_prob <= 0 and eval() turn the dropout off; train() without a
        # keep mask refuses
        off = HeadAttention(d_h, 0.0)
        off.att.copy_(layer.att)
        np.testing.assert_allclose(off(torch.from_numpy(ctx)).numpy(), evaluated, atol=0)
        with pytest.raises(ValueError, match="keep mask"):
            layer.train()(torch.from_numpy(ctx))
    draws = draw_head_keep(4000, heads, mask_prob, torch.Generator().manual_seed(0))
    assert abs(float(draws.float().mean()) - (1 - 1 / int(1 / mask_prob))) < 0.02


# ----------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("n", [1, 5])
def test_train_batchnorm_matches_jax(n):
    """Train-mode ``b2``: output, gradient and running statistics against
    JAX ``_batch_norm``, also for a microbatch of one item (output = bias)."""
    emb = 6
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, emb)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, emb).astype(np.float32),
         "bias": rng.standard_normal(emb).astype(np.float32)}
    state = ModelState(rng.standard_normal(emb).astype(np.float32),
                       rng.uniform(0.5, 2, emb).astype(np.float32), np.int32(3))
    g = rng.standard_normal((n, emb)).astype(np.float32)
    cfg = JaxModelConfig()

    def f(xx):
        y, new = _batch_norm(xx, p, state, cfg, train=True)
        return (y * g).sum(), (y, new)

    (_, (ref, new)), ref_dx = jax.value_and_grad(f, has_aux=True)(x)
    bn = BatchNorm(emb, eps=cfg.bn_eps, momentum=cfg.bn_momentum)
    with torch.no_grad():
        bn.weight.copy_(_t(p["scale"]))
        bn.bias.copy_(_t(p["bias"]))
        bn.running_mean.copy_(_t(state.bn_mean))
        bn.running_var.copy_(_t(state.bn_var))
        bn.num_batches_tracked.fill_(3)
    xt = _t(x, requires_grad=True)
    y = bn.train()(xt)
    (y * _t(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), atol=TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new.bn_mean), atol=TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new.bn_var), atol=TOL)
    assert int(bn.num_batches_tracked) == int(new.bn_count) == 4
    if n == 1:
        np.testing.assert_allclose(y.detach().numpy()[0], p["bias"], atol=TOL)


# ---------------------------------------------------------------- AM-Softmax
@pytest.mark.parametrize("annealing", [False, True])
def test_amsoftmax_and_losses_match_jax(annealing):
    b, emb, n_cls, step = 6, 12, 9, 2500
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, emb)).astype(np.float32)
    w = rng.standard_normal((emb, n_cls)).astype(np.float32)
    y = rng.integers(0, n_cls, b).astype(np.int32)
    jcfg = JaxModelConfig(annealing=annealing)
    cfg = ModelConfig(annealing=annealing)

    def jax_losses(xx, ww):
        costh, logits = jam.amsoftmax_apply({"W": ww}, xx, y, step, jcfg)
        return costh, logits, jam.cross_entropy(logits, y), jam.focal_cross_entropy(logits, y, 2.0)

    @jax.jit
    def jax_all(xx, ww):
        grads = [jax.grad(lambda a, c: jax_losses(a, c)[k], argnums=(0, 1))(xx, ww) for k in (2, 3)]
        return jax_losses(xx, ww), grads

    ref, ref_grads = jax_all(x, w)
    for k, loss_fn in ((2, pam.cross_entropy), (3, pam.focal_cross_entropy)):
        xt, wt = _t(x, requires_grad=True), _t(w, requires_grad=True)
        costh, logits = pam.amsoftmax_logits(wt, xt, _t(y), step, cfg)
        loss = loss_fn(logits, _t(y))
        loss.backward()
        np.testing.assert_allclose(costh.detach().numpy(), np.asarray(ref[0]), atol=TOL)
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref[1]), atol=TOL * 30)
        np.testing.assert_allclose(float(loss), float(ref[k]), rtol=TOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grads[k - 2][0]), atol=TOL)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ref_grads[k - 2][1]), atol=TOL)
    np.testing.assert_allclose(float(pam.annealed_factor(step, cfg)),
                               float(jam.annealed_factor(step, jcfg)), rtol=1e-6)


@pytest.mark.parametrize("n_cls, chunk, annealing", [(23, 5, False), (20, 5, True),
                                                     (7, 16, False)])
def test_chunked_head_matches_dense_and_jax(n_cls, chunk, annealing):
    """Loss, accuracy and gradients of the chunked head against the dense
    head and JAX's ``chunked_amsoftmax_ce``; 23 classes in chunks of 5 clamp
    the last chunk."""
    b, emb, step = 8, 10, 100
    rng = np.random.default_rng(n_cls + chunk)
    x = rng.standard_normal((b, emb)).astype(np.float32)
    w = rng.standard_normal((emb, n_cls)).astype(np.float32)
    y = rng.integers(0, n_cls, b).astype(np.int32)
    # make some rows right, so the accuracy is not 0
    w[:, y[:3]] = x[:3].T
    jcfg = JaxModelConfig(annealing=annealing)
    cfg = ModelConfig(annealing=annealing)
    (ref_loss, ref_acc), ref_g = jax.jit(jax.value_and_grad(
        lambda a, c: jax_chunked({"W": c}, a, y, step, jcfg, chunk=chunk), argnums=(0, 1),
        has_aux=True))(x, w)

    xt, wt = _t(x, requires_grad=True), _t(w, requires_grad=True)
    loss, acc = chunked_amsoftmax_ce(wt, xt, _t(y), step, cfg, chunk=chunk)
    loss.backward()
    xd, wd = _t(x, requires_grad=True), _t(w, requires_grad=True)
    costh, logits = pam.amsoftmax_logits(wd, xd, _t(y), step, cfg)
    dense = pam.cross_entropy(logits, _t(y))
    dense.backward()
    dense_acc = float((costh.argmax(-1) == _t(y)).float().mean())
    assert float(acc) == dense_acc == float(ref_acc) > 0
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=TOL)
    np.testing.assert_allclose(float(loss), float(dense), rtol=TOL)
    for got, dense_g, ref in ((xt.grad, xd.grad, ref_g[0]), (wt.grad, wd.grad, ref_g[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
        np.testing.assert_allclose(got.numpy(), dense_g.numpy(), atol=TOL)


# ----------------------------------------------------------------- optimizers
@pytest.mark.parametrize("name", ["Adam", "SGD", "RMSprop"])
def test_optimizers_match_optax(name):
    """Three steps fed the same gradients, then ``with_lr``, against the JAX
    package's optax chain, within 1e-6 of each tensor's largest value."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(4)]
    jcfg = JaxTrainConfig(optimizer=name, learning_rate=0.01, weight_decay=0.001)
    opt = jopt.make_optimizer(jcfg)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    st = opt.init(params)
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    topt = popt.make_optimizer(TrainConfig(optimizer=name, learning_rate=0.01,
                                           weight_decay=0.001), tparams.values())
    for i, g in enumerate(grads):
        if i == 3:
            st = jopt.with_lr(st, 0.005)
            popt.with_lr(topt, 0.005)
            assert popt.get_lr(topt) == pytest.approx(jopt.get_lr(st)) == pytest.approx(0.005)
        upd, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        for k, p in tparams.items():
            p.grad = _t(g[k])
        topt.step()
        for k, p in tparams.items():
            ref = np.asarray(params[k])
            np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max())
    with pytest.raises(ValueError, match="unknown optimizer"):
        popt.make_optimizer(TrainConfig(optimizer="Lion"), tparams.values())


# ---------------------------------------------------------------- SpecAugment
def test_spec_augment_masks_match_jax():
    """The port's masks from JAX's own widths and starts equal JAX's
    ``spec_augment``; the port's draws stay inside their axes."""
    b, t, f = 5, 60, 20
    feats = np.random.default_rng(4).standard_normal((b, t, f)).astype(np.float32)
    def jax_spans(key, n, length, width):
        kw, ks = jax.random.split(key)
        widths = jax.random.randint(kw, (b, n), 0, width + 1)
        starts = (jax.random.uniform(ks, (b, n)) * (length - widths + 1).astype(jnp.float32)
                  ).astype(jnp.int32)
        return widths, starts

    @jax.jit
    def reference(x, rng):
        kt, kf = jax.random.split(rng)
        return (jaug.spec_augment(x, rng, 2, 30, 2, 10), jaug._axis_masks(kt, b, 2, t, 30),
                jax_spans(kt, 2, t, 30), jax_spans(kf, 2, f, 10))

    ref, ref_time_keep, time, freq = reference(feats, jax.random.PRNGKey(11))
    time, freq = ([_t(a, dtype=torch.int64) for a in spans] for spans in (time, freq))
    np.testing.assert_array_equal(paug.axis_keep(time, t).numpy(), np.asarray(ref_time_keep))
    got = paug.apply_masks(torch.from_numpy(feats), time, freq).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got == 0).any()

    gen = torch.Generator().manual_seed(0)
    widths, starts = paug.draw_spans(gen, 400, 2, t, 30)
    assert 0 <= int(widths.min()) and int(widths.max()) <= 30 and int(widths.max()) > 20
    assert int(starts.min()) >= 0 and int((starts + widths).max()) <= t
    out = paug.spec_augment(torch.from_numpy(feats), gen)
    assert out.shape == feats.shape and bool(((out == 0) | (out == torch.from_numpy(feats))).all())


# ------------------------------------------------------------ the whole step
def grad_scales(grads):
    """Each gradient's largest magnitude, the scale its tolerance is taken
    from. ``fc2.bias`` takes ``fc2.weight``'s: ``b2`` normalizes by the batch
    statistics in train mode, so it removes any constant added to a feature
    before it, and the gradient of the bias feeding it is zero wherever the
    ReLU between them passes every item of the batch. What is left there is
    rounding in a sum that cancels, no scale of its own."""
    scales = {k: float(g.abs().max()) for k, g in grads.items()}
    scales["fc2.bias"] = scales["fc2.weight"]
    return scales


def _configs(front_end="VGG4L", **train_kw):
    model = dict(front_end=front_end, kernel_size=16, heads_number=HEADS, embedding_size=24,
                 num_spkrs=10, mask_prob=0.3, annealing=train_kw.pop("annealing", False))
    train = dict(optimizer="SGD", learning_rate=1e3, weight_decay=0.0, batch_size=B,
                 gradient_accumulation=G, **train_kw)
    jcfg = JaxExperimentConfig(
        model=JaxModelConfig(use_pallas_pooling=False, use_pallas_dsp=False, **model),
        train=JaxTrainConfig(**train), data=JaxDataConfig(source="features"))
    return jcfg, ExperimentConfig(model=ModelConfig(**model), train=TrainConfig(**train))


def _jax_state(jcfg):
    """The JAX model's structure filled from numpy (fan-in-scaled weights,
    small biases, non-trivial ``b2`` running statistics)."""
    params, ms = jax.eval_shape(lambda k: init_speaker_classifier(k, jcfg.model),
                                jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)

    def fill(s):
        std = 0.1 if len(s.shape) < 2 else 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return jnp.asarray((rng.standard_normal(s.shape) * std).astype(np.float32))

    emb = jcfg.model.embedding_size
    return jax.tree.map(fill, params), ModelState(jnp.full((emb,), 0.1), jnp.full((emb,), 2.0),
                                                  jnp.zeros((), jnp.int32))


def _port_model(cfg, params, ms):
    model = SpeakerClassifier(cfg.model)
    state = params_from_jax(_flatten({"params": params, "model_state": ms}))
    model.load_state_dict({k: state[k] for k in model.state_dict()})
    return model


def _batch(wav: bool):
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 10, (G, B)).astype(np.int32)
    if wav:
        n = num_samples_for_frames(T, JaxExperimentConfig().features)
        waves = rng.integers(-3000, 3000, (G, B, n)).astype(np.int16)
        lengths = np.array([[n, n - 4000, n, 3000], [n - 160, n, 5000, n]], np.int32)
        return {"waves": waves, "lengths": lengths, "labels": labels}
    inputs = rng.standard_normal((G, B, T, 80)).astype(np.float32)
    lengths = np.array([[T, 61, T, 33], [T, T, 47, 70]], np.int32)
    return {"inputs": inputs, "lengths": lengths, "labels": labels}


@pytest.mark.parametrize("wav", [False, True], ids=["features", "wav_int16_mean"])
def test_train_step_matches_jax(wav, monkeypatch):
    """One step at G=2 with ragged lengths and head dropout fed JAX's
    ``fold_in(rng, i)`` draws. SGD at lr 1e3 without weight decay, so JAX's
    summed gradient is (p0 - p1) / lr to float32 rounding of p1 over lr.
    Loss and accuracy at 1e-5, every gradient within 1e-4 of its tensor's
    largest, ``b2``'s running statistics at 1e-5, parameters after the step
    within lr * 1e-4 of the gradient's largest.

    The wav case (VGG3L) ships int16 PCM, means the gradients over G and
    anneals. The first conv's gradient follows the features' last digits:
    the two packages' float32 log-mels agree only to the log-mel tolerance,
    as two XLA compilations of JAX's own do, and differences that small
    move that gradient by far more than 1e-4 of its largest value (ReLU
    decisions near zero in a sum that largely cancels). So the step runs
    once as it is, its features held to JAX's step's at the log-mel
    tolerance (2e-4) and its loss and accuracy to JAX's, and once on JAX's
    step's features, where everything after them is held to the tolerances
    above."""
    extra = dict(front_end="VGG3L", grad_accum_mean=True, annealing=True) if wav else {}
    jcfg, cfg = _configs(**extra)
    params, ms = _jax_state(jcfg)
    batch = _batch(wav)
    rng = jax.random.PRNGKey(7)
    jstate = jstep.init_train_state(params, ms, jcfg)
    new_state, metrics = jstep.make_train_step(jcfg, donate=False)(jstate, batch, rng)
    n_levels = int(1 / cfg.model.mask_prob)
    keep = [_t(jax.random.randint(jax.random.fold_in(rng, i), (B, HEADS), 0, n_levels) > 0)
            for i in range(G)]

    def run_step():
        model = _port_model(cfg, params, ms)
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        opt = popt.make_optimizer(cfg.train, model.parameters())
        step = make_train_step(cfg, model, opt, device="cpu")
        out = step(batch, keep=keep)
        assert step.step == 1
        np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), atol=TOL, rtol=0)
        np.testing.assert_allclose(float(out["accuracy"]), float(metrics["accuracy"]), atol=TOL)
        return model, p0

    if wav:
        feats, lengths = pstep.prepare_inputs(batch, cfg, torch.device("cpu"))
        ref_feats, ref_lengths = (_t(a) for a in jax.jit(
            lambda bb: jstep._prepare_inputs(bb, jcfg))(batch))
        torch.testing.assert_close(feats, ref_feats, rtol=0, atol=2e-4)
        assert torch.equal(lengths, ref_lengths.to(torch.int64))
        run_step()
        monkeypatch.setattr(pstep, "prepare_inputs", lambda *_: (ref_feats, lengths))
    model, p0 = run_step()

    lr = cfg.train.learning_rate
    new_flat = params_from_jax(_flatten({"params": new_state.params,
                                         "model_state": new_state.model_state}))
    ref_grads = {name: (p0[name] - new_flat[name]) / lr for name in p0}
    scales = grad_scales(ref_grads)
    for name, p in model.named_parameters():
        ref_g, scale = ref_grads[name], scales[name]
        assert scale > 0, name
        torch.testing.assert_close(p.grad, ref_g, rtol=0, atol=1e-4 * scale, msg=name)
        torch.testing.assert_close(p.detach(), new_flat[name], rtol=0, atol=lr * 1e-4 * scale,
                                   msg=name)
    for name in ("b2.running_mean", "b2.running_var"):
        torch.testing.assert_close(model.state_dict()[name], new_flat[name], rtol=0, atol=TOL)
    assert int(model.b2.num_batches_tracked) == int(new_state.model_state.bn_count) == G

    if not wav:
        # the eval-mode loss of the model before the step against JAX's eval step
        ref = jstep.make_eval_loss_step(jcfg)(params, ms, batch)
        got = make_eval_loss_step(cfg, _port_model(cfg, params, ms), device="cpu")(batch)
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=TOL)
        assert float(got["accuracy"]) == pytest.approx(float(ref["accuracy"]))


def _full_batch():
    """JAX ``tests/test_training.py``'s full-length batch: G=2 x B=4 x 80
    frames, every window full."""
    rng = np.random.default_rng(0)
    return {"inputs": rng.standard_normal((G, B, T, 80)).astype(np.float32),
            "lengths": np.full((G, B), T, np.int32),
            "labels": np.tile(np.arange(B, dtype=np.int32), (G, 1))}


def _jax_keep(key, cfg):
    n_levels = int(1 / cfg.model.mask_prob)
    return [_t(jax.random.randint(jax.random.fold_in(key, i), (B, HEADS), 0, n_levels) > 0)
            for i in range(G)]


def test_remat_vgg_step_matches_plain_step_and_jax(monkeypatch):
    """``remat_vgg`` runs each VGG block under ``torch.utils.checkpoint`` in
    the train step (one call a block a microbatch, none without grad) and
    changes no number: the step with it equals the step without it (loss and
    every gradient at 1e-6), and JAX's remat step from the same weights to
    the whole-step tolerances above. The batch is JAX
    ``tests/test_training.py``'s remat case: G=2 x B=4 x 80 frames, full
    length."""
    from doubleattentionspeakerverification_tpu_torch.models import vgg as pvgg

    jcfg, cfg = _configs()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, remat_vgg=True))
    params, ms = _jax_state(jcfg)
    batch = _full_batch()
    key = jax.random.PRNGKey(7)
    new_state, metrics = jstep.make_train_step(jcfg, donate=False)(
        jstep.init_train_state(params, ms, jcfg), batch, key)
    keep = _jax_keep(key, cfg)
    calls = []
    real_checkpoint = pvgg.checkpoint
    monkeypatch.setattr(pvgg, "checkpoint", lambda *a, **kw: calls.append(1) or
                        real_checkpoint(*a, **kw))

    runs = {}
    for remat in (False, True):
        calls.clear()
        c = cfg.replace(model=dataclasses.replace(cfg.model, remat_vgg=remat))
        model = _port_model(c, params, ms)
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        step = make_train_step(c, model, popt.make_optimizer(c.train, model.parameters()),
                               device="cpu")
        out = step(batch, keep=keep)
        assert len(calls) == (G * model.vgg.n_blocks if remat else 0)
        with torch.no_grad():
            model.eval()(torch.from_numpy(batch["inputs"][0]))
        assert len(calls) == (G * model.vgg.n_blocks if remat else 0)
        runs[remat] = (float(out["loss"]), {n: p.grad.clone() for n, p in model.named_parameters()},
                       p0, model)
    (loss0, grads0, _, _), (loss1, grads1, p0, model) = runs[False], runs[True]
    assert abs(loss1 - loss0) <= 1e-6
    for name in grads0:
        torch.testing.assert_close(grads1[name], grads0[name], rtol=0, atol=1e-6, msg=name)

    np.testing.assert_allclose(loss1, float(metrics["loss"]), atol=TOL, rtol=0)
    lr = cfg.train.learning_rate
    new_flat = params_from_jax(_flatten({"params": new_state.params,
                                         "model_state": new_state.model_state}))
    ref_grads = {name: (p0[name] - new_flat[name]) / lr for name in p0}
    scales = grad_scales(ref_grads)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, ref_grads[name], rtol=0, atol=1e-4 * scales[name],
                                   msg=name)


# bfloat16 rounds to 8 significant bits: two results that differ by their
# rounding alone differ by at most 2**-8 of their size
TOL_BF16 = 2.0 ** -8
_JAX_BF16 = {}


def _bench_configs():
    """``bench.py``'s training configuration at the tiny width: bfloat16
    compute and ``assume_full_lengths``."""
    jcfg, cfg = _configs(assume_full_lengths=True)
    return (jcfg.replace(model=dataclasses.replace(jcfg.model, compute_dtype="bfloat16")),
            cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16")))


def _jax_bf16_step():
    """JAX's compiled bfloat16 full-length step on :func:`_full_batch`, once a
    module: (params, model state, key, state after the step, metrics)."""
    if not _JAX_BF16:
        jcfg, _ = _bench_configs()
        params, ms = _jax_state(jcfg)
        key = jax.random.PRNGKey(7)
        new_state, metrics = jstep.make_train_step(jcfg, donate=False)(
            jstep.init_train_state(params, ms, jcfg), _full_batch(), key)
        _JAX_BF16.update(params=params, ms=ms, key=key, new_state=new_state, metrics=metrics)
    return _JAX_BF16


def _conv_cotangents(monkeypatch):
    """Every VGG conv's output cotangent (NCHW, bfloat16) in the backwards
    run after this call, by the conv's name, one a microbatch."""
    from doubleattentionspeakerverification_tpu_torch.models import vgg as pvgg

    cots, conv = {}, pvgg.VGG._conv

    def hooked(vgg, h, layer):
        out = conv(vgg, h, layer)
        name = next(n for n, m in vgg.named_children() if m is layer)
        out.register_hook(lambda g: cots.setdefault(name, []).append(g.detach().clone()))
        return out

    monkeypatch.setattr(pvgg.VGG, "_conv", hooked)
    return cots


def test_bf16_full_length_step_matches_jax(monkeypatch):
    """``bench.py``'s configuration (bfloat16, ``assume_full_lengths``), one
    SGD step at G=2 on full windows with head dropout fed JAX's
    ``fold_in`` draws, against JAX's compiled step from the same weights.

    The encoder's forward is JAX's bit for bit
    (``tests/test_torch_model.py::test_vgg_matches_jax_bit_for_bit``) and
    its output is float32, so the loss and accuracy (1e-5), the float32
    head's gradients and parameters after the step (1e-4 of the gradient's
    largest, as the float32 step) and ``b2``'s statistics (1e-5) hold at the
    float32 step's tolerances. The convs' backward runs in bfloat16: their
    weight gradients, and the weights after the step, within 2**-8 relative
    L2 of JAX's (one bfloat16 rounding). Their bias gradients are the sum of
    each conv's bfloat16 output cotangent over every position; XLA on the CPU
    accumulates that sum in bfloat16, torch in float32 rounded once, which
    moves a sum that largely cancels by up to a tenth of its size. So the
    port's cotangents are held to JAX's through the sum: reduced as XLA
    reduces them (a jitted ``lax.reduce`` in bfloat16 over NHWC) they give
    JAX's bias gradients at 1e-4 of the largest, and the port's own bias
    gradient is their float64 sum within 2**-8 of each microbatch's sum (one
    bfloat16 rounding of each)."""
    ref = _jax_bf16_step()
    jcfg, cfg = _bench_configs()
    batch, lr = _full_batch(), cfg.train.learning_rate
    model = _port_model(cfg, ref["params"], ref["ms"])
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    cots = _conv_cotangents(monkeypatch)
    step = make_train_step(cfg, model, popt.make_optimizer(cfg.train, model.parameters()),
                           device="cpu")
    out = step(batch, keep=_jax_keep(ref["key"], cfg))
    np.testing.assert_allclose(float(out["loss"]), float(ref["metrics"]["loss"]), atol=TOL, rtol=0)
    np.testing.assert_allclose(float(out["accuracy"]), float(ref["metrics"]["accuracy"]), atol=TOL)

    new = params_from_jax(_flatten({"params": ref["new_state"].params,
                                    "model_state": ref["new_state"].model_state}))
    ref_grads = {name: (p0[name] - new[name]) / lr for name in p0}
    scales = grad_scales(ref_grads)
    reduce_bf16 = jax.jit(lambda a: jax.lax.reduce(a, jnp.bfloat16(0), jax.lax.add, (0, 1, 2)))
    for name, p in model.named_parameters():
        g, ref_g = p.grad, ref_grads[name]
        if not name.startswith("vgg."):
            torch.testing.assert_close(g, ref_g, rtol=0, atol=1e-4 * scales[name], msg=name)
            torch.testing.assert_close(p.detach(), new[name], rtol=0,
                                       atol=lr * 1e-4 * scales[name], msg=name)
        elif name.endswith(".weight"):
            assert float((g - ref_g).norm()) <= TOL_BF16 * float(ref_g.norm()), name
            assert float((p.detach() - new[name]).norm()) <= TOL_BF16 * float(
                (new[name] - p0[name]).norm()), name
        else:
            conv = cots[name.split(".")[1]]
            assert len(conv) == G and conv[0].dtype == torch.bfloat16
            xla = sum(_t(reduce_bf16(jnp.asarray(c.permute(0, 2, 3, 1).float().numpy(),
                                                 jnp.bfloat16)).astype(jnp.float32))
                      for c in conv)
            torch.testing.assert_close(xla, ref_g, rtol=0, atol=1e-4 * scales[name], msg=name)
            sums = [c.double().sum((0, 2, 3)) for c in conv]     # one a microbatch
            bound = TOL_BF16 * sum(m.abs() for m in sums)
            assert bool(((g.double() - sum(sums)).abs() <= bound).all()), name
    for name in ("b2.running_mean", "b2.running_var"):
        torch.testing.assert_close(model.state_dict()[name], new[name], rtol=0, atol=TOL)


def test_full_length_step_equals_masked_step():
    """``assume_full_lengths`` drops the length masks (``prepare_inputs``
    gives no lengths: B1 pools over all T and ``mask_time`` is skipped) and
    changes nothing on full windows: the loss within 1e-6 relative and every
    parameter after the step within 1e-6 of the masked step's, as JAX
    ``tests/test_training.py:340-368``."""
    jcfg, cfg = _configs()
    params, ms = _jax_state(jcfg)
    batch, runs = _full_batch(), {}
    keep = _jax_keep(jax.random.PRNGKey(7), cfg)
    for full in (False, True):
        c = cfg.replace(train=dataclasses.replace(cfg.train, assume_full_lengths=full))
        feats, lengths = pstep.prepare_inputs(batch, c, torch.device("cpu"))
        assert (lengths is None) == full
        model = _port_model(c, params, ms)
        step = make_train_step(c, model, popt.make_optimizer(c.train, model.parameters()),
                               device="cpu")
        runs[full] = float(step(batch, keep=keep)["loss"]), dict(model.named_parameters())
    (loss0, p0), (loss1, p1) = runs[False], runs[True]
    assert loss1 == pytest.approx(loss0, rel=1e-6)
    for name in p0:
        torch.testing.assert_close(p1[name], p0[name], rtol=0, atol=1e-6, msg=name)


def test_bf16_drift_tool():
    """``tools/bf16_drift.py`` at a tiny width: the bfloat16 and the
    emulated steps' losses within one bfloat16 step (2^-8) of the float32
    step's, a finite distance for every gradient, and VGG's own conv back
    once the emulation closes."""
    from doubleattentionspeakerverification_tpu_torch.models import vgg as pvgg
    from doubleattentionspeakerverification_tpu_torch.tools import bf16_drift

    conv = pvgg.VGG._conv
    out = bf16_drift.drift(kernel_size=16, heads=HEADS, batch=B, frames=T, device="cpu")
    assert pvgg.VGG._conv is conv
    loss = out["loss"]
    for key in ("bfloat16", "emulated"):
        assert abs(loss[key] - loss["float32"]) <= TOL_BF16 * abs(loss["float32"]), key
    names = {n for n, _ in SpeakerClassifier(ModelConfig(kernel_size=16, heads_number=HEADS,
                                                         embedding_size=64, num_spkrs=200))
             .named_parameters()}
    assert set(out["distance"]) == names
    assert all(np.isfinite(d).all() and min(d) > 0 for d in out["distance"].values())
    assert out["max_ratio"] > 0 and out["max_ratio_at"] in names


def test_train_step_draws_and_refusals():
    """Without keep masks the step draws them (and SpecAugment's spans) from
    its generator: the same seed gives the same step. Focal with the chunked
    head and an unknown criterion are refused."""
    jcfg, cfg = _configs(specaugment=True)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, learning_rate=0.1))
    params, ms = _jax_state(jcfg)
    batch = _batch(False)
    results = []
    for _ in range(2):
        model = _port_model(cfg, params, ms)
        opt = popt.make_optimizer(cfg.train, model.parameters())
        step = make_train_step(cfg, model, opt, device="cpu")
        results.append((step(batch)["loss"], model.fc1.weight.detach().clone()))
    assert torch.isfinite(results[0][0])
    assert torch.equal(results[0][0], results[1][0]) and torch.equal(results[0][1], results[1][1])
    model = _port_model(cfg, params, ms)
    opt = popt.make_optimizer(cfg.train, model.parameters())
    for bad in (dict(criterion="focal", chunk=8), dict(criterion="hinge", chunk=0)):
        bad_cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, criterion=bad["criterion"]),
            model=dataclasses.replace(cfg.model, classifier_chunk=bad["chunk"]))
        with pytest.raises(ValueError, match="criterion"):
            make_train_step(bad_cfg, model, opt, device="cpu")


def test_frame_helpers_match_jax():
    from doubleattentionspeakerverification_tpu.dsp.features import frames_for_samples

    fcfg = JaxExperimentConfig().features
    lengths = np.array([0, 100, 511, 512, 513, 672, 16000, 56000], np.int32)
    np.testing.assert_array_equal(
        pfeat.frames_for_samples(torch.from_numpy(lengths), ExperimentConfig().features).numpy(),
        np.asarray(frames_for_samples(lengths, fcfg)))
    for frames in (1, 60, 350):
        n = pfeat.num_samples_for_frames(frames, ExperimentConfig().features)
        assert n == num_samples_for_frames(frames, fcfg)
        assert pfeat.num_frames(n, ExperimentConfig().features) == frames
