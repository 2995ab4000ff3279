"""The port's int8 encoder (``models/quantized.py``) against the JAX
package's, on tiny models (k=16, 4 heads, T <= 60) with the same weights
carried over by ``params_from_jax``.

Tolerances. JAX functions called op by op (not jitted) do the same float32
operations as the port, so the encoders' outputs, the quantized weights and
the folded scales are held equal. Jitted, XLA on the CPU contracts each
dynamic epilogue ``y * scale + b`` into an FMA (one float32 ulp apart from a
separate multiply and add in about a quarter of the elements), so the
calibration scales of ``calibrate_int8_scales`` (jitted) are held within
1e-6 relative (an ulp apart at one conv can move the next conv's amax by a
few ulps), and embeddings through jitted JAX paths within 1e-4. With
``compute_dtype="bfloat16"`` the port's dynamic convs round once (kernel B3's
epilogue) where JAX rounds the product, the scale and the sum in bf16: a
conv's outputs are held within 2^-6 of their magnitude.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu.api import SpeakerEmbeddingModel as JaxModel
from doubleattentionspeakerverification_tpu.config import ExperimentConfig as JaxExperimentConfig
from doubleattentionspeakerverification_tpu.config import ModelConfig as JaxModelConfig
from doubleattentionspeakerverification_tpu.models import quantized as jq
from doubleattentionspeakerverification_tpu.models.classifier import init_speaker_classifier
from doubleattentionspeakerverification_tpu.utils.checkpoint import _flatten
from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel
from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig
from doubleattentionspeakerverification_tpu_torch.models import quantized as pq


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_model(seed, **model_kw):
    jcfg = JaxExperimentConfig(model=JaxModelConfig(
        kernel_size=16, heads_number=4, embedding_size=24, num_spkrs=4,
        use_pallas_pooling=False, **model_kw))
    params, state = jax.eval_shape(lambda k: init_speaker_classifier(k, jcfg.model),
                                   jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(s):
        std = 0.1 if len(s.shape) < 2 else 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    params = jax.tree.map(fill, params)
    emb = jcfg.model.embedding_size
    state = state._replace(bn_mean=rng.standard_normal(emb).astype(np.float32) * 0.1,
                           bn_var=rng.uniform(0.5, 2.0, emb).astype(np.float32),
                           bn_count=np.zeros((), np.int32))
    flat = _flatten({"params": params, "model_state": state})
    cfg = ExperimentConfig.from_dict(jcfg.to_dict())
    return params, state, jcfg, cfg, flat


LENS = [45, 30, 17]   # one batch shape throughout: JAX compiles each op once per shape


@pytest.fixture(scope="module")
def tiny():
    """A tiny model in both packages, one padded batch, and JAX's static
    scales and folded constants for it (calibration is jitted in JAX, so it
    runs once)."""
    params, state, jcfg, cfg, flat = _jax_model(seed=2)
    port = SpeakerEmbeddingModel.from_jax(flat, cfg, device="cpu")
    jqv = jq.quantize_vgg(params["vgg"])
    pqv = pq.quantize_vgg(port.model.vgg)
    x, ln = _batch(LENS, seed=3)
    scales = jq.calibrate_int8_scales(jqv, x, ln, jcfg.model)
    return dict(params=params, state=state, jcfg=jcfg, cfg=cfg, flat=flat, port=port,
                jqv=jqv, pqv=pqv, x=x, ln=ln, scales=scales,
                jf=jq.fold_static_scales(jqv, scales, jcfg.model),
                pf=pq.fold_static_scales(pqv, scales, cfg.model))


def _batch(lens, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lens), max(lens), 80), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = rng.standard_normal((n, 80))
    return x, np.asarray(lens, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_quantize_vgg_equal_and_fingerprint(tiny):
    assert sorted(tiny["jqv"]) == sorted(tiny["pqv"])
    for name, jp in tiny["jqv"].items():
        pp = tiny["pqv"][name]
        np.testing.assert_array_equal(pp["w_q"].numpy(), np.asarray(jp["w_q"]))   # HWIO
        np.testing.assert_array_equal(pp["w_s"].numpy(), np.asarray(jp["w_s"]))
        np.testing.assert_array_equal(pp["b"].numpy(), np.asarray(jp["b"]))
    assert pq._weights_fingerprint(tiny["pqv"]) == jq._weights_fingerprint(tiny["jqv"])


def test_dynamic_and_static_vgg_match_jax(tiny):
    x, ln = tiny["x"], tiny["ln"]
    tx, tl = _t(x, ln)
    jcfg, cfg = tiny["jcfg"].model, tiny["cfg"].model
    with torch.no_grad():
        got, got_len = pq.quantized_vgg_apply(tiny["pqv"], tx, tl, cfg)
    want, want_len = jq.quantized_vgg_apply(tiny["jqv"], x, ln, jcfg)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    scales, jf, pf = tiny["scales"], tiny["jf"], tiny["pf"]
    for name in jf:      # the folded constants: equal in float32
        np.testing.assert_array_equal(pf[name]["mult"].numpy(), np.asarray(jf[name]["mult"]))
        np.testing.assert_array_equal(pf[name]["bias"].numpy(), np.asarray(jf[name]["bias"]))
    with torch.no_grad():
        got_s, _ = pq.quantized_vgg_apply_static(pf, scales[0], tx, tl, cfg)
    want_s, _ = jq.quantized_vgg_apply_static(jf, scales[0], x, ln, jcfg)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_bf16_dynamic_conv_close_to_jax(tiny):
    """One dynamic conv after the first (B3's path) in bfloat16: the port
    rounds ``acc * (sx * w_s) + b`` once, JAX rounds the product, the scale
    and the sum in bf16; each element is held within 2^-6 of
    |JAX's pre-activation| + 2|b|."""
    rng = np.random.default_rng(6)
    h = np.maximum(rng.standard_normal((2, 20, 40, 2)), 0).astype(np.float32)
    jp = tiny["jqv"]["conv12"]
    pre = np.asarray(jq._conv3x3_int8(jnp.asarray(h, jnp.bfloat16), jp, jnp.bfloat16), np.float32)
    got = pq._conv3x3_int8(torch.from_numpy(h).to(torch.bfloat16), tiny["pqv"]["conv12"],
                           "bfloat16")
    assert got.dtype == torch.bfloat16
    bound = 2.0 ** -6 * (np.abs(pre) + 2 * np.abs(np.asarray(jp["b"])))
    assert np.all(np.abs(got.float().numpy() - np.maximum(pre, 0)) <= bound)


def test_calibration_scales_match_jax(tiny):
    x, ln = tiny["x"], tiny["ln"]
    tx, tl = _t(x, ln)
    got = pq.calibrate_int8_scales(tiny["pqv"], tx, tl, tiny["cfg"].model)
    # op by op, JAX computes the same float32 amaxes: equal scales
    amax = np.asarray(jq.collect_int8_amaxes(tiny["jqv"], x, ln, tiny["jcfg"].model))
    assert got == [max(float(a), 1e-12) / 127.0 for a in amax]
    # jitted (FMA epilogues): within 1e-6 relative
    want = tiny["scales"]
    np.testing.assert_allclose(np.float32(got), np.float32(want), rtol=1e-6, atol=0)
    assert got[0] == want[0]          # the features' amax involves no epilogue


def test_embeddings_match_jax_and_padding_is_invisible(tiny):
    lens = LENS
    x, ln = tiny["x"], tiny["ln"]
    tx, tl = _t(x, ln)
    jcfg, cfg, model = tiny["jcfg"].model, tiny["cfg"].model, tiny["port"].model
    scales, jf, pf = tiny["scales"], tiny["jf"], tiny["pf"]
    with torch.no_grad():
        dyn = pq.get_embedding_int8(model, tiny["pqv"], tx, tl, cfg).numpy()
        st = pq.get_embedding_int8_static(model, pf, scales[0], tx, tl, cfg).numpy()
        # padded == unpadded, one utterance (the dynamic scale is per batch)
        for i, n in enumerate(lens):
            padded, alone = tx[i:i + 1], tx[i:i + 1, :n]
            np.testing.assert_allclose(
                pq.get_embedding_int8(model, tiny["pqv"], padded, tl[i:i + 1], cfg).numpy(),
                pq.get_embedding_int8(model, tiny["pqv"], alone, None, cfg).numpy(), atol=1e-5)
            np.testing.assert_allclose(
                pq.get_embedding_int8_static(model, pf, scales[0], alone, None, cfg).numpy()[0],
                st[i], atol=1e-5)
    p, s = tiny["params"], tiny["state"]
    np.testing.assert_allclose(dyn, np.asarray(jq.get_embedding_int8(p, tiny["jqv"], s, x, ln, jcfg)),
                               atol=1e-4)
    np.testing.assert_allclose(
        st, np.asarray(jq.get_embedding_int8_static(p, jf, scales[0], s, x, ln, jcfg)), atol=1e-4)


def test_degenerate_batch_is_not_baked_and_scheme_errors(tiny):
    model, cfg = tiny["port"].model, tiny["cfg"].model
    fn = pq.make_int8_embed_fn(model, cfg, scheme="static")
    assert fn.calibration_state() == "uncalibrated"
    x, ln = _t(*_batch(LENS, seed=9))
    with torch.no_grad():
        fn(torch.zeros_like(x), ln)                     # warmup-like traffic
        assert fn.calibration_state() == "uncalibrated"
        with pytest.raises(ValueError, match="calibration batch"):
            fn.calibrate(torch.zeros_like(x), ln)
        assert fn.calibration_state() == "uncalibrated"
        first = fn(x, ln)                               # a real batch calibrates
        assert fn.calibration_state() == "static"
        dyn = pq.make_int8_embed_fn(model, cfg, scheme="dynamic")
        np.testing.assert_allclose(first.numpy(), dyn(x, ln).numpy(), atol=1e-6)
        assert (_cos(model(x, ln), fn(x, ln)) > 0.98).all()
    assert dyn.calibration_state() == "dynamic"
    with pytest.raises(ValueError):
        pq.make_int8_embed_fn(model, cfg, scheme="int4")
    with pytest.raises(ValueError):
        SpeakerEmbeddingModel.from_jax(tiny["flat"], tiny["cfg"], device="cpu", quantize="int4")


def test_cosine_guard_falls_back_to_dynamic(tiny):
    """An unreachable guard (cosine 1.01) forces the fallback: the scheme
    serves the dynamic path for good and never persists scales."""
    model, cfg = tiny["port"].model, tiny["cfg"].model
    x, ln = _t(*_batch(LENS, seed=11))
    with torch.no_grad():
        fn = pq.make_int8_embed_fn(model, cfg, scheme="static", cosine_guard=1.01)
        first = fn(x, ln)
        assert fn.calibration_state() == "fallback_dynamic"
        later = fn(x, ln)
        dyn = pq.make_int8_embed_fn(model, cfg, scheme="dynamic")(x, ln)
    np.testing.assert_array_equal(later.numpy(), dyn.numpy())
    np.testing.assert_array_equal(first.numpy(), later.numpy())


def test_scales_files_move_between_packages(tiny, tmp_path):
    jcfg, cfg = tiny["jcfg"].model, tiny["cfg"].model
    params, model = tiny["params"], tiny["port"].model
    sha = jq._weights_fingerprint(tiny["jqv"])
    assert sha == pq._weights_fingerprint(tiny["pqv"])
    x, ln = _t(*_batch(LENS, seed=10))
    probe, probe_len = _t(*_batch(LENS, seed=12))

    # JAX writes, the port loads and serves those scales before any batch
    jax_path = str(tmp_path / "jax_scales.npz")
    scales = [0.03, 0.05, 0.04, 0.02, 0.03, 0.01, 0.02, 0.015]
    jq.save_int8_scales(jax_path, scales, jcfg, weights_sha=sha)
    with torch.no_grad():
        pfn = pq.make_int8_embed_fn(model, cfg, scheme="static", scales_path=jax_path)
        assert pfn.calibration_state() == "static"
        want = pq.get_embedding_int8_static(model, pq.fold_static_scales(tiny["pqv"], scales, cfg),
                                            scales[0], probe, probe_len, cfg)
        np.testing.assert_array_equal(pfn(probe, probe_len).numpy(), want.numpy())

    # the port calibrates and writes, JAX loads
    port_path = str(tmp_path / "port_scales.npz")
    with torch.no_grad():
        pfn2 = pq.make_int8_embed_fn(model, cfg, scheme="static", scales_path=port_path)
        pfn2(x, ln)
    assert pfn2.calibration_state() == "static" and os.path.exists(port_path)
    with np.load(port_path) as z:
        assert str(z["weights_sha"]) == sha
    assert jq.load_int8_scales(port_path, jcfg, weights_sha=sha) == \
        pq.load_int8_scales(port_path, cfg, weights_sha=sha) == \
        pq.calibrate_int8_scales(tiny["pqv"], x, ln, cfg)
    assert jq.make_int8_embed_fn(params, jcfg, scheme="static",
                                 scales_path=port_path).calibration_state() == "static"

    # a file of other weights, or of another model, is refused by both
    other, _, _, other_cfg, other_flat = _jax_model(seed=99)
    other_port = SpeakerEmbeddingModel.from_jax(other_flat, other_cfg, device="cpu")
    with pytest.raises(ValueError, match="fingerprint"):
        pq.make_int8_embed_fn(other_port.model, cfg, scheme="static", scales_path=jax_path)
    with pytest.raises(ValueError, match="fingerprint"):
        jq.make_int8_embed_fn(other, jcfg, scheme="static", scales_path=port_path)
    with pytest.raises(ValueError, match="calibrated for"):
        pq.load_int8_scales(port_path, type(cfg)(kernel_size=32))


def test_speaker_embedding_model_matches_jax(tiny):
    """The whole slice: the port's and JAX's ``SpeakerEmbeddingModel`` in
    ``int8_static`` on the same weights, calibration batch and features."""
    jm = JaxModel(tiny["params"], tiny["state"], tiny["jcfg"], quantize="int8_static")
    pm = SpeakerEmbeddingModel.from_jax(tiny["flat"], tiny["cfg"], device="cpu",
                                        quantize="int8_static")
    x, ln = _batch(LENS, seed=13)
    assert pm.quantize_calibration_state() == jm.quantize_calibration_state() == "uncalibrated"
    assert pm.calibrate_quantization(x, ln) == jm.calibrate_quantization(x, ln) == "static"
    probe, probe_len = _batch(LENS, seed=14)
    np.testing.assert_allclose(pm.embed_features(probe, probe_len),
                               jm.embed_features(probe, probe_len), atol=1e-4)
    with pytest.raises(ValueError, match="takes no calibration"):
        SpeakerEmbeddingModel.from_jax(tiny["flat"], tiny["cfg"], device="cpu",
                                       quantize="int8").calibrate_quantization(x, ln)
