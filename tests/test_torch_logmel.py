"""The port's log-mel front-end (kernel B2's plain version, CMN/CMVN) against
the JAX package's Pallas kernel (interpret mode) and XLA path."""

import jax
import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu.config import FeatureConfig as JaxFeatureConfig
from doubleattentionspeakerverification_tpu.dsp import features as jf
from doubleattentionspeakerverification_tpu.dsp.mel import mel_filterbank as jax_mel_filterbank
from doubleattentionspeakerverification_tpu.ops.logmel_pallas import log_mel_spectrogram_pallas
from doubleattentionspeakerverification_tpu_torch.config import FeatureConfig
from doubleattentionspeakerverification_tpu_torch.dsp import features as tf
from doubleattentionspeakerverification_tpu_torch.dsp.mel import mel_filterbank
from doubleattentionspeakerverification_tpu_torch.ops import logmel


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _wave(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


@pytest.mark.parametrize(
    "cfg_kw, n_samples, tile_frames",
    [
        (dict(), 16000, 64),
        (dict(), 7000, 64),
        # the non-default configs of tests/test_pallas_logmel.py
        (dict(sample_rate=8000, n_fft=256), 12000, 32),
        (dict(window_stride_s=0.00275), 6000, 32),
        (dict(n_fft=480), 10000, 32),
        (dict(), 2000, 128),
        (dict(), 512 + 160 * 31, 32),
        (dict(window_stride_s=0.0025), 8000, 32),
    ],
)
def test_plain_logmel_matches_pallas_and_xla(cfg_kw, n_samples, tile_frames):
    wave = _wave((2, n_samples), seed=n_samples)
    ref_xla = np.asarray(jax.jit(jf.log_mel_spectrogram, static_argnums=1)(
        wave, JaxFeatureConfig(**cfg_kw)))
    ref_pallas = np.asarray(
        log_mel_spectrogram_pallas(wave, JaxFeatureConfig(**cfg_kw), tile_frames=tile_frames)
    )
    cfg = FeatureConfig(**cfg_kw)
    got = logmel.log_mel_spectrogram_fused(torch.from_numpy(wave), cfg).numpy()
    assert got.shape == ref_xla.shape == (2, tf.num_frames(n_samples, cfg), cfg.n_mels)
    np.testing.assert_allclose(got, ref_pallas, atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(got, ref_xla, atol=2e-4, rtol=1e-5)


def test_constants_match_jax():
    for kw in (dict(), dict(sample_rate=8000, n_fft=256)):
        jc, tc = JaxFeatureConfig(**kw), FeatureConfig(**kw)
        for a, b in zip(jf._dft_mel_constants(jc), tf.dft_mel_constants(tc)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            jax_mel_filterbank(16000, 512, 80), mel_filterbank(16000, 512, 80)
        )
    assert tf.num_frames(16000, FeatureConfig()) == jf.num_frames(16000, JaxFeatureConfig())
    assert tf.num_frames(300, FeatureConfig()) == 0


@pytest.mark.parametrize("mode", ["cmn", "cmvn"])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_normalize_features_matches_jax(mode, with_lengths):
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((3, 40, 80)).astype(np.float32) * 3 + 1
    feats[..., 7] = 2.0  # constant column: std under the 0.01 floor
    lengths = np.array([40, 23, 1], np.int32) if with_lengths else None
    ref = np.asarray(jax.jit(jf.normalize_features, static_argnums=1)(feats, mode, lengths))
    got = tf.normalize_features(
        torch.from_numpy(feats), mode, None if lengths is None else torch.from_numpy(lengths)
    ).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_extract_normalized_matches_jax():
    wave = _wave((12000,), seed=9)
    ref = np.asarray(jax.jit(jf.extract_normalized, static_argnums=1)(wave, JaxFeatureConfig()))
    got = tf.extract_normalized(torch.from_numpy(wave), FeatureConfig()).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-5)


def test_wrapper_never_falls_back_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel's wrapper, which refuses what is not a CUDA tensor."""
    wave = torch.zeros((1, 16000), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        logmel.log_mel_spectrogram_fused(wave, FeatureConfig())
    with pytest.raises(ValueError, match="CUDA"):
        logmel.log_mel_cuda(torch.zeros((1, 16000)), FeatureConfig())
    assert logmel.KERNEL.launches == 0


def test_short_wave_has_no_frames():
    got = logmel.log_mel_spectrogram_fused(torch.zeros(300), FeatureConfig())
    assert got.shape == (0, 80)
