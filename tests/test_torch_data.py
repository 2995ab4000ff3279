"""The port's data path, checkpoints and validation against the JAX
package's on the CPU: ``TrainLoader`` batches bit for bit in all four
source modes, the native host loader and log-mel, the train state's
checkpoint leaves both ways for each optimizer, the checkpoint directory
rules, ``EmbeddingExtractor`` on the same weights, embedding stores read
across packages, and ``validate_eer``. No JAX train step is compiled here.
"""

import dataclasses
import os
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu import config as jconfig
from doubleattentionspeakerverification_tpu.data import dataset as jdata
from doubleattentionspeakerverification_tpu.data import feature_cache as jcache
from doubleattentionspeakerverification_tpu.data.manifest import parse_train_manifest
from doubleattentionspeakerverification_tpu.data.wav import write_wav
from doubleattentionspeakerverification_tpu.dsp import features as jfeat
from doubleattentionspeakerverification_tpu.evaluation import embeddings as jemb
from doubleattentionspeakerverification_tpu.models.classifier import ModelState, get_embedding
from doubleattentionspeakerverification_tpu.training.step import init_train_state
from doubleattentionspeakerverification_tpu.utils import checkpoint as jckpt
from doubleattentionspeakerverification_tpu.utils import native as jnative
from doubleattentionspeakerverification_tpu_torch import config as pconfig
from doubleattentionspeakerverification_tpu_torch.data import dataset as pdata
from doubleattentionspeakerverification_tpu_torch.data import feature_cache as pcache
from doubleattentionspeakerverification_tpu_torch.dsp import features as pfeat
from doubleattentionspeakerverification_tpu_torch.evaluation import embeddings as pemb
from doubleattentionspeakerverification_tpu_torch.models.classifier import SpeakerClassifier
from doubleattentionspeakerverification_tpu_torch.models.init import init_parameters
from doubleattentionspeakerverification_tpu_torch.models.poolings import draw_head_keep
from doubleattentionspeakerverification_tpu_torch.training import optimizers as popt
from doubleattentionspeakerverification_tpu_torch.utils import checkpoint as pckpt
from doubleattentionspeakerverification_tpu_torch.utils import dist_ckpt
from doubleattentionspeakerverification_tpu_torch.utils import native as pnative
from doubleattentionspeakerverification_tpu_torch.utils.weights import (
    load_train_state,
    optimizer_state_by_name,
    params_from_jax,
    train_state_to_jax,
)
from test_data import make_synthetic_features

TOL_EMB = 1e-5
MODEL = dict(kernel_size=16, heads_number=4, embedding_size=32, num_spkrs=4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port_model(mcfg, seed=0) -> SpeakerClassifier:
    """A port model of a JAX ``ModelConfig``, seeded."""
    pm = pconfig.ModelConfig(**dataclasses.asdict(mcfg))
    return init_parameters(SpeakerClassifier(pm), torch.Generator().manual_seed(seed))


def jax_state_from_port(mcfg, seed=0):
    """(params, ModelState) for the JAX package from the port's seeded init,
    through ``train_state_to_jax``: no JAX random program is compiled."""
    flat = train_state_to_jax(port_model(mcfg, seed).state_dict(), {}, "SGD", 0, 0.1)
    params = {}
    for key, value in flat.items():
        if key.startswith("params/"):
            node = params
            *path, leaf = key.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(value)
    ms = ModelState(*(jnp.asarray(flat[f"model_state/{k}"])
                      for k in ("bn_mean", "bn_var", "bn_count")))
    return params, ms


# ------------------------------------------------------------------ loader
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """24 feature pickles of 1.5-4 s and 12 wavs of 1.5-4.5 s, with
    manifests: some shorter and some longer than the 2.5 s window."""
    root = tmp_path_factory.mktemp("corpus")
    feat_lines = make_synthetic_features(str(root / "feats"), 4, 6, t_range=(150, 400))
    rng = np.random.default_rng(1)
    (root / "wavs").mkdir()
    wav_lines = []
    for i in range(12):
        n = int(rng.integers(24000, 72000))
        t = np.arange(n) / 16000
        y = 0.3 * np.sin(2 * np.pi * (150 + 40 * (i % 3)) * t) + 0.05 * rng.standard_normal(n)
        write_wav(str(root / "wavs" / f"u{i}.wav"), y, 16000)
        wav_lines.append(f"u{i} {i % 3} -1\n")
    return {"root": root, "feats": parse_train_manifest(feat_lines),
            "wavs": parse_train_manifest(wav_lines)}


def _sources(mode, root, cfgs):
    """(JAX source, port source, is_wave) of one source mode."""
    window = 250
    if mode == "features":
        return (jdata.FeaturePickleSource(str(root / "feats"), "cmn", window),
                pdata.FeaturePickleSource(str(root / "feats"), "cmn", window), False)
    wavs = str(root / "wavs")
    jf, pf = cfgs
    if mode == "wav_pcm":
        return (jdata.WavSource(wavs, jf, window, native_reader=jnative.native_read_wav),
                pdata.WavSource(wavs, pf, window, native_reader=pnative.native_read_wav), True)
    if mode == "wav_host_dsp":
        return (jdata.HostDspWavSource(wavs, jf, window, "cmvn"),
                pdata.HostDspWavSource(wavs, pf, window, "cmvn"), False)
    return (jcache.CachedDspWavSource(wavs, jf, window, "cmn", cache_mb=1.0),
            pcache.CachedDspWavSource(wavs, pf, window, "cmn", cache_mb=1.0), False)


def _loaders(mode, workers, corpus, start_step=0):
    jf, pf = jconfig.FeatureConfig(), pconfig.FeatureConfig()
    jsrc, psrc, is_wave = _sources(mode, corpus["root"], (jf, pf))
    manifest = corpus["feats" if mode == "features" else "wavs"]
    kw = dict(window_size=2.5, batch_size=3, gradient_accumulation=2, random_slicing=True,
              seed=11, transfer_dtype="int16" if is_wave else "bfloat16")
    if mode == "wav_host_dsp":
        kw["transfer_dtype"] = "float32"
    out = []
    for pkg, src in ((jconfig, jsrc), (pconfig, psrc)):
        loader_mod = jdata if pkg is jconfig else pdata
        loader = loader_mod.TrainLoader(manifest, src, pkg.TrainConfig(**kw),
                                        pkg.DataConfig(num_workers=workers, prefetch=2),
                                        is_wave=is_wave)
        out.append(list(loader.epoch(1, start_step=start_step)))
    return out


def _bits(x):
    """A batch entry as numpy; bfloat16 (a torch tensor in the port, an
    ``ml_dtypes`` array in JAX) as its int16 bit patterns."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.view(torch.int16).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("mode", ["features", "wav_pcm", "wav_host_dsp", "wav_cache"])
def test_train_loader_stream_equals_jax(corpus, mode, workers):
    """Every batch of an epoch, bit for bit: shuffle, windows, random
    slicing, padding, labels and the transfer dtype (bfloat16 features,
    int16 PCM)."""
    assert jnative.native_available() and pnative.native_available()
    ref, got = _loaders(mode, workers, corpus)
    assert len(got) == len(ref) == (4 if mode == "features" else 2)
    for r, g in zip(ref, got):
        assert set(r) == set(g)
        for key in r:
            a, b = _bits(r[key]), _bits(g[key])
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert np.array_equal(a, b), (mode, key)
    if mode == "features":
        assert got[0]["inputs"].dtype == torch.bfloat16
    elif mode == "wav_pcm":
        assert got[0]["waves"].dtype == np.int16


def test_train_loader_start_step_skips_exactly(corpus):
    ref, got = _loaders("features", 3, corpus, start_step=2)
    full = _loaders("features", 1, corpus)[1]
    assert len(got) == len(ref) == len(full) - 2
    for r, g, f in zip(ref, got, full[2:]):
        assert np.array_equal(_bits(r["inputs"]), _bits(g["inputs"]))
        assert np.array_equal(_bits(g["inputs"]), _bits(f["inputs"]))


def test_assume_full_loader_rejects_short_as_jax(tmp_path):
    """Under ``assume_full_lengths`` a batch with an utterance shorter than
    the window is refused, with JAX's message (JAX
    ``tests/test_training.py:371-386``: a 100-frame window over files of
    60-120 frames)."""
    root = str(tmp_path / "feats")
    manifest = parse_train_manifest(make_synthetic_features(root, t_range=(60, 120)))
    errors = []
    for cfgs, data in ((jconfig, jdata), (pconfig, pdata)):
        tcfg = cfgs.TrainConfig(window_size=1.0, batch_size=4, gradient_accumulation=1,
                                assume_full_lengths=True)
        loader = data.TrainLoader(manifest, data.FeaturePickleSource(root, "cmn", 100), tcfg,
                                  cfgs.DataConfig(), feature_dim=80)
        with pytest.raises(ValueError, match="assume_full_lengths") as err:
            list(loader.epoch(0))
        errors.append(str(err.value))
    assert errors[1] == errors[0]


def test_native_windows_and_host_logmel_equal_jax(corpus):
    """The port's own build of ``native/`` draws the JAX loader's windows and
    computes its host log-mel; the numpy fallback is a copy."""
    paths = [str(corpus["root"] / "wavs" / f"u{i}.wav") for i in range(12)]
    seeds = np.arange(12, dtype=np.uint64) * 977 + 5
    a = jnative.native_read_windows(paths, 9000, seeds)
    b = pnative.native_read_windows(paths, 9000, seeds)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert os.path.dirname(pnative._SO_PATH).endswith("_build")
    jf, pf = jconfig.FeatureConfig(), pconfig.FeatureConfig()
    wave = pnative.native_read_wav(paths[3])
    assert np.array_equal(wave, jnative.native_read_wav(paths[3]))
    for norm in ("none", "cmn", "cmvn"):
        assert np.array_equal(pnative.host_logmel_extractor(pf, norm)(wave),
                              jnative.host_logmel_extractor(jf, norm)(wave))
    a = jnative.NativeLogmel(jf).wav_windows(paths, 9000, seeds, "cmn")
    b = pnative.NativeLogmel(pf).wav_windows(paths, 9000, seeds, "cmn")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(pfeat.log_mel_spectrogram_np(wave, pf),
                          jfeat.log_mel_spectrogram_np(wave, jf))


# --------------------------------------------------------------- checkpoint
def _jax_template(optimizer):
    jcfg = jconfig.ExperimentConfig(model=jconfig.ModelConfig(**MODEL),
                                    train=jconfig.TrainConfig(optimizer=optimizer))
    params, ms = jax_state_from_port(jcfg.model, seed=2)
    return jcfg, init_train_state(params, ms, jcfg)


@pytest.mark.parametrize("optimizer", ["Adam", "RMSprop", "SGD"])
def test_checkpoint_leaves_both_ways(optimizer, tmp_path):
    """Port -> JAX: the step-0 leaves equal JAX's ``init_train_state``
    (zero moments), and after real torch steps JAX's ``load_checkpoint``
    restores the port's file into its template. JAX -> port -> JAX: a JAX
    file of arbitrary values comes back exactly."""
    jcfg, template = _jax_template(optimizer)
    ref0 = jckpt._flatten(template)
    model = port_model(jcfg.model, seed=2)
    opt = popt.make_optimizer(pconfig.TrainConfig(optimizer=optimizer), model.parameters())
    got0 = train_state_to_jax(model.state_dict(), optimizer_state_by_name(model, opt),
                              optimizer, 0, float(np.float32(1e-4)))
    assert set(got0) == set(ref0) and len(got0) == {"Adam": 88, "RMSprop": 60, "SGD": 33}[optimizer]
    for k in ref0:
        assert got0[k].dtype == ref0[k].dtype and np.array_equal(got0[k], ref0[k]), k

    for _ in range(2):
        opt.zero_grad()
        x = torch.randn(3, 40, 80, generator=torch.Generator().manual_seed(4))
        keep = draw_head_keep(3, model.cfg.heads_number, model.cfg.mask_prob,
                              torch.Generator().manual_seed(1))
        costh, logits = model.classify(x, torch.tensor([0, 1, 2]), 0, keep=keep)
        logits.sum().backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
    leaves = train_state_to_jax(model.state_dict(), optimizer_state_by_name(model, opt),
                                optimizer, 2, popt.get_lr(opt))
    path = str(tmp_path / "port.npz")
    pckpt.save_checkpoint(path, leaves, {"step": 2})
    state, meta = jckpt.load_checkpoint(path, template)
    back = jckpt._flatten(state)
    assert meta == {"step": 2} and set(back) == set(leaves)
    assert all(np.array_equal(back[k], leaves[k]) for k in back)
    if optimizer == "Adam":
        assert int(back["opt_state/inner_state/1/count"]) == 2

    rng = np.random.default_rng(9)
    flat = {k: (np.asarray(7, v.dtype) if v.dtype == np.int32 and v.ndim == 0
                else rng.standard_normal(v.shape).astype(v.dtype)) for k, v in ref0.items()}
    flat["model_state/bn_var"] = np.abs(flat["model_state/bn_var"])
    flat["opt_state/hyperparams/learning_rate"] = np.asarray(3.3e-4, np.float32)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, jckpt.load_checkpoint(
        pckpt.save_checkpoint(str(tmp_path / "tmp.npz"), flat, {}), template)[0], {"step": 7})
    read, meta = pckpt.load_checkpoint(jpath)
    model2 = port_model(jcfg.model, seed=8)
    opt2 = popt.make_optimizer(pconfig.TrainConfig(optimizer=optimizer), model2.parameters())
    assert load_train_state(read, model2, opt2, optimizer) == 7
    assert popt.get_lr(opt2) == float(np.float32(3.3e-4))
    again = train_state_to_jax(model2.state_dict(), optimizer_state_by_name(model2, opt2),
                               optimizer, 7, popt.get_lr(opt2))
    assert set(again) == set(flat)
    for k in flat:
        assert again[k].dtype == flat[k].dtype and np.array_equal(again[k], flat[k]), k
    state = params_from_jax(read)
    assert torch.equal(model2.b2.running_var, state["b2.running_var"])


def test_latest_and_prune_choose_as_jax(tmp_path):
    names = ["m_1.npz", "m_10.npz", "m_2.npz", "m_best_3.npz", "m_best_12.npz", "other_40.npz",
             "m_x.npz", "m_7.npz", "m_config.json"]
    dirs = []
    for sub in ("jax", "port"):
        d = tmp_path / sub
        d.mkdir()
        for n in names:
            (d / n).write_bytes(b"0")
        dirs.append(str(d))
    assert os.path.basename(jckpt.latest_checkpoint(dirs[0])) == os.path.basename(
        pckpt.latest_checkpoint(dirs[1])) == "other_40.npz"
    assert pckpt.latest_checkpoint(str(tmp_path / "missing")) is None
    protect_j = (os.path.join(dirs[0], "m_2.npz"),)
    protect_p = (os.path.join(dirs[1], "m_2.npz"),)
    jckpt.prune_checkpoints(dirs[0], "m", 2, protect=protect_j)
    pckpt.prune_checkpoints(dirs[1], "m", 2, protect=protect_p)
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))
    assert "m_7.npz" in os.listdir(dirs[1]) and "m_1.npz" not in os.listdir(dirs[1])
    assert pckpt.checkpoint_path("o", "m", 5) == jckpt.checkpoint_path("o", "m", 5)


def test_async_checkpointer_supersedes_and_prunes_after_writing(tmp_path):
    ck = pckpt.AsyncCheckpointer()
    calls = []
    for step in range(4):
        path = str(tmp_path / f"m_{step % 2}.npz")
        ck.save(path, {"x": np.full((2,), step, np.float32)}, {"step": step},
                then=lambda p=path: calls.append(os.path.exists(p)))
    ck.wait()
    assert all(calls) and sorted(os.listdir(tmp_path)) == ["m_0.npz", "m_1.npz"]
    flat, meta = pckpt.load_checkpoint(str(tmp_path / "m_1.npz"))
    assert meta["step"] in (1, 3) and flat["x"][0] == meta["step"]


def test_dcp_async_saver_defers_finalization(tmp_path):
    """``DcpAsyncSaver`` on one process, as JAX
    ``test_orbax_async_saver_defers_finalization``
    (``tests/test_training.py:693-724``): a save not yet waited for has no
    ``meta.json`` and is invisible to ``latest_dcp_checkpoint`` and to the
    pruning; ``wait()`` lands it; ``block=True`` finalizes before it returns;
    the leaves read back equal the synchronous writer's, ``W`` in columns
    too."""
    _, template = _jax_template("Adam")
    flat = jckpt._flatten(template)
    out = str(tmp_path / "ck")
    saver = dist_ckpt.DcpAsyncSaver()
    p2 = saver.save(f"{out}/m_2.dcp", flat, {"step": 2})
    assert dist_ckpt.latest_dcp_checkpoint(out) is None
    assert not os.path.exists(os.path.join(p2, "meta.json"))
    dist_ckpt.prune_dcp_checkpoints(out, "m", 1)
    saver.wait()
    assert dist_ckpt.latest_dcp_checkpoint(out) == p2

    # the next save finalizes the one before it; the one in flight is
    # neither counted nor removed by the pruning
    p3 = saver.save(f"{out}/m_3.dcp", flat, {"step": 3}, columns=(0, 4))
    dist_ckpt.prune_dcp_checkpoints(out, "m", 1)
    assert dist_ckpt.latest_dcp_checkpoint(out) == p2
    best = saver.save(f"{out}/m_best_4.dcp", flat, {"step": 4}, block=True)
    assert all(os.path.exists(os.path.join(p, "meta.json")) for p in (p2, p3, best))
    assert dist_ckpt.latest_dcp_checkpoint(out) == best
    saver.close()

    sync = dist_ckpt.save_checkpoint_dcp(str(tmp_path / "sync_2.dcp"), flat, {"step": 2})
    ref, _ = dist_ckpt.load_checkpoint_dcp(sync)
    for path, step in ((p2, 2), (p3, 3), (best, 4)):
        got, meta = dist_ckpt.load_checkpoint_dcp(path)
        assert meta == {"step": step} and set(got) == set(ref) == set(flat)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), (path, k)


# --------------------------------------------------------------- embeddings
LENGTHS = (30, 45, 70, 90, 95, 250)
BUCKETS = (50, 100)


@pytest.fixture(scope="module")
def extractors():
    """The JAX and port extractors' inputs on one set of weights; the JAX
    embedding function is shared so each bucket compiles once."""
    jcfg = jconfig.ModelConfig(**MODEL)
    params, ms = jax_state_from_port(jcfg, seed=6)
    model = port_model(jcfg, seed=0)
    model.load_state_dict(params_from_jax(jckpt._flatten({"params": params,
                                                          "model_state": ms})))
    rng = np.random.default_rng(3)
    feats = {f"utt{i}": rng.standard_normal((t, 80)).astype(np.float32)
             for i, t in enumerate(LENGTHS)}
    embed = jax.jit(partial(get_embedding, cfg=jcfg))
    return jcfg, params, ms, model, feats, embed


@pytest.mark.parametrize("long_audio", ["chunk", "pad"])
def test_embedding_extractor_equals_jax(extractors, long_audio):
    """Several buckets and one utterance past ``max_frames`` (200): chunked
    into a duration-weighted centroid, or padded to 300 frames."""
    jcfg, params, ms, model, feats, embed = extractors
    ref = jemb.EmbeddingExtractor(params, ms, jcfg, feats.__getitem__, buckets=BUCKETS,
                                  embed_fn=embed, num_workers=1, long_audio=long_audio)
    got = pemb.EmbeddingExtractor(model, feats.__getitem__, buckets=BUCKETS, num_workers=2,
                                  long_audio=long_audio)
    a, b = ref.extract(list(feats)), got.extract(list(feats))
    assert set(a) == set(b) == set(feats) and got.n_embedded == ref.n_embedded
    for u in feats:
        np.testing.assert_allclose(b[u], a[u], rtol=0, atol=TOL_EMB, err_msg=u)
    assert model.training  # the extractor restores the model's mode


def test_validate_eer_and_embedding_stores_across_packages(extractors, tmp_path):
    jcfg, params, ms, model, feats, embed = extractors
    clients = [("utt0", "utt1"), ("utt2", "utt3"), ("utt4", "utt5"), ("utt1", "utt2")]
    impostors = [("utt0", "utt3"), ("utt1", "utt4"), ("utt2", "utt5"), ("utt0", "utt5")]
    ref = jemb.validate_eer(jemb.EmbeddingExtractor(
        params, ms, jcfg, feats.__getitem__, buckets=BUCKETS, embed_fn=embed,
        num_workers=1), clients, impostors)
    got_ex = pemb.EmbeddingExtractor(model, pemb.FeatureCache(feats.__getitem__, 1.0),
                                     buckets=BUCKETS)
    got = pemb.validate_eer(got_ex, clients, impostors)
    assert got["eer"] == ref["eer"]
    for key in ("eer_exact", "min_dcf", "mean_client", "mean_impostor"):
        assert got[key] == pytest.approx(ref[key], abs=1e-5), key

    pemb.save_embeddings(str(tmp_path / "p.npz"), got_ex.cache, quantize="int8")
    jemb.save_embeddings(str(tmp_path / "j.npz"), got_ex.cache)
    for read in (jemb.load_embeddings(str(tmp_path / "p.npz")),
                 pemb.load_embeddings(str(tmp_path / "j.npz"))):
        assert set(read) == set(got_ex.cache)
        assert all(np.array_equal(read[u], got_ex.cache[u]) for u in read)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pemb.load_embeddings(str(tmp_path / "p.npz"), expect_quantize="none")
    assert any("quantize='int8'" in str(w.message) for w in caught)


def test_pickle_loader_equals_jax(corpus):
    root = str(corpus["root"] / "feats")
    for norm in ("cmn", "cmvn"):
        a = jemb.pickle_feature_loader(root, norm)("spk1_utt2")
        b = pemb.pickle_feature_loader(root, norm)("spk1_utt2")
        assert np.array_equal(a, b)
    wave_dir = str(corpus["root"] / "wavs")
    a = jemb.wav_feature_loader(wave_dir, jconfig.FeatureConfig(), "cmn", host_dsp=True)("u4")
    b = pemb.wav_feature_loader(wave_dir, pconfig.FeatureConfig(), "cmn", host_dsp=True,
                                device="cpu")("u4")
    assert np.array_equal(a, b)
