"""The port's serving path on the CPU: micro-batching, enrollment, the HTTP
server (``/embed``, ``/score``, ``/enroll``, ``/verify``, ``/identify``, 413
and 503), the upload front-end against the JAX package, and import
hygiene."""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu.config import FeatureConfig as JaxFeatureConfig
from doubleattentionspeakerverification_tpu.dsp.features import extract_normalized
from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel
from doubleattentionspeakerverification_tpu_torch.cli.serve import build_server
from doubleattentionspeakerverification_tpu_torch.config import ExperimentConfig, ModelConfig
from doubleattentionspeakerverification_tpu_torch.data.wav import decode_wav_bytes, encode_wav
from doubleattentionspeakerverification_tpu_torch.evaluation.embeddings import (
    weighted_unit_centroid,
)
from doubleattentionspeakerverification_tpu_torch.serving import (
    AudioTooLong,
    EnrollmentDB,
    MicroBatcher,
    ServerOverloaded,
    make_server,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ExperimentConfig(model=ModelConfig(kernel_size=16, heads_number=4, embedding_size=16))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    return SpeakerEmbeddingModel.from_random_init(TINY, seed=3, device="cpu")


class _GatedModel:
    """Each forward announces itself and waits for the test's go-ahead, so
    tests order requests by events instead of by timing."""

    def __init__(self, model):
        self._model = model
        self.entered = threading.Event()
        self.go = threading.Event()
        self.batch_sizes = []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def embed_features(self, x, lengths=None):
        self.batch_sizes.append(x.shape[0])
        self.entered.set()
        if not self.go.wait(60):
            raise TimeoutError("gate never opened")
        return self._model.embed_features(x, lengths)


def _feats(t, seed=0):
    return np.random.default_rng(seed).standard_normal((t, 80)).astype(np.float32)


def _wav(seconds=0.6, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return encode_wav(0.3 * np.sin(2 * np.pi * (200 + 40 * seed) * t)
                      + 0.02 * rng.standard_normal(len(t)), sr)


class _Server:
    def __init__(self, model, **kw):
        self.server = make_server(model, port=0, **kw)
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.batcher.close()
        self.thread.join(timeout=10)

    def post(self, path, data):
        req = urllib.request.Request(self.base + path, data=data, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=60) as r:
            return json.loads(r.read())

    def post_error(self, path, data):
        with pytest.raises(urllib.error.HTTPError) as ei:
            self.post(path, data)
        return ei.value


def test_http_embed_score_enroll_verify_identify(model):
    with _Server(model, max_batch=2, max_wait_ms=1.0) as s:
        e1 = s.post("/embed", _wav(seed=1))
        e2 = s.post("/embed", _wav(seed=2))
        assert len(e1["embedding"]) == TINY.model.embedding_size
        assert e1["frames"] == 57
        # the served embedding is the API's embedding of the same upload
        wave, sr = decode_wav_bytes(_wav(seed=1))
        np.testing.assert_allclose(e1["embedding"], model.embed_wave(wave, sr), atol=1e-5)

        same = s.post("/score", json.dumps({"a": e1["embedding"], "b": e1["embedding"]}).encode())
        assert same["score"] == pytest.approx(1.0, abs=1e-6)
        cross = s.post("/score", json.dumps({"a": e1["embedding"], "b": e2["embedding"]}).encode())
        assert -1.0 <= cross["score"] <= 1.0

        assert s.post("/enroll?speaker=a", _wav(seed=1))["enrollments"] == 1
        assert s.post("/enroll?speaker=b", _wav(seed=2))["enrollments"] == 1
        v = s.post("/verify?speaker=a", _wav(seed=1))
        assert v["score"] >= 0.99 and v["decision"] is True
        top = s.post("/identify?top_k=2", _wav(seed=2))["speakers"]
        scores = {r["speaker"]: r["score"] for r in top}   # ties come in any order
        assert set(scores) == {"a", "b"} and scores["b"] >= 0.99
        assert s.get("/speakers") == {"speakers": {"a": 1, "b": 1}}
        assert s.post_error("/verify?speaker=nobody", _wav()).code == 404
        assert s.post_error("/enroll", _wav()).code == 400
        assert s.post_error("/nope", b"x").code == 404
        assert s.post("/unenroll?speaker=a", b"")["removed"] == 1
        h = s.get("/health")
        assert h["status"] == "ok" and h["pending"] == 0 and h["device"] == "cpu"


def test_http_413_oversized_body_and_too_long_audio(model):
    with _Server(model, max_batch=2, max_wait_ms=1.0, max_body_mb=0.05) as s:
        err = s.post_error("/embed", b"\x00" * 100_000)
        assert err.code == 413 and "limit" in json.loads(err.read())["error"]
        s.server.batcher.buckets = (32, 64)
        err = s.post_error("/embed", _wav(seconds=1.0))   # 97 frames > 64
        assert err.code == 413 and "bucket" in json.loads(err.read())["error"]
        assert s.post_error("/embed", _wav(seconds=0.01)).code == 400  # no whole frame
        assert s.get("/health")["pending"] == 0


def test_http_503_when_the_admission_bound_is_full(model):
    gated = _GatedModel(model)
    with _Server(gated, max_batch=2, max_wait_ms=0.0, max_pending=1) as s:
        first = {}
        t = threading.Thread(target=lambda: first.update(s.post("/embed", _wav(seed=1))))
        t.start()
        assert gated.entered.wait(60)          # the first request holds the only slot
        err = s.post_error("/embed", _wav(seed=2))
        assert err.code == 503 and err.headers.get("Retry-After") == "1"
        assert "Overloaded" in json.loads(err.read())["error"]
        gated.go.set()
        t.join(timeout=60)
        assert len(first["embedding"]) == TINY.model.embedding_size
        assert s.get("/health")["shed"] == 1


def test_microbatcher_fuses_requests_that_wait_together(model):
    gated = _GatedModel(model)
    batcher = MicroBatcher(gated, max_batch=8, max_wait_ms=0.0, buckets=(64, 128), pipeline=1)
    feats = [_feats(30 + 4 * i, seed=i) for i in range(7)]
    results = [None] * 7
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, batcher.embed(feats[i])))
               for i in range(7)]
    # events, not a clock: the gate opens once the collector has taken the
    # six requests that arrive behind the held forward off the queue
    lock, first, taken, all_taken = threading.Lock(), [], set(), threading.Event()

    def first_put(item, _put=batcher._q.put):
        with lock:
            if not first:
                first.append(item)
        _put(item)

    def counting_get(*args, _get=batcher._q.get, **kwargs):
        # Queue.get_nowait calls self.get, so both ways of taking land here
        item = _get(*args, **kwargs)
        with lock:
            if item is not None and item is not first[0]:
                taken.add(id(item))
                if len(taken) == 6:
                    all_taken.set()
        return item

    batcher._q.put = first_put
    batcher._q.get = counting_get
    try:
        threads[0].start()
        assert gated.entered.wait(60)
        for th in threads[1:]:
            th.start()
        # all six wait behind the held forward, taken into the collector
        assert all_taken.wait(60), batcher.stats()
        gated.go.set()
        for th in threads:
            th.join(timeout=60)
        # the six fuse into the one forward after the held one
        sizes = gated.batch_sizes
        assert sizes == [1, 6], sizes
        for f, got in zip(feats, results):
            np.testing.assert_allclose(got, model.embed_features(f), atol=1e-5)
        with pytest.raises(AudioTooLong):
            batcher.embed(_feats(129))
        s = batcher.stats()
        assert (s["requests"], s["forwards"], s["pending"]) == (7, len(sizes), 0)
    finally:
        gated.go.set()
        batcher.close()


def test_microbatcher_chunks_long_audio_and_sheds(model):
    batcher = MicroBatcher(model, max_batch=4, max_wait_ms=1.0, buckets=(64,),
                           long_audio="chunk", max_pending=2)
    try:
        f = _feats(150, seed=4)        # chunks of 64, 64 and a dropped 22-frame tail
        want = weighted_unit_centroid(
            [model.embed_features(f[:64]), model.embed_features(f[64:128])], [64, 64])
        np.testing.assert_allclose(batcher.embed(f), want, atol=1e-5)
        with pytest.raises(AudioTooLong):   # 3 chunks can never fit max_pending=2
            batcher.embed(_feats(200, seed=5))
        with batcher._stats_lock:
            batcher._stats["pending"] = 2
        with pytest.raises(ServerOverloaded):
            batcher.embed(_feats(20))
        with batcher._stats_lock:
            batcher._stats["pending"] = 0
        assert batcher.stats()["shed"] == 1
    finally:
        batcher.close()


def test_enrollment_db_identify_and_persistence(tmp_path):
    path = str(tmp_path / "enroll.npz")
    db = EnrollmentDB(path)
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal(8).astype(np.float32), rng.standard_normal(8).astype(np.float32)
    db.enroll("a", a)
    db.enroll("a", a * 3)              # scale-invariant centroid
    db.enroll("b", b)
    assert db.score(a, "a") == pytest.approx(1.0, abs=1e-6)
    assert [r["speaker"] for r in db.identify(b, top_k=5)] == ["b", "a"]
    db.unenroll("b")                   # invalidates the cached centroid matrix
    assert [r["speaker"] for r in db.identify(b, top_k=5)] == ["a"]
    assert EnrollmentDB(path).speakers() == {"a": 2}


def test_upload_features_match_jax_at_another_rate(model):
    """Uploads at 8 kHz keep every configured front-end constant; only the
    rate, window and hop follow the audio (JAX ``api.py:130-141``)."""
    wave = (np.random.default_rng(6).standard_normal(8000) * 0.1).astype(np.float32)
    cfg = model.features_cfg_for_rate(8000)
    assert (cfg.sample_rate, cfg.hop_length, cfg.n_fft, cfg.fmax_hz) == (8000, 80, 512, 4000)
    jcfg = dataclasses.replace(JaxFeatureConfig(), sample_rate=8000, fmax=None)
    ref = np.asarray(extract_normalized(wave, jcfg))
    got = model.features_of_wave(wave, 8000).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-5)


def test_cli_builds_a_server_on_the_cpu():
    server = build_server([
        "--modelCheckpoint", os.path.join(REPO, "examples", "pretrained", "example_model.npz"),
        "--device", "cpu", "--port", "0", "--max_batch", "4",
    ])
    try:
        assert server.batcher.max_batch == 4
        assert server.batcher.model.cfg.model.kernel_size == 32
    finally:
        server.server_close()
        server.batcher.close()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, serving, the multi-process modules, the
    kernel dispatcher, the profiler, the TensorBoard writer and the bfloat16
    drift tool included, imports without loading jax or any module of the
    JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import doubleattentionspeakerverification_tpu_torch as port\n"
        "import doubleattentionspeakerverification_tpu_torch.serving\n"
        "names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "new = ['parallel.distributed', 'parallel.mesh', 'parallel.sharded_amsoftmax',\n"
        "       'utils.dist_ckpt', 'cli.convert_checkpoint', 'tools.multihost_check',\n"
        "       'utils.kernel_auto', 'utils.profiling', 'utils.tensorboard',\n"
        "       'tools.bf16_drift']\n"
        "assert all(port.__name__ + '.' + m in names for m in new), names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')\n"
        "       or (m + '.').startswith('doubleattentionspeakerverification_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
