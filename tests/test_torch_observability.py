"""The port's observability modules and its package surface on the CPU:
``utils/tensorboard.py`` (files read both ways with the JAX package's
reader), ``utils/logging.py``'s TensorBoard sink, ``utils/profiling.py``
(the step window of ``tests/test_aux.py``, here as a readable
``torch.profiler`` trace), ``data/wav.py:write_wav`` and the ``__init__``
re-exports."""

import importlib
import io
import json
import os

import numpy as np
import pytest
import torch

from doubleattentionspeakerverification_tpu.data import wav as jwav
from doubleattentionspeakerverification_tpu.utils import tensorboard as jtb
from doubleattentionspeakerverification_tpu.utils.logging import MetricLogger as JaxLogger
from doubleattentionspeakerverification_tpu_torch.data import wav as pwav
from doubleattentionspeakerverification_tpu_torch.utils import tensorboard as ptb
from doubleattentionspeakerverification_tpu_torch.utils.logging import MetricLogger
from doubleattentionspeakerverification_tpu_torch.utils.profiling import (
    StepProfiler,
    ThroughputMeter,
    annotate,
    trace,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ TensorBoard
def test_crc32c_known_answers():
    # RFC 3720 / kernel test vectors for CRC32-C (Castagnoli)
    assert ptb.crc32c(b"") == 0x00000000
    assert ptb.crc32c(b"123456789") == 0xE3069283
    assert ptb.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert ptb.crc32c(b"\xff" * 32) == 0x62A8AB43
    for data in (b"", b"abc", bytes(range(256))):
        assert ptb.masked_crc32c(data) == jtb.masked_crc32c(data)


def _write(writer_cls, logdir):
    w = writer_cls(str(logdir))
    for step, tag, value in ((1, "train/loss", 1.25), (2, "train/loss", 0.75),
                             (2, "val/eer", 12.5), (2**40, "s", -3.0)):
        w.add_scalar(tag, value, step, wall_time=1000.0 + step % 7)
    w.close()
    return w.path


@pytest.mark.parametrize("writer, reader", [(ptb, jtb), (jtb, ptb), (ptb, ptb)],
                         ids=["port_read_by_jax", "jax_read_by_port", "port_roundtrip"])
def test_event_files_read_both_ways(tmp_path, writer, reader):
    path = _write(writer.TensorBoardWriter, tmp_path)
    got = reader.read_scalars(path)
    assert [(s, t, v) for (_, s, t, v) in got] == [
        (1, "train/loss", 1.25), (2, "train/loss", 0.75), (2, "val/eer", 12.5),
        (2**40, "s", -3.0)]
    assert [w for (w, _, _, _) in got] == [1001.0, 1002.0, 1002.0, 1000.0 + 2**40 % 7]


def test_event_records_are_byte_identical():
    for args in ((1234.5, 7, "train/loss", 0.125), (0.0, 2**40, "a/b", -1e30)):
        assert ptb._tfrecord(ptb._scalar_event(*args)) == jtb._tfrecord(jtb._scalar_event(*args))
    assert ptb._tfrecord(ptb._version_event(5.0)) == jtb._tfrecord(jtb._version_event(5.0))


@pytest.mark.parametrize("offset", [-6, 3, 9])
def test_corruption_is_detected(tmp_path, offset):
    """A flipped byte of a payload (-6), of the length (3) or of the length's
    CRC (9) is refused by either reader."""
    path = _write(ptb.TensorBoardWriter, tmp_path)
    raw = bytearray(open(path, "rb").read())
    raw[offset] ^= 0xFF
    bad = tmp_path / "corrupt"
    bad.write_bytes(bytes(raw))
    for reader in (ptb, jtb):
        with pytest.raises(ValueError, match="bad (length|data) crc"):
            reader.read_scalars(str(bad))


def test_metric_logger_sink_matches_jax(tmp_path):
    """The same events give the same scalars through either package's
    logger: numbers (0-d arrays and tensors too) at the event's step or the
    last one seen, no strings, no booleans."""
    events = [("train", dict(step=10, loss=2.0, acc=0.5, lr=1e-4, n=np.float32(3.0))),
              ("validation", dict(step=10, eer=25.0, model="vgg4l", best=True)),
              ("new_best", dict(eer=24.0, path="/x/y.npz")),
              ("train", dict(step=11, loss=np.array(1.5)))]
    scalars = {}
    for name, cls in (("port", MetricLogger), ("jax", JaxLogger)):
        out = tmp_path / name
        log = cls(stream=io.StringIO(), tensorboard_dir=str(out))
        for event, fields in events:
            log.log(event, **fields)
        log.close()
        (path,) = out.glob("events.out.tfevents.*")
        scalars[name] = [(s, t, v) for (_, s, t, v) in ptb.read_scalars(str(path))]
    assert scalars["port"] == scalars["jax"]
    got = {(s, t): v for (s, t, v) in scalars["port"]}
    assert got[(10, "train/loss")] == 2.0 and got[(10, "new_best/eer")] == 24.0
    assert got[(11, "train/loss")] == 1.5 and got[(10, "train/n")] == 3.0
    assert not any(t.endswith(("/model", "/path", "/best")) for (_, t) in got)
    log = MetricLogger(stream=io.StringIO(), tensorboard_dir=str(tmp_path / "t"))
    log.log("train", step=3, loss=torch.tensor(0.25))
    log.close()
    (path,) = (tmp_path / "t").glob("events.out.tfevents.*")
    assert [(s, t, v) for (_, s, t, v) in ptb.read_scalars(str(path))] == [(3, "train/loss",
                                                                              0.25)]


# --------------------------------------------------------------- profiler
def _trace_events(logdir):
    (name,) = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    with open(os.path.join(logdir, name)) as f:
        return json.load(f)["traceEvents"]


def test_trace_and_annotate(tmp_path):
    with trace(str(tmp_path / "trace")):
        with annotate("matmul_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.get("name") for e in _trace_events(tmp_path / "trace")}
    assert "matmul_region" in names and "aten::mm" in names


def test_step_profiler_window(tmp_path):
    """StepProfiler traces exactly [start, start + n): each step's region is
    in the one trace it writes, and no other step's."""
    logdir = str(tmp_path / "prof")
    p = StepProfiler(logdir, start_step=2, num_steps=2)
    events = {}
    x = torch.ones(8, 8)
    for step in range(6):
        evt = p.before_step(step, sync=x.sum())
        if evt:
            events[step] = evt
        with annotate(f"step_{step}"):
            x = x @ x / 8
    p.close(sync=x.sum())
    assert events == {2: "started", 4: "stopped"}
    assert p.done and not p.active and p.path.startswith(logdir)
    names = {e.get("name") for e in _trace_events(logdir)}
    assert {f"step_{s}" for s in range(6)} & names == {"step_2", "step_3"}

    off = StepProfiler("", 0, 1)
    assert off.before_step(0) is None and off.done


def test_step_profiler_close_mid_window(tmp_path):
    """Training that ends inside the window still writes its trace."""
    logdir = str(tmp_path / "prof2")
    p = StepProfiler(logdir, start_step=0, num_steps=100)
    assert p.before_step(0) == "started"
    assert p.before_step(1) is None
    p.close()
    assert p.done and not p.active
    assert isinstance(_trace_events(logdir), list)


def test_throughput_meter():
    m = ThroughputMeter(window_audio_s=3.5, samples_per_step=64, n_chips=2)
    assert m.steps_per_second() is None and m.audio_seconds_per_second_per_chip() is None
    m.step(3)
    m._t0 -= 100.0      # as if started 100 s ago: the rates no longer hang on the clock
    assert m.steps_per_second() == pytest.approx(0.03, rel=1e-3)
    assert m.audio_seconds_per_second_per_chip() == pytest.approx(3 * 64 * 3.5 / 100 / 2,
                                                                   rel=1e-3)


# ------------------------------------------------------------ the surface
def test_write_wav_matches_jax(tmp_path):
    x = np.sin(np.arange(4000) / 9.0) * 1.3
    pwav.write_wav(str(tmp_path / "p.wav"), x, 16000)
    jwav.write_wav(str(tmp_path / "j.wav"), x, 16000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    wave, sr = pwav.read_wav(str(tmp_path / "p.wav"))
    assert sr == 16000 and np.abs(wave - np.clip(x, -1, 1)).max() < 1e-4


# JAX names with no port counterpart by design (the modules' docstrings say
# why), and the port's counterparts of JAX's functional API
NO_COUNTERPART = {"models": {"ModelState", "init_speaker_classifier", "speaker_classifier_apply",
                             "get_embedding", "vgg_apply"},
                  "training": {"TrainState", "init_train_state"}}
PORT_ONLY = {"models": {"SpeakerClassifier", "VGG", "init_parameters"},
             "training": {"TrainStep"}}


@pytest.mark.parametrize("sub", ["", "dsp", "models", "evaluation", "training"])
def test_package_exports_follow_jax(sub):
    suffix = f".{sub}" if sub else ""
    jmod = importlib.import_module("doubleattentionspeakerverification_tpu" + suffix)
    pmod = importlib.import_module("doubleattentionspeakerverification_tpu_torch" + suffix)
    want = (set(jmod.__all__) - NO_COUNTERPART.get(sub, set())) | PORT_ONLY.get(sub, set())
    assert set(pmod.__all__) == want
    assert all(getattr(pmod, name) is not None for name in pmod.__all__)
