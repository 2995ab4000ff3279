"""The harness end to end at tiny sizes on the CPU (``--cpu-smoke``): each
kind of cell, the result line's keys, cells and metrics added as files
alone, and no JAX in the process that runs a cell."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from conftest import PORTBENCH, ROOT, load_run_module, run_cell
from harness import common
from harness.trace import TraceSummary

CELLS = ["train-paper-f32", "train-paper-bf16-full", "verify-f32-steady"]
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_smoke(cell, trace):
    rc, last, err = run_cell("--workload", cell, "--seed", "2147483659", "--seconds", "2",
                             "--trace", str(trace), "--cpu-smoke")
    assert rc == 0, err[-3000:]
    assert last["correct"] is True, err[-3000:]
    assert last["attempted"] > 0 and last["failed"] == 0
    assert last["metrics"] == {}                 # a CPU run names no metric
    assert list(last)[-1] == "checks"
    bench = common.load_json(ROOT, "BENCHMARK.json")
    if trace:
        assert "breakdown" in last
        wanted = {m["name"] for m in bench["per_layer"] if common.reports(m, cell, bench)}
        assert set(last["smoke_metrics"]) <= wanted and last["smoke_metrics"]
    else:
        wanted = {m["name"] for m in bench["end_to_end"] if common.reports(m, cell, bench)}
        assert set(last["smoke_metrics"]) == wanted


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_only_the_contracts_keys(trace):
    run = load_run_module()
    cell = common.load_cell("verify-f32-steady")
    summary = TraceSummary(window_s=2.0, busy_s=1.0, kernels={"logmel_kernel": (1e-4, 8)},
                           classes={"b2": (1e-4, 8), "b1": (2e-4, 4), "conv_gemm": (0.5, 40)})
    view = common.RunView("verify", cell.config, cell.traffic, 2.0, summary if trace else None,
                          counters={"forwards": 4, "batched_requests": 8},
                          requests=[{"samples": 64000, "status": 200}] * 8)
    out = common.Outcome(attempted=8, failed=0,
                         e2e={"setup_s": 1.0, "verify_p95_ms": 9.0, "verify_p50_ms": 5.0},
                         view=view, checks={"score_gap": (1e-7, 1e-5)}, memory_peak_bytes=123)
    args = SimpleNamespace(workload="verify-f32-steady", trace=trace, cpu_smoke=False)
    result = run.assemble(args, cell, out, "NVIDIA H100 80GB HBM3")
    assert list(result) == CONTRACT + (["breakdown"] if trace else []) + ["checks"]
    assert set(result["device"]) == ({"platform", "kind", "count", "memory_peak_bytes"}
                                     | ({"busy_s", "window_s"} if trace else set()))
    assert result["device"]["platform"] == "gpu" and result["correct"] is True
    for v in result["metrics"].values():
        assert set(v) == {"value", "unit"}
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in cell.bench["end_to_end"]
                                          if common.reports(m, "verify-f32-steady", cell.bench)}
        assert {"setup_s", "verify_p50_ms"} <= set(result["metrics"])


def test_a_configuration_a_mix_and_a_metric_added_as_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(PORTBENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    os.symlink(os.path.join(ROOT, "doubleattentionspeakerverification_tpu_torch"),
               root / "doubleattentionspeakerverification_tpu_torch")
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "vgg4l-dmha-paper-f32.json").read_text())
    conf.update(name="vgg4l-dmha-paper-f32-cmvn", normalization="cmvn")
    (pb / "configs" / "vgg4l-dmha-paper-f32-cmvn.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "verify-steady.json").read_text())
    mix["rate_per_s"] = 3.0
    (pb / "traffic" / "verify-slow.json").write_text(json.dumps(mix))
    (pb / "metrics" / "answered_share.serve.py").write_text(
        "def read(run):\n"
        "    ok = [r for r in run.requests if r['status'] == 200]\n"
        "    return 100.0 * len(ok) / len(run.requests) if run.requests else None\n")
    (pb / "limits" / "verify-cmvn-slow.json").write_text(json.dumps(
        {"score_gap": 1e-3, "cpu_smoke": {"score_gap": 1e-3}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": conf["name"], "source": conf["source"],
                             "file": "portbench/configs/vgg4l-dmha-paper-f32-cmvn.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "verify-cmvn-slow", "config": conf["name"],
                               "traffic": "verify-slow", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "answered_share.serve", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "HTTP handler",
                               "moves": "verify_p50_ms", "workloads": ["verify-cmvn-slow"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, last, err = run_cell("--workload", "verify-cmvn-slow", "--seed", "5", "--seconds", "2",
                             "--trace", "1", "--cpu-smoke", cwd=str(root))
    assert rc == 0, err[-3000:]
    assert last["correct"] is True
    assert last["smoke_metrics"]["answered_share.serve"]["value"] == 100.0


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "doubleattentionspeakerverification_tpu_torch_x", sys)
    assert common.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    monkeypatch.setitem(sys.modules, "doubleattentionspeakerverification_tpu.models", sys)
    assert common.loaded_forbidden() == ["doubleattentionspeakerverification_tpu", "jaxlib"]


@pytest.mark.parametrize("cell", ["train-paper-f32", "verify-f32-steady"])
def test_no_jax_in_the_process_that_runs_a_cell(cell):
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('r', {os.path.join(PORTBENCH, 'run.py')!r})\n"
        "r = importlib.util.module_from_spec(spec); spec.loader.exec_module(r)\n"
        f"rc = r.main(['--workload', {cell!r}, '--seed', '9', '--seconds', '1', '--cpu-smoke'])\n"
        "print(json.dumps({'rc': rc, 'top': sorted({m.split('.')[0] for m in sys.modules})}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0, proc.stderr[-3000:]
    assert "doubleattentionspeakerverification_tpu_torch" in out["top"]
    assert not set(out["top"]) & {"jax", "jaxlib", "flax", "doubleattentionspeakerverification_tpu"}


def test_load_generator_imports_numpy_and_the_standard_library_only():
    code = ("import sys; sys.path.insert(0, %r); import loadgen, json; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % os.path.join(PORTBENCH, "harness"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "numpy" in top and not top & {"torch", "jax", "jaxlib", "flax"}


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(card, cell):
    rc, last, err = run_cell("--workload", cell, "--seed", "4294967311", "--seconds", "5",
                             "--trace", "0", timeout=1500)
    assert rc == 0, err[-3000:]
    assert last["correct"] is True, err[-3000:]
    assert last["device"]["platform"] == "gpu"
