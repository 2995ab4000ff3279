"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, turning a configuration file into the port's command
line, the seeded weights, the view the per-layer readers take, and the
result line."""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # portbench/
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")
# the CPU smoke mode keeps its small corpus apart, under TMPDIR
SMOKE_CACHE = os.path.join(tempfile.gettempdir(), "portbench-smoke-cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "doubleattentionspeakerverification_tpu")

# The harness's own CPU tests run each cell at these sizes (``--cpu-smoke``);
# no chip run uses them.
SMOKE_CONFIG = {"kernel_size": 16, "heads_number": 4, "embedding_size": 32, "num_spkrs": 12,
                "batch_size": 4, "window_size": 1.0}
SMOKE_TRAFFIC = {
    "train": {"corpus": {"seed": 7, "utterances_per_class": 2, "min_s": 1.2, "max_s": 2.0}},
    "verify": {"rate_per_s": 4.0, "pool_size": 12, "speakers": 3, "enroll_per_speaker": 2,
               "check_sample": 4, "client_threads": 4, "enroll_concurrency": 2, "drain_s": 60,
               "lengths": {"min_s": 1.0, "median_s": 1.5, "mean_s": 1.7, "max_s": 3.0}},
}


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(*path) -> Any:
    with open(os.path.join(*path)) as f:
        return json.load(f)


@dataclass
class Cell:
    bench: Dict
    workload: Dict
    config: Dict
    traffic: Dict
    limits: Dict


def load_cell(name: str, smoke: bool = False) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its configuration file, its
    traffic file ``portbench/traffic/<traffic>.json`` and the limits of its
    comparison ``portbench/limits/<name>.json`` (those under ``cpu_smoke``
    for the CPU smoke mode)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    (wl,) = [w for w in bench["workloads"] if w["name"] == name] or [None]
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    (cf,) = [c for c in bench["configs"] if c["name"] == wl["config"]]
    conf = load_json(ROOT, cf["file"])
    tr = load_json(HERE, "traffic", f"{wl['traffic']}.json")
    limits = load_json(HERE, "limits", f"{name}.json")
    # the CPU smoke mode's tiny model is held to limits of its own
    limits = limits.get("cpu_smoke", {}) if smoke else {
        k: v for k, v in limits.items() if k != "cpu_smoke"}
    if smoke:
        conf = {**conf, **SMOKE_CONFIG}
        over = SMOKE_TRAFFIC[tr["kind"]]
        tr = {**tr, **{k: ({**tr[k], **v} if isinstance(v, dict) and k in tr else v)
                       for k, v in over.items()}}
    return Cell(bench, wl, conf, tr, limits)


def cli_argv(parser: argparse.ArgumentParser, conf: Dict) -> List[str]:
    """The command line that runs ``conf``: each key that names an option
    of ``parser`` becomes that option (a flag where it is boolean)."""
    argv = []
    for act in parser._actions:
        if act.dest not in conf or not act.option_strings:
            continue
        value, opt = conf[act.dest], act.option_strings[0]
        if isinstance(act, argparse.BooleanOptionalAction):
            argv.append(opt if value else "--no-" + opt[2:])
        elif act.nargs == 0:
            if value:
                argv.append(opt)
        else:
            argv += [opt, str(value)]
    return argv


def fill_weights(model, seed: int, device) -> Dict[str, Any]:
    """Random weights for ``model`` from ``seed``, drawn on ``device`` in one
    call and in the types they are served in: convolution and linear weights
    uniform with He's variance (2 / fan_in, which keeps the signal's scale
    through the ReLUs, so the embedding follows the input rather than the
    biases) and zero biases, the attention vectors and ``W`` uniform with
    Xavier's variance, batch norm at 1, 0, running mean 0 and variance 1.
    Returns a copy of every value written, keyed by state-dict name."""
    import torch
    from torch import nn

    leaves = []
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            leaves.append((pre + "weight", mod.weight, math.sqrt(6.0 / mod.weight[0].numel())))
            with torch.no_grad():
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm1d):
            with torch.no_grad():
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        else:
            for pname, p in mod.named_parameters(recurse=False):
                std = math.sqrt(2.0 / (p.shape[0] + p.shape[1]))
                leaves.append((pre + pname, p, math.sqrt(3.0) * std))
    total = sum(p.numel() for _, p, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    off = 0
    with torch.no_grad():
        for _, p, bound in leaves:
            p.copy_(flat[off:off + p.numel()].view_as(p) * bound)
            off += p.numel()
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def loaded_forbidden() -> List[str]:
    """Top-level names of ``sys.modules`` that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class RunView:
    """What a per-layer reader (``portbench/metrics/<name>.py``) may read."""

    kind: str
    conf: Dict
    traffic: Dict
    window_s: float
    trace: Optional[Any] = None                      # trace.TraceSummary
    counters: Dict[str, float] = field(default_factory=dict)
    requests: List[Dict] = field(default_factory=list)


@dataclass
class Outcome:
    """A cell runner's result: the end-to-end values it measured, the view for
    the readers, and the comparison's numbers as (value, limit)."""

    attempted: int
    failed: int
    e2e: Dict[str, float]
    view: RunView
    checks: Dict[str, Tuple[float, float]]
    memory_peak_bytes: int


def read_metric(name: str, view: RunView) -> Optional[float]:
    """The reader ``portbench/metrics/<name>.py``'s ``read(view)``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(view)
    return None if value is None else float(value)


def reports(metric: Dict, workload: str, bench: Dict) -> bool:
    """Whether ``workload`` reports ``metric``: its ``workloads`` list, or,
    for a per-layer metric without one, every cell that reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        (target,) = [m for m in bench["end_to_end"] if m["name"] == metric["moves"]]
        return reports(target, workload, bench)
    return True
