"""The benchmark of the PyTorch and CUDA port: one cell, run once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration file and a traffic file; the traffic's ``kind`` picks the
runner (``harness/train.py`` or ``harness/verify.py``), which builds the
port's system as its entry point does, warms every shape the traffic uses,
measures for ``--seconds`` and then holds what the timed path produced to
the plain reference (``harness/reference.py``). The last line of standard
output is one JSON object: with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics (each read by
``portbench/metrics/<name>.py``) and a ``breakdown`` of the device trace.
The numbers compared, each beside its limit, close standard error and the
result's line.

An end-to-end metric named ``<quantity>.<suffix>`` (one bound a class of
cells) reads the runner's ``<quantity>``.

``--control 1`` puts the reference, computed one precision step lower, in
the program's place where the comparison is made: its numbers are the ones
held to the limits, so such a run must read ``correct`` false (used to set
and test the limits; never part of a cell's runs).
``--cpu-smoke`` runs the cell at tiny sizes on the CPU for the harness's
own tests and reports no device metric.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _process_start() -> float:
    """Wall time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
# build and kernel caches live at fixed paths inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(HERE, "cache", _sub)

from harness import common  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu-smoke", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def assemble(args, cell: common.Cell, out: common.Outcome, device_kind: str) -> dict:
    """The result line: the cell's end-to-end metrics (``--trace 0``) or
    per-layer metrics (``--trace 1``), the device, the trace's breakdown,
    and last the numbers compared with their limits. A smoke run reports
    its numbers apart and names no device."""
    bench, name = cell.bench, args.workload
    metrics, smoke_metrics = {}, {}
    chosen = [m for m in (bench["per_layer"] if args.trace else bench["end_to_end"])
              if common.reports(m, name, bench)]
    for m in chosen:
        value = (common.read_metric(m["name"], out.view) if args.trace
                 else out.e2e.get(m["name"], out.e2e.get(m["name"].split(".")[0])))
        if value is not None:
            (smoke_metrics if args.cpu_smoke else metrics)[m["name"]] = {
                "value": value, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in out.checks.values())
    if args.cpu_smoke:
        device = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    else:
        device = {"platform": "gpu", "kind": device_kind, "count": cell.workload["chips"],
                  "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device}
    if args.trace and out.view.trace is not None:
        if not args.cpu_smoke:
            device["busy_s"] = out.view.trace.busy_s
            device["window_s"] = out.view.trace.window_s
        result["breakdown"] = out.view.trace.breakdown()
    if args.cpu_smoke:
        result["smoke_metrics"] = smoke_metrics
        result["smoke_e2e"] = out.e2e
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cell = common.load_cell(args.workload, args.cpu_smoke)
    import torch

    chips = cell.workload["chips"]
    if not args.cpu_smoke and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        common.log(f"error: the cell needs {chips} CUDA device(s); "
                   f"available={torch.cuda.is_available()} count={torch.cuda.device_count()}")
        return 3
    kind = cell.traffic["kind"]
    if kind == "train":
        from harness import train as runner
    elif kind == "verify":
        from harness import verify as runner
    else:
        common.log(f"error: unknown traffic kind {kind!r}")
        return 2
    out = runner.run(args, cell, T_START)

    found = common.loaded_forbidden()
    if found:
        common.log(f"error: JAX or the JAX package was loaded in this process: {found}")
        return 4

    kind_name = "cpu" if args.cpu_smoke else torch.cuda.get_device_name(0)
    result = assemble(args, cell, out, kind_name)
    for k, (v, lim) in out.checks.items():
        common.log(f"check {k}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
