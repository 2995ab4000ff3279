"""Start N processes of one program as a process group on this machine.

    python -m doubleattentionspeakerverification_tpu_torch.tools.multihost_check 2 -- \\
        -m doubleattentionspeakerverification_tpu_torch.cli.train --distributed \\
        --checkpoint_backend orbax ...
    python -m doubleattentionspeakerverification_tpu_torch.tools.multihost_check \\
        --call package.module:function [--device cpu] 2 [arguments ...]

Each process runs ``python <argv>`` with ``JAX_COORDINATOR_ADDRESS`` set to
a ``file://`` store in a fresh temporary directory (no port to collide
with), ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``, which
``parallel.distributed.initialize`` reads. ``--call`` runs
``function(*arguments)`` in every process after ``initialize`` (the
function's return value, an int or None, is the exit code). Each process's
output goes to a file; :func:`launch` returns every rank's exit code and
outputs. Once one process fails the others get a grace period and are
then killed, as are all of them at the time limit: nothing is left running.
"""

from __future__ import annotations

import argparse
import importlib
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

GRACE_S = 30.0
MODULE = "doubleattentionspeakerverification_tpu_torch.tools.multihost_check"


@dataclass
class RankResult:
    rank: int
    returncode: int       # negative: killed by that signal (time limit, or a failed peer)
    stdout: str
    stderr: str


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + 5
    for p in procs:
        try:
            p.wait(max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(argv: Sequence[str], nprocs: int, timeout: float = 600.0,
           env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None,
           workdir: Optional[str] = None) -> List[RankResult]:
    """Run ``python *argv`` ``nprocs`` times as one group; ``env`` is added
    to this process's environment. The store and the outputs live in
    ``workdir`` (a temporary directory, removed after, by default)."""
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="multihost_") if own else workdir
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    procs, files = [], []
    try:
        for r in range(nprocs):
            out = open(os.path.join(workdir, f"rank{r}.out"), "w+")
            err = open(os.path.join(workdir, f"rank{r}.err"), "w+")
            files.append((out, err))
            penv = dict(os.environ, **(env or {}), JAX_COORDINATOR_ADDRESS=f"file://{store}",
                        JAX_NUM_PROCESSES=str(nprocs), JAX_PROCESS_ID=str(r))
            procs.append(subprocess.Popen([sys.executable, *argv], stdout=out, stderr=err,
                                          env=penv, cwd=cwd))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if now > deadline:
                break
            if any(p.poll() not in (None, 0) for p in procs):
                deadline = min(deadline, now + GRACE_S)
            time.sleep(0.05)
        _stop(procs)
        results = []
        for r, (p, (out, err)) in enumerate(zip(procs, files)):
            out.seek(0)
            err.seek(0)
            results.append(RankResult(r, p.returncode, out.read(), err.read()))
        return results
    finally:
        _stop(procs)
        for out, err in files:
            out.close()
            err.close()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def call_argv(target: str, *args: str, device: str = "cpu") -> List[str]:
    """The argv that runs ``target`` ("module:function") with ``args`` in
    every process of a :func:`launch`, after joining the group on ``device``."""
    return ["-m", MODULE, "worker", device, target, *args]


def _worker(device: str, target: str, args: Sequence[str]) -> int:
    from ..parallel.distributed import initialize

    initialize(force=True, device=device)
    module, _, name = target.partition(":")
    rc = getattr(importlib.import_module(module), name)(*args)
    return int(rc or 0)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["worker"]:
        return _worker(argv[1], argv[2], argv[3:])
    p = argparse.ArgumentParser(description="Run N processes of one program as a group.")
    p.add_argument("nprocs", type=int)
    p.add_argument("--call", type=str, default=None, help="module:function to call in each")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--timeout", type=float, default=3600.0)
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="the python arguments of each process (after --); with --call, "
                        "the function's arguments. Options go before N")
    a = p.parse_args(argv)
    rest = a.rest[1:] if a.rest[:1] == ["--"] else a.rest
    run = call_argv(a.call, *rest, device=a.device) if a.call else rest
    results = launch(run, a.nprocs, timeout=a.timeout)
    for r in results:
        print(f"--- rank {r.rank}: exit {r.returncode}")
        sys.stdout.write(r.stdout)
        sys.stderr.write(r.stderr)
    return max((abs(r.returncode) for r in results), default=0)


if __name__ == "__main__":
    raise SystemExit(main())
