"""The benchmark harness's own tests, on the CPU unless marked ``card``.

    python -m pytest portbench/tests -q             # CPU, tiny sizes
    python -m pytest portbench/tests -q -m card     # on a machine with the card
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)
for p in (PORTBENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card (decided here, at run
    time, never when the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run_cell(*args, cwd=ROOT, timeout=600):
    """``portbench/run.py`` in a subprocess from ``cwd``: (exit code, the
    last line of its output parsed, its standard error)."""
    proc = subprocess.run([sys.executable, os.path.join(cwd, "portbench", "run.py"), *args],
                          cwd=cwd, capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return proc.returncode, last, proc.stderr


def load_run_module():
    """``portbench/run.py`` as a module, for runs in this process."""
    spec = importlib.util.spec_from_file_location("portbench_run", os.path.join(PORTBENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
