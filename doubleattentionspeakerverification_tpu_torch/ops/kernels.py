"""Build, load and count the hand-written CUDA kernels.

Each kernel is one source under ``csrc/`` with a plain C entry point. It is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``_build/`` (listed in ``.gitignore``) at first use, and loaded with
``ctypes``: no PyTorch headers are compiled, so a build takes seconds.
``build_all`` starts one ``nvcc`` per source at once.

A :class:`CudaKernel` counts its launches in a plain integer; the count
moves only where the kernel is launched, so a run can show that its path
went through the kernel. Launches made inside :func:`uncounted` (the kernel
dispatcher's self-checks, ``utils/kernel_auto.py``) are counted apart, in
``check_launches``, and only for the thread that opened it. A source may export several C entries (variants
compiled from one template); ``launch`` takes the entry's name.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import contextlib
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOCAL = threading.local()


@contextlib.contextmanager
def uncounted():
    """Launches of this thread inside the block go to ``check_launches``,
    not ``launches``."""
    prev = getattr(_LOCAL, "uncounted", False)
    _LOCAL.uncounted = True
    try:
        yield
    finally:
        _LOCAL.uncounted = prev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return path


class CudaKernel:
    """One kernel: its source, its built library and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.check_launches = 0
        self.build_log = ""
        self._lib = None
        self._fns: Dict[str, object] = {}
        self._lock = threading.Lock()

    @property
    def library(self) -> Path:
        return BUILD_DIR / f"lib{self.name}.so"

    @property
    def _tmp(self) -> Path:
        return self.library.with_suffix(f".{os.getpid()}.tmp")

    def _stale(self) -> bool:
        lib = self.library
        return not lib.exists() or lib.stat().st_mtime < self.source.stat().st_mtime

    def start_build(self) -> subprocess.Popen:
        """Start ``nvcc`` on this kernel's source; the library appears under
        its final name only when the compile succeeded."""
        BUILD_DIR.mkdir(exist_ok=True)
        return subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(self._tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

    def finish_build(self, proc: subprocess.Popen) -> None:
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            self._tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n{out}")
        os.replace(self._tmp, self.library)

    def _function(self, symbol: Optional[str] = None):
        symbol = symbol or self.symbol
        with self._lock:
            if symbol not in self._fns:
                if self._lib is None:
                    if self._stale():
                        self.finish_build(self.start_build())
                    self._lib = ctypes.CDLL(str(self.library))
                fn = getattr(self._lib, symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fns[symbol] = fn
            return self._fns[symbol]

    def launch(self, *args, symbol: Optional[str] = None) -> None:
        """Call the C entry ``symbol`` (default: the kernel's own; it launches
        on the stream passed last) and raise on a refused launch.
        ``cudaGetLastError`` is the C entry's return value; a fault during
        the run shows at the next sync."""
        rc = self._function(symbol)(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: cudaError {rc}")
        with self._lock:
            if getattr(_LOCAL, "uncounted", False):
                self.check_launches += 1
            else:
                self.launches += 1


def build_all(kernels: List[CudaKernel]) -> Dict[str, str]:
    """Compile every stale kernel at once (one ``nvcc`` each) and load all;
    returns each kernel's compiler output (register and spill counts)."""
    procs = [(k, k.start_build()) for k in kernels if k._stale()]
    errors = []
    for k, proc in procs:
        try:
            k.finish_build(proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k._function()
    return {k.name: k.build_log for k in kernels}
