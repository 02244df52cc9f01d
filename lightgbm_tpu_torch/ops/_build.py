"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface, ``build/kernels/lib<name>.so`` at the repository root
(``build/`` is git-ignored), and loaded with ``ctypes``.  The sources share
device code through the headers ``csrc/*.cuh``.  Libraries are built at
first use and rebuilt when their source or any header is newer;
``build_all`` starts one ``nvcc`` per source, all at once.  A failed build
raises — the port has no fallback to the plain PyTorch versions on a CUDA
tensor.

Only sources in the repository are built.  Each library's ``nvcc -Xptxas
-v`` report (registers, shared memory, spills per kernel) is kept beside
it as ``lib<name>.ptxas.txt``.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("histogram", "search", "record", "split_step", "level_histogram",
           "predict", "sparse_histogram", "predict_binned")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no contracted multiply-adds: the kernels' f32 arithmetic must be the
    # plain PyTorch versions' (ops/histogram.py, ops/split.py)
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# libraries built (nvcc runs) in this process: serving's steady state
# builds none after prewarm
BUILDS = 0


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output of the last build of ``name``."""
    with open(os.path.join(BUILD_DIR, f"lib{name}.ptxas.txt")) as fh:
        return fh.read()


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    shared header (a header edit rebuilds every source)."""
    so = lib_path(name)
    if not os.path.exists(so):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")] + glob.glob(
        os.path.join(CSRC, "*.cuh"))
    return max(os.path.getmtime(d) for d in deps) > os.path.getmtime(so)


def _start(name: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = lib_path(name) + f".tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    with open(os.path.join(BUILD_DIR, f"lib{name}.ptxas.txt"), "w") as fh:
        fh.write(out)
    os.replace(proc.tmp_path, lib_path(name))  # type: ignore[attr-defined]


def build_all(force: bool = False) -> Dict[str, float]:
    """Build every stale (or, with ``force``, every) kernel library, one
    ``nvcc`` per source, all started together.  Returns wall seconds per
    source (0.0 for one that was already current)."""
    global BUILDS
    with _lock:
        names = [n for n in SOURCES if force or _stale(n)]
        BUILDS += len(names)
        t0 = time.perf_counter()
        procs = {n: _start(n) for n in names}
        secs = {n: 0.0 for n in SOURCES}
        for n, p in procs.items():
            _finish(n, p)
            secs[n] = time.perf_counter() - t0
            _libs.pop(n, None)
        return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if _stale(name):
        build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(lib_path(name))
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero cudaGetLastError() code from a C entry."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
