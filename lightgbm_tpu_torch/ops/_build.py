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

``build_host`` builds the host libraries of ``csrc/host/`` the same way:
the native reader (g++ with OpenMP) and the C API shim (gcc against the
running Python's headers) into ``build/native/``.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from typing import Dict, List

from ..analysis import lockcheck

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("histogram", "search", "record", "split_step", "level_histogram",
           "predict", "sparse_histogram", "predict_binned", "forest")
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


# ------------------------------------------------------------ host libraries
HOST_CSRC = os.path.join(CSRC, "host")
HOST_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
_host_lock = lockcheck.make_lock("native.build")


def python_flags() -> List[str]:
    """Compile against the running Python's headers; link its libpython
    only where it is a shared library (a static interpreter exports the
    C API itself, and a second copy would be a second interpreter)."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or ""
    flags = [f"-I{inc}"]
    if (sysconfig.get_config_var("Py_ENABLE_SHARED")
            and os.path.exists(os.path.join(libdir, f"libpython{ver}.so"))):
        flags += [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-lpython{ver}"]
    return flags


# name -> (source under csrc/host, library, compiler and flags, what to do
# when the build fails); the shim also links against Python
HOST_LIBS = {
    "native": ("lgbm_native.cpp", "liblgbm_native.so",
               ["g++", "-O3", "-std=c++17", "-Wall", "-fPIC", "-fopenmp",
                "-shared"],
               "set LIGHTGBM_TPU_NO_NATIVE=1 to parse with numpy instead"),
    "capi": ("lgbm_capi.c", "lib_lightgbm_tpu_torch.so",
             ["gcc", "-O2", "-Wall", "-fPIC", "-shared",
              f'-DLGBM_TPU_ROOT="{os.path.dirname(_PKG)}"'],
             "the C API needs gcc and Python.h"),
}


def _host_command(name: str, out: str) -> List[str]:
    src, _, cc, _ = HOST_LIBS[name]
    link = python_flags() if name == "capi" else []
    return [*cc, "-o", out, os.path.join(HOST_CSRC, src), *link]


def host_lib_path(name: str) -> str:
    return os.path.join(HOST_DIR, HOST_LIBS[name][1])


def build_host(name: str) -> str:
    """The path of host library ``name`` (``HOST_LIBS``), built first when
    it is missing, older than its source or built by another command or
    machine (its ``.cmd`` stamp: a copied checkout rebuilds).  The
    compiler writes a temporary name that is then renamed, so processes
    building at once never load a half-written file.  A failed build
    raises ``RuntimeError`` with the compiler's output."""
    out = host_lib_path(name)
    stamp_path = out + ".cmd"
    src = os.path.join(HOST_CSRC, HOST_LIBS[name][0])
    stamp = " ".join(_host_command(name, out)) + "\n" + os.uname().nodename
    with _host_lock:
        try:
            with open(stamp_path) as fh:
                same = fh.read() == stamp
            if same and os.path.getmtime(out) >= os.path.getmtime(src):
                return out
        except OSError:
            pass
        os.makedirs(HOST_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = _host_command(name, tmp)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"building {out} failed ({e}); "
                               f"{HOST_LIBS[name][3]}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cmd[0]} failed for csrc/host/{HOST_LIBS[name][0]} "
                f"({HOST_LIBS[name][3]}):\n{proc.stderr}")
        os.replace(tmp, out)
        with open(f"{stamp_path}.tmp{os.getpid()}", "w") as fh:
            fh.write(stamp)
        os.replace(f"{stamp_path}.tmp{os.getpid()}", stamp_path)
        return out
