"""ctypes bindings of the port's native reader.

Counterpart of lightgbm_tpu/native.py over ``csrc/host/lgbm_native.cpp``:
an OpenMP text parser (CSV, TSV, blank separated and LibSVM, the rows
parsed in parallel), its chunked reader for streamed loads, and the value
-> bin encoder of numerical features.  ``ops/_build.build_host`` builds
the library into ``build/native/`` at first use.

The parser accepts a file only where its matrix is bitwise the numpy
parser's (``io/parser.py``; the rules head the C++ source).  On any other
file it raises :class:`Refused`, and ``io/parser.py`` hands the file to
the numpy parser, counting the hand-off (telemetry ``native_fallbacks``).
Unlike the JAX package there is no quiet fallback: a failed build raises,
and ``LIGHTGBM_TPU_NO_NATIVE=1`` (read at each call) is the one way to
parse and encode with numpy alone.  Every parallel loop runs
``os.cpu_count()`` threads.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, List, Optional

import numpy as np

from .analysis import lockcheck
from .ops import _build

_lock = lockcheck.make_lock("native.load")
_lib: Optional[ctypes.CDLL] = None

_FMT = {"csv": 1, "tsv": 2}
_REASONS = {
    1: "the file cannot be read whole",
    3: "the first data row has no fields",
    4: "out of memory",
    5: "a row or byte outside the exact grammar, or a malformed row",
}

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
_LONG_P = ctypes.POINTER(ctypes.c_long)


class Refused(ValueError):
    """The native reader does not accept the file (or a chunk of it); the
    numpy parser reads it."""


def enabled() -> bool:
    """False under ``LIGHTGBM_TPU_NO_NATIVE`` (the JAX package's switch)."""
    return not os.environ.get("LIGHTGBM_TPU_NO_NATIVE")


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build.build_host("native"))
        lib.lgbm_parse_delimited.restype = ctypes.c_int
        lib.lgbm_parse_delimited.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(_DOUBLE_P), _LONG_P, _LONG_P]
        lib.lgbm_parse_libsvm.restype = ctypes.c_int
        lib.lgbm_parse_libsvm.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_DOUBLE_P),
            _LONG_P, _LONG_P]
        lib.lgbm_detect_format.restype = ctypes.c_int
        lib.lgbm_detect_format.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.lgbm_value_to_bin.restype = None
        lib.lgbm_value_to_bin.argtypes = [
            _DOUBLE_P, ctypes.c_long, ctypes.c_long, _LONG_P, ctypes.c_long,
            _DOUBLE_P, _LONG_P, ctypes.c_void_p, ctypes.c_int]
        lib.lgbm_free.restype = None
        lib.lgbm_free.argtypes = [ctypes.c_void_p]
        lib.lgbm_chunk_open.restype = ctypes.c_void_p
        lib.lgbm_chunk_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, _LONG_P]
        lib.lgbm_chunk_next.restype = ctypes.c_long
        lib.lgbm_chunk_next.argtypes = [ctypes.c_void_p, _DOUBLE_P,
                                        ctypes.c_long]
        lib.lgbm_chunk_close.restype = None
        lib.lgbm_chunk_close.argtypes = [ctypes.c_void_p]
        lib.lgbm_num_threads.restype = ctypes.c_int
        lib.lgbm_num_threads.argtypes = []
        lib.lgbm_set_num_threads.restype = None
        lib.lgbm_set_num_threads.argtypes = [ctypes.c_int]
        lib.lgbm_set_num_threads(os.cpu_count() or 1)
        _lib = lib
        return lib


def available() -> bool:
    """True unless ``LIGHTGBM_TPU_NO_NATIVE`` is set; builds the library
    (raising if that fails)."""
    return enabled() and _load() is not None


def num_threads() -> int:
    """The threads of the reader's parallel loops."""
    return int(_load().lgbm_num_threads())


def detect_format(path: str, skip_header: bool) -> Optional[str]:
    """'csv', 'tsv' or 'libsvm' from the first data lines, as
    ``io/parser.detect_format`` decides; None when unreadable."""
    code = _load().lgbm_detect_format(path.encode(), int(skip_header))
    return {1: "csv", 2: "tsv", 3: "libsvm"}.get(code)


def parse_file(path: str, fmt: str, skip_header: bool) -> np.ndarray:
    """The whole file as a float64 ``[rows, cols]`` matrix (``[0, 0]``
    without data lines); LibSVM with the label in column 0.  Raises
    :class:`Refused`."""
    lib = _load()
    data = _DOUBLE_P()
    rows, cols = ctypes.c_long(), ctypes.c_long()
    out = (ctypes.byref(data), ctypes.byref(rows), ctypes.byref(cols))
    if fmt == "libsvm":
        rc = lib.lgbm_parse_libsvm(path.encode(), int(skip_header), *out)
    else:
        rc = lib.lgbm_parse_delimited(path.encode(), _FMT[fmt],
                                      int(skip_header), *out)
    if rc != 0:
        raise Refused(_REASONS.get(rc, f"code {rc}"))
    n, f = rows.value, cols.value
    if n == 0:
        return np.empty((0, 0))
    try:
        return np.ctypeslib.as_array(data, shape=(n, f)).copy()
    finally:
        lib.lgbm_free(data)


def parse_file_chunks(path: str, fmt: str, skip_header: bool,
                      chunk_rows: int) -> Iterator[np.ndarray]:
    """float64 chunks of ``chunk_rows`` data rows of a CSV / TSV file (the
    last one shorter).  Raises :class:`Refused` when the reader refuses
    the file at its first line or a chunk mid-stream: the chunks yielded
    before stand, and the rows after them are for the numpy parser."""
    lib = _load()
    cols = ctypes.c_long()
    handle = lib.lgbm_chunk_open(path.encode(), _FMT[fmt], int(skip_header),
                                 ctypes.byref(cols))
    if not handle:
        raise Refused("the file cannot be opened, or its header holds a "
                      "lone carriage return")
    try:
        while cols.value > 0:
            buf = np.empty((chunk_rows, cols.value), np.float64)
            got = lib.lgbm_chunk_next(handle, buf.ctypes.data_as(_DOUBLE_P),
                                      chunk_rows)
            if got < 0:
                raise Refused(_REASONS[5])
            if got == 0:
                return
            yield buf[:got]
    finally:
        lib.lgbm_chunk_close(handle)


def value_to_bin_numerical(X: np.ndarray, col_idx: np.ndarray,
                           bounds_list: List[np.ndarray],
                           out: np.ndarray) -> bool:
    """``out[:, j] = BinMapper.value_to_bin(X[:, col_idx[j]])`` for
    numerical features, feature j's upper bounds ``bounds_list[j]``: ``X``
    a C-contiguous float64 ``[n, f]`` matrix, ``out`` a C-contiguous
    uint8 / uint16 ``[n, len(col_idx)]`` one.  Returns True."""
    col_idx = np.ascontiguousarray(col_idx, np.int64)
    if (X.dtype != np.float64 or not X.flags.c_contiguous or X.ndim != 2
            or out.dtype not in (np.uint8, np.uint16)
            or not out.flags.c_contiguous
            or out.shape != (X.shape[0], len(col_idx))
            or len(bounds_list) != len(col_idx)
            or (len(col_idx) and (col_idx.min() < 0
                                  or col_idx.max() >= X.shape[1]))
            or any(len(b) == 0 for b in bounds_list)):
        raise ValueError("value_to_bin_numerical: X must be C-contiguous "
                         "float64 [n, f], out C-contiguous uint8/uint16 "
                         "[n, len(col_idx)], one non-empty bound array a "
                         "column, columns within X")
    offsets = np.zeros(len(bounds_list) + 1, np.int64)
    offsets[1:] = np.cumsum([len(b) for b in bounds_list])
    bounds = np.ascontiguousarray(
        np.concatenate(bounds_list) if bounds_list else np.zeros(0),
        np.float64)
    _load().lgbm_value_to_bin(
        X.ctypes.data_as(_DOUBLE_P), X.shape[0], X.shape[1],
        col_idx.ctypes.data_as(_LONG_P), len(col_idx),
        bounds.ctypes.data_as(_DOUBLE_P), offsets.ctypes.data_as(_LONG_P),
        out.ctypes.data_as(ctypes.c_void_p), int(out.dtype == np.uint16))
    return True
