"""Single-row-set histograms: the CUDA kernels and their dispatch.

Counterpart of lightgbm_tpu/ops/pallas_histogram.py
``histogram_single_leaf``: ``hist[F, num_bins, 3]`` = (Σ g·m, Σ h·m, Σ m)
over the ``cap`` rows of ``bins_T [F, cap]``.  On a CUDA tensor it
launches kernel 1 (csrc/histogram.cu, which says what it replaces, its
bound and its design) and adds one to ``LAUNCHES``; on a CPU tensor it
returns the plain version (ops/histogram.py).  Nothing else selects
between the two.

``histogram_record_window`` is the same for a window of the packed record
(the counterpart of ``histogram_single_leaf_raw`` on ``unpack_window``):
kernel 1' on a CUDA record, counted in ``RECORD_LAUNCHES``, the plain
version on a CPU one.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import histogram as plain
from .histogram import CHUNK_ROWS, histogram_feature_major
from .record import rec_height

# kernel launches since the last reset (chip_smoke.py reads and resets them)
LAUNCHES = 0  # kernel 1
RECORD_LAUNCHES = 0  # kernel 1'

_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    lib = _build.load("histogram")
    if not getattr(lib, "_typed", False):
        lib.lgbm_hist_single_leaf.restype = _I
        lib.lgbm_hist_single_leaf.argtypes = [
            _VP, _I, _VP, _VP, _VP, _I, _I64, _I, _VP, _VP, _VP]
        lib.lgbm_hist_record_window.restype = _I
        lib.lgbm_hist_record_window.argtypes = [
            _VP, _I64, _I64, _I64, _I, _I, _I, _VP, _VP, _VP]
        lib.lgbm_hist_chunk_rows.restype = _I
        lib.lgbm_hist_chunk_rows.argtypes = []
        if lib.lgbm_hist_chunk_rows() != CHUNK_ROWS:
            raise RuntimeError("csrc/histogram.cu kChunk differs from "
                               "ops/histogram.py CHUNK_ROWS")
        lib._typed = True
    return lib


def histogram_single_leaf(bins_T: torch.Tensor, grad: torch.Tensor,
                          hess: torch.Tensor, mask: torch.Tensor,
                          num_bins: int) -> torch.Tensor:
    """``bins_T`` [F, cap] uint8/uint16; ``grad``/``hess``/``mask`` [cap]
    float32.  Returns [F, num_bins, 3] float32."""
    if bins_T.device.type == "cpu":
        return histogram_feature_major(bins_T, grad, hess, mask, num_bins)
    return histogram_single_leaf_cuda(bins_T, grad, hess, mask, num_bins)


def histogram_single_leaf_cuda(bins_T, grad, hess, mask, num_bins):
    """Kernel 1 on the card (raises on anything it does not take)."""
    global LAUNCHES
    if bins_T.device.type != "cuda":
        raise ValueError(f"bins_T must be a CUDA tensor, got {bins_T.device}")
    if bins_T.dim() != 2:
        raise ValueError(f"bins_T must be [F, cap], got {tuple(bins_T.shape)}")
    F, cap = bins_T.shape
    bin_bytes = {torch.uint8: 1, torch.uint16: 2}.get(bins_T.dtype)
    if bin_bytes is None:
        raise TypeError(f"bins_T must be uint8 or uint16, got {bins_T.dtype}")
    dev = bins_T.device
    for name, t in (("grad", grad), ("hess", hess), ("mask", mask)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, bins_T on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.shape != (cap,):
            raise ValueError(f"{name} must be [{cap}], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not bins_T.is_contiguous():
        raise ValueError("bins_T must be contiguous")
    if num_bins < 1:
        raise ValueError("num_bins must be >= 1")
    out = _launch(_lib().lgbm_hist_single_leaf, "histogram kernel",
                  bins_T.device, F, cap, num_bins, bins_T.data_ptr(),
                  bin_bytes, grad.data_ptr(), hess.data_ptr(),
                  mask.data_ptr(), F, cap, num_bins)
    LAUNCHES += 1
    return out


def _launch(entry, what, dev, F, cnt, num_bins, *args):
    """Allocate the output and the per-chunk scratch, call the C entry on
    the current stream (``args`` then the two buffers and the stream) and
    raise on a launch error.  Returns the [F, num_bins, 3] output."""
    nchunks = (cnt + CHUNK_ROWS - 1) // CHUNK_ROWS
    out = torch.empty((F, num_bins, 3), dtype=torch.float32, device=dev)
    partial = torch.empty((nchunks, F, num_bins, 3), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = entry(*args, partial.data_ptr(), out.data_ptr(), stream)
    _build.check(code, what)
    return out


def histogram_record_window(rec: torch.Tensor, begin: int, cnt: int, F: int,
                            k: int, num_bins: int) -> torch.Tensor:
    """Columns ``[begin, begin+cnt)`` of the ``[W, n]`` int32 record
    (ops/record.py, ``k`` bins per word).  Returns [F, num_bins, 3]
    float32."""
    if rec.device.type == "cpu":
        return plain.histogram_record_window(rec, begin, cnt, F, k, num_bins)
    return histogram_record_window_cuda(rec, begin, cnt, F, k, num_bins)


def histogram_record_window_cuda(rec, begin, cnt, F, k, num_bins):
    """Kernel 1' on the card (raises on anything it does not take)."""
    global RECORD_LAUNCHES
    if rec.device.type != "cuda":
        raise ValueError(f"rec must be a CUDA tensor, got {rec.device}")
    if rec.dtype != torch.int32 or rec.dim() != 2 or not rec.is_contiguous():
        raise ValueError("rec must be a contiguous [W, n] int32 tensor")
    if k not in (2, 4):
        raise ValueError(f"k must be 2 or 4 bins per word, got {k}")
    W, n = rec.shape
    if W != rec_height(F, k):
        raise ValueError(f"a record of {F} features at {k} per word has "
                         f"{rec_height(F, k)} rows, got {W}")
    if begin < 0 or cnt < 0 or begin + cnt > n:
        raise ValueError(f"window [{begin}, {begin + cnt}) is outside "
                         f"[0, {n})")
    if num_bins < 1:
        raise ValueError("num_bins must be >= 1")
    out = _launch(_lib().lgbm_hist_record_window, "record histogram kernel",
                  rec.device, F, cnt, num_bins, rec.data_ptr(), n, begin, cnt,
                  F, k, num_bins)
    RECORD_LAUNCHES += 1
    return out
