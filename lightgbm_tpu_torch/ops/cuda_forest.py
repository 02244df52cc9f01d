"""The forest's lane functions: CUDA kernels F1 and F3 and their dispatch.

``forest_histogram`` is every lane's histogram of the rows of one leaf
(``leaf_id[b] == target[b]``; ``target[b] == -1`` idles lane b): kernel F1
(csrc/forest.cu, which says what it replaces, its bound and its design)
on CUDA tensors, counted in ``LAUNCHES``; the plain version
(ops/forest.py) on CPU tensors.  ``forest_search`` is both children's
best split for every lane under the lane's own feature mask and scalars:
kernel F3 on CUDA tensors (``SEARCH_LAUNCHES``), the plain version on CPU
ones.  Both are bitwise their plain versions, which are the order route's
kernel 1 and kernel 3 lane by lane.  Nothing else selects between kernel
and plain version: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from . import forest as plain
from .histogram import CHUNK_ROWS

# kernel launches since the last reset (chip_smoke.py reads and resets them)
LAUNCHES = 0  # F1
SEARCH_LAUNCHES = 0  # F3

_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_PER_FEATURE = 8  # values of one (child, feature) best (csrc kPerFeature)


def _lib():
    lib = _build.load("forest")
    if not getattr(lib, "_typed", False):
        lib.lgbm_forest_hist.restype = _I
        lib.lgbm_forest_hist.argtypes = [
            _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _I64, _I, _I, _I, _VP, _VP,
            _VP, _VP, _VP]
        lib.lgbm_forest_search.restype = _I
        lib.lgbm_forest_search.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I,
                                           _VP, _VP, _VP]
        lib.lgbm_forest_chunk_rows.restype = _I
        lib.lgbm_forest_chunk_rows.argtypes = []
        if lib.lgbm_forest_chunk_rows() != CHUNK_ROWS:
            raise RuntimeError("csrc/forest.cu kChunk differs from "
                               "ops/histogram.py CHUNK_ROWS")
        lib._typed = True
    return lib


def forest_histogram(bins_T: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, mask: torch.Tensor,
                     leaf_id: torch.Tensor, target: torch.Tensor,
                     num_bins: int, max_rows: Optional[int] = None
                     ) -> torch.Tensor:
    """[B, F, num_bins, 3] float32: lane b's histogram over its rows with
    ``leaf_id[b] == target[b]``.  ``max_rows`` (default n) bounds any
    lane's rows and sizes F1's scratch."""
    if bins_T.device.type == "cpu":
        return plain.forest_histogram_plain(bins_T, grad, hess, mask,
                                            leaf_id, target, num_bins,
                                            max_rows)
    return forest_histogram_cuda(bins_T, grad, hess, mask, leaf_id, target,
                                 num_bins, max_rows)


def _check_lanes(bins_T, grad, hess, mask, leaf_id, target):
    """Returns (B, F, n, bytes per bin) or raises."""
    if bins_T.device.type != "cuda":
        raise ValueError(f"bins_T must be a CUDA tensor, got {bins_T.device}")
    bin_bytes = {torch.uint8: 1, torch.uint16: 2}.get(bins_T.dtype)
    if bin_bytes is None or bins_T.dim() != 2 or not bins_T.is_contiguous():
        raise ValueError("bins_T must be a contiguous [F, n] uint8/uint16 "
                         "tensor")
    F, n = bins_T.shape
    dev = bins_T.device
    B = grad.shape[0] if grad.dim() == 2 else -1
    for name, t, dt in (("grad", grad, torch.float32),
                        ("hess", hess, torch.float32),
                        ("mask", mask, torch.float32),
                        ("leaf_id", leaf_id, torch.int32)):
        if t.device != dev or t.dtype != dt or t.shape != (B, n) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B, {n}] {dt} "
                             f"tensor on {dev}")
    if (target.device != dev or target.dtype != torch.int32
            or target.shape != (B,) or not target.is_contiguous()):
        raise ValueError(f"target must be a contiguous [{B}] int32 tensor "
                         f"on {dev}")
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows: F1 counts rows in int32")
    return B, F, n, bin_bytes


def forest_histogram_cuda(bins_T, grad, hess, mask, leaf_id, target,
                          num_bins, max_rows=None):
    """Kernel F1 on the card (raises on anything it does not take)."""
    global LAUNCHES
    B, F, n, bin_bytes = _check_lanes(bins_T, grad, hess, mask, leaf_id,
                                      target)
    if num_bins < 1:
        raise ValueError("num_bins must be >= 1")
    rows = n if max_rows is None else max(0, min(int(max_rows), n))
    cap = B * -(-rows // CHUNK_ROWS)
    ntiles = -(-n // CHUNK_ROWS)
    dev = bins_T.device
    work = torch.empty(2 * B * ntiles + 2 * B + 1, dtype=torch.int32,
                       device=dev)
    order = torch.empty(max(cap * CHUNK_ROWS, 1), dtype=torch.int64,
                        device=dev)
    partial = torch.empty((max(cap, 1), F, num_bins, 3), dtype=torch.float32,
                          device=dev)
    out = torch.empty((B, F, num_bins, 3), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().lgbm_forest_hist(
            bins_T.data_ptr(), bin_bytes, grad.data_ptr(), hess.data_ptr(),
            mask.data_ptr(), leaf_id.data_ptr(), target.data_ptr(), B, n, F,
            num_bins, cap, work.data_ptr(), order.data_ptr(),
            partial.data_ptr(), out.data_ptr(), stream)
    _build.check(code, "forest histogram kernel (F1)")
    LAUNCHES += 1
    return out


def forest_search(h_left: torch.Tensor, h_right: torch.Tensor,
                  meta: torch.Tensor, scal: torch.Tensor) -> torch.Tensor:
    """[A, 2, 16]: every lane's two children's best splits (kernel 3's
    rows) from ``h_left``/``h_right`` [A, F, nb, 3] float32, ``meta`` [A,
    F, 4] int32 and ``scal`` [A, 12] float32."""
    if h_left.device.type == "cpu":
        return plain.forest_search_plain(h_left, h_right, meta, scal)
    return forest_search_cuda(h_left, h_right, meta, scal)


def forest_search_cuda(h_left, h_right, meta, scal):
    """Kernel F3 on the card (raises on anything it does not take)."""
    global SEARCH_LAUNCHES
    if h_left.dim() != 4 or h_left.shape[3] != 3 \
            or h_right.shape != h_left.shape:
        raise ValueError(f"histograms must both be [A, F, nb, 3], got "
                         f"{tuple(h_left.shape)} and {tuple(h_right.shape)}")
    A, F, nb, _ = h_left.shape
    dev = h_left.device
    for name, t, dt, shape in (("h_left", h_left, torch.float32, None),
                               ("h_right", h_right, torch.float32, None),
                               ("meta", meta, torch.int32, (A, F, 4)),
                               ("scal", scal, torch.float32, (A, 12))):
        if (t.device.type != "cuda" or t.device != dev or t.dtype != dt
                or not t.is_contiguous()
                or (shape is not None and t.shape != shape)):
            raise ValueError(f"{name} must be a contiguous {dt} CUDA tensor "
                             f"on {dev}" + (f" of shape {shape}"
                                            if shape else ""))
    out = torch.empty((A, 2, 16), dtype=torch.float32, device=dev)
    if A == 0:
        return out
    best = torch.empty(max(A * 2 * F * _PER_FEATURE, 1), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().lgbm_forest_search(
            h_left.data_ptr(), h_right.data_ptr(), meta.data_ptr(),
            scal.data_ptr(), A, F, nb, best.data_ptr(), out.data_ptr(),
            stream)
    _build.check(code, "forest search kernel (F3)")
    SEARCH_LAUNCHES += 1
    return out
