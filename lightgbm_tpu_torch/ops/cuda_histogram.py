"""Single-row-set histogram: the CUDA kernel and its dispatch.

Counterpart of lightgbm_tpu/ops/pallas_histogram.py
``histogram_single_leaf``: ``hist[F, num_bins, 3]`` = (Σ g·m, Σ h·m, Σ m)
over the ``cap`` rows of ``bins_T [F, cap]``.  On a CUDA tensor it
launches kernel 1 (csrc/histogram.cu, which says what it replaces, its
bound and its design) and adds one to ``LAUNCHES``; on a CPU tensor it
returns the plain version (ops/histogram.py).  Nothing else selects
between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .histogram import CHUNK_ROWS, histogram_feature_major

# kernel launches since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0

_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    lib = _build.load("histogram")
    if not getattr(lib, "_typed", False):
        lib.lgbm_hist_single_leaf.restype = _I
        lib.lgbm_hist_single_leaf.argtypes = [
            _VP, _I, _VP, _VP, _VP, _I, _I64, _I, _VP, _VP, _VP]
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
    lib = _lib()
    nchunks = (cap + CHUNK_ROWS - 1) // CHUNK_ROWS
    out = torch.empty((F, num_bins, 3), dtype=torch.float32, device=dev)
    partial = torch.empty((nchunks, F, num_bins, 3), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lgbm_hist_single_leaf(
            bins_T.data_ptr(), bin_bytes, grad.data_ptr(), hess.data_ptr(),
            mask.data_ptr(), F, cap, num_bins, partial.data_ptr(),
            out.data_ptr(), stream)
    _build.check(code, "histogram kernel")
    LAUNCHES += 1
    return out
