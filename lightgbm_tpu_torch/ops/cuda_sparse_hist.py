"""Kernel S1 (csrc/sparse_histogram.cu): the level histogram of a sparse
dataset on the card.

``sparse_histogram_by_leaf_cuda`` takes what ``ops/sparse_hist.csc_from_csr``
built (the CSR entries regrouped by feature, with their segment table),
checks every tensor, allocates the output and the scratch and launches
S1's kernels from one C entry on the current stream (the stored sums,
the fold, the leaf totals and the remainder).  It adds one to
``LAUNCHES`` per call.  It raises on anything the kernel does not take;
it never falls back to the plain version (ops/sparse_hist.py), which the
CPU path and the checks on the card use.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .sparse_hist import ROW_CHUNK

# calls since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0

_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    lib = _build.load("sparse_histogram")
    if not getattr(lib, "_typed", False):
        lib.lgbm_sparse_hist.restype = _I
        lib.lgbm_sparse_hist.argtypes = [
            _VP, _VP, _I, _VP, _VP, _VP, _VP, _I64, _VP, _VP, _VP, _I, _VP,
            _VP, _VP, _VP, _VP, _I64, _I, _I, _I, _VP, _VP, _VP, _VP, _VP]
        lib._typed = True
    return lib


def sparse_histogram_by_leaf_cuda(csc: dict, leaf_id: torch.Tensor,
                                  grad: torch.Tensor, hess: torch.Tensor,
                                  mask: torch.Tensor, num_leaves: int,
                                  num_bins: int) -> torch.Tensor:
    """Kernel S1: [L, F, num_bins, 3] float32 on the card."""
    global LAUNCHES
    dev = grad.device
    if dev.type != "cuda":
        raise ValueError(f"S1 needs CUDA tensors, got {dev}")
    n, F = csc["num_rows"], csc["num_features"]
    for name, t in (("grad", grad), ("hess", hess), ("mask", mask)):
        if (t.device != dev or t.dtype != torch.float32 or t.shape != (n,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [{n}] "
                             f"tensor on {dev}")
    if leaf_id.device != dev or leaf_id.shape != (n,) \
            or leaf_id.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"leaf_id must be an int32/int64 [{n}] tensor on "
                         f"{dev}")
    ebin = csc["bin"]
    if csc["row"].device != dev or ebin.dtype not in (torch.uint8,
                                                      torch.uint16):
        raise ValueError(f"the CSC entries must lie on {dev} with uint8 or "
                         "uint16 bins")
    L, B = int(num_leaves), int(num_bins)
    if L < 1 or B < 1 or L * B >= 1 << 31:
        raise ValueError(f"num_leaves={L} x num_bins={B} out of range")
    lid = leaf_id.to(torch.int32).contiguous()
    out = torch.empty((L, F, B, 3), dtype=torch.float32, device=dev)
    slabs = torch.empty((max(csc["num_slots"], 1), L, B, 3),
                        dtype=torch.float32, device=dev)
    part = torch.empty((max(1, -(-n // ROW_CHUNK)), L, 3),
                       dtype=torch.float32, device=dev)
    tot = torch.empty((L, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().lgbm_sparse_hist(
            csc["row"].data_ptr(), ebin.data_ptr(), ebin.element_size(),
            csc["seg_feat"].data_ptr(), csc["seg_begin"].data_ptr(),
            csc["seg_end"].data_ptr(), csc["seg_slot"].data_ptr(),
            csc["seg_feat"].shape[0], csc["fold_feat"].data_ptr(),
            csc["fold_slot"].data_ptr(), csc["fold_nseg"].data_ptr(),
            csc["fold_feat"].shape[0], csc["default_bins"].data_ptr(),
            lid.data_ptr(), grad.data_ptr(), hess.data_ptr(), mask.data_ptr(),
            n, L, F, B, slabs.data_ptr(), part.data_ptr(), tot.data_ptr(),
            out.data_ptr(), stream)
    _build.check(code, "sparse level histogram kernel (S1)")
    LAUNCHES += 1
    return out
