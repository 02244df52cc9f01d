"""Kernel S1 (csrc/sparse_histogram.cu): the level histogram of a sparse
dataset on the card.

``sparse_histogram_by_leaf_cuda`` takes what ``ops/sparse_hist.csc_from_csr``
built (the CSR entries regrouped by feature, with their segment table),
checks every tensor, allocates the output and the scratch and launches
S1's kernels from one C entry on the current stream (the row records and
leaf totals, the stored sums with each one-segment feature's remainder,
the fold of the others).  It adds one to ``LAUNCHES`` per call.  It
raises on anything the kernel does not take; it never falls back to the
plain version (ops/sparse_hist.py), which the CPU path and the checks on
the card use.

``leaf_tiles`` is the host's plan of a call: a block of S1 holds the
[Lt, B, 3] cells of Lt leaves in shared memory, so the leaves are cut
into the fewest tiles whose cells fit (``tile_smem``, the C entry's own
sum, which checks it again).  A set whose one leaf does not fit
(``MAX_BINS``) grows on the dense level route (``GBDT._level_hist_fn``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .sparse_hist import ROW_CHUNK

# calls since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0

# csrc/sparse_histogram.cu: shared memory a block may use (227 KB on the
# H100), entries bucketed a chunk and the threads (owners) of a block
SMEM_MAX = 232_448
_CHUNK, _THREADS = 1024, 256


def tile_smem(tile_leaves: int, num_bins: int) -> int:
    """Shared memory bytes of an S1 block over ``tile_leaves`` leaves:
    the cells (padded to 16 bytes), the bucketed chunk (a key and three
    stats an entry), the count table and the scan's warp totals."""
    cells = (tile_leaves * num_bins * 3 + 3) // 4 * 4
    warps = _THREADS // 32
    return 4 * cells + 16 * _CHUNK + 4 * (warps * _THREADS + warps)


# the most bins one leaf may have: its cells and the rest of a block fit
# SMEM_MAX (17,319)
MAX_BINS = (SMEM_MAX - tile_smem(0, 1) - 12) // 12


def leaf_tiles(num_leaves: int, num_bins: int) -> tuple:
    """(leaves a tile, tiles): the fewest tiles of equal size whose
    blocks fit in SMEM_MAX bytes; tile t holds leaves [t·Lt, min(L, t·Lt
    + Lt)).  Raises when one leaf's bins do not fit (more than
    MAX_BINS)."""
    L, B = int(num_leaves), int(num_bins)
    most = (SMEM_MAX - tile_smem(0, B) - 12) // (12 * B)
    if most < 1:
        raise ValueError(f"S1 holds a leaf's {B} bins in shared memory: "
                         f"at most {MAX_BINS} bins")
    tiles = -(-L // min(most, L))
    lt = -(-L // tiles)
    return lt, -(-L // lt)


_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    lib = _build.load("sparse_histogram")
    if not getattr(lib, "_typed", False):
        lib.lgbm_sparse_hist.restype = _I
        lib.lgbm_sparse_hist.argtypes = [
            _VP, _VP, _I, _VP, _VP, _VP, _VP, _I64, _VP, _VP, _VP, _I, _VP,
            _VP, _VP, _VP, _VP, _I64, _I, _I, _I, _I, _VP, _VP, _VP, _VP,
            _VP, _VP]
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
    lt = leaf_tiles(L, B)[0]
    lid = leaf_id.to(torch.int32).contiguous()
    out = torch.empty((L, F, B, 3), dtype=torch.float32, device=dev)
    rec = torch.empty((max(n, 1), 4), dtype=torch.float32, device=dev)
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
            n, L, F, B, lt, rec.data_ptr(), slabs.data_ptr(),
            part.data_ptr(), tot.data_ptr(), out.data_ptr(), stream)
    _build.check(code, "sparse level histogram kernel (S1)")
    LAUNCHES += 1
    return out
