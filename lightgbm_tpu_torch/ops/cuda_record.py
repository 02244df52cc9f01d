"""The record's CUDA kernels: K6 (compact), K7 (place) and K9 (write).

Counterparts of lightgbm_tpu/ops/record.py ``partition_window``'s
compaction kernel and ``place_runs``.  On a CUDA record
``ops/record.partition_window`` runs them in turn: K6 compacts the
window's tiles into ``comp`` (every row but the leaf id) and writes the
per-tile counts, and K7 turns the counts into run offsets and the left
total itself (the JAX package computes them in XLA outside its kernels),
copies the runs back into the record at their offsets and stamps the
child ids, so nothing else is launched between the two.  K7 also places
K8's output on the mega route (``ops/record.place_window``).  K9 writes a
window back into the record (``ops/record.write_window``, the counterpart
of ``write_window``; no learner calls it).  Each wrapper adds one to its
launch count when it launches its kernel (csrc/record.cu says what they
replace, their bound and their design).  The plain versions are in
ops/record.py.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import _build
from .record import TILE

# kernel launches since the last reset (chip_smoke.py reads and resets them)
COMPACT_LAUNCHES = 0
PLACE_LAUNCHES = 0
WRITE_LAUNCHES = 0

_VP, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_I64 = ctypes.c_int64


def _lib():
    lib = _build.load("record")
    if not getattr(lib, "_typed", False):
        lib.lgbm_record_tile.restype = _I
        lib.lgbm_record_tile.argtypes = []
        lib.lgbm_record_compact.restype = _I
        lib.lgbm_record_compact.argtypes = [
            _VP, _I64, _I, _I64, _I64, _I, _I, _U, _I, _I, _VP, _VP, _VP]
        lib.lgbm_record_place.restype = _I
        lib.lgbm_record_place.argtypes = [
            _VP, _VP, _I64, _VP, _I64, _I, _I64, _I, _I, _VP, _VP]
        lib.lgbm_record_grids.restype = _I
        lib.lgbm_record_grids.argtypes = [_I64, _I, _VP]
        lib.lgbm_record_write.restype = _I
        lib.lgbm_record_write.argtypes = [_VP, _I64, _I, _VP, _I64, _I64,
                                          _VP]
        if lib.lgbm_record_tile() != TILE:
            raise RuntimeError("csrc/record.cu kTile differs from "
                               "ops/record.py TILE")
        lib._typed = True
    return lib


def _check_record(rec: torch.Tensor, begin: int, pcnt: int,
                  min_rows: int = 6) -> None:
    if rec.device.type != "cuda":
        raise ValueError(f"rec must be a CUDA tensor, got {rec.device}")
    if rec.dtype != torch.int32 or rec.dim() != 2 or not rec.is_contiguous():
        raise ValueError("rec must be a contiguous [W, n] int32 tensor")
    if rec.shape[0] < min_rows:
        raise ValueError(f"rec has {rec.shape[0]} rows; this kernel takes "
                         f">= {min_rows}")
    if begin < 0 or pcnt < 0 or begin + pcnt > rec.shape[1]:
        raise ValueError(f"window [{begin}, {begin + pcnt}) is outside "
                         f"[0, {rec.shape[1]})")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _on(dev):
    """``dev`` made current for a launch; nothing to do (and no host time
    spent) when it already is."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def compact_cuda(rec: torch.Tensor, f: int, thr: int, is_cat: bool,
                 begin: int, pcnt: int, k: int):
    """K6 over window ``[begin, begin+pcnt)``: (comp [nt, W-1, 2*TILE],
    counts [2, nt] int32 = (cl, cr)).  Lanes past a run's count are
    left unwritten."""
    global COMPACT_LAUNCHES
    _check_record(rec, begin, pcnt)
    if k not in (2, 4):
        raise ValueError(f"k must be 2 or 4 bins per word, got {k}")
    W, n = rec.shape
    if not 0 <= f < (W - 5) * k:
        raise ValueError(f"feature {f} is not in the record's {W - 5} words")
    shift = 32 // k
    nt = -(-pcnt // TILE)
    dev = rec.device
    comp = torch.empty((nt, W - 1, 2 * TILE), dtype=torch.int32,
                       device=dev)
    counts = torch.empty((2, nt), dtype=torch.int32, device=dev)
    lib = _lib()
    with _on(dev):
        code = lib.lgbm_record_compact(
            rec.data_ptr(), n, W, begin, pcnt, f // k, (f % k) * shift,
            (1 << shift) - 1, int(thr), int(bool(is_cat)), comp.data_ptr(),
            counts.data_ptr(), _stream(dev))
    _build.check(code, "record compact kernel")
    if nt:
        COMPACT_LAUNCHES += 1
    return comp, counts


def place_cuda(rec: torch.Tensor, comp: torch.Tensor, counts: torch.Tensor,
               begin: int, pcnt: int, left_leaf: int,
               right_leaf: int) -> torch.Tensor:
    """K7: the runs of ``comp`` (K6's or K8's output for window
    ``[begin, begin+pcnt)``) back into that window of ``rec``, in place,
    with the child ids in the leaf-id row.  Returns nleft, a 0-d int32
    tensor on the card that the kernel writes; nothing but K7 is
    launched."""
    global PLACE_LAUNCHES
    _check_record(rec, begin, pcnt)
    W, n = rec.shape
    nt = -(-pcnt // TILE)
    if comp.dtype != torch.int32 or comp.shape != (nt, W - 1, 2 * TILE) \
            or comp.device != rec.device or not comp.is_contiguous():
        raise ValueError(f"comp must be a contiguous [{nt}, {W - 1}, "
                         f"{2 * TILE}] int32 tensor on {rec.device}")
    if counts.dtype != torch.int32 or counts.shape != (2, nt) \
            or counts.device != rec.device or not counts.is_contiguous():
        raise ValueError(f"counts must be a contiguous [2, {nt}] int32 tensor")
    if not nt:  # an empty window: nothing to place
        return torch.zeros((), dtype=torch.int32, device=rec.device)
    nleft = torch.empty((), dtype=torch.int32, device=rec.device)
    lib = _lib()
    with _on(rec.device):
        code = lib.lgbm_record_place(
            comp.data_ptr(), counts.data_ptr(), nt, rec.data_ptr(), n, W,
            begin, int(left_leaf), int(right_leaf), nleft.data_ptr(),
            _stream(rec.device))
    _build.check(code, "record place kernel")
    PLACE_LAUNCHES += 1
    return nleft


def grids(nt: int, W: int, dev) -> dict:
    """K6's and K7's grids for a window of ``nt`` tiles of a ``W``-row
    record on CUDA device ``dev``: blocks over the tiles, rows a block
    (the rows are split over a second grid dimension when the tiles give
    few blocks) and tiles a block."""
    out = (ctypes.c_int64 * 6)()
    with _on(torch.device(dev)):
        if _lib().lgbm_record_grids(nt, W, out):
            raise ValueError(f"no grid for {nt} tiles")
    return {"K6 tiles a block": out[0], "K6 blocks": out[1],
            "K6 rows a block": out[2], "K7 tiles a block": out[3],
            "K7 blocks": out[4], "K7 rows a block": out[5]}


def write_window_cuda(rec: torch.Tensor, out_win: torch.Tensor,
                      begin: int) -> None:
    """K9: ``rec[:, begin:begin+cap] = out_win`` in place, ``begin``
    already placed in ``[0, n - cap]`` (ops/record.write_window)."""
    global WRITE_LAUNCHES
    W, cap = out_win.shape
    # any [W, n] int32 record, as the plain version takes
    _check_record(rec, begin, cap, min_rows=1)
    dev = rec.device
    if W > 65535:
        raise ValueError(f"the write-back kernel takes at most 65535 rows, "
                         f"got {W}")
    if out_win.dtype != torch.int32 or out_win.device != dev \
            or not out_win.is_contiguous() or W != rec.shape[0]:
        raise ValueError(f"out_win must be a contiguous [{rec.shape[0]}, cap] "
                         f"int32 tensor on {dev}")
    lib = _lib()
    with _on(dev):
        code = lib.lgbm_record_write(out_win.data_ptr(), cap, W,
                                     rec.data_ptr(), rec.shape[1], begin,
                                     _stream(dev))
    _build.check(code, "record write kernel")
    if cap:
        WRITE_LAUNCHES += 1
