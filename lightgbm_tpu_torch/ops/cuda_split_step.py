"""The mega route's split step: CUDA kernel K8.

Counterpart of lightgbm_tpu/ops/record.py ``split_step_window(...,
return_comp=True)``.  ``split_step_cuda`` is what ``ops/record.split_step``
runs on a CUDA record: one launch of K8 (csrc/split_step.cu, which says
what it replaces, its bound and its design) computes the go flags, the
window's compacted tiles ``comp`` and their counts, the left child's
histogram, both buffer rows in place and both children's [2, 16] search
rows, with the left count in ``rows[0, 11]``.  K7 (ops/cuda_record.py)
then places ``comp`` into the record.  The wrapper adds one to
``LAUNCHES`` when it launches the kernel.  The plain version is
``ops/record.split_step_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from . import _build
from .histogram import CHUNK_ROWS
from .record import TILE, rec_height

# kernel launches since the last reset (chip_smoke.py reads and resets them)
LAUNCHES = 0

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_I64 = ctypes.c_int64

# the grid barrier's two words per (device, stream); each launch leaves
# its ticket at zero, so one zeroed buffer serves every launch in order
_BARRIERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _lib():
    lib = _build.load("split_step")
    if not getattr(lib, "_typed", False):
        lib.lgbm_split_step.restype = _I
        lib.lgbm_split_step.argtypes = (
            [_VP, _I64, _I, _I64, _I64, _I, _I, _I, _I, _I, _I, _VP, _I, _I,
             _VP] + [_F] * 12 + [_VP, _VP, _VP, _VP, _VP, _VP])
        lib.lgbm_split_step_grid.restype = _I
        lib.lgbm_split_step_grid.argtypes = [_I64, _I, _I]
        lib._typed = True
    return lib


def grid_blocks(pcnt: int, F: int, num_bins: int) -> int:
    """Blocks of K8's cooperative grid for a ``pcnt``-column window of F
    features and ``num_bins`` bins (on the current CUDA device)."""
    return _lib().lgbm_split_step_grid(pcnt, F, num_bins)


def _barrier(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    bar = _BARRIERS.get(key)
    if bar is None:
        bar = torch.zeros(2, dtype=torch.int32, device=dev)
        _BARRIERS[key] = bar
    return bar


def split_step_cuda(rec: torch.Tensor, hists: torch.Tensor, f: int, thr: int,
                    is_cat: bool, begin: int, pcnt: int, parent: int,
                    new_leaf: int, scal: Sequence[float], meta: torch.Tensor,
                    k: int, num_bins: int):
    """K8 on the card (raises on anything it does not take).  Returns
    (comp [nt, W-1, 2*TILE] int32, counts [2, nt] int32, rows [2, 16]
    float32); ``hists`` rows ``parent`` and ``new_leaf`` are updated in
    place.  Lanes of ``comp`` past a run's count are left unwritten."""
    global LAUNCHES
    if rec.device.type != "cuda":
        raise ValueError(f"rec must be a CUDA tensor, got {rec.device}")
    if rec.dtype != torch.int32 or rec.dim() != 2 or not rec.is_contiguous():
        raise ValueError("rec must be a contiguous [W, n] int32 tensor")
    if k not in (2, 4):
        raise ValueError(f"k must be 2 or 4 bins per word, got {k}")
    if hists.dim() != 4 or hists.shape[3] != 3 \
            or hists.shape[2] != num_bins:
        raise ValueError(f"hists must be [L, F, {num_bins}, 3], got "
                         f"{tuple(hists.shape)}")
    L, F = hists.shape[:2]
    W, n = rec.shape
    if W != rec_height(F, k):
        raise ValueError(f"a record of {F} features at {k} per word has "
                         f"{rec_height(F, k)} rows, got {W}")
    if hists.dtype != torch.float32 or hists.device != rec.device \
            or not hists.is_contiguous():
        raise ValueError(f"hists must be a contiguous float32 tensor on "
                         f"{rec.device}")
    if (meta.dtype != torch.int32 or meta.shape != (F, 4)
            or meta.device != rec.device or not meta.is_contiguous()):
        raise ValueError(f"meta must be a contiguous [{F}, 4] int32 tensor "
                         f"on {rec.device}")
    if not 0 <= f < F:
        raise ValueError(f"feature {f} is not one of the {F} features")
    if not (0 <= parent < L and 0 <= new_leaf < L and parent != new_leaf):
        raise ValueError(f"rows {parent} and {new_leaf} must be distinct "
                         f"rows of the {L}-row buffer")
    if begin < 0 or pcnt < 0 or begin + pcnt > n:
        raise ValueError(f"window [{begin}, {begin + pcnt}) is outside "
                         f"[0, {n})")
    if len(scal) != 12:
        raise ValueError("scal must hold 12 values")
    lib = _lib()
    dev = rec.device
    nt = -(-pcnt // TILE)
    nchunks = -(-pcnt // CHUNK_ROWS)
    comp = torch.empty((nt, W - 1, 2 * TILE), dtype=torch.int32, device=dev)
    counts = torch.empty((2, nt), dtype=torch.int32, device=dev)
    # the chunk partials, then (after the kernel's reduction) both
    # children's per-feature bests [2, F, 8]
    partial = torch.empty(max(nchunks * F * num_bins * 3, 2 * F * 8),
                          dtype=torch.float32, device=dev)
    rows = torch.empty((2, 16), dtype=torch.float32, device=dev)
    can, lsg, lsh, lc, rsg, rsh, rc, md, mh, l1, l2, mg = (
        float(v) for v in scal)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lgbm_split_step(
            rec.data_ptr(), n, W, begin, pcnt, F, k, num_bins, f, int(thr),
            int(bool(is_cat)), hists.data_ptr(), parent, new_leaf,
            meta.data_ptr(), can, lsg, lsh, lc, rsg, rsh, rc, md, mh, l1, l2,
            mg, comp.data_ptr(), counts.data_ptr(), partial.data_ptr(),
            _barrier(dev, stream).data_ptr(), rows.data_ptr(), stream)
    _build.check(code, "split-step kernel")
    LAUNCHES += 1
    return comp, counts, rows
