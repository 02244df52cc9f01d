"""The forest's lane functions: CUDA kernels F1 and F3 and their dispatch.

Kernel F1 (csrc/forest.cu, which says what it replaces, its bound and its
design) is every lane's histogram of the rows of one leaf, in two forms:
the root form (each lane's leaf 0, its root set) and the step form (the
partition of each active lane's split leaf in the ``[B, n]`` leaf map, in
place, then each lane's smaller child).  Kernel F3 is both children's best
split for every lane under the lane's own feature mask and scalars, in two
forms: the root form (the lane's root histogram as both children) and the
step form (the larger child by subtraction, both children written into
the lanes' ``[B, L, F, nb, 3]`` buffer, both searched, the left count in
slot 11).  Each call adds one to ``LAUNCHES`` (F1: three launches, two
where n <= CHUNK_ROWS) or ``SEARCH_LAUNCHES`` (F3: one).

``ForestStep``, the one entry, binds both to one round of a forest: the
bins, the ``[B, n]`` gradients, hessians, mask and leaf map, ``meta`` and
the buffer are checked, and the device, the stream, the bin type, the
scratch (sized from the round's largest root: every lane at the steps'
bound, the root form in batches of lanes) and the kernels' attributes
settled, once; a call checks its own values, packs them into one pinned
host buffer that one copy uploads, and launches, with no allocation.  On
CPU tensors every call is the plain version (ops/forest.py), which the
kernels are bitwise; nothing else selects between kernel and plain
version: a CUDA tensor launches the kernel or raises.  One stream at a
time may use a ``ForestStep``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from . import _build
from . import forest as plain
from .histogram import CHUNK_ROWS

# kernel launches since the last reset (chip_smoke.py reads and resets them)
LAUNCHES = 0  # F1
SEARCH_LAUNCHES = 0  # F3

_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_PER_FEATURE = 8  # values of one (child, feature) best (csrc kPerFeature)
STEP_INTS = 20  # a step's values a lane (csrc kStepInts)
INFO_INTS = 8  # F1's results a lane (csrc kInfoInts)
# the step's values a lane, in STEP_INTS int32: lane, parent leaf,
# feature, threshold, categorical, parent count, new leaf, then the 12
# search scalars' float32 bits from column 8
_SCAL = 8


def _lib():
    lib = _build.load("forest")
    if not getattr(lib, "_typed", False):
        lib.lgbm_forest_hist.restype = _I
        lib.lgbm_forest_hist.argtypes = [
            _VP, _I, _VP, _VP, _VP, _VP, _I64, _I, _I, _I, _I, _I, _I, _VP,
            _VP, _VP, _VP, _VP, _I64, _VP]
        lib.lgbm_forest_split.restype = _I
        lib.lgbm_forest_split.argtypes = [
            _VP, _I, _VP, _VP, _VP, _VP, _I64, _I, _I, _I, _I, _I, _VP, _VP,
            _I, _I, _VP, _VP, _VP, _VP, _VP, _I64, _VP]
        lib.lgbm_forest_search.restype = _I
        lib.lgbm_forest_search.argtypes = [_VP, _I64, _VP, _VP, _VP, _I,
                                           _I64, _I, _I, _VP, _VP, _VP]
        lib.lgbm_forest_search_step.restype = _I
        lib.lgbm_forest_search_step.argtypes = [
            _VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I64, _I, _I, _VP, _VP, _VP]
        lib.lgbm_forest_upload.restype = _I
        lib.lgbm_forest_upload.argtypes = [_VP, _VP, _I64, _VP]
        lib.lgbm_forest_prepare.restype = _I
        lib.lgbm_forest_prepare.argtypes = [_I, _I]
        lib.lgbm_forest_work_ints.restype = _I64
        lib.lgbm_forest_work_ints.argtypes = [_I, _I64, _I]
        for name, want in (("chunk_rows", CHUNK_ROWS),
                           ("step_ints", STEP_INTS),
                           ("info_ints", INFO_INTS)):
            fn = getattr(lib, f"lgbm_forest_{name}")
            fn.restype, fn.argtypes = _I, []
            if fn() != want:
                raise RuntimeError(f"csrc/forest.cu's {name} differs from "
                                   "ops/cuda_forest.py's")
        lib._typed = True
    return lib


def _check_lanes(bins_T, grad, hess, mask, leaf_id):
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
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows: F1 counts rows in int32")
    if B > 65535:
        raise ValueError(f"{B} lanes: at most 65,535")
    return B, F, n, bin_bytes


def _check(t, name, dt, shape, dev):
    if (t.device != dev or t.dtype != dt or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dt} tensor of shape "
                         f"{tuple(shape)} on {dev}")


class ForestStep:
    """F1 and F3 bound to one round of a forest of B lanes: ``bins_T`` [F,
    n] uint8/uint16, ``grad``/``hess``/``mask`` [B, n] float32 and
    ``leaf_id`` [B, n] int32 (partitioned in place by the steps);
    ``max_rows`` (default n) bounds any lane's root rows (a lane past
    ``ceil(max_rows / CHUNK_ROWS)`` chunks gets NaN on the card,
    ``ValueError`` on the CPU); ``meta`` [B, F, 4] int32
    (``cuda_search.pack_meta`` a lane) and ``hists`` [B, L, F, nb, 3]
    float32 (the lanes' leaf rows).  F1's scratch holds every lane at the
    steps' bound (a smaller child holds at most ``max_rows // 2`` rows),
    and the root form runs over as many lanes a call as it holds at the
    roots'.

    ``root_histogram`` is F1's root form over every lane's leaf 0 into
    ``hists[:, 0]``; ``root_search`` F3's root form on it as both
    children; ``root`` both.  ``split_histogram`` is F1's step form
    (``self.h[:A]`` the smaller children, ``self.lane_info[:A]`` each
    lane's (rows, nleft, side (0 left), leaf, chunks, past capacity));
    ``search`` F3's step form after it; ``step`` both.  Tensors returned
    on the card are this object's and are overwritten by its next call:
    read them first."""

    def __init__(self, bins_T: torch.Tensor, grad: torch.Tensor,
                 hess: torch.Tensor, mask: torch.Tensor,
                 leaf_id: torch.Tensor, num_bins: int,
                 meta: torch.Tensor, hists: torch.Tensor,
                 max_rows: Optional[int] = None):
        self.bins_T, self.grad, self.hess, self.mask = bins_T, grad, hess, mask
        self.leaf_id, self.meta, self.hists = leaf_id, meta, hists
        self.num_bins = int(num_bins)
        F, n = bins_T.shape
        B = grad.shape[0]
        self.B, self.F, self.n = B, F, n
        self.L = hists.shape[1]
        self.max_rows = n if max_rows is None else max(0, min(int(max_rows),
                                                              n))
        self.cuda = bins_T.device.type == "cuda"
        self._cpu_step = None  # the CPU's split, for its search
        if not self.cuda:
            return
        B, F, n, bin_bytes = _check_lanes(bins_T, grad, hess, mask, leaf_id)
        nb = self.num_bins
        if nb < 1:
            raise ValueError("num_bins must be >= 1")
        dev = bins_T.device
        _check(meta, "meta", torch.int32, (B, F, 4), dev)
        if hists.dim() != 5:
            raise ValueError("hists must be [B, L, F, nb, 3]")
        _check(hists, "hists", torch.float32, (B, self.L, F, nb, 3), dev)
        lib = _lib()
        with torch.cuda.device(dev):
            grid = lib.lgbm_forest_prepare(bin_bytes, nb)
            self._stream = torch.cuda.current_stream(dev).cuda_stream
        if grid <= 0:
            _build.check(-grid or 1, "forest histogram kernel (F1) setup")
        # chunks a lane: the root's, and the steps' (a smaller child holds
        # at most half its parent); the scratch holds every lane at the
        # steps' and the root runs in batches of lanes at the root's
        cap_r = -(-self.max_rows // CHUNK_ROWS)
        cap_s = -(-(self.max_rows // 2) // CHUNK_ROWS)
        slots = max(B * cap_s, cap_r)
        self._cap_r, self._cap_s = cap_r, cap_s
        self._root_batch = B if cap_r == 0 else max(1, min(B, slots // cap_r))
        cells = F * nb * 3
        self._cells = cells

        def empty(size, dt=torch.float32):
            return torch.empty(size, dtype=dt, device=dev)

        self.h = empty((B, F, nb, 3))
        self.rows = empty((B, 2, 16))
        self._work = torch.zeros(lib.lgbm_forest_work_ints(B, n, F),
                                 dtype=torch.int32, device=dev)
        self.lane_info = self._work[:B * INFO_INTS].view(B, INFO_INTS)
        order = empty(max(slots * CHUNK_ROWS, 1), torch.int32)
        stats = empty(max(3 * slots * CHUNK_ROWS, 1))  # g, h, mask
        # partials only where a lane may hold more than one chunk
        partial = empty(max(slots * cells, 1) if cap_r > 1 else 1)
        best = empty(max(B * 2 * F * _PER_FEATURE, 1))
        self._step_dev = empty(B * STEP_INTS, torch.int32)
        self._pin = torch.empty(B * STEP_INTS, dtype=torch.int32,
                                pin_memory=True)
        self._blk = self._pin.numpy().reshape(B, STEP_INTS)
        self._blk_f = self._blk.view(np.float32)
        self._keep = (order, stats, partial, best)
        self._split_fn, self._hist_fn = lib.lgbm_forest_split, \
            lib.lgbm_forest_hist
        self._search_fn = lib.lgbm_forest_search
        self._step_fn = lib.lgbm_forest_search_step
        self._upload = lib.lgbm_forest_upload
        # the calls' fixed arguments, around each call's own
        self._lanes = (bins_T.data_ptr(), bin_bytes, grad.data_ptr(),
                       hess.data_ptr(), mask.data_ptr(), leaf_id.data_ptr(),
                       n, F, nb)
        self._scratch = (grid, self._work.data_ptr(), order.data_ptr(),
                         stats.data_ptr(), partial.data_ptr())
        self._best = best.data_ptr()
        self._h_views = [self.h[:a] for a in range(B + 1)]
        self._row_views = [self.rows[:a] for a in range(B + 1)]

    # ------------------------------------------------------------ root forms
    def root_histogram(self) -> torch.Tensor:
        """F1's root form: every lane's histogram of its leaf 0 into
        ``hists[:, 0]``, a batch of lanes a call (one call where the
        scratch holds every lane's root); returns ``hists[:, 0]``."""
        global LAUNCHES
        if not self.cuda:
            self.hists[:, 0] = plain.forest_histogram_plain(
                self.bins_T, self.grad, self.hess, self.mask, self.leaf_id,
                torch.zeros(self.B, dtype=torch.int32), self.num_bins,
                self.max_rows)
            return self.hists[:, 0]
        if self.B == 0 or self.n == 0:
            raise ValueError("F1 needs at least one lane and one row")
        bins, bin_bytes, g, h, m, lid, n, F, nb = self._lanes
        stride = self.L * self._cells  # lane a's row 0 of the buffer
        out = self.hists.data_ptr()
        for a0 in range(0, self.B, self._root_batch):
            A = min(self._root_batch, self.B - a0)
            o = 4 * a0 * n  # lane a0's row of the [B, n] tensors
            code = self._hist_fn(bins, bin_bytes, g + o, h + o, m + o,
                                 lid + o, n, F, nb, A, self.B, self._cap_r,
                                 *self._scratch, out + 4 * a0 * stride,
                                 stride, self._stream)
            _build.check(code, "forest histogram kernel (F1), root form")
            LAUNCHES += 1
        return self.hists[:, 0]

    def root(self, scal: np.ndarray) -> torch.Tensor:
        """``root_histogram``, then ``root_search``: [B, 2, 16]."""
        self.root_histogram()
        return self.root_search(scal)

    def root_search(self, scal: np.ndarray) -> torch.Tensor:
        """F3's root form on ``hists[:, 0]`` as both children of every lane
        under ``scal`` [B, 12] float32: [B, 2, 16]."""
        global SEARCH_LAUNCHES
        scal = np.asarray(scal, np.float32).reshape(self.B, 12)
        if not self.cuda:
            h0 = self.hists[:, 0]
            return plain.forest_search_plain(h0, h0, self.meta,
                                             torch.from_numpy(scal))
        self._blk_f[:, _SCAL:] = scal
        sp = self._step_dev.data_ptr()
        code = self._upload(sp, self._pin.data_ptr(),
                            4 * self.B * STEP_INTS, self._stream)
        if code == 0:
            code = self._search_fn(self.hists.data_ptr(),
                                   self.L * self._cells,
                                   self.meta.data_ptr(), sp,
                                   self._work.data_ptr(), self.B, self.n,
                                   self.F, self.num_bins, self._best,
                                   self.rows.data_ptr(), self._stream)
        _build.check(code, "forest search kernel (F3), root form")
        SEARCH_LAUNCHES += 1
        return self.rows

    # ------------------------------------------------------------ step forms
    def _pack(self, lanes, leaves, feats, thrs, cats, pcnt, new_leaf, scal):
        """The step's values into the pinned buffer (the C call checks
        them); returns A."""
        A = len(lanes)
        if not 0 < A <= self.B:
            raise ValueError(f"{A} active lanes of {self.B}")
        blk = self._blk[:A]
        blk[:, 0] = lanes
        blk[:, 1] = leaves
        blk[:, 2] = feats
        blk[:, 3] = thrs
        blk[:, 4] = cats
        blk[:, 5] = pcnt
        blk[:, 6] = new_leaf
        self._blk_f[:A, _SCAL:] = scal
        return A

    def split_histogram(self, lanes: Sequence[int], leaves: Sequence[int],
                        feats: Sequence[int], thrs: Sequence[int],
                        cats: Sequence[bool], pcnt: Sequence[int],
                        new_leaf: int, scal) -> torch.Tensor:
        """F1's step form for A active lanes (ascending ``lanes``; each
        lane's split leaf, feature, bin threshold, categorical flag and
        parent count; ``scal`` [A, 12], for ``search``): the rows of each
        split leaf that go right take ``new_leaf`` in ``leaf_id``; returns
        [A, F, nb, 3], each lane's smaller child's histogram (left where
        2 * nleft <= pcnt)."""
        global LAUNCHES
        if not self.cuda:
            self._cpu_step = (lanes, leaves, new_leaf, scal,
                              *plain.forest_split_plain(
                                  self.bins_T, self.grad, self.hess,
                                  self.mask, self.leaf_id, self.num_bins,
                                  lanes, leaves, feats, thrs, cats, pcnt,
                                  new_leaf))
            return self._cpu_step[4]
        A = self._pack(lanes, leaves, feats, thrs, cats, pcnt, new_leaf,
                       scal)
        code = self._split_fn(*self._lanes, A, self.B, self.L,
                              self._pin.data_ptr(), self._step_dev.data_ptr(),
                              self._cap_s, *self._scratch, self.h.data_ptr(),
                              self._cells, self._stream)
        if code == -1:
            raise ValueError("a step needs ascending lanes in [0, B), leaves "
                             "below new_leaf < L, features in [0, F), parent "
                             "counts in [0, n] and 0/1 categorical flags")
        _build.check(code, "forest histogram kernel (F1), step form")
        LAUNCHES += 1
        self._A, self._new_leaf = A, new_leaf
        return self._h_views[A]

    def search(self) -> torch.Tensor:
        """F3's step form after ``split_histogram``: the larger child as
        parent - smaller, the children into ``hists`` at (lane, leaf)
        (left) and (lane, new_leaf) (right), both searched; returns [A, 2,
        16] with each lane's left count in ``[:, 0, 11]``."""
        global SEARCH_LAUNCHES
        if not self.cuda:
            lanes, leaves, new_leaf, scal, h_small, nleft, small_left = \
                self._cpu_step
            return plain.forest_search_step_plain(
                self.hists, self.meta, h_small, nleft, small_left, lanes,
                leaves, new_leaf, scal)
        A = self._A
        code = self._step_fn(self.hists.data_ptr(), self.L,
                             self.h.data_ptr(), self.meta.data_ptr(),
                             self._step_dev.data_ptr(), self._work.data_ptr(),
                             A, self.B, self.n, self.F, self.num_bins,
                             self._best, self.rows.data_ptr(), self._stream)
        _build.check(code, "forest search kernel (F3), step form")
        SEARCH_LAUNCHES += 1
        return self._row_views[A]

    def step(self, lanes, leaves, feats, thrs, cats, pcnt, new_leaf, scal
             ) -> torch.Tensor:
        """One forest step (``split_histogram``, then ``search``)."""
        self.split_histogram(lanes, leaves, feats, thrs, cats, pcnt,
                             new_leaf, scal)
        return self.search()

