"""Two-child split search: the CUDA kernels and their dispatch.

Counterpart of lightgbm_tpu/ops/pallas_search.py ``search2_pallas`` and
``search2_update_pallas``.  ``search2`` takes both children's [F, B, 3]
histograms and returns two SplitResults; ``search2_rows`` is the same
search in the packed [2, 16] row layout of pallas_search._unpack (gain,
feature, threshold, lg, lh, lc, rg, rh, rc, left_out, right_out, 0...),
which the grower consumes.  On CUDA tensors it launches kernel 3
(csrc/search.cu, which says what it replaces, its bound and its design)
and adds one to ``LAUNCHES``; on CPU tensors it runs the plain version
(ops/split.py).  ``search2_update`` is the record route's step: the
larger child by subtraction from the parent's buffer row, both children
written into the ``[L, F, B, 3]`` buffer in place, and both searched;
kernel 4 on the card (counted in ``UPDATE_LAUNCHES``), the plain version
on the CPU.  ``search2_pool`` is the pooled leaf-wise route's step, the
counterpart of ``search2_pallas_raw`` with the subtraction and the slot
writes around it: the same over a ``[P, F, B, 3]`` histogram pool, the
children written to slots ``s1`` and ``s2`` and the parent read from a
slot or from a recomputed row; kernel 5 on the card (``POOL_LAUNCHES``).

On float64 histograms (``hist_dtype=float64``) the same three calls
launch kernel 3-f64, the search in double, and return float64 rows:
``search2_rows`` its root form (``F64_LAUNCHES``), ``search2_update`` and
``search2_pool`` its step form (``F64_STEP_LAUNCHES``: the subtraction, the
two rows written and both searches in one launch).  ``F64Step`` is the
step form bound to one tree's buffer: the checks, the device, the stream,
the configuration and the [2, 16] rows buffer are fixed once a tree, and
each split pays only for its launch (the float64 learners call it).
``search64_config`` picks kernel 3-f64's design by shape: one
thread-block cluster (B <= 256 and F up to ``F64_CLUSTER_MAX_F``, the
measured size switch) or the ticketed grid; both give the same bits.

The ticketed kernels write each (child, feature)'s best to a scratch of
``2 * F * 8`` values of the histogram's dtype and pick the winners in the
last block behind an integer ticket; both live in ``_WORK``, allocated
once per device and dtype (the scratch grown when a wider F comes) and
shared by every launch there, so one stream at a time may search on a
device.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple, Union

import torch

from . import _build
from . import split as plain
from .split import SplitResult

# kernel launches since the last reset (chip_smoke.py reads and resets them)
LAUNCHES = 0  # kernel 3
UPDATE_LAUNCHES = 0  # kernel 4
POOL_LAUNCHES = 0  # kernel 5
F64_LAUNCHES = 0  # kernel 3-f64, root form
F64_STEP_LAUNCHES = 0  # kernel 3-f64, step form

_VP, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_double
_PER_FEATURE = 8  # values of one (child, feature) best (csrc kPerFeature)

# kernel 3-f64's cluster design (csrc/search.cu search2_cluster_kernel):
# at most 256 bins (kClusterBins), 8 blocks (kMaxCluster) of 7 warps
# (kClusterWarps); above F64_CLUSTER_MAX_F features, where the 2F pairs
# no longer fit its 56 warps at once, the ticketed grid searches the root
# faster (tools/search_variants.py --f64)
CLUSTER_BINS, MAX_CLUSTER, CLUSTER_WARPS = 256, 8, 7
F64_CLUSTER_MAX_F = MAX_CLUSTER * CLUSTER_WARPS // 2
# (cluster, warps) forced on every kernel 3-f64 launch when set (the
# variants tool and the holds of each branch; (0, 0) = the ticketed grid)
_forced_config = None

# (device index, dtype) -> (ticket int32 [1], bests [>= 2 * F * 8])
_WORK: Dict[Tuple[int, torch.dtype], Tuple[torch.Tensor, torch.Tensor]] = {}


def _lib():
    lib = _build.load("search")
    if not getattr(lib, "_typed", False):
        lib.lgbm_search2.restype = _I
        # ... best, ticket, out, stream
        lib.lgbm_search2.argtypes = [_VP, _VP, _VP, _I, _I] + [_F] * 13 + [
            _VP] * 4
        # ... scal (12 doubles on the host), cluster, warps, best, ticket,
        # out, stream
        lib.lgbm_search2_f64.restype = _I
        lib.lgbm_search2_f64.argtypes = [_VP, _VP, _VP, _I, _I, _VP, _I,
                                         _I] + [_VP] * 4
        lib.lgbm_search2_update_f64.restype = _I
        lib.lgbm_search2_update_f64.argtypes = [
            _VP, _VP, _I, _I, _I, _VP, _I, _I, _VP, _I, _I] + [_VP] * 4
        lib.lgbm_search2_pool_f64.restype = _I
        lib.lgbm_search2_pool_f64.argtypes = [
            _VP, _VP, _VP, _I, _I, _I, _VP, _I, _I, _VP, _I, _I] + [_VP] * 4
        lib.lgbm_search2_update.restype = _I
        lib.lgbm_search2_update.argtypes = [_VP, _VP, _I, _I, _I, _VP, _I,
                                            _I] + [_F] * 12 + [_VP] * 4
        lib.lgbm_search2_pool.restype = _I
        lib.lgbm_search2_pool.argtypes = [_VP, _VP, _VP, _I, _I, _I, _VP, _I,
                                          _I] + [_F] * 12 + [_VP] * 4
        lib._typed = True
    return lib


def pack_meta(feature_mask, num_bins_per_feature, is_categorical,
              device) -> torch.Tensor:
    """[F] feature metadata -> the kernel's [F, 4] int32 operand
    (feature_mask, num_bins, is_categorical, 0)."""
    fm = torch.as_tensor(feature_mask).to(device=device, dtype=torch.int32)
    return torch.stack([
        fm,
        torch.as_tensor(num_bins_per_feature).to(device=device,
                                                 dtype=torch.int32),
        torch.as_tensor(is_categorical).to(device=device, dtype=torch.int32),
        torch.zeros_like(fm),
    ], dim=1).contiguous()


def search64_config(F: int, B: int) -> Tuple[int, int]:
    """Kernel 3-f64's (cluster, warps) at F features and B bins: one
    cluster of up to 8 blocks, the 2F (child, feature) pairs spread over
    at most 7 warps a block, where B <= 256 and F <= F64_CLUSTER_MAX_F;
    else (0, 0), the ticketed grid."""
    if _forced_config is not None:
        return _forced_config
    if B > CLUSTER_BINS or F > F64_CLUSTER_MAX_F:
        return 0, 0
    pairs = max(2 * F, 1)
    cluster = min(MAX_CLUSTER, pairs)
    return cluster, min(CLUSTER_WARPS, -(-pairs // cluster))


def search2_rows(h_left: torch.Tensor, h_right: torch.Tensor,
                 scal: Sequence[float], meta: torch.Tensor) -> torch.Tensor:
    """Both children's best splits as a [2, 16] tensor of the
    histograms' dtype (kernel 3, or 3-f64 for float64 histograms).

    ``scal`` = (can, lsg, lsh, lc, rsg, rsh, rc, min_data, min_hess, l1,
    l2, min_gain) as Python floats; ``meta`` is ``pack_meta``'s [F, 4]."""
    if h_left.device.type == "cpu":
        return plain.search2_rows(h_left, h_right, scal, meta)
    return _search2_rows_cuda(h_left, h_right, scal, meta)


def _workspace(dev: torch.device, F: int,
               dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """Pointers to the device's ticket (zero between launches) and bests
    scratch in ``dtype``, the scratch grown to ``2 * F`` bests if it is
    smaller."""
    key = (dev.index, dtype)
    work = _WORK.get(key)
    if work is None or work[1].numel() < 2 * F * _PER_FEATURE:
        ticket = (torch.zeros(1, dtype=torch.int32, device=dev)
                  if work is None else work[0])
        work = _WORK[key] = (ticket, torch.empty(
            2 * F * _PER_FEATURE, dtype=dtype, device=dev))
    return work[1].data_ptr(), work[0].data_ptr()


def _check_search(hists, meta, scal, F, dtype=torch.float32):
    """Shared argument checks of kernels 3, 4, 5 (float32) and 3-f64
    (float64)."""
    for name, t in hists:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    dev = hists[0][1].device
    if (meta.dtype != torch.int32 or meta.shape != (F, 4)
            or meta.device != dev or not meta.is_contiguous()):
        raise ValueError(f"meta must be a contiguous [{F}, 4] int32 tensor "
                         f"on {dev}")
    if len(scal) != 12:
        raise ValueError("scal must hold 12 values")


def _search2_rows_cuda(h_left, h_right, scal, meta):
    """Kernel 3, or kernel 3-f64's root form on float64 histograms, on the
    card (raises on anything it does not take)."""
    global LAUNCHES, F64_LAUNCHES
    F, B, three = h_left.shape
    dev = h_left.device
    if three != 3 or h_right.shape != h_left.shape:
        raise ValueError(
            f"histograms must both be [F, B, 3], got {tuple(h_left.shape)} "
            f"and {tuple(h_right.shape)}")
    if h_right.device != dev:
        raise ValueError(f"h_right is on {h_right.device}, h_left on {dev}")
    dt = h_left.dtype
    f64 = dt == torch.float64
    _check_search([("h_left", h_left), ("h_right", h_right)], meta, scal, F,
                  torch.float64 if f64 else torch.float32)
    lib = _lib()
    out = torch.empty((2, 16), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if f64:
            code = lib.lgbm_search2_f64(
                h_left.data_ptr(), h_right.data_ptr(), meta.data_ptr(), F, B,
                (_D * 12)(*map(float, scal)), *search64_config(F, B),
                *_workspace(dev, F, dt), out.data_ptr(), stream)
        else:
            can, lsg, lsh, lc, rsg, rsh, rc, md, mh, l1, l2, mg = (
                float(v) for v in scal)
            code = lib.lgbm_search2(
                h_left.data_ptr(), h_right.data_ptr(), meta.data_ptr(), F, B,
                can, lsg, lsh, lc, can, rsg, rsh, rc, md, mh, l1, l2, mg,
                *_workspace(dev, F, dt), out.data_ptr(), stream)
    if f64:
        _build.check(code, "float64 search kernel")
        F64_LAUNCHES += 1
    else:
        _build.check(code, "search kernel")
        LAUNCHES += 1
    return out


def search2_update(hists: torch.Tensor, h_small: torch.Tensor, parent: int,
                   new_leaf: int, small_is_left: bool, scal: Sequence[float],
                   meta: torch.Tensor) -> torch.Tensor:
    """``hists[parent]`` <- left child, ``hists[new_leaf]`` <- right child
    (``h_small`` and ``hists[parent] - h_small``, routed by
    ``small_is_left``), in place; returns both children's [2, 16] rows
    (kernel 4, or kernel 3-f64's step form on float64 tensors).  ``scal``
    and ``meta`` as for ``search2_rows``."""
    if hists.device.type == "cpu":
        return plain.search2_update(hists, h_small, parent, new_leaf,
                                    small_is_left, scal, meta)
    if hists.dtype == torch.float64:
        return F64Step(hists, meta).update(h_small, parent, new_leaf,
                                           small_is_left, scal)
    return _search2_update_cuda(hists, h_small, parent, new_leaf,
                                small_is_left, scal, meta)


def _search2_update_cuda(hists, h_small, parent, new_leaf, small_is_left,
                         scal, meta):
    """Kernel 4 on the card (raises on anything it does not take)."""
    global UPDATE_LAUNCHES
    if hists.dim() != 4 or hists.shape[3] != 3 \
            or h_small.shape != hists.shape[1:]:
        raise ValueError(f"hists must be [L, F, B, 3] and h_small [F, B, 3], "
                         f"got {tuple(hists.shape)} and "
                         f"{tuple(h_small.shape)}")
    L, F, B, _ = hists.shape
    if not (0 <= parent < L and 0 <= new_leaf < L and parent != new_leaf):
        raise ValueError(f"rows {parent} and {new_leaf} must be distinct "
                         f"rows of the {L}-row buffer")
    if h_small.device != hists.device:
        raise ValueError(f"h_small is on {h_small.device}, hists on "
                         f"{hists.device}")
    _check_search([("hists", hists), ("h_small", h_small)], meta, scal, F)
    lib = _lib()
    can, lsg, lsh, lc, rsg, rsh, rc, md, mh, l1, l2, mg = (
        float(v) for v in scal)
    dev = hists.device
    out = torch.empty((2, 16), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lgbm_search2_update(
            hists.data_ptr(), h_small.data_ptr(), parent, new_leaf,
            int(bool(small_is_left)), meta.data_ptr(), F, B, can, lsg, lsh,
            lc, rsg, rsh, rc, md, mh, l1, l2, mg, *_workspace(dev, F),
            out.data_ptr(), stream)
    _build.check(code, "search-update kernel")
    UPDATE_LAUNCHES += 1
    return out


def search2_pool(pool: torch.Tensor, h_small: torch.Tensor,
                 parent: Union[int, torch.Tensor], s1: int, s2: int,
                 small_is_left: bool, scal: Sequence[float],
                 meta: torch.Tensor) -> torch.Tensor:
    """``pool[s1]`` <- left child, ``pool[s2]`` <- right child (``h_small``
    and parent - ``h_small``, routed by ``small_is_left``), in place;
    returns both children's [2, 16] rows.  ``parent`` is the parent's pool
    slot or its recomputed [F, B, 3] histogram.  ``s2`` may be neither
    ``s1`` nor the parent's slot; ``s1`` may be the parent's slot (the left
    child then overwrites the parent).  Kernel 5, or kernel 3-f64's step
    form on float64 tensors.  ``scal`` and ``meta`` as for
    ``search2_rows``."""
    P = pool.shape[0]
    ps = None if isinstance(parent, torch.Tensor) else int(parent)
    if not (0 <= s1 < P and 0 <= s2 < P and s1 != s2):
        raise ValueError(f"slots {s1} and {s2} must be distinct slots of the "
                         f"{P}-slot pool")
    if ps is not None and not (0 <= ps < P and ps != s2):
        raise ValueError(f"the parent's slot {ps} must be a slot of the "
                         f"{P}-slot pool other than s2={s2}")
    parent = parent if ps is None else ps
    if pool.device.type == "cpu":
        return plain.search2_pool(pool, h_small, parent, s1, s2,
                                  small_is_left, scal, meta)
    if pool.dtype == torch.float64:
        return F64Step(pool, meta).pool(h_small, parent, s1, s2,
                                        small_is_left, scal)
    return _search2_pool_cuda(pool, h_small, parent, s1, s2, small_is_left,
                              scal, meta)


def _search2_pool_cuda(pool, h_small, parent, s1, s2, small_is_left, scal,
                       meta):
    """Kernel 5 on the card (raises on anything it does not take; the
    slots are checked by ``search2_pool``)."""
    global POOL_LAUNCHES
    if pool.dim() != 4 or pool.shape[3] != 3 \
            or h_small.shape != pool.shape[1:]:
        raise ValueError(f"pool must be [P, F, B, 3] and h_small [F, B, 3], "
                         f"got {tuple(pool.shape)} and "
                         f"{tuple(h_small.shape)}")
    _, F, B, _ = pool.shape
    dev = pool.device
    rows = [("pool", pool), ("h_small", h_small)]
    if not isinstance(parent, torch.Tensor):
        parent_ptr = pool.data_ptr() + parent * F * B * 3 * pool.element_size()
    else:
        if parent.shape != h_small.shape:
            raise ValueError(f"parent must be [F, B, 3], got "
                             f"{tuple(parent.shape)}")
        rows.append(("parent", parent))
        parent_ptr = parent.data_ptr()
    for name, t in rows[1:]:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, pool on {dev}")
    _check_search(rows, meta, scal, F)
    lib = _lib()
    can, lsg, lsh, lc, rsg, rsh, rc, md, mh, l1, l2, mg = (
        float(v) for v in scal)
    out = torch.empty((2, 16), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lgbm_search2_pool(
            pool.data_ptr(), h_small.data_ptr(), parent_ptr, s1, s2,
            int(bool(small_is_left)), meta.data_ptr(), F, B, can, lsg, lsh,
            lc, rsg, rsh, rc, md, mh, l1, l2, mg, *_workspace(dev, F),
            out.data_ptr(), stream)
    _build.check(code, "pooled search kernel")
    POOL_LAUNCHES += 1
    return out


class F64Step:
    """Kernel 3-f64's step form over one tree's float64 buffer ``buf``
    ([L, F, B, 3] leaf rows or a [P, F, B, 3] pool): ``update`` is
    ``search2_update``, ``pool`` is ``search2_pool``, with everything that
    holds for the tree (the buffer's and ``meta``'s checks, the device,
    the stream, the configuration, the scratch and the [2, 16] rows)
    settled here once.  Each call checks its own tensors' shape, dtype,
    device and layout, launches (one count in ``F64_STEP_LAUNCHES``) and
    returns the same rows tensor, overwritten by the next call: read it
    first.  On a CPU buffer the calls are the plain versions (ops/split.py),
    each returning new rows."""

    def __init__(self, buf: torch.Tensor, meta: torch.Tensor):
        self.buf, self.meta = buf, meta
        self.cuda = buf.device.type == "cuda"
        if not self.cuda:
            return
        if buf.dim() != 4 or buf.shape[3] != 3:
            raise ValueError(f"the buffer must be [L, F, B, 3], got "
                             f"{tuple(buf.shape)}")
        n, F, B, _ = buf.shape
        _check_search([("buffer", buf)], meta, [0.0] * 12, F, torch.float64)
        self._n, self._F, self._B = n, F, B
        self._shape, self._dev = buf.shape[1:], buf.get_device()
        self._row_bytes = F * B * 3 * 8
        lib = _lib()
        self._update_fn = lib.lgbm_search2_update_f64
        self._pool_fn = lib.lgbm_search2_pool_f64
        self.rows = torch.empty((2, 16), dtype=torch.float64,
                                device=buf.device)
        self._scal = (_D * 12)()
        with torch.cuda.device(buf.device):
            stream = torch.cuda.current_stream(buf.device).cuda_stream
        # buffer, meta, F, B / scal, cluster, warps, best, ticket, rows,
        # stream
        self._head = (meta.data_ptr(), F, B)
        self._tail = (self._scal, *search64_config(F, B),
                      *_workspace(buf.device, F, torch.float64),
                      self.rows.data_ptr(), stream)

    def _check(self, t: torch.Tensor, name: str) -> int:
        if (t.dtype != torch.float64 or t.shape != self._shape
                or t.get_device() != self._dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float64 "
                             f"{list(self._shape)} tensor on the buffer's "
                             "device")
        return t.data_ptr()

    def update(self, h_small: torch.Tensor, parent: int, new_leaf: int,
               small_is_left: bool, scal: Sequence[float]) -> torch.Tensor:
        """``buf[parent]`` <- left child, ``buf[new_leaf]`` <- right child,
        both searched (``search2_update``)."""
        global F64_STEP_LAUNCHES
        if not self.cuda:
            return plain.search2_update(self.buf, h_small, parent, new_leaf,
                                        small_is_left, scal, self.meta)
        if not (0 <= parent < self._n and 0 <= new_leaf < self._n
                and parent != new_leaf):
            raise ValueError(f"rows {parent} and {new_leaf} must be distinct "
                             f"rows of the {self._n}-row buffer")
        small = self._check(h_small, "h_small")
        self._scal[:] = scal
        code = self._update_fn(self.buf.data_ptr(), small, parent, new_leaf,
                               int(bool(small_is_left)), *self._head,
                               *self._tail)
        _build.check(code, "float64 search-update kernel")
        F64_STEP_LAUNCHES += 1
        return self.rows

    def pool(self, h_small: torch.Tensor, parent: Union[int, torch.Tensor],
             s1: int, s2: int, small_is_left: bool,
             scal: Sequence[float]) -> torch.Tensor:
        """``buf[s1]`` <- left child, ``buf[s2]`` <- right child, the
        parent a slot or a recomputed [F, B, 3] tensor, both searched
        (``search2_pool``, which checks the slots)."""
        global F64_STEP_LAUNCHES
        if not self.cuda:
            return plain.search2_pool(self.buf, h_small, parent, s1, s2,
                                      small_is_left, scal, self.meta)
        small = self._check(h_small, "h_small")
        if isinstance(parent, torch.Tensor):
            par = self._check(parent, "parent")
        else:
            par = self.buf.data_ptr() + parent * self._row_bytes
        self._scal[:] = scal
        code = self._pool_fn(self.buf.data_ptr(), small, par, s1, s2,
                             int(bool(small_is_left)), *self._head,
                             *self._tail)
        _build.check(code, "float64 pooled search kernel")
        F64_STEP_LAUNCHES += 1
        return self.rows


def unpack(rows: torch.Tensor, i: int) -> SplitResult:
    """Row ``i`` of a [2, 16] result as a SplitResult of 0-d tensors."""
    r = rows[i]
    return SplitResult(r[0], r[1].to(torch.int32), r[2].to(torch.int32),
                       *[r[k] for k in range(3, 11)])


def search2(h_left, h_right, lsg, lsh, lc, rsg, rsh, rc, can,
            feature_mask, num_bins_per_feature, is_categorical,
            min_data_in_leaf, min_sum_hessian_in_leaf, lambda_l1, lambda_l2,
            min_gain_to_split) -> Tuple[SplitResult, SplitResult]:
    """``search2_pallas``'s signature: both children's SplitResults."""
    meta = pack_meta(feature_mask, num_bins_per_feature, is_categorical,
                     h_left.device)
    scal = [float(can), float(lsg), float(lsh), float(lc), float(rsg),
            float(rsh), float(rc), float(min_data_in_leaf),
            float(min_sum_hessian_in_leaf), float(lambda_l1),
            float(lambda_l2), float(min_gain_to_split)]
    rows = search2_rows(h_left, h_right, scal, meta)
    return unpack(rows, 0), unpack(rows, 1)
