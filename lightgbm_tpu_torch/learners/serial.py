"""Serial leaf-wise tree learner: the order, record, mega and pooled routes.

Counterpart of lightgbm_tpu/learners/serial.py ``grow_tree`` on its
canonical route (``opt = rec = pooled = False``, ``init_tree=None``), on
its record route (``hist_fn_raw`` given, the fused mega kernel off:
serial.py:817-829, :874-889, :944-965) and on its mega route
(``hist_fn_raw`` given and ``fuse_hist``: serial.py:774-816, :938-943),
and on its two pooled routes (``0 < hist_pool < max_leaves``, below):
the best-first growth of SerialTreeLearner
(serial_tree_learner.cpp:116-150).

* Order route: the row partition is a leaf-sorted permutation ``order``
  plus per-leaf ``(begin, count)`` ranges (DataPartition,
  data_partition.hpp:91-139).  A split stably partitions only the
  parent's range: left-going rows keep their order at the front,
  right-going rows follow (serial.py:219-249).  The smaller child's rows
  are one contiguous slice of ``order``, gathered (serial.py:252-264).
* Record route: the partition is the packed record itself
  (ops/record.py), kept leaf-sorted by the same stable split of the
  parent's window (kernels 6 and 7 on the card).  The smaller child's
  histogram reads its window straight from the record (``hist_fn_raw``,
  kernel 1'), and one call subtracts, routes, updates the buffer rows and
  searches both children (``search2_update``, kernel 4).  Each leaf's
  rows sit in the record in the order ``order`` would hold them, so both
  routes sum the same rows in the same order and grow bitwise-equal
  trees.
* Mega route: the record route's record, with the whole split step in
  one call (``ops/record.split_step``, kernel 8 on the card): the go
  flags, the compaction of the parent's window, the LEFT child's
  histogram over that whole window, the subtraction, both buffer rows and
  both searches; ``place_window`` (kernel 7) then places the window.  The
  left count comes back in the search rows' slot 11, so one host read per
  split carries both.  It builds the left child from data, whichever is
  smaller, where the other routes build the smaller child, so its floats
  may differ from theirs in the last bits and a near-tie split may go
  the other way.
* On the order and record routes only the SMALLER child's histogram is
  built from data, by positional count with ties to the left
  (serial.py:866).  The larger child is parent - smaller.  Every live
  leaf's histogram stays resident in one ``[L, F, B, 3]`` buffer.
* Both children are searched in one call; the root is searched through
  the two-child search (its two inputs are the root histogram).
* Leaf numbering matches the reference: the left child keeps the
  parent's index, the right child takes ``step + 1`` (tree.cpp:78-89).
* Pooled (``0 < hist_pool < max_leaves``, the HistogramPool of
  feature_histogram.hpp:337-481; serial.py:590-606, :899-934,
  :986-1033): the order route with only ``P = max(hist_pool, 2)``
  histograms resident in a ``[P, F, B, 3]`` pool, slots handed out
  least-recently-used.  A parent evicted since the split that made it is
  rebuilt from its ``order`` range after this split's partition (left
  rows, then right rows), as the JAX package rebuilds it.  The step is
  kernel 5 (``search2_pool``: subtraction, slot writes and both searches)
  where ``hist_fn_raw`` is given, the JAX package's raw-layout pooled
  route (serial.py:444-456, which switches the record and mega routes
  off under the pool, :404, :427); otherwise PyTorch subtraction, slot
  writes and kernel 3, its canonical pooled route.  The residency tables
  live on the host, so the pool adds no host sync.
* Hooked (the parallel learners, parallel/*; serial.py:300-358): the
  record route's partition or the order route's, with the histograms,
  root sums, child counts and searches through the learner's hooks,
  which may reduce across ranks and hold feature shards; see
  ``grow_tree``.  Host syncs: three at the root (its row-order totals,
  their reduced values, its search row), two per split (the left count
  with the reduced counts, the two children's rows).
* Resume (``init_tree``, hybrid growth's second phase, serial.py:605-687):
  the order route starts from a partial tree of K0 leaves; one level
  histogram pass fills the live leaves' histograms, one search of all of
  them fills the best-split table, one host read brings its rows and the
  leaves' row counts, and the loop numbers nodes from K0 - 1 on.

Float64 histograms (``hist_dtype=float64``; the JAX package's x64 route,
gbdt.py:818-830) run on the order route, pooled or not, and in the
resume, given float64 histogram functions (kernels 1-f64 and 1''-f64 on
the card, over the float32 rows): everything follows the histograms'
dtype (serial.py:597-602): the root sums are summed in float64 in row
order, the searches return float64 rows (kernel 3-f64: the root form at
the root, its step form, ``F64Step``, for every split: the subtraction,
both rows written and both searches in one call, unpooled as
``search2_update``, pooled as ``search2_pool``) and the best-split table
is float64; the node table rounds the gain, the
internal value and ``lc + rc`` once to float32 (serial.py:1089-1091),
and the leaf rows are rounded when the tree is built.  The record, mega
and raw pooled routes are float32 only.

PyTorch runs eagerly with dynamic shapes, so the JAX version's static
capacity tiers and masked no-op steps are not ported: each split slices
the exact range, and the loop stops at the first step without a positive
gain (the JAX loop runs its remaining steps as no-ops; the tree is the
same).  Per-leaf bookkeeping (the best-split table, ranges, node table)
lives on the host; the per-row work and the kernels run on the device.
Host syncs: two at the root on every route (its row-order totals, its
search row).  Then, on the order (pooled or not) and record routes, two
per split: the partition's left count (needed to slice the smaller child)
and the two children's search rows (needed to pick the next leaf); on the
mega route
one per split, the search rows with the left count in them.  At 255
leaves that is 510 host syncs per tree against 256.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.tree import Tree
from ..obs.device_time import phase_scope
from ..ops.cuda_histogram import histogram_single_leaf, make_level_hist_fn
from ..ops.cuda_search import (F64Step, pack_meta, search2_pool,
                               search2_rows, search2_update)
from ..ops.histogram import leaf_totals, take_bins
from ..ops.record import (bins_per_word, build_record, leaf_row,
                          partition_window, place_window, row_id_row,
                          split_step)
from ..ops.split import find_best_split_leaves

# host syncs since the last reset (chip_smoke.py reads and resets it)
HOST_SYNCS = 0
# parent histograms rebuilt on the pooled route since the last reset
POOL_RECOMPUTES = 0

# best-split table rows: 0-10 are the search kernel's [2, 16] row layout
# (pallas_search._unpack), 11-14 the per-leaf half of the Tree
_BG, _BF, _BT = 0, 1, 2
_BLSG, _BLSH, _BLC = 3, 4, 5
_BRSG, _BRSH, _BRC = 6, 7, 8
_BLO, _BRO = 9, 10
_BLV, _BLCNT, _BLPAR, _BLDEP = 11, 12, 13, 14
_BROWS = 16


@dataclasses.dataclass(frozen=True)
class TreeLearnerParams:
    """Scalar tree-growth constraints (TreeConfig, config.h:165-190)."""

    min_data_in_leaf: float
    min_sum_hessian_in_leaf: float
    lambda_l1: float
    lambda_l2: float
    min_gain_to_split: float
    max_depth: int  # <= 0 means unlimited

    @staticmethod
    def from_config(cfg) -> "TreeLearnerParams":
        f32 = lambda v: float(np.float32(v))  # noqa: E731 — the f32 value
        return TreeLearnerParams(
            min_data_in_leaf=f32(cfg.min_data_in_leaf),
            min_sum_hessian_in_leaf=f32(cfg.min_sum_hessian_in_leaf),
            lambda_l1=f32(cfg.lambda_l1),
            lambda_l2=f32(cfg.lambda_l2),
            min_gain_to_split=f32(cfg.min_gain_to_split),
            max_depth=int(cfg.max_depth),
        )

    def can_split(self, depth: int) -> bool:
        return self.max_depth <= 0 or depth < self.max_depth


def _host(t: torch.Tensor) -> np.ndarray:
    global HOST_SYNCS
    HOST_SYNCS += 1
    return t.cpu().numpy()


def host_tree(num_leaves: int, tree_i: np.ndarray, tree_f: np.ndarray,
              leaf_value, leaf_count, leaf_parent, leaf_depth,
              device) -> Tree:
    """A Tree on ``device`` from the host tables: ``tree_i`` [5, >= L-1]
    (feature, threshold, decision type, left, right child), ``tree_f`` [3,
    >= L-1] (gain, internal value, internal count) and the four [L] leaf
    rows.  Real thresholds and features are filled at finalize."""
    li = len(leaf_value) - 1

    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(device)

    return Tree(
        num_leaves=num_leaves,
        split_feature=t(tree_i[0, :li], torch.int32),
        split_feature_real=torch.full((li,), -1, dtype=torch.int32,
                                      device=device),
        threshold_bin=t(tree_i[1, :li], torch.int32),
        threshold_real=torch.zeros(li, dtype=torch.float32, device=device),
        decision_type=t(tree_i[2, :li], torch.int32),
        left_child=t(tree_i[3, :li], torch.int32),
        right_child=t(tree_i[4, :li], torch.int32),
        split_gain=t(tree_f[0, :li], torch.float32),
        internal_value=t(tree_f[1, :li], torch.float32),
        internal_count=t(tree_f[2, :li], torch.float32),
        leaf_value=t(leaf_value, torch.float32),
        leaf_count=t(leaf_count, torch.float32),
        leaf_parent=t(leaf_parent, torch.int32),
        leaf_depth=t(leaf_depth, torch.int32),
    )


def _root_sums(grad: torch.Tensor, hess: torch.Tensor, m: torch.Tensor,
               acc_dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Root (Σ g·m, Σ h·m, Σ m), each summed in row order in
    ``acc_dtype`` — the order of the JAX package's one-segment segment_sum
    on the CPU (serial.py:585-589).  The leaf outputs and gains take
    differences of these totals, so their rounding carries into every
    split; a row-order sum on the host gives the same totals on any
    device.  One device-to-host copy of 12 bytes per row, and the tree's
    first host sync.  Float32 multiplies on the device; float64 widens the
    float32 rows on the host first (each product exact) and sums there,
    so the count is exact above 2**24 rows."""
    if acc_dtype == torch.float64:
        x = _host(torch.stack([grad, hess, m])).astype(np.float64)
        x[:2] *= x[2]
    else:
        x = _host(torch.stack([grad * m, hess * m, m]))
    dt = x.dtype
    if x.shape[1] == 0:
        return np.zeros(3, dt)
    return np.cumsum(x, axis=1, dtype=dt)[:, -1]


def _partition(order: torch.Tensor, frow: torch.Tensor, thr: int,
               is_cat: bool, begin: int, pcnt: int) -> torch.Tensor:
    """Stably partition ``order[begin:begin+pcnt]`` in place by the
    split decision (lefts first, then rights, each in the old order);
    returns the left count as a 0-d tensor.  The positions are the JAX
    version's: lefts at (lefts before them), rights at nleft + (rights
    before)."""
    rows = order[begin:begin + pcnt]
    vals = take_bins(frow, 0, rows).to(torch.int32)
    go = (vals == thr) if is_cat else (vals <= thr)
    lcnt = torch.cumsum(go.to(torch.int64), 0)  # lefts up to and incl. j
    nleft_t = lcnt[-1]
    j = torch.arange(pcnt, device=order.device)
    newpos = torch.where(go, lcnt - 1, nleft_t + j - lcnt)
    out = torch.empty_like(rows)
    out[newpos] = rows
    rows.copy_(out)
    return nleft_t


def _empty_best(L: int, dtype=np.float32) -> np.ndarray:
    """The [16, L] best-split table before any search, in the histograms'
    dtype: gain -inf, feature -1, parent -1 (empty_tree's leaf_parent),
    everything else 0."""
    best = np.zeros((_BROWS, L), dtype)
    best[_BG] = -np.inf
    best[_BF] = -1.0
    best[_BLPAR] = -1.0
    return best


def _resume(bins_T, grad, hess, bag_mask, feature_mask, num_bins_per_feature,
            is_categorical, params, num_bins, L, init_tree, init_leaf_id,
            init_hist_fn, consts, init_search_fn=None):
    """The state of a resumed tree (serial.py:605-687): the leaf-sorted
    permutation (a stable sort of the leaf ids) and per-leaf ranges, every
    live leaf's histogram from one ``init_hist_fn`` pass, the best-split
    table (rows 0-10 from one search of the live leaves on totals from
    feature 0's bins, rows 11-14 the initial tree's leaf value, count,
    parent and depth) and the node table.  One host read brings the search
    rows and the leaves' row counts."""
    dev = bins_T.device
    F, n = bins_T.shape
    K0 = int(init_tree.num_leaves)
    lid = init_leaf_id.to(torch.int32)
    sorted_lid, order = torch.sort(lid, stable=True)
    row_start = torch.searchsorted(
        sorted_lid, torch.arange(K0 + 1, dtype=torch.int32, device=dev))
    if init_hist_fn is None:
        init_hist_fn = make_level_hist_fn(num_bins)
    fused = init_hist_fn(bins_T, lid, grad, hess, bag_mask, K0)
    tot = leaf_totals(fused)
    depth0 = init_tree.leaf_depth.cpu().numpy()
    can0 = torch.from_numpy(np.array([params.can_split(int(d))
                                      for d in depth0[:K0]])).to(dev)
    if init_search_fn is not None:
        res = init_search_fn(fused, tot[:, 0], tot[:, 1], tot[:, 2], can0)
    else:
        res = find_best_split_leaves(
            fused, tot[:, 0], tot[:, 1], tot[:, 2], feature_mask,
            num_bins_per_feature, is_categorical, *consts, can0)
    got = _host(torch.stack([a.to(torch.float64) for a in res]
                            + [(row_start[1:] - row_start[:-1]).double()]))

    best = _empty_best(L, _np_dtype(fused.dtype))
    best[:11, :K0] = got[:11]
    for row, field in ((_BLV, "leaf_value"), (_BLCNT, "leaf_count"),
                       (_BLPAR, "leaf_parent"), (_BLDEP, "leaf_depth")):
        best[row] = getattr(init_tree, field).cpu().numpy()
    count = np.zeros(L, np.int64)
    count[:K0] = got[11]
    begin = np.concatenate([[0], np.cumsum(count)[:-1]])
    hists = torch.zeros((L,) + tuple(fused.shape[1:]), dtype=fused.dtype,
                        device=dev)
    hists[:K0] = fused
    li = L - 1
    tree_i = np.zeros((5, L), np.int32)
    tree_f = np.zeros((3, L), np.float32)
    for i, field in enumerate(("split_feature", "threshold_bin",
                               "decision_type", "left_child",
                               "right_child")):
        tree_i[i, :li] = getattr(init_tree, field).cpu().numpy()
    for i, field in enumerate(("split_gain", "internal_value",
                               "internal_count")):
        tree_f[i, :li] = getattr(init_tree, field).cpu().numpy()
    return order, hists, best, begin, count, tree_i, tree_f, K0


def _np_dtype(dt: torch.dtype):
    return np.float64 if dt == torch.float64 else np.float32


def _pool_slots(slot_of: np.ndarray, slot_last: np.ndarray, leaf: int,
                recompute):
    """The parent's histogram and the children's slots of a pooled split
    of ``leaf`` (serial.py:899-934): the parent's slot if it is resident,
    else its histogram rebuilt by ``recompute()`` (counted in
    ``POOL_RECOMPUTES``); ``s1`` the parent's slot when resident, else the
    least recently written slot; ``s2`` the least recently written slot
    other than ``s1``.  Free slots carry -1 and win; ties go to the lowest
    index (``np.argmin``, as ``jnp.argmin``)."""
    global POOL_RECOMPUTES
    ps = int(slot_of[leaf])
    if ps >= 0:
        parent, s1 = ps, ps
    else:
        POOL_RECOMPUTES += 1
        parent, s1 = recompute(), int(np.argmin(slot_last))
    others = np.where(np.arange(len(slot_last)) == s1, 2 ** 30, slot_last)
    return parent, s1, int(np.argmin(others))


def record_split(best: np.ndarray, tree_i: np.ndarray, tree_f: np.ndarray,
                 bcol: np.ndarray, res: np.ndarray, best_leaf: int, node: int,
                 is_cat: bool) -> None:
    """The host tables after split ``node`` of ``best_leaf`` (its column
    ``bcol`` of the best-split table, copied before the split) with the
    children's search rows ``res`` [2, >= 11]: the left child takes the
    parent's column of ``best``, the right child the new leaf's (``node +
    1``), and the node table the split (Tree::Split, tree.cpp:52-96)."""
    new_leaf = node + 1
    depth_child = int(bcol[_BLDEP]) + 1
    lc, rc = bcol[_BLC], bcol[_BRC]
    tail = np.array([0.0, 0.0, node, depth_child, 0.0], best.dtype)
    best[:11, best_leaf] = res[0, :11]
    best[11:, best_leaf] = tail
    best[_BLV, best_leaf], best[_BLCNT, best_leaf] = bcol[_BLO], lc
    best[:11, new_leaf] = res[1, :11]
    best[11:, new_leaf] = tail
    best[_BLV, new_leaf], best[_BLCNT, new_leaf] = bcol[_BRO], rc
    parent = int(bcol[_BLPAR])
    if parent >= 0:
        side = 3 if tree_i[3, parent] == ~best_leaf else 4
        tree_i[side, parent] = node
    tree_i[:, node] = [int(bcol[_BF]), int(bcol[_BT]), int(is_cat),
                       ~best_leaf, ~new_leaf]
    # lc + rc in the table's dtype, rounded once to float32
    tree_f[:, node] = [bcol[_BG], bcol[_BLV], np.float32(lc + rc)]


def grow_tree(bins_T: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              bag_mask: torch.Tensor, feature_mask, num_bins_per_feature,
              is_categorical, params: TreeLearnerParams, num_bins: int,
              max_leaves: int, hist_fn_raw=None, fuse_hist: bool = False,
              hist_fn=None, init_tree: Optional[Tree] = None,
              init_leaf_id: Optional[torch.Tensor] = None,
              init_hist_fn=None,
              hist_pool: int = 0,
              root_rows: Optional[torch.Tensor] = None,
              reduce_fn=None, search_fn=None, search2_fn=None,
              child_counts_fn=None, init_search_fn=None
              ) -> Tuple[Tree, torch.Tensor]:
    """Grow one tree; returns (tree, leaf_id per row).

    ``bins_T`` [F, n] uint8/uint16; ``grad``/``hess``/``bag_mask`` [n]
    float32; ``feature_mask``/``num_bins_per_feature``/``is_categorical``
    [F].  ``hist_fn_raw(rec, begin, cnt, F, k, num_bins)``, the record
    window histogram (ops/cuda_histogram.histogram_record_window), selects
    the record route, as it selects the JAX package's (serial.py:391-400),
    and with ``fuse_hist`` the mega route (serial.py:536); without it the
    order route runs, its histograms through ``hist_fn(bins, g, h, m) ->
    [F, B, 3]`` (default: ``histogram_single_leaf``).

    ``init_tree`` (a Tree whose tensors lie on the CPU) and
    ``init_leaf_id`` [n] resume best-first growth from a partial tree, as
    hybrid growth does (serial.py:605-687), on the order route only: the
    JAX package turns its raw and record routes off under ``init_tree``
    (serial.py:395, :426).  One fused pass of ``init_hist_fn`` (the level
    histogram, default ``histogram_by_leaf_sorted``) fills every live
    leaf's histogram.

    ``hist_pool`` with ``0 < hist_pool < max_leaves`` keeps only
    ``max(hist_pool, 2)`` histograms resident (serial.py:590-606) and grows
    on the order route; a given ``hist_fn_raw`` then selects the pooled
    step of kernel 5 instead of the record route, and is not called (the
    port has no raw layout; every histogram comes from ``hist_fn``).  The
    pool does not combine with ``init_tree`` (serial.py:606).

    The root sums, the search rows and the best-split table take the
    histograms' dtype: float64 ``hist_fn`` / ``init_hist_fn`` grow a
    hist_dtype=float64 tree.

    ``root_rows`` (int64, ascending) is the root's row set, a cv fold's
    training rows on the shared bins (``GBDT.set_base_row_mask``): the
    order route's ``order`` and the record route's root record start as
    those rows, so every window, block and positional count is the run's
    on the fold's row subset, and the tree is that run's tree bitwise.
    Rows outside the set get leaf 0 in the returned map.

    The parallel learners (parallel/*) grow through five hooks, the JAX
    package's (serial.py:300-358); with none given every route above is
    unchanged.  ``hist_fn`` / ``hist_fn_raw`` / ``init_hist_fn`` may
    return a feature shard ``[Fs, B, 3]`` of the global histogram; the
    resident buffer then holds shards and the subtraction runs on them.

    * ``reduce_fn(x)`` sums the root's ``[Σg, Σh, count]`` over ranks.
    * ``child_counts_fn(nl, nr) -> [2]`` lifts a split's local
      positional child counts (0-d tensors) to (Σ left, Σ right); the
      smaller child is chosen by the sums, so every rank builds the same
      child.  Default: ``reduce_fn`` of the pair.  (The JAX package also
      reduces the maxes for its capacity-tier gates; the port slices
      exact ranges and has no tiers.)
    * ``search_fn(hist, scal, meta)`` (the root; its first row is the
      result) and ``search2_fn(h_left, h_right, scal, meta)`` (both
      children) return the winners' ``[.., >= 11]`` rows, combined over
      ranks; defaults: kernel 3 through ``search2_rows``.
    * ``init_search_fn(hist, sum_g, sum_h, count, can)`` searches the
      resume's live leaves (a SplitResult).

    Under hooks the step is the record route's partition (kernels 6 and
    7) and window histogram where ``hist_fn_raw`` is given (the JAX
    package's ``rec_hooks``, serial.py:413-429), else the order route's;
    then the subtraction on the histograms ``hist_fn_raw`` / ``hist_fn``
    returned, ``search2_fn``, and the buffer writes: no mega step, no
    kernel 4 or 5, no float64 step form.  A split's host read carries
    the local left count and the reduced counts; every branch depends on
    reduced values only, so all ranks take the same branches."""
    hooked = any(h is not None for h in (
        reduce_fn, search_fn, search2_fn, child_counts_fn, init_search_fn))
    if hooked and (fuse_hist or root_rows is not None):
        raise ValueError("a hooked tree grows without the mega step and "
                         "without a root row set")
    if search2_fn is None:
        search2_fn = search2_rows
    if search_fn is None:
        def search_fn(h, scal, meta_):
            return search2_fn(h, h, scal, meta_)
    if child_counts_fn is None and hooked:
        def child_counts_fn(nl, nr):
            two = torch.stack([nl, nr])
            return two if reduce_fn is None else reduce_fn(two)
    pooled = 0 < hist_pool < max_leaves
    if pooled and init_tree is not None:
        raise ValueError("a resumed tree grows unpooled")
    pool_step = pooled and hist_fn_raw is not None and not hooked
    if pooled:
        hist_fn_raw = None
    if hist_fn is None:
        def hist_fn(b, g, h, m):
            return histogram_single_leaf(b, g, h, m, num_bins)

    rec_route = hist_fn_raw is not None
    if init_tree is not None and rec_route:
        raise ValueError("a resumed tree grows on the order route only")
    if init_tree is not None and root_rows is not None:
        raise ValueError("a resumed tree has no root row set")
    mega = rec_route and fuse_hist
    dev = bins_T.device
    F, n = bins_T.shape
    L = max_leaves
    is_cat_h = np.asarray(torch.as_tensor(is_categorical).cpu(), bool)
    meta = pack_meta(feature_mask, num_bins_per_feature, is_categorical, dev)
    consts = [params.min_data_in_leaf, params.min_sum_hessian_in_leaf,
              params.lambda_l1, params.lambda_l2, params.min_gain_to_split]

    if init_tree is not None:
        (order, hists, best, begin, count, tree_i, tree_f,
         nleaves) = _resume(bins_T, grad, hess, bag_mask, feature_mask,
                            num_bins_per_feature, is_categorical, params,
                            num_bins, L, init_tree, init_leaf_id,
                            init_hist_fn, consts, init_search_fn)
    else:
        # ---- root (LeafSplits::Init, leaf_splits.hpp:51-92)
        n0 = n if root_rows is None else int(root_rows.shape[0])
        if rec_route:
            k = bins_per_word(bins_T.dtype)
            with phase_scope("partition"):
                rec = build_record(bins_T, grad, hess, bag_mask)
                if root_rows is not None:
                    rec = rec.index_select(1, root_rows)
            hist0 = hist_fn_raw(rec, 0, n0, F, k, num_bins)
        elif root_rows is None:
            order = torch.arange(n, dtype=torch.int64, device=dev)
            hist0 = hist_fn(bins_T, grad, hess, bag_mask)
        else:
            order = root_rows.clone()
            with phase_scope("histogram"):
                hist0 = hist_fn(take_bins(bins_T, 1, order),
                                grad.index_select(0, order),
                                hess.index_select(0, order),
                                bag_mask.index_select(0, order))
        with phase_scope("histogram"):
            stats = ((grad, hess, bag_mask) if root_rows is None else
                     (t.index_select(0, root_rows) for t in (grad, hess,
                                                             bag_mask)))
            sums0 = _root_sums(*stats, hist0.dtype)
        if reduce_fn is not None:
            # the tree-start allreduce (data_parallel_tree_learner.cpp:
            # 97-125): every rank's row-order sums, summed over ranks
            sums0 = _host(reduce_fn(torch.from_numpy(sums0)))
        sg0, sh0, c0 = (float(v) for v in sums0)
        rows = search_fn(hist0, [float(params.can_split(0)),
                                 sg0, sh0, c0, sg0, sh0, c0] + consts, meta)
        best = _empty_best(L, _np_dtype(hist0.dtype))
        best[:11, 0] = _host(rows)[0, :11]

        P = max(hist_pool, 2) if pooled else L
        hists = torch.zeros((P,) + tuple(hist0.shape), dtype=hist0.dtype,
                            device=dev)
        hists[0] = hist0
        begin = np.zeros(L, np.int64)
        count = np.zeros(L, np.int64)
        count[0] = n0
        tree_i = np.zeros((5, L), np.int32)  # feat, thr, dtype, lch, rch
        tree_i[0] = -1
        tree_f = np.zeros((3, L), np.float32)  # gain, int_value, int_count
        nleaves = 1
        if pooled:
            # residency (serial.py:722-727): leaf -> slot, slot -> leaf,
            # slot -> step of its last write; -1 = none
            slot_of = np.full(L, -1, np.int64)
            slot_leaf = np.full(P, -1, np.int64)
            slot_last = np.full(P, -1, np.int64)
            slot_of[0] = slot_leaf[0] = slot_last[0] = 0

    # float64 histograms: every split is one call of kernel 3-f64's step
    # form, its checks, stream and rows buffer settled once a tree
    step64 = (F64Step(hists, meta)
              if hists.dtype == torch.float64 and not hooked else None)
    for step in range(nleaves - 1, L - 1):
        best_leaf = int(np.argmax(best[_BG]))
        if not best[_BG, best_leaf] > 0.0:
            break
        node, new_leaf = step, step + 1
        bcol = best[:, best_leaf].copy()
        f, thr = int(bcol[_BF]), int(bcol[_BT])
        is_cat = bool(is_cat_h[f])
        lc, rc = bcol[_BLC], bcol[_BRC]
        depth_child = int(bcol[_BLDEP]) + 1

        b0, pcnt = int(begin[best_leaf]), int(count[best_leaf])
        scal = [float(params.can_split(depth_child)),
                float(bcol[_BLSG]), float(bcol[_BLSH]), float(lc),
                float(bcol[_BRSG]), float(bcol[_BRSH]), float(rc)] + consts
        if mega:
            # ---- the whole step in one call, then the placement; one
            # host read brings the children's rows and the left count
            comp, counts, rows = split_step(
                rec, hists, f, thr, is_cat, b0, pcnt, best_leaf, new_leaf,
                scal, meta, k, num_bins)
            place_window(rec, comp, counts, b0, pcnt, best_leaf, new_leaf)
            # the run buffer (88 MB at a 1M-row root) must not live on
            # into the next split's allocations
            del comp, counts
            res = _host(rows)
            nleft = int(res[0, 11])
        else:
            # ---- partition the parent's range (DataPartition::Split)
            if rec_route:
                nleft_t = partition_window(rec, f, thr, is_cat, b0, pcnt,
                                           best_leaf, new_leaf, k)
            else:
                with phase_scope("partition"):
                    nleft_t = _partition(order, bins_T[f], thr, is_cat, b0,
                                         pcnt)
            if hooked:
                # one read: the local left count and the reduced counts
                nleft_t = nleft_t.to(torch.int32)
                got = _host(torch.cat([
                    nleft_t.reshape(1),
                    child_counts_fn(nleft_t, pcnt - nleft_t).to(
                        torch.int32)]))
                nleft = int(got[0])
                small_is_left = bool(got[1] <= got[2])
            else:
                nleft = int(_host(nleft_t))
                small_is_left = nleft <= pcnt - nleft

            # ---- smaller child's histogram from its contiguous range;
            # the sibling by subtraction
            cnt_s = nleft if small_is_left else pcnt - nleft
            begin_s = b0 if small_is_left else b0 + nleft
            if rec_route and not hooked:
                h_small = hist_fn_raw(rec, begin_s, cnt_s, F, k, num_bins)
                rows = search2_update(hists, h_small, best_leaf, new_leaf,
                                      small_is_left, scal, meta)
            else:
                def range_hist(b, cnt):
                    rs = order[b:b + cnt]
                    with phase_scope("histogram"):
                        return hist_fn(take_bins(bins_T, 1, rs),
                                       grad.index_select(0, rs),
                                       hess.index_select(0, rs),
                                       bag_mask.index_select(0, rs))

                h_small = (hist_fn_raw(rec, begin_s, cnt_s, F, k, num_bins)
                           if rec_route else range_hist(begin_s, cnt_s))
                # the parent's histogram and the children's rows: the
                # buffer rows of the two leaves, or pool slots s1/s2
                if pooled:
                    h_parent, s1, s2 = _pool_slots(
                        slot_of, slot_last, best_leaf,
                        lambda: range_hist(b0, pcnt))
                else:
                    h_parent, s1, s2 = best_leaf, best_leaf, new_leaf
                if step64 is not None and pooled:
                    rows = step64.pool(h_small, h_parent, s1, s2,
                                       small_is_left, scal)
                elif step64 is not None:
                    rows = step64.update(h_small, best_leaf, new_leaf,
                                         small_is_left, scal)
                elif pool_step:
                    rows = search2_pool(hists, h_small, h_parent, s1, s2,
                                        small_is_left, scal, meta)
                else:
                    if not isinstance(h_parent, torch.Tensor):
                        h_parent = hists[h_parent]
                    with phase_scope("split-search"):
                        h_large = h_parent - h_small
                        h_left, h_right = ((h_small, h_large)
                                           if small_is_left
                                           else (h_large, h_small))
                        rows = search2_fn(h_left, h_right, scal, meta)
                        hists[s1] = h_left
                        hists[s2] = h_right
                if pooled:
                    # evict the slots' occupants, then the children claim
                    # them (serial.py:1021-1029; the parent may be its own
                    # evictee)
                    for e in (slot_leaf[s1], slot_leaf[s2]):
                        if e >= 0:
                            slot_of[e] = -1
                    slot_of[best_leaf], slot_of[new_leaf] = s1, s2
                    slot_leaf[s1], slot_leaf[s2] = best_leaf, new_leaf
                    slot_last[s1] = slot_last[s2] = step
            res = _host(rows)
        record_split(best, tree_i, tree_f, bcol, res, best_leaf, node,
                     is_cat)
        begin[new_leaf] = b0 + nleft
        count[best_leaf], count[new_leaf] = nleft, pcnt - nleft
        nleaves += 1

    tree = host_tree(nleaves, tree_i, tree_f, best[_BLV], best[_BLCNT],
                     best[_BLPAR], best[_BLDEP], dev)

    leaf_id = (torch.empty if root_rows is None else torch.zeros)(
        n, dtype=torch.int32, device=dev)
    if rec_route:
        # every split stamped its children's ids into the record's leaf-id
        # row (serial.py:1148-1154)
        W = rec.shape[0]
        with phase_scope("partition"):
            leaf_id[rec[row_id_row(W)].to(torch.int64)] = rec[leaf_row(W)]
        return tree, leaf_id
    # ---- leaf of every row from the final ranges: leaves own disjoint
    # contiguous spans of ``order``, laid out in ``begin`` order
    live = [lf for lf in range(nleaves) if count[lf] > 0]
    live.sort(key=lambda lf: begin[lf])
    with phase_scope("partition"):
        leaf_of_pos = torch.repeat_interleave(
            torch.tensor(live, dtype=torch.int32, device=dev),
            torch.tensor([int(count[lf]) for lf in live], dtype=torch.int64,
                         device=dev),
            output_size=order.shape[0])
        leaf_id[order] = leaf_of_pos
    return tree, leaf_id
