"""Depthwise (level-synchronous) tree learner.

Counterpart of lightgbm_tpu/learners/depthwise.py ``grow_tree_depthwise``:
a whole level grows per iteration, as a Python loop with one host read
per level.

* **Histogram**: ``hist_fn`` builds the level histogram of every live
  leaf in one pass (ops/cuda_histogram.histogram_by_leaf_sorted: kernel
  1'', or kernel 2 under ``LGBM_TPU_HIST_KERNEL=bsub``, on the card; the
  plain version on the CPU).
* **Leaf totals** come from feature 0's bins (depthwise.py:108), summed in
  the JAX package's CPU order (ops/histogram.leaf_totals).
* **Search**: ops/split.find_best_split_leaves scores every leaf in
  PyTorch ops on every device, as the JAX package runs its jnp search
  outside any Pallas kernel on the TPU too (depthwise.py:90-96).
* **One host read per level**: the level's split rows (the eleven
  SplitResult fields and the winner's categorical flag).  On the host the
  budget selection takes the top-gain leaves by a stable sort on -gain
  (depthwise.py:121-129, dead and non-positive gains last, leaf index
  breaking ties), numbers the new nodes in gain order (:131-140), updates
  the tree tables (:142-207; two sibling leaves may hook into one parent on
  different sides) and applies the stop rule, ``stop_before_budget``
  included (:219-235).
* **Partition**: one elementwise pass on the device routes every row of
  a split leaf (:209-217).

Sizing: the JAX grower builds ``hist[max_leaves, F, B, 3]`` every level
and searches every row with ``can_split = live & depth_ok``.  The port
sizes a level's histogram and search by its ``K`` live leaves (leaf ids
``0..K-1``).  In the JAX search a dead leaf's row carries gain
``K_MIN_SCORE`` and sorts after every live leaf in the stable budget
order, so the live leaves' rows, their ranks and the selection are the
JAX package's.

Float64 histograms (hist_dtype=float64): the level histogram is float64
(kernel 1''-f64 on the card), and so are the totals, the search and the
level's read, so the gain ranking and ``lc + rc`` are taken in float64, as
the JAX package's level state is; the tree tables round each value once
to float32, as its float32 tree arrays do.  The JAX package's own float64
depthwise grower does not run (ROADMAP C9).

Host syncs: one per level.  The host-to-device copies of a level (the
partition's per-leaf table after the read; the per-leaf ``can_split``
when ``max_depth`` > 0) are not counted: they follow a read, when the
card's queue is already empty.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.tree import Tree
from ..ops.cuda_histogram import make_level_hist_fn
from ..ops.histogram import leaf_totals, take_bins
from ..ops.split import find_best_split_leaves
from .serial import TreeLearnerParams, _host, host_tree

# levels grown and splits made by them since the last reset (chip_smoke.py
# reads and resets them)
LEVELS = 0
LEVEL_SPLITS = 0

# rows of the per-level read: the SplitResult fields, then the flag
_GAIN, _FEAT, _THR, _LC, _RC, _LOUT, _ROUT, _CAT = 0, 1, 2, 5, 8, 9, 10, 11


def _route(bins_T: torch.Tensor, leaf_id: torch.Tensor,
           tab: torch.Tensor) -> torch.Tensor:
    """One partition pass: ``tab`` [4, K] int32 holds per leaf the split
    feature (-1: not split), threshold, categorical flag and right child's
    leaf.  A row of a split leaf that does not go left moves to the right
    child (depthwise.py:209-217)."""
    F, n = bins_T.shape
    lid = leaf_id.to(torch.int64)
    f_row = tab[0][lid]
    pos = f_row.clamp(min=0).to(torch.int64) * n + torch.arange(
        n, device=leaf_id.device)
    v = take_bins(bins_T.reshape(-1), 0, pos).to(torch.int32)
    thr = tab[1][lid]
    go_left = torch.where(tab[2][lid] > 0, v == thr, v <= thr)
    return torch.where((f_row >= 0) & ~go_left, tab[3][lid], leaf_id)


def grow_tree_depthwise(bins_T: torch.Tensor, grad: torch.Tensor,
                        hess: torch.Tensor, bag_mask: torch.Tensor,
                        feature_mask, num_bins_per_feature, is_categorical,
                        params: TreeLearnerParams, num_bins: int,
                        max_leaves: int, hist_fn=None,
                        stop_before_budget: int = 0,
                        tree_device=None, search_leaves_fn=None
                        ) -> Tuple[Tree, torch.Tensor]:
    """Grow one tree level by level; returns (tree, leaf_id per row).

    Arguments as ``serial.grow_tree``'s.  ``hist_fn(bins_T, leaf_id, grad,
    hess, mask, num_leaves) -> [num_leaves, F, B, 3]`` is the level
    histogram (default: ``histogram_by_leaf_sorted``); its dtype is the
    level's (float64 under hist_dtype=float64).
    ``stop_before_budget`` (hybrid growth's first phase) stops once
    ``factor * num_leaves > max_leaves``.  The tree's tensors go to
    ``tree_device`` (default: ``bins_T``'s device); the hybrid learner
    keeps them on the host for its resume.

    ``search_leaves_fn(hist, sum_g, sum_h, count, can) -> SplitResult``
    searches a level (default: ``find_best_split_leaves`` over every
    feature): the data-parallel learner's searches its feature shard of
    a reduce-scattered level histogram and combines the ranks' winners
    (depthwise.py:90-96, data_parallel.py:114-160).  The leaf totals come
    from the first feature of the histogram ``hist_fn`` returns, its
    shard's under the data-parallel learner, as in the JAX package."""
    global LEVELS, LEVEL_SPLITS
    dev = bins_T.device
    F, n = bins_T.shape
    L = max_leaves
    if hist_fn is None:
        hist_fn = make_level_hist_fn(num_bins)
    is_cat = torch.as_tensor(is_categorical, device=dev)
    consts = torch.tensor(
        [params.min_data_in_leaf, params.min_sum_hessian_in_leaf,
         params.lambda_l1, params.lambda_l2, params.min_gain_to_split],
        dtype=torch.float32, device=dev)
    max_levels = params.max_depth if params.max_depth > 0 else L - 1
    if search_leaves_fn is None:
        def search_leaves_fn(hist, sg, sh, c, can):
            return find_best_split_leaves(hist, sg, sh, c, feature_mask,
                                          num_bins_per_feature, is_cat,
                                          *consts, can)

    tree_i = np.zeros((5, L), np.int32)  # feat, thr, dtype, lch, rch
    tree_i[0] = -1
    tree_f = np.zeros((3, L), np.float32)  # gain, int_value, int_count
    leaf_value = np.zeros(L, np.float32)
    leaf_count = np.zeros(L, np.float32)
    leaf_parent = np.full(L, -1, np.int32)
    leaf_depth = np.zeros(L, np.int32)
    leaf_id = torch.zeros(n, dtype=torch.int32, device=dev)
    K, depth = 1, 0

    while True:
        # ---- one histogram pass, one search, one read for the level
        hist = hist_fn(bins_T, leaf_id, grad, hess, bag_mask, K)
        tot = leaf_totals(hist)
        if params.max_depth > 0:
            can = torch.from_numpy(leaf_depth[:K] < params.max_depth).to(dev)
        else:
            can = torch.ones(K, dtype=torch.bool, device=dev)
        best = search_leaves_fn(hist, tot[:, 0], tot[:, 1], tot[:, 2], can)
        dt = hist.dtype
        del hist  # the next level's histogram must not wait for it
        cat = is_cat[best.feature.clamp(min=0).to(torch.int64)]
        res = _host(torch.stack([a.to(dt) for a in best] + [cat.to(dt)]))
        LEVELS += 1

        # ---- budget selection: top-gain splits, at most L - K
        gains = np.where(res[_GAIN] > 0.0, res[_GAIN], -np.inf)
        order = np.argsort(-gains, kind="stable")  # leaf-index tie-break
        rank = np.empty(K, np.int64)
        rank[order] = np.arange(K)
        selected = (gains > -np.inf) & (rank < L - K)
        n_sel = int(selected.sum())

        if n_sel:
            # ---- node numbering in gain order: the i-th selected split is
            # node K-1+i, its right child leaf K+i
            slot_of = np.empty(K, np.int64)
            slot_of[order] = np.cumsum(selected[order]) - 1
            lv = np.flatnonzero(selected)
            node = K - 1 + slot_of[lv]
            new = K + slot_of[lv]
            feat = res[_FEAT, lv].astype(np.int32)
            thr = res[_THR, lv].astype(np.int32)
            iscat = res[_CAT, lv].astype(np.int32)

            # ---- tree tables (Tree::Split, tree.cpp:52-96)
            parent = leaf_parent[lv]
            was_left = tree_i[3, np.maximum(parent, 0)] == ~lv
            tree_i[:, node] = [feat, thr, iscat, ~lv, ~new]
            tree_f[:, node] = [res[_GAIN, lv], leaf_value[lv],
                               res[_LC, lv] + res[_RC, lv]]
            hooked = parent >= 0
            tree_i[3, parent[hooked & was_left]] = node[hooked & was_left]
            tree_i[4, parent[hooked & ~was_left]] = node[hooked & ~was_left]
            depth_child = leaf_depth[lv] + 1
            for side, rows_of in ((lv, (_LOUT, _LC)), (new, (_ROUT, _RC))):
                leaf_value[side] = res[rows_of[0], lv]
                leaf_count[side] = res[rows_of[1], lv]
                leaf_parent[side] = node
                leaf_depth[side] = depth_child

            # ---- one partition pass for the whole level
            tab = np.full((4, K), -1, np.int32)
            tab[:, lv] = [feat, thr, iscat, new]
            leaf_id = _route(bins_T, leaf_id, torch.from_numpy(tab).to(dev))
            LEVEL_SPLITS += n_sel

        K += n_sel
        depth += 1
        keep_going = n_sel > 0 and K < L and depth < max_levels
        if stop_before_budget:
            # hybrid phase 1 goes on only while factor * K <= L
            keep_going = keep_going and stop_before_budget * K <= L
        if not keep_going:
            break

    tree = host_tree(K, tree_i, tree_f, leaf_value, leaf_count, leaf_parent,
                     leaf_depth, dev if tree_device is None else tree_device)
    return tree, leaf_id
