"""Forest-level batched growth: one step advances B independent trees.

Counterpart of lightgbm_tpu/learners/forest.py ``make_grow_forest`` with
``impl="batched"`` (:150-400), the JAX package's explicit batched grow
loop; its ``impl="vmap"`` is a JAX lowering with no counterpart here.
The B trees (lanes) are a multiclass iteration's K class trees, a cv
run's folds or ``train_many``'s models (models/gbdt.py
``train_forest_round``).  They share the ``[F, n]`` bins; each lane has
its own gradients, hessians and bagging mask ``[B, n]``, feature mask
``[B, F]`` and ``TreeLearnerParams``, and may have its own root row set
(a cv fold's training rows on the shared bins).

Each step splits every live lane's best leaf.  The host picks the lanes,
their leaves and split values from its tables, then one ``ForestStep``
call (ops/cuda_forest.py, bound once a round to the lanes' tensors and
buffer) uploads them in one copy and runs:

* kernel F1's step form: the partition, a masked update of a direct row
  -> leaf map ``leaf_id [B, n]`` in place (the left child keeps the
  parent's index, the right child takes ``step + 1``, tree.cpp:78-89),
  with the left counts; then each lane's smaller child's histogram (by
  positional count, ties to the left, as learners/serial.py picks it)
  from the rows the map gives it, in ascending row order: the order
  route's window of that leaf, so the histogram is the order route's
  bitwise;
* kernel F3's step form: the larger child as parent - smaller, both
  children written into the lanes' buffer rows, both searched;
* one host read brings every lane's two search rows with its left count
  in slot 11: the winners, the counts and (a gain <= 0 next step) the stop
  flags of all B lanes.

On CPU tensors the same calls run the plain step (ops/forest.py
``forest_step_plain``).
The host keeps each lane's best-split table and node table as the serial
learner keeps its one (``record_split``), so every lane's tree, its leaf
map included, is bitwise the order route's tree grown alone
(docs/forest_batching.md's contract).  At the root one host read brings
every lane's row-order totals (``_root_sums``'s order) and one the root
search rows: two host syncs for the B roots, then one a step, where B
trees grown one by one on the order route take two at each root and two
a split.  Rows outside a lane's root set carry leaf -1 while the lanes
grow and leaf 0 in the returned map.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.tree import Tree
from ..ops.cuda_forest import ForestStep
from ..ops.cuda_search import pack_meta
from .serial import (_BF, _BG, _BLC, _BLCNT, _BLDEP, _BLPAR, _BLSG, _BLSH,
                     _BLV, _BRC, _BRSG, _BRSH, _BT, TreeLearnerParams,
                     _empty_best, _host, host_tree, record_split)

# grow_forest calls (one a round of lanes) since the process started
DISPATCHES = 0


def _scal(params: TreeLearnerParams, can: bool, left, right) -> list:
    """A lane's 12 search scalars: (can, the left child's three totals,
    the right child's, the five constraints)."""
    return ([float(can), *map(float, left), *map(float, right)]
            + [params.min_data_in_leaf, params.min_sum_hessian_in_leaf,
               params.lambda_l1, params.lambda_l2, params.min_gain_to_split])


def _lanes_root_sums(grad, hess, bag_mask, root_rows) -> List[np.ndarray]:
    """Every lane's root (Σ g·m, Σ h·m, Σ m) over its root rows in row
    order (serial._root_sums, float32), from one host read."""
    parts = []
    for b in range(grad.shape[0]):
        st = torch.stack([grad[b] * bag_mask[b], hess[b] * bag_mask[b],
                          bag_mask[b]])
        if root_rows[b] is not None:
            st = st.index_select(1, root_rows[b])
        parts.append(st.reshape(-1))
    flat = _host(torch.cat(parts))
    sums, at = [], 0
    for p in parts:
        x = flat[at:at + p.numel()].reshape(3, -1)
        at += p.numel()
        sums.append(np.zeros(3, np.float32) if x.shape[1] == 0 else
                    np.cumsum(x, axis=1, dtype=np.float32)[:, -1])
    return sums


def grow_forest(bins_T: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                bag_mask: torch.Tensor, feature_mask: torch.Tensor,
                num_bins_per_feature, is_categorical,
                params: Sequence[TreeLearnerParams], num_bins: int,
                max_leaves: int,
                root_rows: Optional[Sequence[Optional[torch.Tensor]]] = None
                ) -> Tuple[List[Tree], torch.Tensor]:
    """Grow B trees at once; returns (B trees, leaf_id [B, n] int32).

    ``bins_T`` [F, n] uint8/uint16; ``grad``/``hess``/``bag_mask`` [B, n]
    float32; ``feature_mask`` [B, F] bool; ``num_bins_per_feature`` /
    ``is_categorical`` [F]; ``params`` B TreeLearnerParams;
    ``root_rows`` None or B entries, each None (every row) or an
    ascending int64 row set (``grow_tree``'s ``root_rows``)."""
    global DISPATCHES
    dev = bins_T.device
    F, n = bins_T.shape
    B, L = grad.shape[0], max_leaves
    DISPATCHES += 1
    grad, hess, bag_mask = (t.contiguous() for t in (grad, hess, bag_mask))
    sets = list(root_rows) if root_rows is not None else [None] * B
    is_cat_h = np.asarray(torch.as_tensor(is_categorical).cpu(), bool)
    meta = torch.stack([pack_meta(feature_mask[b], num_bins_per_feature,
                                  is_categorical, dev) for b in range(B)])

    # ---- roots: every lane's row set as leaf 0 (-1 outside it)
    leaf_id = torch.zeros((B, n), dtype=torch.int32, device=dev)
    n0 = np.full(B, n, np.int64)
    for b, rows in enumerate(sets):
        if rows is not None:
            leaf_id[b].fill_(-1).index_fill_(0, rows, 0)
            n0[b] = rows.shape[0]
    sums = _lanes_root_sums(grad, hess, bag_mask, sets)
    hists = torch.zeros((B, L, F, num_bins, 3), dtype=torch.float32,
                        device=dev)
    fs = ForestStep(bins_T, grad, hess, bag_mask, leaf_id, num_bins,
                    max_rows=int(n0.max(initial=0)), meta=meta, hists=hists)
    scal = np.array([_scal(params[b], params[b].can_split(0), sums[b],
                           sums[b]) for b in range(B)], np.float32)
    res0 = _host(fs.root(scal))
    best = np.stack([_empty_best(L) for _ in range(B)])
    best[:, :11, 0] = res0[:, 0, :11]
    count = np.zeros((B, L), np.int64)
    count[:, 0] = n0
    tree_i = np.zeros((B, 5, L), np.int32)  # feat, thr, dtype, lch, rch
    tree_i[:, 0] = -1
    tree_f = np.zeros((B, 3, L), np.float32)  # gain, int_value, int_count
    nleaves = np.ones(B, np.int64)
    done = np.zeros(B, bool)
    # each lane's constraints, the last five of its search scalars
    consts = np.array([_scal(p, False, (0, 0, 0), (0, 0, 0))[7:]
                       for p in params], np.float32).reshape(B, 5)

    for step in range(L - 1):
        node, new_leaf = step, step + 1
        live = np.flatnonzero(~done)
        top = np.argmax(best[live, _BG], axis=1)  # each lane's best leaf
        ok = best[live, _BG, top] > 0.0
        done[live[~ok]] = True
        act, leaves = live[ok], top[ok]
        if not act.size:
            break
        bcols = best[act, :, leaves]  # [A, rows]: each lane's best column
        pcnt = count[act, leaves]
        feats = bcols[:, _BF].astype(np.int64)
        can = [params[b].can_split(int(d) + 1)
               for b, d in zip(act, bcols[:, _BLDEP])]
        scal = np.column_stack([
            can, bcols[:, [_BLSG, _BLSH, _BLC, _BRSG, _BRSH, _BRC]],
            consts[act]]).astype(np.float32)

        # ---- one forest step on the device: the partition and the
        # smaller child's histogram (F1), the larger by subtraction, both
        # children into the buffer and searched (F3); the left counts
        # ride in slot 11, so one host read serves every lane
        res = _host(fs.step(act, leaves, feats,
                            bcols[:, _BT].astype(np.int64), is_cat_h[feats],
                            pcnt, new_leaf, scal))
        for i, (b, lf) in enumerate(zip(act, leaves)):
            nleft = int(res[i, 0, 11])
            record_split(best[b], tree_i[b], tree_f[b], bcols[i], res[i], lf,
                         node, bool(is_cat_h[feats[i]]))
            count[b, lf], count[b, new_leaf] = nleft, pcnt[i] - nleft
            nleaves[b] += 1

    trees = [host_tree(int(nleaves[b]), tree_i[b], tree_f[b],
                       best[b, _BLV], best[b, _BLCNT], best[b, _BLPAR],
                       best[b, _BLDEP], dev) for b in range(B)]
    return trees, leaf_id.clamp_(min=0)
