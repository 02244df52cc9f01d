"""Decision tree model as a small dataclass of tensors.

Counterpart of lightgbm_tpu/models/tree.py.  The layout is the
reference's flat-array Tree (tree.h:18-198): internal nodes
``0..L-2``, leaves addressed as ``~leaf`` in child pointers, every
per-node and per-leaf field padded to the ``max_leaves`` training
budget.  ``num_leaves`` is the used leaf count, kept as a Python int
(the port reads it on the host anyway: growth syncs once per split).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

_INT_FIELDS = ("split_feature", "split_feature_real", "threshold_bin",
               "decision_type", "left_child", "right_child", "leaf_parent",
               "leaf_depth")
_NODE_FIELDS = ("split_feature", "split_feature_real", "threshold_bin",
                "threshold_real", "decision_type", "left_child",
                "right_child", "split_gain", "internal_value",
                "internal_count")
_LEAF_FIELDS = ("leaf_value", "leaf_count", "leaf_parent", "leaf_depth")
TREE_FIELDS = _NODE_FIELDS + _LEAF_FIELDS


@dataclasses.dataclass
class Tree:
    num_leaves: int  # used leaves (1 = stump)
    # internal nodes [max_leaves-1]
    split_feature: torch.Tensor  # inner feature index
    split_feature_real: torch.Tensor  # original column index (model IO)
    threshold_bin: torch.Tensor  # bin-space threshold
    threshold_real: torch.Tensor  # raw-value threshold (filled at finalize)
    decision_type: torch.Tensor  # 0 numerical (<=), 1 categorical (==)
    left_child: torch.Tensor  # node idx or ~leaf
    right_child: torch.Tensor
    split_gain: torch.Tensor
    internal_value: torch.Tensor
    internal_count: torch.Tensor
    # leaves [max_leaves]
    leaf_value: torch.Tensor
    leaf_count: torch.Tensor
    leaf_parent: torch.Tensor
    leaf_depth: torch.Tensor

    @property
    def max_leaves(self) -> int:
        return self.leaf_value.shape[-1]

    def replace(self, **kw) -> "Tree":
        return dataclasses.replace(self, **kw)

    def shrink(self, rate: float) -> "Tree":
        """Tree::Shrinkage (tree.h:103-107)."""
        return self.replace(leaf_value=self.leaf_value * rate,
                            internal_value=self.internal_value * rate)


def empty_tree(max_leaves: int, device="cpu") -> Tree:
    li = max_leaves - 1

    def full(n, v, dt):
        return torch.full((n,), v, dtype=dt, device=device)

    i32, f32 = torch.int32, torch.float32
    return Tree(
        num_leaves=1,
        split_feature=full(li, -1, i32),
        split_feature_real=full(li, -1, i32),
        threshold_bin=full(li, 0, i32),
        threshold_real=full(li, 0, f32),
        decision_type=full(li, 0, i32),
        left_child=full(li, 0, i32),
        right_child=full(li, 0, i32),
        split_gain=full(li, 0, f32),
        internal_value=full(li, 0, f32),
        internal_count=full(li, 0, f32),
        leaf_value=full(max_leaves, 0, f32),
        leaf_count=full(max_leaves, 0, f32),
        leaf_parent=full(max_leaves, -1, i32),
        leaf_depth=full(max_leaves, 0, i32),
    )


def _walk(tree: Tree, X: torch.Tensor, feat: torch.Tensor,
          thr: torch.Tensor, raw: bool) -> torch.Tensor:
    """Lockstep root-to-leaf walk of every row (Tree::GetLeaf,
    tree.cpp:98-122 / Tree::Predict, tree.h:226-238).  Rows that reached
    a leaf keep their (negative) node; the loop ends when none is left
    or after max_leaves-1 steps.  Returns the leaf index per row."""
    n = X.shape[0]
    start = 0 if tree.num_leaves > 1 else -1
    node = torch.full((n,), start, dtype=torch.int64, device=X.device)
    if tree.num_leaves <= 1:
        return ~node
    is_cat_n = tree.decision_type.to(torch.int64) == 1
    lch = tree.left_child.to(torch.int64)
    rch = tree.right_child.to(torch.int64)
    feat = feat.to(torch.int64).clamp(min=0)
    for _ in range(tree.max_leaves - 1):
        active = node >= 0
        if not bool(active.any()):
            break
        idx = node.clamp(min=0)
        f = feat[idx]
        t = thr[idx]
        v = X.gather(1, f[:, None])[:, 0]
        if raw:
            go_left = torch.where(
                is_cat_n[idx], v.to(torch.int32) == t.to(torch.int32), v <= t)
        else:
            go_left = torch.where(is_cat_n[idx], v == t, v <= t)
        nxt = torch.where(go_left, lch[idx], rch[idx])
        node = torch.where(active, nxt, node)
    return ~node


def predict_leaf_binned(tree: Tree, X_bin: torch.Tensor) -> torch.Tensor:
    """Leaf index per row of a BINNED row-major matrix ``[n, F]``."""
    return _walk(tree, X_bin.to(torch.int32), tree.split_feature,
                 tree.threshold_bin, raw=False)


def predict_binned(tree: Tree, X_bin: torch.Tensor) -> torch.Tensor:
    return tree.leaf_value[predict_leaf_binned(tree, X_bin)]


def predict_leaf_raw(tree: Tree, X: torch.Tensor) -> torch.Tensor:
    """Leaf index per row on RAW float32 features: numerical goes left
    when value <= threshold_real, categorical when int(value) ==
    int(threshold_real)."""
    return _walk(tree, X, tree.split_feature_real, tree.threshold_real,
                 raw=True)


def predict_raw(tree: Tree, X: torch.Tensor) -> torch.Tensor:
    return tree.leaf_value[predict_leaf_raw(tree, X)]


# ---------------------------------------------------------------- thresholds
def pack_threshold_bounds(bin_thresholds: List[np.ndarray],
                          real_feature_indices, device="cpu"):
    """Per-feature bin upper bounds as one padded ``[F, Bmax]`` f32 matrix
    (+inf -> float32 max; bins past a feature's list reuse its last
    bound) plus the real-feature index vector."""
    F = len(bin_thresholds)
    bmax = max((len(b) for b in bin_thresholds), default=1)
    mat = np.full((max(F, 1), max(bmax, 1)), np.finfo(np.float32).max,
                  np.float32)
    for f, bounds in enumerate(bin_thresholds):
        for b, v in enumerate(bounds):
            mat[f, b] = (np.float32(v) if np.isfinite(v)
                         else np.finfo(np.float32).max)
        mat[f, len(bounds):] = mat[f, max(len(bounds) - 1, 0)]
    return (torch.from_numpy(mat).to(device),
            torch.from_numpy(np.asarray(real_feature_indices, np.int32))
            .to(device))


def finalize_thresholds_device(tree: Tree, bounds_mat: torch.Tensor,
                               real_feat: torch.Tensor) -> Tree:
    """Real thresholds from the bin upper bounds (numerical: the bin's
    upper bound, tree.cpp:70; categorical: the category) and real feature
    ids, as tensor ops (-1/0 on non-split nodes)."""
    sf = tree.split_feature.to(torch.int64)
    is_split = sf >= 0
    fc = sf.clamp(min=0)
    tb = tree.threshold_bin.to(torch.int64).clamp(0, bounds_mat.shape[1] - 1)
    tr = torch.where(is_split, bounds_mat[fc, tb],
                     torch.zeros((), dtype=torch.float32, device=sf.device))
    sfr = torch.where(is_split, real_feat[fc].to(torch.int32),
                      torch.full((), -1, dtype=torch.int32, device=sf.device))
    return tree.replace(threshold_real=tr.to(torch.float32),
                        split_feature_real=sfr)

