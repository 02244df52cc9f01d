"""Hybrid growth: depthwise levels, then best-first refinement.

Counterpart of lightgbm_tpu/learners/hybrid.py ``grow_tree_hybrid``
(:39-73): phase 1 grows level-synchronously (learners/depthwise.py) while
the frontier stays within ``max_leaves // HYBRID_STOP_FACTOR`` leaves, so
no level is cut by the budget; phase 2 resumes exact best-first growth
from that tree (``serial.grow_tree`` with ``init_tree``, on the order
route), spending the rest of the budget one highest-gain leaf at a time.
The phase-1 tree is handed over on the host, where the resume reads it.
"""

from __future__ import annotations

from .depthwise import grow_tree_depthwise
from .serial import grow_tree

# the JAX package's handoff factor (hybrid.py:39)
HYBRID_STOP_FACTOR = 4


def grow_tree_hybrid(bins_T, grad, hess, bag_mask, feature_mask,
                     num_bins_per_feature, is_categorical, params,
                     num_bins: int, max_leaves: int, hist_fn=None,
                     level_hist_fn=None, search_leaves_fn=None, **hooks):
    """Grow one tree: depthwise to ``max_leaves // 4``, best-first the
    rest.  ``hist_fn`` is the single-leaf histogram of phase 2,
    ``level_hist_fn`` the level histogram of phase 1 and of the resume's
    fused pass.  The data-parallel learner passes its level search as
    ``search_leaves_fn`` (phase 1 and the resume's ``init_search_fn``)
    and its leaf-wise ``hooks`` (``grow_tree``'s ``reduce_fn``,
    ``search2_fn``, ...) to phase 2, as data_parallel.py:236-258 does.
    Returns (tree, leaf_id)."""
    tree1, leaf1 = grow_tree_depthwise(
        bins_T, grad, hess, bag_mask, feature_mask, num_bins_per_feature,
        is_categorical, params, num_bins=num_bins, max_leaves=max_leaves,
        hist_fn=level_hist_fn, stop_before_budget=HYBRID_STOP_FACTOR,
        tree_device="cpu", search_leaves_fn=search_leaves_fn)
    return grow_tree(
        bins_T, grad, hess, bag_mask, feature_mask, num_bins_per_feature,
        is_categorical, params, num_bins=num_bins, max_leaves=max_leaves,
        hist_fn=hist_fn, init_tree=tree1, init_leaf_id=leaf1,
        init_hist_fn=level_hist_fn, init_search_fn=search_leaves_fn,
        **hooks)
