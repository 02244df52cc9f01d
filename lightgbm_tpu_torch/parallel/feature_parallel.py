"""Feature-parallel tree learner: rows replicated, split search sharded.

Counterpart of lightgbm_tpu/parallel/feature_parallel.py, the TPU
re-design of FeatureParallelTreeLearner
(src/treelearner/feature_parallel_tree_learner.cpp): every rank holds
ALL rows but builds histograms and searches thresholds only for its
contiguous feature block (``ceil(F / W)`` features; the reference's
bin-balanced assignment, feature_parallel_tree_learner.cpp:29-42, has
nothing to balance when every feature has the same bin width).  The
global best split is one packed all-gather of the ranks' bests and the
reference's deterministic max (split_comm.py); every rank then makes the
same split on its own copy of the rows, so no collective carries
histograms or counts.  Both children ride one all-gather (the JAX
package gathers each child's best on its own; the winners are the same).

Each rank grows on the order route: the partition in PyTorch over its
whole ``[F, n]`` bins (the split feature may be any rank's), the smaller
child's histogram of its block with kernel 1 (1-f64), the subtraction on
the block, kernel 3 (3-f64's root form) on both children's blocks.
"""

from __future__ import annotations

import torch

from ..learners.serial import grow_tree
from ..ops.cuda_histogram import histogram_single_leaf
from .data_parallel import FeatureShard
from .mesh import Mesh


def make_feature_parallel_grower(mesh: Mesh, num_bins: int, max_leaves: int,
                                 hist_pool: int = 0,
                                 hist_dtype: torch.dtype = torch.float32):
    """grow(bins_T, grad, hess, bag_mask, feature_mask, nbpf, is_cat,
    params) -> (tree, leaf_id) over every row, on every rank."""
    def grow(bins_T, grad, hess, bag_mask, fmask, nbpf, is_cat, params):
        shard = FeatureShard(bins_T.shape[0], mesh.size, mesh.rank, fmask,
                             nbpf, is_cat, bins_T.device)

        def hist_fn(b, g, h, m):
            # ``b`` is the root's bins or a child's gathered rows: slice
            # the block out of what is passed
            return histogram_single_leaf(shard.slice_bins(b), g, h, m,
                                         num_bins, acc_dtype=hist_dtype)

        return grow_tree(
            bins_T, grad, hess, bag_mask, fmask, nbpf, is_cat, params,
            num_bins=num_bins, max_leaves=max_leaves, hist_fn=hist_fn,
            hist_pool=hist_pool, **shard.search_hooks(mesh, "fp"))

    return grow
