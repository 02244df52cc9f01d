"""Grid-parallel tree learner: rows x split search over a 2-D world.

Counterpart of lightgbm_tpu/parallel/grid_parallel.py: on an ``R x C``
grid of ranks (rank = r·C + c), rows are sharded over the row axis (row
block r, replicated across the C ranks of that row) and the split SEARCH
over the feature axis (feature block c).  A split costs each rank

1. the histogram of its feature block over its row block (kernel 1 on
   the order route: n/R rows x F/C features of work),
2. an all-reduce over the ranks of its feature block, the R ranks that
   hold the other row blocks (the data-parallel reduce),
3. a search of its block (kernel 3) and one packed all-gather over the C
   ranks of its row block with the deterministic max (the
   feature-parallel combine).

Every rank stores all F features of its rows, so the winning split
partitions locally with its global feature id and the tree is the same
on every rank.  ``grid_mesh`` makes the two axes as ``torch.distributed``
sub-groups; every rank creates every sub-group, in the same order, as
``new_group`` requires.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..learners.serial import grow_tree
from ..ops.cuda_histogram import histogram_single_leaf
from .data_parallel import FeatureShard
from .mesh import FEATURE_AXIS, ROW_AXIS, Mesh, row_padded_grower


class GridMesh:
    """An ``R x C`` grid: ``row`` is the Mesh over the R ranks of this
    rank's feature block (axis ``row``), ``feature`` the Mesh over the C
    ranks of its row block (axis ``feature``)."""

    def __init__(self, shape, device=None):
        R, C = shape
        W = dist.get_world_size()
        if R * C != W:
            raise ValueError(f"a {R} x {C} grid needs {R * C} ranks, the "
                             f"world has {W}: pick grid_feature_shards "
                             "dividing the rank count")
        rank = dist.get_rank()
        r, c = divmod(rank, C)
        col_groups = [dist.new_group([i * C + j for i in range(R)])
                      for j in range(C)]
        row_groups = [dist.new_group([i * C + j for j in range(C)])
                      for i in range(R)]
        self.row = Mesh(col_groups[c], ROW_AXIS, device)
        self.feature = Mesh(row_groups[r], FEATURE_AXIS, device)
        self.shape = {ROW_AXIS: R, FEATURE_AXIS: C}


def grid_mesh(shape, device=None) -> GridMesh:
    """An ``(R, C)`` grid over the whole world, axes (row, feature)."""
    return GridMesh(shape, device)


def make_grid_parallel_grower(mesh: GridMesh, num_bins: int, max_leaves: int,
                              hist_pool: int = 0,
                              hist_dtype: torch.dtype = torch.float32):
    """grow(bins_T, grad, hess, bag_mask, feature_mask, nbpf, is_cat,
    params) -> (tree, leaf_id) over every row: rank (r, c) keeps row
    block r and the whole row -> leaf map comes back on every rank."""
    rows, feats = mesh.row, mesh.feature

    def sharded(bins_T, grad, hess, bag_mask, fmask, nbpf, is_cat, params):
        shard = FeatureShard(bins_T.shape[0], feats.size, feats.rank, fmask,
                             nbpf, is_cat, bins_T.device)

        def hist_fn(b, g, h, m):
            return rows.psum(
                histogram_single_leaf(shard.slice_bins(b), g, h, m, num_bins,
                                      acc_dtype=hist_dtype),
                site="grid.hist_allreduce")

        return grow_tree(
            bins_T, grad, hess, bag_mask, fmask, nbpf, is_cat, params,
            num_bins=num_bins, max_leaves=max_leaves, hist_fn=hist_fn,
            hist_pool=hist_pool,
            reduce_fn=lambda x: rows.psum(x, site="grid.root_sums_allreduce"),
            child_counts_fn=rows.child_counts_fn(
                "grid.child_counts_allgather"),
            **shard.search_hooks(feats, "grid"))

    return row_padded_grower(sharded, rows)
