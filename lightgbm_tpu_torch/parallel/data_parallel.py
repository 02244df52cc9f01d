"""Data-parallel tree learner: rows sharded over the ranks.

Counterpart of lightgbm_tpu/parallel/data_parallel.py, the TPU re-design
of DataParallelTreeLearner (src/treelearner/
data_parallel_tree_learner.cpp):

* each rank holds a block of rows (``row_padded_grower``: contiguous
  blocks of the whole data, the last padded with rows of mask 0; or the
  rank's partition from a distributed load, ``data_parallel_sharded``);
* each rank builds its rows' histograms of every feature, and one
  reduce-scatter by feature block leaves rank r with the GLOBAL
  histogram of features ``[r·Fs, (r+1)·Fs)``, ``Fs = ceil(F / W)``
  (data_parallel_tree_learner.cpp:127-157); features past F pad the last
  block with ``nbpf = 1`` and a false mask (data_parallel.py:83-90);
* each rank searches its shard and the winners meet in one all-gather
  and the deterministic max (data_parallel_tree_learner.cpp:192-227,
  split_comm.py);
* the root's ``[Σg, Σh, count]`` is one all-reduce
  (data_parallel_tree_learner.cpp:97-125);
* the leaf partition stays local (leaf ids are global numbers).

Collectives of a leaf-wise tree: the root's three (sums all-reduce,
histogram reduce-scatter, split all-gather), then exactly three a split:
one all-gather of both children's local counts (``child_counts_fn``),
one reduce-scatter of the smaller child's ``[F, B, 3]`` partials, one
all-gather of both children's packed ``[2, 11]`` shard-best rows.  A
depthwise level costs one reduce-scatter of ``[K, F, B, 3]`` and one
all-gather of ``[K, 11]``.  ``row_padded_grower`` adds one all-gather
of the leaf ids a tree.

Kernels a rank launches on the card, at its own shapes: leaf-wise on the
record route (float32, unpooled) kernels 6 and 7 partition its record,
kernel 1' builds the smaller child's window histogram and kernel 3
searches the two children's ``[Fs, B, 3]`` shards (the subtraction runs
on the shard); pooled or float64 on the order route, kernel 1 (1-f64)
and kernel 3 (3-f64's root form); depthwise kernel 1'' (1''-f64) and the
PyTorch search on the level's shard, as serial depthwise; hybrid both.
Float order: a reduce-scatter sums the W partials in the backend's order,
so on data whose sums are not exact a near tie can flip a split; on data
whose sums are exact the trees are bitwise the serial learner's.
"""

from __future__ import annotations

import torch

from ..learners.depthwise import grow_tree_depthwise
from ..learners.hybrid import grow_tree_hybrid
from ..learners.serial import grow_tree
from ..ops.cuda_histogram import (histogram_record_window,
                                  histogram_single_leaf, make_level_hist_fn)
from ..ops.cuda_search import pack_meta, search2_rows
from ..ops.split import SplitResult, find_best_split_leaves
from .mesh import Mesh, row_padded_grower
from .split_comm import gather_and_combine, gather_rows


class FeatureShard:
    """Rank ``index`` of ``count``'s block of the F features: ``start``,
    ``width`` (``ceil(F / count)``), ``pad`` (features past F in the last
    blocks) and the shard's metadata, padded features unusable."""

    def __init__(self, F: int, count: int, index: int, feature_mask, nbpf,
                 is_cat, device):
        self.width = -(-F // count)
        self.pad = self.width * count - F
        self.start = index * self.width
        dev = torch.device(device)

        def local(a, fill):
            a = torch.as_tensor(a).to(dev)
            a = torch.cat([a, a.new_full((self.pad,), fill)])
            return a[self.start:self.start + self.width]

        self.fmask = local(feature_mask, False)
        self.nbpf = local(nbpf, 1)
        self.is_cat = local(is_cat, False)
        self.meta = pack_meta(self.fmask, self.nbpf, self.is_cat, dev)

    def pad_features(self, h: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """``h`` with the padded features' zero histograms appended."""
        if not self.pad:
            return h
        shape = list(h.shape)
        shape[dim] = self.pad
        return torch.cat([h, h.new_zeros(shape)], dim)

    def slice_bins(self, bins: torch.Tensor) -> torch.Tensor:
        """Rows ``[start, start + width)`` of ``[F, n]`` bins, features
        past F of bin 0."""
        part = bins[self.start:self.start + self.width]
        if part.shape[0] == self.width:
            return part
        return torch.cat([part, part.new_zeros(
            (self.width - part.shape[0],) + tuple(part.shape[1:]))])

    def search_hooks(self, mesh: Mesh, prefix: str) -> dict:
        """``grow_tree``'s ``search_fn`` and ``search2_fn`` over this
        shard: kernel 3 on the shard's histograms, then one packed
        all-gather over ``mesh`` and the deterministic max (sites
        ``<prefix>.root_split_allgather`` and ``<prefix>.split_allgather``)."""
        def search_fn(hist, scal, _meta):
            return gather_rows(search2_rows(hist, hist, scal, self.meta)[:1],
                               self.start, mesh,
                               f"{prefix}.root_split_allgather")

        def search2_fn(h_left, h_right, scal, _meta):
            return gather_rows(search2_rows(h_left, h_right, scal, self.meta),
                               self.start, mesh, f"{prefix}.split_allgather")

        return dict(search_fn=search_fn, search2_fn=search2_fn)

    def offset(self, r: SplitResult) -> SplitResult:
        """A shard search's SplitResult with global feature ids."""
        return r._replace(feature=torch.where(r.feature >= 0,
                                              r.feature + self.start,
                                              r.feature))


def search_shard_leaves(mesh: Mesh, shard: FeatureShard, params, site: str):
    """``search_leaves_fn`` over a level's ``[K, Fs, B, 3]`` shard: the
    PyTorch search of the shard, then one packed ``[W, K, 11]``
    all-gather and the deterministic max."""
    consts = [params.min_data_in_leaf, params.min_sum_hessian_in_leaf,
              params.lambda_l1, params.lambda_l2, params.min_gain_to_split]

    def search_leaves_fn(hist, sg, sh, c, can):
        r = find_best_split_leaves(hist, sg, sh, c, shard.fmask, shard.nbpf,
                                   shard.is_cat, *consts, can)
        return gather_and_combine(shard.offset(r), mesh, site)

    return search_leaves_fn


def data_parallel_sharded(mesh: Mesh, num_bins: int, max_leaves: int,
                          growth: str = "leafwise", hist_pool: int = 0,
                          hist_dtype: torch.dtype = torch.float32):
    """grow(bins_T, grad, hess, bag_mask, feature_mask, nbpf, is_cat,
    params) -> (tree, leaf_id) over THIS rank's rows (its block or its
    partition): every rank calls it at once and returns the same tree.
    Leaf-wise float32 unpooled trees take the record route."""
    W, rank = mesh.size, mesh.rank
    level_hist = make_level_hist_fn(num_bins, hist_dtype)

    def grow(bins_T, grad, hess, bag_mask, fmask, nbpf, is_cat, params):
        shard = FeatureShard(bins_T.shape[0], W, rank, fmask, nbpf, is_cat,
                             bins_T.device)

        def scatter(h, dim, site):
            return mesh.psum_scatter(shard.pad_features(h, dim), dim,
                                     site=site)

        def level_hist_scatter(bt, lid, g, h, m, num_leaves):
            return scatter(level_hist(bt, lid, g, h, m, num_leaves), 1,
                           "dp.level_hist_reduce_scatter")

        search_leaves_fn = search_shard_leaves(
            mesh, shard, params, "dp.split_allgather_leaves")
        if growth == "depthwise":
            return grow_tree_depthwise(
                bins_T, grad, hess, bag_mask, fmask, nbpf, is_cat, params,
                num_bins=num_bins, max_leaves=max_leaves,
                hist_fn=level_hist_scatter,
                search_leaves_fn=search_leaves_fn)

        def hist_scatter(b, g, h, m):
            return scatter(histogram_single_leaf(b, g, h, m, num_bins,
                                                 acc_dtype=hist_dtype),
                           0, "dp.hist_reduce_scatter")

        def hist_scatter_raw(rec, begin, cnt, F, k, nb):
            return scatter(histogram_record_window(rec, begin, cnt, F, k, nb),
                           0, "dp.hist_reduce_scatter")

        hooks = dict(
            reduce_fn=lambda x: mesh.psum(x, site="dp.root_sums_allreduce"),
            child_counts_fn=mesh.child_counts_fn("dp.child_counts_allgather"),
            **shard.search_hooks(mesh, "dp"))
        if growth == "hybrid":
            # the level phase and the resume's fused pass reduce-scatter
            # levels; the best-first phase takes the leaf-wise hooks
            return grow_tree_hybrid(
                bins_T, grad, hess, bag_mask, fmask, nbpf, is_cat, params,
                num_bins=num_bins, max_leaves=max_leaves,
                hist_fn=hist_scatter, level_hist_fn=level_hist_scatter,
                search_leaves_fn=search_leaves_fn, **hooks)
        use_record = (hist_dtype == torch.float32
                      and not 0 < hist_pool < max_leaves)
        return grow_tree(
            bins_T, grad, hess, bag_mask, fmask, nbpf, is_cat, params,
            num_bins=num_bins, max_leaves=max_leaves, hist_fn=hist_scatter,
            hist_fn_raw=hist_scatter_raw if use_record else None,
            hist_pool=hist_pool, **hooks)

    return grow


def make_data_parallel_grower(mesh: Mesh, num_bins: int, max_leaves: int,
                              growth: str = "leafwise", hist_pool: int = 0,
                              hist_dtype: torch.dtype = torch.float32):
    """grow(...) over every row: each rank keeps its contiguous block
    (``row_padded_grower``) and returns the whole row -> leaf map.
    ``growth`` is ``leafwise``, ``depthwise`` or ``hybrid``."""
    return row_padded_grower(
        data_parallel_sharded(mesh, num_bins, max_leaves, growth=growth,
                              hist_pool=hist_pool, hist_dtype=hist_dtype),
        mesh)
