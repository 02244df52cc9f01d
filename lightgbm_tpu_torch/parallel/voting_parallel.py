"""Voting-parallel (PV-Tree) learner: data parallel with top-k voting.

Counterpart of lightgbm_tpu/parallel/voting_parallel.py, the TPU
re-design of VotingParallelTreeLearner
(src/treelearner/voting_parallel_tree_learner.cpp): rows are sharded as
for the data-parallel learner, but instead of reducing every feature's
histogram each rank

(a) searches its LOCAL histogram feature by feature, with the data
    constraints scaled by 1/W (voting_parallel_tree_learner.cpp:52-54);
(b) proposes its local top ``2·top_k`` features (ArrayArgs::MaxK, :229-232);
(c) the proposals, weighted by the rank's local count, are summed with
    one all-reduce of an ``[F]`` vector, and the top ``2·top_k`` by votes
    are selected (:137-166);
(d) only the selected features' histograms are summed, with a second
    all-reduce (:260-265), and every rank searches them alike, so no
    SplitInfo exchange is needed.

Both children vote in the same two all-reduces.  "Top" is a stable sort
on (-value, index): ``torch.topk`` does not order equal values, and the
JAX package's ``lax.top_k`` keeps the lower index first; ranks that broke
ties differently would select different features.  Each rank grows on
the record route (float32, unpooled: kernels 6 and 7, kernel 1' for the
smaller child's LOCAL histogram, the subtraction on local histograms) or
the order route (kernel 1), the per-feature local gains in PyTorch (the
JAX package's are jnp too) and kernel 3 once a child on the selected
features' summed histograms.
"""

from __future__ import annotations

import numpy as np
import torch

from ..learners.serial import grow_tree
from ..ops.cuda_histogram import histogram_record_window, histogram_single_leaf
from ..ops.cuda_search import pack_meta, search2_rows
from ..ops.split import feature_best_gains
from .mesh import Mesh, row_padded_grower


def top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest entries along the last axis,
    larger first and equal values in index order (``lax.top_k``'s)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def voting_parallel_sharded(mesh: Mesh, num_bins: int, max_leaves: int,
                            top_k: int, hist_pool: int = 0,
                            hist_dtype: torch.dtype = torch.float32):
    """grow(...) over THIS rank's rows; the same tree on every rank."""
    W = mesh.size
    scale = np.float32(1.0 / W)

    def grow(bins_T, grad, hess, bag_mask, fmask, nbpf, is_cat, params):
        F = bins_T.shape[0]
        dev = bins_T.device
        k2 = min(2 * top_k, F)
        fmask_t = torch.as_tensor(fmask).to(dev).bool()
        nbpf_t = torch.as_tensor(nbpf).to(dev)
        iscat_t = torch.as_tensor(is_cat).to(dev).bool()
        local_consts = [float(np.float32(params.min_data_in_leaf) * scale),
                        float(np.float32(params.min_sum_hessian_in_leaf)
                              * scale),
                        params.lambda_l1, params.lambda_l2,
                        params.min_gain_to_split]

        def vote(hists, scal):
            """Rows ``[C, 11]`` of the C children whose local histograms
            are ``hists`` [C, F, B, 3]; ``scal`` the children's global
            totals as ``search2_rows`` takes them."""
            C = hists.shape[0]
            can = bool(scal[0])
            # (a) local totals from feature 0's bins, local gains
            tot = hists[:, 0].sum(dim=1)  # [C, 3]
            gains = feature_best_gains(
                hists, tot[:, 0], tot[:, 1], tot[:, 2], fmask_t, nbpf_t,
                iscat_t, *local_consts,
                torch.full((C,), can, dtype=torch.bool, device=dev))
            # (b) + (c) proposals weighted by the local counts
            prop = torch.zeros((C, F), dtype=hists.dtype, device=dev)
            prop.scatter_(1, top_indices(gains, k2), 1.0)
            votes = mesh.psum(prop * tot[:, 2:3], site="vp.votes_allreduce")
            sel = torch.sort(top_indices(votes, k2), dim=1).values  # [C, k2]
            # (d) the winners' histograms summed, searched alike everywhere
            summed = mesh.psum(
                torch.stack([hists[c, sel[c]] for c in range(C)]),
                site="vp.hist_allreduce")
            out = []
            for c in range(C):
                s = sel[c]
                meta = pack_meta(fmask_t[s], nbpf_t[s], iscat_t[s], dev)
                sc = list(scal)
                if c == 1:  # the right child's totals in the left's place
                    sc[1:4] = scal[4:7]
                row = search2_rows(summed[c], summed[c], sc, meta)[0, :11]
                f = row[1].to(torch.int64)
                row = row.clone()
                row[1] = torch.where(f >= 0, s[f.clamp(min=0)].to(row.dtype),
                                     row[1])
                out.append(row)
            return torch.stack(out)

        def hist_fn(b, g, h, m):
            return histogram_single_leaf(b, g, h, m, num_bins,
                                         acc_dtype=hist_dtype)

        use_record = (hist_dtype == torch.float32
                      and not 0 < hist_pool < max_leaves)
        return grow_tree(
            bins_T, grad, hess, bag_mask, fmask, nbpf, is_cat, params,
            num_bins=num_bins, max_leaves=max_leaves, hist_fn=hist_fn,
            hist_fn_raw=histogram_record_window if use_record else None,
            hist_pool=hist_pool,
            reduce_fn=lambda x: mesh.psum(x, site="vp.root_sums_allreduce"),
            search_fn=lambda h, scal, _m: vote(h[None], scal),
            search2_fn=lambda hl, hr, scal, _m: vote(torch.stack([hl, hr]),
                                                     scal),
            child_counts_fn=mesh.child_counts_fn(
                "vp.child_counts_allgather"))

    return grow


def make_voting_parallel_grower(mesh: Mesh, num_bins: int, max_leaves: int,
                                top_k: int, hist_pool: int = 0,
                                hist_dtype: torch.dtype = torch.float32):
    """grow(...) over every row: contiguous row blocks
    (``row_padded_grower``), the whole row -> leaf map on every rank."""
    return row_padded_grower(
        voting_parallel_sharded(mesh, num_bins, max_leaves, top_k,
                                hist_pool=hist_pool, hist_dtype=hist_dtype),
        mesh)
