"""Best-split search over feature histograms — the plain PyTorch version.

Counterpart of lightgbm_tpu/ops/split.py (``find_best_split`` /
``find_best_split_leaves``), itself the vectorized form of the
reference's FindBestThresholdForNumerical / ForCategorical scans
(feature_histogram.hpp:116-246):

* numerical: right side = exclusive suffix sums over bins, with the
  kEpsilon seed on the right hessian; left = leaf totals - right.
* categorical: one-vs-rest — "left" is the single bin == threshold.
* gain / leaf output with L1/L2 (feature_histogram.hpp:290-313).
* deterministic winner: max gain, then the LARGEST threshold within a
  feature, then the SMALLEST feature (split_info.hpp:98-103).  Written
  out as a min over flat (feature asc, bin desc) positions of the
  maxima, so it does not lean on which maximum ``argmax`` returns.

This is the CPU path of ``ops/cuda_search.search2`` and the oracle the
CUDA kernel is held against on the card.  ``search2_rows`` packs a
two-child search into the kernels' [2, 16] rows; ``search2_update`` is
the plain version of kernel 4 (subtract, route, update the buffer rows,
search), ``search2_pool`` that of kernel 5 (the same over a histogram
pool's slots).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch

K_EPSILON = 1e-15
K_MIN_SCORE = float("-inf")


class SplitResult(NamedTuple):
    """Split decision per leaf (SplitInfo, split_info.hpp:17-44)."""

    gain: torch.Tensor  # improvement over the un-split leaf (-inf: none)
    feature: torch.Tensor  # int32 inner feature, -1 if no split
    threshold: torch.Tensor  # int32 bin threshold (<= t, == t for cat)
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor
    right_sum_grad: torch.Tensor
    right_sum_hess: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


SCAN_BLOCK = 16


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis, in the order the JAX
    package's ``jnp.cumsum`` takes on the CPU (XLA rewrites the scan into
    blocks of 16): sequential within each block of 16, the block totals
    scanned the same way (recursively while more than 16), each block
    offset by the exclusive prefix of the totals.  Every step is one
    elementwise float add, so the result is the same on any device; the
    search kernel (csrc/search.cu) scans in the same order."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        out = x.clone()
        for j in range(1, n):
            out[..., j] = out[..., j - 1] + x[..., j]
        return out
    pad = (-n) % SCAN_BLOCK
    xp = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], -1)
    blk = xp.reshape(x.shape[:-1] + (-1, SCAN_BLOCK))
    within = blocked_cumsum(blk)  # sequential per block
    tot = blocked_cumsum(within[..., -1])
    excl = torch.cat([tot.new_zeros(tot.shape[:-1] + (1,)), tot[..., :-1]], -1)
    return (within + excl[..., None]).reshape(xp.shape)[..., :n]


def leaf_split_gain(sum_grad, sum_hess, l1, l2):
    """GetLeafSplitGain (feature_histogram.hpp:290-298)."""
    reg = torch.clamp(sum_grad.abs() - l1, min=0.0)
    return reg * reg / (sum_hess + l2)


def leaf_output(sum_grad, sum_hess, l1, l2):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:306-313)."""
    reg = torch.clamp(sum_grad.abs() - l1, min=0.0)
    return -torch.sign(sum_grad) * reg / (sum_hess + l2)


def find_best_split_leaves(hist, sum_grad, sum_hess, num_data, feature_mask,
                           num_bins_per_feature, is_categorical,
                           min_data_in_leaf, min_sum_hessian_in_leaf,
                           lambda_l1, lambda_l2, min_gain_to_split,
                           can_split) -> SplitResult:
    """Best split of K leaves at once.  ``hist`` [K, F, B, 3];
    ``sum_grad``/``sum_hess``/``num_data``/``can_split`` [K];
    ``feature_mask``/``num_bins_per_feature``/``is_categorical`` [F];
    the five constraints are scalars.  Returns a SplitResult of [K]."""
    K, F, B, _ = hist.shape
    dt, dev = hist.dtype, hist.device

    def s(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    md, mh = s(min_data_in_leaf), s(min_sum_hessian_in_leaf)
    l1, l2, mg = s(lambda_l1), s(lambda_l2), s(min_gain_to_split)
    sg, sh, cnt = s(sum_grad), s(sum_hess), s(num_data)

    # exclusive suffix sums: tail[t] = sum_{b > t} hist[b], kEpsilon on h
    rev = torch.flip(hist, [2]).permute(0, 1, 3, 2)  # [K, F, 3, B]
    suf = torch.flip(blocked_cumsum(rev).permute(0, 1, 3, 2), [2])
    tail = torch.cat([suf[:, :, 1:], torch.zeros_like(suf[:, :, :1])], 2)
    tail = tail + torch.tensor([0.0, K_EPSILON, 0.0], dtype=dt, device=dev)
    tot = torch.stack([sg, sh, cnt], -1)[:, None, None, :]  # [K, 1, 1, 3]

    is_cat = is_categorical.to(dev).bool()
    cat4 = is_cat[None, :, None, None]
    left = torch.where(cat4, hist, tot - tail)
    right = torch.where(cat4, tot - hist, tail)

    bins = torch.arange(B, device=dev)[None, :]
    nb = num_bins_per_feature.to(dev).to(torch.int64)[:, None]
    in_range = torch.where(is_cat[:, None], bins < nb, bins < nb - 1)
    in_range = in_range & feature_mask.to(dev).bool()[:, None]  # [F, B]
    gain_shift = leaf_split_gain(sg, sh, l1, l2)  # [K]
    gains = (leaf_split_gain(left[..., 0], left[..., 1], l1, l2)
             + leaf_split_gain(right[..., 0], right[..., 1], l1, l2))
    valid = (in_range[None]
             & (left[..., 2] >= md) & (right[..., 2] >= md)
             & (left[..., 1] >= mh) & (right[..., 1] >= mh)
             & (gains >= (gain_shift + mg)[:, None, None])
             & torch.as_tensor(can_split, device=dev).bool()
             .reshape(-1)[:, None, None])
    gains = torch.where(valid, gains, torch.full_like(gains, K_MIN_SCORE))

    # winner: smallest (feature, B-1-bin) position among the maxima
    flat = torch.flip(gains, [2]).reshape(K, F * B)
    best_gain = flat.max(dim=1).values  # [K]
    pos = torch.arange(F * B, device=dev)[None, :].expand(K, -1)
    best = torch.where(flat == best_gain[:, None], pos,
                       torch.full_like(pos, F * B)).min(dim=1).values
    best = torch.where(best == F * B, torch.zeros_like(best), best)
    feat = best // B
    thr = B - 1 - best % B
    splittable = best_gain > K_MIN_SCORE

    kk = torch.arange(K, device=dev)
    lw, rw = left[kk, feat, thr], right[kk, feat, thr]  # [K, 3]
    lg, lh, lc = lw[:, 0], lw[:, 1], lw[:, 2]
    rg, rh, rc = rw[:, 0], rw[:, 1], rw[:, 2]
    return SplitResult(
        gain=torch.where(splittable, best_gain - gain_shift,
                         torch.full_like(best_gain, K_MIN_SCORE)),
        feature=torch.where(splittable, feat, -1).to(torch.int32),
        threshold=torch.where(splittable, thr, 0).to(torch.int32),
        left_sum_grad=lg, left_sum_hess=lh, left_count=lc,
        right_sum_grad=rg, right_sum_hess=rh, right_count=rc,
        left_output=leaf_output(lg, lh, l1, l2),
        right_output=leaf_output(rg, rh, l1, l2),
    )


def find_best_split(hist, sum_grad, sum_hess, num_data, feature_mask,
                    num_bins_per_feature, is_categorical, min_data_in_leaf,
                    min_sum_hessian_in_leaf, lambda_l1, lambda_l2,
                    min_gain_to_split, can_split) -> SplitResult:
    """One leaf: ``hist`` [F, B, 3], scalar totals; 0-d results."""
    res = find_best_split_leaves(
        hist[None], torch.as_tensor(sum_grad).reshape(1),
        torch.as_tensor(sum_hess).reshape(1),
        torch.as_tensor(num_data).reshape(1), feature_mask,
        num_bins_per_feature, is_categorical, min_data_in_leaf,
        min_sum_hessian_in_leaf, lambda_l1, lambda_l2, min_gain_to_split,
        torch.as_tensor(can_split).reshape(1))
    return SplitResult(*[a[0] for a in res])


def search2_rows(h_left: torch.Tensor, h_right: torch.Tensor,
                 scal: Sequence[float], meta: torch.Tensor) -> torch.Tensor:
    """Both children's best splits as the [2, 16] rows of
    pallas_search._unpack, in the histograms' dtype (float32, or float64
    under hist_dtype=float64, as the JAX package's ``_sr_row(..., acc_dt)``).
    ``scal`` = (can, lsg, lsh, lc, rsg, rsh, rc, min_data, min_hess, l1,
    l2, min_gain); ``meta`` [F, 4] int32 = (feature_mask, num_bins,
    is_categorical, 0)."""
    can, lsg, lsh, lc, rsg, rsh, rc, md, mh, l1, l2, mg = scal
    dt, dev = h_left.dtype, h_left.device
    res = find_best_split_leaves(
        torch.stack([h_left, h_right]),
        torch.tensor([lsg, rsg], dtype=dt, device=dev),
        torch.tensor([lsh, rsh], dtype=dt, device=dev),
        torch.tensor([lc, rc], dtype=dt, device=dev),
        meta[:, 0] > 0, meta[:, 1], meta[:, 2] > 0, md, mh, l1, l2, mg,
        torch.tensor([bool(can), bool(can)], device=dev))
    out = torch.zeros((2, 16), dtype=dt, device=dev)
    out[:, :11] = torch.stack([a.to(dt) for a in res], dim=1)
    return out


def search2_update(hists: torch.Tensor, h_small: torch.Tensor, parent: int,
                   new_leaf: int, small_is_left: bool, scal: Sequence[float],
                   meta: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 4 (pallas_search.search2_update_pallas):
    ``h_large = hists[parent] - h_small``, the two routed to left and
    right by ``small_is_left``, written in place to ``hists[parent]``
    (left) and ``hists[new_leaf]`` (right), then both searched.  Returns
    the [2, 16] rows.  It is ``search2_pool`` with the parent's row as the
    left child's slot."""
    return search2_pool(hists, h_small, parent, parent, new_leaf,
                        small_is_left, scal, meta)


def search2_pool(pool: torch.Tensor, h_small: torch.Tensor,
                 parent: Union[int, torch.Tensor], s1: int, s2: int,
                 small_is_left: bool, scal: Sequence[float],
                 meta: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 5, the pooled route's step (the JAX
    package's subtraction, routing and slot writes around
    ``search2_pallas_raw``, serial.py:961-1008): ``h_large = parent -
    h_small`` in the tensors' dtype (float32, or float64 for kernel
    3-f64's step form), where ``parent`` is ``pool[parent]`` for a slot
    index or the recomputed [F, B, 3] histogram itself; the two routed to
    left and right by ``small_is_left`` and written to ``pool[s1]`` (left)
    and ``pool[s2]`` (right); both searched from the written slots, as the
    kernel searches them.  Returns the [2, 16] rows."""
    h_parent = parent if isinstance(parent, torch.Tensor) else pool[parent]
    h_large = h_parent - h_small
    h_left, h_right = ((h_small, h_large) if small_is_left
                       else (h_large, h_small))
    pool[s1] = h_left
    pool[s2] = h_right
    return search2_rows(pool[s1], pool[s2], scal, meta)
