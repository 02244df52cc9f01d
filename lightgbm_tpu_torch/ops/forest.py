"""The forest's lane functions — the plain PyTorch versions of F1 and F3.

A forest grows B independent trees (lanes) over one shared ``[F, n]`` bin
matrix (learners/forest.py).  ``forest_histogram_plain`` is F1's root
form: lane b's histogram over the rows whose ``leaf_id[b]`` is
``target[b]`` (zeros for an idle lane, ``target[b] == -1``), the lane's
rows in ascending row order through ``histogram_feature_major``, in
blocks of ``CHUNK_ROWS``, each block in row order, then the blocks in
block order.  That is the order route's histogram of the same leaf
(learners/serial.py gathers a leaf's rows from ``order``, which its stable
partition keeps ascending), bitwise, and kernel F1's order
(csrc/forest.cu).  ``forest_search_plain`` is F3's root form:
``ops/split.search2_rows`` lane by lane, each under its own ``meta``
slice and ``scal`` row: kernel 3's rows, kernel F3's.

``forest_step_plain`` is one forest step, the PyTorch composition the
grower ran before the kernels took it: F1's step form
(``forest_split_plain``: the masked update of the leaf map, in place, the
left counts, each lane's smaller child by positional count, ties to the
left, and its histogram) and F3's step form (``forest_search_step_plain``:
the larger child by subtraction, both children written into the lanes'
``[B, L, F, nb, 3]`` buffer, both searched, the left count in slot 11).
These are the lanes' CPU path (ops/cuda_forest.py) and the oracle F1 and
F3 are held against on the card.

Counterparts of the JAX package's batched grower's lane functions,
lightgbm_tpu/learners/forest.py ``_batched_hist`` (:123) and
``_search2_lanes`` / ``_search_root`` (:112-121), and of its step
(:252-318).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import split
from .histogram import histogram_feature_major, take_bins


def forest_histogram_plain(bins_T: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, mask: torch.Tensor,
                           leaf_id: torch.Tensor, target: torch.Tensor,
                           num_bins: int,
                           max_rows: Optional[int] = None) -> torch.Tensor:
    """``bins_T`` [F, n] uint8/uint16; ``grad``/``hess``/``mask`` [B, n]
    float32; ``leaf_id`` [B, n] int32; ``target`` [B] int32.  Returns [B,
    F, num_bins, 3] float32.  ``max_rows`` is the caller's bound on any
    lane's rows, which sizes the kernel's scratch; a lane above it raises
    ``ValueError`` here (the kernel answers NaN)."""
    F = bins_T.shape[0]
    B = grad.shape[0]
    out = torch.zeros((B, F, num_bins, 3), dtype=torch.float32,
                      device=grad.device)
    for b, t in enumerate(target.tolist()):
        if t < 0:
            continue
        rows = torch.nonzero(leaf_id[b] == t).flatten()  # ascending
        if max_rows is not None and rows.numel() > max_rows:
            raise ValueError(f"lane {b} holds {rows.numel()} rows, more than "
                             f"max_rows={max_rows}")
        out[b] = histogram_feature_major(
            take_bins(bins_T, 1, rows), grad[b].index_select(0, rows),
            hess[b].index_select(0, rows), mask[b].index_select(0, rows),
            num_bins)
    return out


def forest_search_plain(h_left: torch.Tensor, h_right: torch.Tensor,
                        meta: torch.Tensor, scal: torch.Tensor
                        ) -> torch.Tensor:
    """``h_left``/``h_right`` [A, F, nb, 3] float32; ``meta`` [A, F, 4]
    int32 (``cuda_search.pack_meta`` a lane); ``scal`` [A, 12] float32
    (can, lsg, lsh, lc, rsg, rsh, rc, min_data, min_hess, l1, l2,
    min_gain).  Returns [A, 2, 16]: each lane's two rows of
    ``search2_rows``."""
    if h_left.shape[0] == 0:
        return h_left.new_zeros((0, 2, 16))
    return torch.stack([
        split.search2_rows(h_left[a], h_right[a], s, meta[a])
        for a, s in enumerate(scal.tolist())])


def forest_split_plain(bins_T: torch.Tensor, grad: torch.Tensor,
                       hess: torch.Tensor, mask: torch.Tensor,
                       leaf_id: torch.Tensor, num_bins: int,
                       lanes: Sequence[int], leaves: Sequence[int],
                       feats: Sequence[int], thrs: Sequence[int],
                       cats: Sequence[bool], pcnt: Sequence[int],
                       new_leaf: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """F1's step form for the A active ``lanes`` (ascending) of [B, n]
    ``leaf_id``: lane ``lanes[i]``'s rows of leaf ``leaves[i]`` that fail
    ``bin <= thrs[i]`` (``bin == thrs[i]`` where ``cats[i]``) on feature
    ``feats[i]`` take ``new_leaf``, in place.  Returns (the smaller
    children's [A, F, num_bins, 3] histograms, the left counts [A] int64,
    small_left [A] bool: 2 * nleft <= ``pcnt``)."""
    dev = bins_T.device
    B = grad.shape[0]
    act = list(lanes)

    def on_dev(v, dt):
        return torch.tensor(v, dtype=dt, device=dev)

    idx = None if len(act) == B else on_dev(act, torch.int64)

    def sel(t):
        return t if idx is None else t.index_select(0, idx)

    bl_t = on_dev(list(leaves), torch.int64)
    thr_t = on_dev(list(thrs), torch.int32)
    cat_t = on_dev(list(map(bool, cats)), torch.bool)
    pcnt_t = on_dev(list(pcnt), torch.int64)

    # ---- partition: the parent's rows that go right take new_leaf
    lid = sel(leaf_id)
    vals = take_bins(bins_T, 0, on_dev(list(feats), torch.int64)).to(
        torch.int32)
    in_leaf = lid == bl_t[:, None].to(torch.int32)
    dec = torch.where(cat_t[:, None], vals == thr_t[:, None],
                      vals <= thr_t[:, None])
    nleft_t = (in_leaf & dec).sum(1)
    lid = lid.masked_fill(in_leaf & ~dec, new_leaf)
    if idx is None:
        leaf_id.copy_(lid)
    else:
        leaf_id.index_copy_(0, idx, lid)

    # ---- the smaller child's histogram (by positional count, ties left)
    small_left = 2 * nleft_t <= pcnt_t
    target = torch.where(small_left, bl_t, new_leaf).to(torch.int32)
    h_small = forest_histogram_plain(bins_T, sel(grad), sel(hess),
                                     sel(mask), lid, target, num_bins,
                                     max_rows=max(pcnt) // 2)
    return h_small, nleft_t, small_left


def forest_search_step_plain(hists: torch.Tensor, meta: torch.Tensor,
                             h_small: torch.Tensor, nleft: torch.Tensor,
                             small_left: torch.Tensor,
                             lanes: Sequence[int], leaves: Sequence[int],
                             new_leaf: int, scal) -> torch.Tensor:
    """F3's step form after ``forest_split_plain``: the larger child as
    parent - smaller (the parent at ``hists[lane, leaf]``), the left
    child written to ``hists[lane, leaf]`` and the right to ``hists[lane,
    new_leaf]``, both searched under ``meta[lane]`` and ``scal`` [A, 12];
    returns [A, 2, 16] with the left counts in ``[:, 0, 11]``."""
    dev = hists.device
    B = hists.shape[0]
    act = list(lanes)
    idx = None if len(act) == B else torch.tensor(act, dtype=torch.int64,
                                                    device=dev)
    lanes_t = torch.arange(B, device=dev) if idx is None else idx
    bl_t = torch.tensor(list(leaves), dtype=torch.int64, device=dev)
    h_parent = hists[lanes_t, bl_t]
    h_large = h_parent - h_small
    sl = small_left[:, None, None, None]
    h_left = torch.where(sl, h_small, h_large)
    h_right = torch.where(sl, h_large, h_small)
    del h_parent, h_large
    hists[lanes_t, bl_t] = h_left
    hists[lanes_t, new_leaf] = h_right

    # ---- both children's searches; the left counts ride in slot 11, so
    # one host read serves every lane
    rows = forest_search_plain(
        h_left, h_right, meta if idx is None else meta.index_select(0, idx),
        torch.as_tensor(np.asarray(scal, np.float32)).to(dev))
    rows[:, 0, 11] = nleft.to(rows.dtype)
    return rows


def forest_step_plain(bins_T, grad, hess, mask, leaf_id, meta, hists,
                      num_bins, lanes, leaves, feats, thrs, cats, pcnt,
                      new_leaf, scal) -> torch.Tensor:
    """One forest step: ``forest_split_plain`` then
    ``forest_search_step_plain`` (``leaf_id`` and ``hists`` updated in
    place); returns the [A, 2, 16] rows."""
    h_small, nleft, small_left = forest_split_plain(
        bins_T, grad, hess, mask, leaf_id, num_bins, lanes, leaves, feats,
        thrs, cats, pcnt, new_leaf)
    return forest_search_step_plain(hists, meta, h_small, nleft, small_left,
                                    lanes, leaves, new_leaf, scal)
