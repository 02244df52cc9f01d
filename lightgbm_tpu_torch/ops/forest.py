"""The forest's lane functions — the plain PyTorch versions of F1 and F3.

A forest grows B independent trees (lanes) over one shared ``[F, n]`` bin
matrix (learners/forest.py).  ``forest_histogram_plain`` is lane b's
histogram over the rows whose ``leaf_id[b]`` is ``target[b]`` (zeros for
an idle lane, ``target[b] == -1``): the lane's rows in ascending row
order through ``histogram_feature_major``, in blocks of ``CHUNK_ROWS``,
each block in row order, then the blocks in block order.  That is the
order route's histogram of the same leaf (learners/serial.py gathers a
leaf's rows from ``order``, which its stable partition keeps ascending),
bitwise, and kernel F1's order (csrc/forest.cu).  ``forest_search_plain``
is ``ops/split.search2_rows`` lane by lane, each under its own ``meta``
slice and ``scal`` row: kernel 3's rows, kernel F3's.  They are the
lanes' CPU path (ops/cuda_forest.py) and the oracle F1 and F3 are held
against on the card.

Counterparts of the JAX package's batched grower's lane functions,
lightgbm_tpu/learners/forest.py ``_batched_hist`` (:123) and
``_search2_lanes`` / ``_search_root`` (:112-121).
"""

from __future__ import annotations

from typing import Optional

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
