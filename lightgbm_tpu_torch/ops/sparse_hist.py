"""O(nnz) level histogram of a sparse dataset (kernel S1's plain version).

Counterpart of lightgbm_tpu/ops/sparse_hist.py ``sparse_histogram_by_leaf``
(a jnp ``segment_sum``, not a Pallas kernel): ``hist[L, F, B, 3]`` =
(Σ g·m, Σ h·m, Σ m) of every row in leaf ``l`` at bin ``b`` of feature
``f``, from the binned CSR entries alone:

* every STORED entry (row, feature, bin) adds its row's stats at
  ``[leaf(row), feature, bin]``;
* every ABSENT entry sits in its feature's default bin (the bin of raw
  0.0, bin.h:150-160): per (leaf, feature) the leaf's total minus the
  stored sum is added at ``default_bins[feature]``.

On the card a ``segment_sum`` would be an atomic ``index_add_``, whose
order changes from run to run; kernel S1 (csrc/sparse_histogram.cu) sums
in a fixed order instead, and ``sparse_histogram_by_leaf_plain`` sums in
that order, so the two agree bitwise:

* the entries are regrouped by feature once (``csc_from_csr``, rows
  ascending within a feature) and cut into segments (``segment_entries``
  of the dataset's bins: 4,096 entries for one-hot data, up to 65,536);
  within a segment each (leaf, bin) cell is summed in row order from 0,
  and a feature's segment sums are added in segment order from 0;
* each leaf's total is summed in ``ROW_CHUNK``-row chunks, rows in order
  from 0, and the chunk sums in chunk order from 0;
* the stored sum of a (leaf, feature) is its bins' sum, bin 0 first, and
  the remainder ``total − stored`` is added to the default bin's cell.

``make_sparse_hist_fn`` is the depthwise growers' ``hist_fn`` over a
sparse dataset: S1 on a CUDA device, this plain version on the CPU.  The
dense ``[F, n]`` bins stay the routing bins; only the histogram reads
the CSR entries.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SEG_ENTRIES = 1 << 16  # the most entries of a feature a segment holds
SEG_ENTRIES_MIN = 1 << 12
ROW_CHUNK = 2048  # rows per leaf-total chunk


def segment_entries(num_bins: int) -> int:
    """Entries a segment (one S1 block) holds for ``num_bins`` bins: 256
    a bin, a power of two in [SEG_ENTRIES_MIN, SEG_ENTRIES].  Few keys
    (one-hot data: 2 bins) make long serial chains a segment, which short
    segments cut; many keys make large slabs (L·B cells a segment of a
    feature with several), which long segments avoid."""
    want = 1 << max(0, (256 * max(int(num_bins), 1) - 1).bit_length())
    return max(SEG_ENTRIES_MIN, min(SEG_ENTRIES, want))


def entry_rows(indptr: np.ndarray) -> np.ndarray:
    """Row index of every stored CSR entry (host-side, O(nnz))."""
    counts = np.diff(indptr).astype(np.int64)
    return np.repeat(np.arange(len(counts), dtype=np.int32), counts)


def segment_table(col_ptr: np.ndarray,
                  seg_entries: int) -> Dict[str, np.ndarray]:
    """The fixed cut of each feature's entries into segments of
    ``seg_entries`` (at least one, maybe empty, per feature): per segment
    its feature, [begin, end) and slab slot (-1 for a feature of one
    segment, which S1 writes straight into the output); per feature of
    several segments its first slot and count."""
    col_ptr = np.asarray(col_ptr, np.int64)
    nnz_f = np.diff(col_ptr)
    nseg_f = np.maximum(1, -(-nnz_f // seg_entries))
    feat = np.repeat(np.arange(len(nnz_f), dtype=np.int64), nseg_f)
    first = np.concatenate([[0], np.cumsum(nseg_f)[:-1]])
    t = np.arange(len(feat)) - first[feat]
    begin = col_ptr[feat] + t * seg_entries
    end = np.minimum(begin + seg_entries, col_ptr[feat + 1])
    multi = nseg_f[feat] > 1
    slot = np.full(len(feat), -1, np.int64)
    slot[multi] = np.arange(int(multi.sum()))
    fold_feat = np.flatnonzero(nseg_f > 1)
    return dict(seg_feat=feat, seg_begin=begin, seg_end=end, seg_slot=slot,
                fold_feat=fold_feat,
                fold_slot=slot[first[fold_feat]] if len(fold_feat)
                else np.empty(0, np.int64),
                fold_nseg=nseg_f[fold_feat])


def csc_from_csr(indptr, col, bins, default_bins, num_features: int,
                 device, seg_entries: int = SEG_ENTRIES) -> dict:
    """The binned CSR entries regrouped by feature on ``device``, rows
    ascending within each feature (a stable sort by column), with the
    segment table of ``seg_entries``: the static input of S1 and of its
    plain version."""
    dev = torch.device(device)
    counts = torch.from_numpy(np.diff(np.asarray(indptr, np.int64)))
    n = len(counts)
    erow = torch.repeat_interleave(torch.arange(n, dtype=torch.int32),
                                   counts).to(dev)
    ecol = torch.from_numpy(np.asarray(col, np.int64)).to(dev)
    ebin = torch.from_numpy(np.ascontiguousarray(bins)).to(dev)
    order = torch.sort(ecol, stable=True).indices
    col_ptr = np.concatenate([[0], np.cumsum(np.bincount(
        np.asarray(col, np.int64), minlength=num_features))]).astype(np.int64)
    tab = segment_table(col_ptr, seg_entries)
    out = {k: torch.from_numpy(v).to(dev) for k, v in tab.items()}
    # CUDA gathers no uint16: move 16-bit bins as int16 (the same bits)
    wide = ebin.dtype == torch.uint16
    ebin = ebin.view(torch.int16)[order].view(torch.uint16) if wide \
        else ebin[order]
    out.update(
        row=erow[order].contiguous(), bin=ebin.contiguous(),
        col_ptr=torch.from_numpy(col_ptr).to(dev),
        default_bins=torch.from_numpy(
            np.asarray(default_bins, np.int32)).to(dev),
        num_rows=n, num_features=int(num_features),
        num_slots=int((tab["seg_slot"] >= 0).sum()))
    return out


def _stats(grad, hess, mask):
    return torch.stack([grad * mask, hess * mask, mask.to(grad.dtype)], -1)


def leaf_totals_chunked(leaf_id: torch.Tensor, stats: torch.Tensor,
                        num_leaves: int) -> torch.Tensor:
    """[L, 3] per-leaf sums of ``stats`` [n, 3]: ``ROW_CHUNK``-row chunk
    sums (rows in order), added in chunk order from 0."""
    n = stats.shape[0]
    L = num_leaves
    nchunks = max(1, -(-n // ROW_CHUNK))
    chunk = torch.arange(n, device=stats.device) // ROW_CHUNK
    part = torch.zeros(nchunks * L, 3, dtype=stats.dtype,
                       device=stats.device)
    part.index_add_(0, chunk * L + leaf_id.to(torch.int64), stats)
    part = part.reshape(nchunks, L, 3)
    tot = torch.zeros(L, 3, dtype=stats.dtype, device=stats.device)
    for c in range(nchunks):
        tot = tot + part[c]
    return tot


def sparse_histogram_by_leaf_plain(csc: dict, leaf_id: torch.Tensor,
                                   grad: torch.Tensor, hess: torch.Tensor,
                                   mask: torch.Tensor, num_leaves: int,
                                   num_bins: int) -> torch.Tensor:
    """[L, F, B, 3] in S1's order (module docstring).  Bitwise S1's on
    the CPU, where ``index_add_`` adds in index order."""
    L, B, F = num_leaves, num_bins, csc["num_features"]
    dev = grad.device
    stats = _stats(grad, hess, mask)
    lid = leaf_id.to(torch.int64)
    row = csc["row"].to(torch.int64)
    nseg = csc["seg_feat"].shape[0]
    # each entry's segment: segments tile [0, nnz) in order
    seg_of = torch.repeat_interleave(
        torch.arange(nseg, device=dev),
        (csc["seg_end"] - csc["seg_begin"]).to(torch.int64))
    keys = (seg_of * L + lid[row]) * B + csc["bin"].to(torch.int64)
    seg_sum = torch.zeros(nseg * L * B, 3, dtype=grad.dtype, device=dev)
    seg_sum.index_add_(0, keys, stats.index_select(0, row))
    seg_sum = seg_sum.reshape(nseg, L, B, 3)
    # a feature's segment sums in segment order from 0
    seg_feat = csc["seg_feat"]
    first = torch.zeros(F, dtype=torch.int64, device=dev)
    nseg_f = torch.bincount(seg_feat, minlength=F)
    first[1:] = torch.cumsum(nseg_f, 0)[:-1]
    stored = torch.zeros(F, L, B, 3, dtype=grad.dtype, device=dev)
    for t in range(int(nseg_f.max())):
        sel = torch.nonzero(nseg_f > t).reshape(-1)
        stored[sel] = stored[sel] + seg_sum[first[sel] + t]
    stored = stored.permute(1, 0, 2, 3).contiguous()  # [L, F, B, 3]
    # the absent entries' mass at each feature's default bin
    tot = leaf_totals_chunked(lid, stats, L)
    s = torch.zeros(L, F, 3, dtype=grad.dtype, device=dev)
    for b in range(B):
        s = s + stored[:, :, b]
    rem = tot[:, None, :] - s
    fidx = torch.arange(F, device=dev)
    d = csc["default_bins"].to(torch.int64)
    stored[:, fidx, d] = stored[:, fidx, d] + rem
    return stored


def sparse_histogram_by_leaf(csc: dict, leaf_id, grad, hess, mask,
                             num_leaves: int, num_bins: int) -> torch.Tensor:
    """Kernel S1 on a CUDA tensor, the plain version on a CPU one."""
    if grad.device.type == "cpu":
        return sparse_histogram_by_leaf_plain(csc, leaf_id, grad, hess, mask,
                                              num_leaves, num_bins)
    from .cuda_sparse_hist import sparse_histogram_by_leaf_cuda

    return sparse_histogram_by_leaf_cuda(csc, leaf_id, grad, hess, mask,
                                         num_leaves, num_bins)


def make_sparse_hist_fn(dataset, num_bins: int, device):
    """The depthwise growers' ``hist_fn(bins_T, leaf_id, grad, hess, mask,
    num_leaves)`` over a sparse dataset's CSR entries on ``device`` (the
    dense ``bins_T`` argument is not read)."""
    csc = dataset.sparse_device(device)

    def hist_fn(bins_T, leaf_id, grad, hess, mask, num_leaves):
        return sparse_histogram_by_leaf(csc, leaf_id, grad, hess, mask,
                                        num_leaves, num_bins)

    return hist_fn
