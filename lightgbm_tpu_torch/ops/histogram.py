"""Histogram construction — the plain PyTorch versions.

Counterpart of lightgbm_tpu/ops/histogram.py ``histogram_feature_major``:
``hist[F, num_bins, 3]`` = (Σ g·m, Σ h·m, Σ m) over one masked row set.
It is the CPU path of ``ops/cuda_histogram.histogram_single_leaf`` and
the oracle the CUDA kernel is held against on the card; nothing on the
training path calls it for a CUDA tensor.  ``histogram_record_window`` is
the same sums over a window of the packed record (ops/record.py), the
plain version of kernel 1'; with a go mask it is the left child's
histogram of kernel 8 (ops/record.py ``split_step_plain``).

The sums follow the kernel's order: rows in blocks of ``CHUNK_ROWS``,
each block summed in row order (``index_add_`` is sequential on the
CPU), the block partials then added in block order.  On the CPU the two
agree bitwise, so trees grown with the plain version and with the
kernel see the same histograms.

The level histograms ``hist[L, F, B, 3]`` of depthwise growth (the
counterpart of lightgbm_tpu/ops/histogram.py ``histogram_by_leaf``):
``histogram_by_leaf_sorted_plain`` is the plain version of kernels 1''
and 2 and sums in their order — the stable leaf sort, then each leaf's
rows in blocks of ``CHUNK_ROWS`` (``level_layout``, the prep the kernels
share), each block in row order, then each leaf's block partials in
block order.  ``histogram_by_leaf`` is the segment-sum counterpart (each
cell in row order); it is a test oracle and follows no kernel.
``leaf_totals`` takes the per-leaf sums from feature 0's bins in XLA's
CPU reduction order (``xla_sum``, which the LambdaRank gradients use
too).

``acc_dtype=torch.float64`` (``hist_dtype=float64``, the reference's
double accumulation) sums the same rows in the same order in float64:
the float32 row stats are widened first, so each product g·m and h·m of
two float32 values is exact, and at most ``CHUNK_ROWS`` rows a leaf the
sums are the JAX package's float64 ``segment_sum`` bitwise (each bin's
rows in row order from 0).  It is the plain version of the float64
kernels 1-f64 and 1''-f64.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .record import unpack_window

# rows per block; must equal kChunk in csrc/hist_chunk.cuh
CHUNK_ROWS = 2048
# XLA's CPU tree-reduction window (the order of ``xla_sum``)
REDUCE_WINDOW = 32


def take_bins(bins: torch.Tensor, dim: int, idx: torch.Tensor
              ) -> torch.Tensor:
    """``bins.index_select(dim, idx)`` for uint8 or uint16 bins.  torch
    has no uint16 ``index_select`` on the CPU, so uint16 bins are gathered
    through an int16 view of the same bits."""
    if bins.dtype == torch.uint16:
        return bins.view(torch.int16).index_select(dim, idx).view(
            torch.uint16)
    return bins.index_select(dim, idx)


def _row_stats(grad: torch.Tensor, hess: torch.Tensor, mask: torch.Tensor,
               dt: torch.dtype) -> torch.Tensor:
    """[n, 3] (g·m, h·m, m) in ``dt``, each row stat widened to ``dt``
    before the product."""
    m = mask.to(dt)
    return torch.stack([grad.to(dt) * m, hess.to(dt) * m, m], dim=-1)


def histogram_feature_major(bins_T: torch.Tensor, grad: torch.Tensor,
                            hess: torch.Tensor, mask: torch.Tensor,
                            num_bins: int,
                            acc_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """``bins_T`` [F, n] integer bins (feature-major); ``grad``/``hess``/
    ``mask`` [n].  Returns [F, num_bins, 3] in ``acc_dtype`` (default:
    ``grad``'s dtype)."""
    F, n = bins_T.shape
    dev, dt = grad.device, acc_dtype or grad.dtype
    stats = _row_stats(grad, hess, mask, dt)
    offs = torch.arange(F, device=dev)[:, None] * num_bins
    out = torch.zeros(F * num_bins, 3, dtype=dt, device=dev)
    for r0 in range(0, n, CHUNK_ROWS):
        r1 = min(n, r0 + CHUNK_ROWS)
        keys = bins_T[:, r0:r1].to(torch.int64) + offs
        part = torch.zeros_like(out)
        part.index_add_(0, keys.reshape(-1), stats[r0:r1].repeat(F, 1))
        out += part
    return out.reshape(F, num_bins, 3)


def histogram_record_window(rec: torch.Tensor, begin: int, cnt: int, F: int,
                            k: int, num_bins: int,
                            go: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Columns ``[begin, begin+cnt)`` of the ``[W, n]`` record (``k`` bins
    per word) -> [F, num_bins, 3] float32: ``unpack_window`` then
    ``histogram_feature_major``, in the same summation order.  With ``go``
    ([cnt] bool) each column's mask is multiplied by its go flag, so only
    the left-going columns count (the JAX package's ``mw = mrow * govf``,
    record.py:485)."""
    bins, g, h, m = unpack_window(rec[:, begin:begin + cnt], F, k,
                                  torch.uint8 if k == 4 else torch.uint16)
    if go is not None:
        m = m * go.to(m.dtype)
    return histogram_feature_major(bins, g, h, m, num_bins)


class LevelLayout(NamedTuple):
    """The leaf-sorted chunk layout of a level (pallas_histogram.py
    :257-296 without the padding): ``order`` [n] int64 sorted position ->
    row (a stable sort of the leaf ids), ``sorted_leaf`` [n], and per leaf
    ``row_start`` / ``chunk_start`` [L+1] (first sorted position, first
    chunk; the last entry is the total).  Each leaf owns
    max(ceil(rows / CHUNK_ROWS), 1) chunks, so an empty leaf still has one
    (with no rows).  Per chunk, for a static capacity of ceil(n /
    CHUNK_ROWS) + L chunks: ``chunk_row0`` (first sorted position),
    ``chunk_rows`` (row count) and ``chunk_leaf`` (L for the unused tail).
    Every entry is computed on the leaf ids' device; nothing is read back
    to the host.  On the card kernels 1'' and 2 build the same chunk table
    themselves (csrc/level_histogram.cu ``layout_kernel``) after the same
    stable sort."""

    order: torch.Tensor
    sorted_leaf: torch.Tensor
    row_start: torch.Tensor
    chunk_start: torch.Tensor
    chunk_row0: torch.Tensor
    chunk_rows: torch.Tensor
    chunk_leaf: torch.Tensor


def level_layout(leaf_id: torch.Tensor, num_leaves: int) -> LevelLayout:
    """``leaf_id`` [n] integer leaf per row, every id in [0, num_leaves)."""
    n, L, C = leaf_id.shape[0], num_leaves, CHUNK_ROWS
    dev = leaf_id.device
    sorted_leaf, order = torch.sort(leaf_id, stable=True)
    ids = torch.arange(L + 1, dtype=sorted_leaf.dtype, device=dev)
    row_start = torch.searchsorted(sorted_leaf, ids)  # [L+1] int64
    counts = row_start[1:] - row_start[:-1]
    per_leaf = torch.clamp((counts + C - 1) // C, min=1)
    chunk_start = torch.cat([torch.zeros(1, dtype=per_leaf.dtype,
                                         device=dev),
                             torch.cumsum(per_leaf, 0)])
    c = torch.arange((n + C - 1) // C + L, device=dev)
    leaf = torch.searchsorted(chunk_start, c, right=True) - 1  # L: the tail
    lc = leaf.clamp(max=L - 1)
    k = (c - chunk_start[lc]) * C  # rows of the leaf before this chunk
    used = leaf < L
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    chunk_row0 = torch.where(used, row_start[lc] + k, zero)
    chunk_rows = torch.where(used, (counts[lc] - k).clamp(0, C), zero)
    return LevelLayout(order, sorted_leaf, row_start, chunk_start,
                       chunk_row0.contiguous(), chunk_rows.contiguous(),
                       leaf)


def histogram_by_leaf_sorted_plain(bins_T: torch.Tensor,
                                   leaf_id: torch.Tensor, grad: torch.Tensor,
                                   hess: torch.Tensor, mask: torch.Tensor,
                                   num_bins: int, num_leaves: int,
                                   acc_dtype: Optional[torch.dtype] = None
                                   ) -> torch.Tensor:
    """The plain version of kernels 1'', 2 and 1''-f64: ``bins_T`` [F, n]
    integer bins; ``leaf_id`` [n]; ``grad``/``hess``/``mask`` [n].
    Returns [L, F, num_bins, 3] in ``acc_dtype`` (default: ``grad``'s
    dtype), summed in ``level_layout``'s chunk order (``index_add_`` adds
    each source row in order on the CPU)."""
    F, n = bins_T.shape
    L = num_leaves
    lay = level_layout(leaf_id, L)
    dev, dt = grad.device, acc_dtype or grad.dtype
    stats = _row_stats(grad, hess, mask, dt)
    stats = stats.index_select(0, lay.order)  # [n, 3] in sorted order
    sl = lay.sorted_leaf.to(torch.int64)
    pos = torch.arange(n, device=dev)
    chunk = lay.chunk_start[sl] + (pos - lay.row_start[sl]) // CHUNK_ROWS
    nchunks = lay.chunk_leaf.shape[0]
    part = torch.zeros(nchunks * F * num_bins, 3, dtype=dt, device=dev)
    for f in range(F):
        keys = ((chunk * F + f) * num_bins
                + bins_T[f].to(torch.int64)[lay.order])
        part.index_add_(0, keys, stats)
    out = torch.zeros(L + 1, F * num_bins * 3, dtype=dt, device=dev)
    out.index_add_(0, lay.chunk_leaf, part.reshape(nchunks, -1))
    return out[:L].reshape(L, F, num_bins, 3)


def histogram_by_leaf(bins_T: torch.Tensor, leaf_id: torch.Tensor,
                      grad: torch.Tensor, hess: torch.Tensor,
                      mask: torch.Tensor, num_bins: int,
                      num_leaves: int) -> torch.Tensor:
    """[L, F, num_bins, 3] with every cell summed in row order: the
    counterpart of the JAX package's segment-sum ``histogram_by_leaf``
    (bitwise on the CPU)."""
    F, n = bins_T.shape
    dt = grad.dtype
    stats = torch.stack([grad * mask, hess * mask, mask.to(dt)], dim=-1)
    base = leaf_id.to(torch.int64) * num_bins
    out = torch.zeros(F, num_leaves * num_bins, 3, dtype=dt,
                      device=grad.device)
    for f in range(F):
        out[f].index_add_(0, base + bins_T[f].to(torch.int64), stats)
    return out.reshape(F, num_leaves, num_bins, 3).transpose(0, 1) \
        .contiguous()


def xla_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ over ``dim`` in the order XLA's CPU build adds (its tree
    reduction): more than 32 elements are padded with zeros to whole
    windows of 32 (half the padding, rounded down, in front), each window
    is summed in order, and the window sums are reduced the same way.
    Every step is an elementwise add, so any device gives the same bits."""
    x = x.movedim(dim, 0)
    while x.shape[0] > REDUCE_WINDOW:
        w = -(-x.shape[0] // REDUCE_WINDOW)
        pad = w * REDUCE_WINDOW - x.shape[0]
        if pad:
            x = torch.cat([x.new_zeros((pad // 2,) + x.shape[1:]), x,
                           x.new_zeros((pad - pad // 2,) + x.shape[1:])])
        x = x.reshape((w, REDUCE_WINDOW) + x.shape[1:])
        acc = x[:, 0]
        for i in range(1, REDUCE_WINDOW):
            acc = acc + x[:, i]
        x = acc
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def leaf_totals(hist: torch.Tensor) -> torch.Tensor:
    """Per-leaf (Σg, Σh, count) [K, 3] from feature 0's bins of ``hist``
    [K, F, B, 3] (every feature sees every row): ``jnp.sum(hist[:, 0],
    axis=1)`` of learners/depthwise.py:108 and serial.py:632, in the order
    XLA's CPU tree-reduction takes (bitwise equal to it).  Every step is an
    elementwise float add, so the totals are the same on any device."""
    return xla_sum(hist[:, 0], 1)
