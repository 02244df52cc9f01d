"""Sparse ingest: CSR/LibSVM -> binned storage without densification.

A copy of lightgbm_tpu/io/sparse.py (numpy only).  The dataset keeps ONE
binned CSR structure (row pointers + column + bin per stored entry), and
rows absent from a column implicitly sit in that column's *default bin*
(the bin of raw 0.0, bin.h:150-160); the reference keeps per-feature
sparse bins instead (src/io/sparse_bin.hpp:153-181).

Invariants:
* loading a LibSVM/CSR input is O(nnz) memory end-to-end: no dense
  float64 matrix is ever materialized;
* the binned result is bit-identical to the dense path on the same data,
  because bin *finding* already models elided zeros via
  ``total_sample_cnt`` (io/binner.py, bin.cpp:48-85);
* ``SparseBins.toarray()`` gives the dense uint8/uint16 ``[n, F_used]``
  matrix on demand (the dense routing bins of depthwise growth); the
  level histogram of a sparse dataset reads the CSR entries themselves
  (ops/sparse_hist.py, kernel S1 on the card).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .binner import BinMapper, CATEGORICAL, NUMERICAL


class SparseBins:
    """Binned CSR storage: entry k of row i (``indptr[i] <= k < indptr[i+1]``)
    says "inner feature ``col[k]`` has bin ``bin[k]``"; every (row, feature)
    pair not stored holds ``default_bins[feature]``.
    """

    __slots__ = ("indptr", "col", "bin", "default_bins", "shape", "dtype")

    def __init__(self, indptr, col, bins, default_bins, shape):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.col = np.asarray(col, dtype=np.int32)
        self.bin = bins
        self.default_bins = np.asarray(default_bins)
        self.shape = tuple(shape)
        self.dtype = bins.dtype

    @property
    def nnz(self) -> int:
        return len(self.col)

    @property
    def nbytes(self) -> int:
        return self.indptr.nbytes + self.col.nbytes + self.bin.nbytes

    def toarray(self) -> np.ndarray:
        """Dense ``[n, F_used]`` binned matrix (default bins filled in)."""
        n, f = self.shape
        out = np.empty((n, f), dtype=self.dtype)
        out[:] = self.default_bins.astype(self.dtype)[None, :]
        rows = np.repeat(
            np.arange(n, dtype=np.int64), np.diff(self.indptr)
        )
        out[rows, self.col] = self.bin
        return out

    def rows(self, indices: np.ndarray) -> "SparseBins":
        """Row subset (Dataset::Subset) in O(nnz of the subset)."""
        indices = np.asarray(indices, dtype=np.int64)
        starts = self.indptr[indices]
        lens = self.indptr[indices + 1] - starts
        new_indptr = np.concatenate([[0], np.cumsum(lens)])
        take = _ranges_concat(starts, lens)
        return SparseBins(
            new_indptr, self.col[take], self.bin[take],
            self.default_bins, (len(indices), self.shape[1]),
        )


def _ranges_concat(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate index ranges [starts[i], starts[i]+lens[i]) vectorized:
    a cumsum over an array of ones with a corrective jump planted at each
    range boundary."""
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    nonempty = lens > 0
    st = np.asarray(starts, dtype=np.int64)[nonempty]
    ln = lens[nonempty]
    out = np.ones(total, dtype=np.int64)
    out[0] = st[0]
    pos = np.cumsum(ln)[:-1]  # positions where each later range begins
    prev_end = st[:-1] + ln[:-1]
    out[pos] = st[1:] - prev_end + 1
    return np.cumsum(out)


def parse_libsvm_csr(
    path_or_lines, has_header: bool = False, chunk_lines: int = 200_000
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Stream-parse LibSVM ``label idx:val ...`` text into CSR arrays.

    Returns ``(labels f32[n], indptr int64[n+1], indices int32[nnz],
    values f64[nnz], num_cols)``.  Peak memory is O(nnz) plus one
    ``chunk_lines``-line text buffer (the reference streams 1MB blocks,
    utils/text_reader.h:144-288).
    """
    own = isinstance(path_or_lines, str)
    fh = open(path_or_lines) if own else iter(path_or_lines)
    labels: List[np.ndarray] = []
    idx_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []
    row_lens: List[np.ndarray] = []
    try:
        if own and has_header:
            fh.readline()
        first = not own and has_header
        while True:
            lines = []
            for line in fh:
                if first:
                    first = False
                    continue
                if line.strip():
                    lines.append(line)
                if len(lines) >= chunk_lines:
                    break
            if not lines:
                break
            lab, ind, val, rl = _parse_libsvm_chunk(lines)
            labels.append(lab)
            idx_parts.append(ind)
            val_parts.append(val)
            row_lens.append(rl)
    finally:
        if own:
            fh.close()
    if not labels:
        return (
            np.empty(0, np.float32),
            np.zeros(1, np.int64),
            np.empty(0, np.int32),
            np.empty(0, np.float64),
            0,
        )
    lab = np.concatenate(labels)
    ind = np.concatenate(idx_parts)
    val = np.concatenate(val_parts)
    rl = np.concatenate(row_lens)
    indptr = np.concatenate([[0], np.cumsum(rl, dtype=np.int64)])
    num_cols = int(ind.max()) + 1 if len(ind) else 0
    return lab.astype(np.float32), indptr, ind.astype(np.int32), val, num_cols


def _parse_libsvm_chunk(lines: List[str]):
    """Vectorized LibSVM token parse of a batch of lines."""
    toks = np.asarray(" ".join(s.strip() for s in lines).split())
    is_pair = np.char.find(toks, ":") >= 0
    labels = toks[~is_pair].astype(np.float64)
    # rows are delimited by the label tokens; entries between two labels
    # belong to the earlier row
    row_of_tok = np.cumsum(~is_pair) - 1
    pair_toks = toks[is_pair]
    if len(pair_toks):
        kv = np.char.partition(pair_toks, ":")
        ind = kv[:, 0].astype(np.int64)
        val = kv[:, 2].astype(np.float64)
    else:
        ind = np.empty(0, np.int64)
        val = np.empty(0, np.float64)
    row_lens = np.bincount(row_of_tok[is_pair], minlength=len(labels))
    return labels, ind, val, row_lens.astype(np.int64)


def _column_order(cols: np.ndarray, num_cols: int) -> np.ndarray:
    """The stable order of entries by column: numpy's radix sort where the
    column indices fit 16 bits, else its merge sort (the same order)."""
    if num_cols <= np.iinfo(np.int16).max:
        cols = cols.astype(np.int16)
    return np.argsort(cols, kind="stable")


def find_bin_mappers_csr(
    indptr: np.ndarray,
    indices: np.ndarray,
    values: np.ndarray,
    num_cols: int,
    sample_idx: np.ndarray,
    max_bin: int = 256,
    categorical_features: Sequence[int] = (),
) -> List[BinMapper]:
    """Per-column BinMappers from a sampled row subset of a CSR matrix.

    Elided zeros are modeled exactly like the reference's sparse
    bin-finding (bin.cpp:48-85): each column's sample is its nonzero
    values among the sampled rows, with ``total_sample_cnt`` equal to the
    number of sampled rows.
    """
    sample_idx = np.asarray(sample_idx, dtype=np.int64)
    starts = indptr[sample_idx]
    lens = indptr[sample_idx + 1] - starts
    take = _ranges_concat(starts, lens)
    cols_s = indices[take]
    vals_s = values[take]
    order = _column_order(cols_s, num_cols)
    cols_s, vals_s = cols_s[order], vals_s[order]
    cats = set(int(c) for c in categorical_features)
    n_sample = len(sample_idx)
    # columns with no sampled nonzero are all-zero -> one shared trivial
    # mapper; only columns actually present get a real find() (this is
    # what keeps 1M-column data O(nnz), not O(num_cols x find))
    trivial = BinMapper.find(np.empty(0), n_sample, max_bin, NUMERICAL)
    mappers: List[BinMapper] = [trivial] * num_cols
    present, first = np.unique(cols_s, return_index=True)
    bounds = np.append(first, len(cols_s))
    for k, j in enumerate(present):
        bt = CATEGORICAL if int(j) in cats else NUMERICAL
        mappers[int(j)] = BinMapper.find(
            vals_s[bounds[k]:bounds[k + 1]], n_sample, max_bin, bt
        )
    return mappers


def encode_csr_bins(
    indptr: np.ndarray,
    indices: np.ndarray,
    values: np.ndarray,
    used_map: np.ndarray,
    mappers: List[BinMapper],
) -> SparseBins:
    """Bin-encode CSR entries in place: O(nnz), never densifies.

    Entries in trivial (dropped) columns vanish; remaining columns are
    renumbered to inner feature indices (used_feature_map semantics,
    dataset.h:286-307).
    """
    n = len(indptr) - 1
    inner_of = np.asarray(used_map, dtype=np.int64)
    keep = inner_of[indices] >= 0
    rows_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    rows = rows_all[keep]
    cols = inner_of[indices[keep]].astype(np.int32)
    vals = values[keep]

    f_used = len(mappers)
    dtype = np.uint8 if max(
        (m.num_bin for m in mappers), default=1
    ) <= 256 else np.uint16
    bins = np.empty(len(vals), dtype=dtype)
    # group entries by column once, encode per column vectorized
    order = _column_order(cols, f_used)
    cols_sorted = cols[order]
    bounds = np.searchsorted(cols_sorted, np.arange(f_used + 1))
    for j in range(f_used):
        sl = order[bounds[j]:bounds[j + 1]]
        if len(sl):
            bins[sl] = mappers[j].value_to_bin(vals[sl]).astype(dtype)

    row_lens = np.bincount(rows, minlength=n)
    new_indptr = np.concatenate([[0], np.cumsum(row_lens, dtype=np.int64)])
    # entries are already in row-major order (rows ascending, original
    # column order within a row)
    default_bins = np.asarray([m.default_bin for m in mappers], dtype=dtype)
    return SparseBins(new_indptr, cols, bins, default_bins, (n, f_used))
