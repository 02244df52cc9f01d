"""DCG/NDCG shared machinery (DCGCalculator, src/metric/dcg_calculator.cpp).

A copy of lightgbm_tpu/dcg.py (numpy only), so that the port's ranking
objective and metric compute their gains and discounts exactly as the
JAX package's do; ``build_padded_query_layout`` also takes a selection
of queries and a width, for the objective's buckets.

Default label gains 2^i - 1 and position discounts 1/log2(2+i)
(dcg_calculator.cpp:13-32, kMaxPosition=10000).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

K_MAX_POSITION = 10000
_MAX_LABEL = 31


def default_label_gains() -> np.ndarray:
    return (2.0 ** np.arange(_MAX_LABEL) - 1.0).astype(np.float64)


def label_gains_from_config(label_gain: Sequence[float]) -> np.ndarray:
    if label_gain:
        return np.asarray(label_gain, np.float64)
    return default_label_gains()


def position_discounts(n: int) -> np.ndarray:
    """discount[i] = 1 / log2(2 + i) (dcg_calculator.cpp:25-28)."""
    return 1.0 / np.log2(2.0 + np.arange(n, dtype=np.float64))


def build_padded_query_layout(qb: np.ndarray, num_data: int,
                              queries: Optional[np.ndarray] = None,
                              width: int = 0):
    """Padded [nq, Q] row-index matrix shared by the lambdarank objective
    and the NDCG metric: row q holds that query's row indices, padding
    cells point at the sentinel slot ``num_data``.  Returns
    (pad_idx int32[nq, Q], lens int64[nq]).

    ``queries`` (the port's addition) keeps only those queries' rows, in
    that order, and ``width`` sets Q to at least that many cells (the
    lambdarank objective's bucket bound); by default every query, Q its
    longest length, as the JAX package's copy."""
    qb = np.asarray(qb)
    lens = np.diff(qb)
    if queries is not None:
        lens = lens[queries]
        qb = qb[queries]  # each kept query's start
    nq = len(lens)
    Q = max(int(lens.max()) if nq else 1, int(width))
    # int32 is enough for row indices and halves the peak footprint
    # (callers needing int64 can cast the small result)
    pad_idx = np.full((nq, Q), num_data, np.int32)
    for q in range(nq):
        pad_idx[q, : lens[q]] = np.arange(qb[q], qb[q] + lens[q])
    return pad_idx, lens


def max_dcg_at_k(k: int, labels: np.ndarray, gains: np.ndarray) -> float:
    """CalMaxDCGAtK (dcg_calculator.cpp:34-56): ideal DCG using labels
    sorted descending."""
    labels = np.asarray(labels)
    k = min(int(k), len(labels))
    top = np.sort(labels.astype(np.int64))[::-1][:k]
    disc = position_discounts(k)
    return float((gains[top] * disc).sum())


def dcg_at_k(k: int, labels_in_score_order: np.ndarray, gains: np.ndarray) -> float:
    labels = np.asarray(labels_in_score_order).astype(np.int64)
    k = min(int(k), len(labels))
    disc = position_discounts(k)
    return float((gains[labels[:k]] * disc).sum())
