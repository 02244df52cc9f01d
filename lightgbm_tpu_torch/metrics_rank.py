"""NDCG@k metric (src/metric/rank_metric.hpp:16-165).

A copy of lightgbm_tpu/metrics_rank.py (host numpy): the padded
vectorised path, the per-query fallback for skewed query sizes, and the
NDCG = 1 rule for a query with no positive label.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .dcg import (
    build_padded_query_layout,
    dcg_at_k,
    label_gains_from_config,
    max_dcg_at_k,
    position_discounts,
)
from .metrics import Metric


class NDCGMetric(Metric):
    """Per-query NDCG averaged with query weights; all-negative queries
    count as 1 (rank_metric.hpp:96-100).  Reports one value per eval_at
    position via ``eval_multi``; ``eval`` returns the first position
    (used for early stopping like the reference's metric vector head)."""

    name = "ndcg"
    bigger_is_better = True

    def __init__(self, config):
        self.eval_at = list(config.ndcg_eval_at) or [1, 2, 3, 4, 5]
        self.gains = label_gains_from_config(config.label_gain)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            raise ValueError("NDCG metric requires query information")
        self.qb = np.asarray(metadata.query_boundaries)
        self.query_weights = metadata.query_weights
        nq = len(self.qb) - 1
        self.sum_query_weights = (
            float(nq) if self.query_weights is None else float(self.query_weights.sum())
        )
        # cache per-query ideal DCG at each eval position
        self.max_dcgs = np.zeros((nq, len(self.eval_at)))
        for q in range(nq):
            lab = self.label[self.qb[q] : self.qb[q + 1]]
            for ki, k in enumerate(self.eval_at):
                self.max_dcgs[q, ki] = max_dcg_at_k(k, lab, self.gains)
        # padded [nq, Q] layout for the vectorized eval (shared with the
        # lambdarank objective): padding cells point at the sentinel slot
        # n, whose score sorts last and whose gain is 0, so they never
        # contribute to any DCG@k.  Guard against skewed group sizes —
        # one giant query among many small ones makes nq*Q explode — by
        # falling back to the per-query loop when padding inflates the
        # work more than ~8x over the O(n) loop.
        lens = np.diff(self.qb)
        Q = int(lens.max()) if nq else 1
        # decide BEFORE allocating: the guard would be pointless if the
        # nq x Q matrix it protects against already existed
        self._use_padded = nq == 0 or nq * Q <= 8 * max(num_data, 1)
        if not self._use_padded:
            return
        pad_idx, _ = build_padded_query_layout(self.qb, num_data)
        self._pad_idx = pad_idx
        valid = pad_idx < num_data
        lab_idx = np.minimum(
            self.label[np.minimum(pad_idx, num_data - 1)].astype(np.int64),
            len(self.gains) - 1,
        )
        self._gain_padded = np.where(valid, self.gains[lab_idx], 0.0)
        self._discounts = position_discounts(pad_idx.shape[1])

    def _eval_multi_loop(self, scores) -> List[float]:
        """O(n) per-query fallback for heavily skewed query sizes."""
        acc = np.zeros(len(self.eval_at))
        nq = len(self.qb) - 1
        for q in range(nq):
            beg, end = self.qb[q], self.qb[q + 1]
            lab = self.label[beg:end]
            order = np.argsort(-scores[beg:end], kind="stable")
            w = 1.0 if self.query_weights is None else self.query_weights[q]
            for ki, k in enumerate(self.eval_at):
                if self.max_dcgs[q, ki] <= 0:
                    acc[ki] += w  # no positive labels -> NDCG := 1
                else:
                    acc[ki] += (
                        w * dcg_at_k(k, lab[order], self.gains) / self.max_dcgs[q, ki]
                    )
        return [float(a / self.sum_query_weights) for a in acc]

    def eval_multi(self, scores) -> List[float]:
        """Vectorized over queries: one padded argsort + gather replaces
        the per-query python loop (rank_metric.hpp's per-thread
        accumulators collapse into matrix ops)."""
        scores = np.asarray(scores, np.float64).reshape(-1)
        if not self._use_padded:
            return self._eval_multi_loop(scores)
        nq, Q = self._pad_idx.shape
        sp = np.concatenate([scores, [-np.inf]])  # sentinel slot n;
        # every pad cell maps there via the min(), so no extra masking
        qs = sp[np.minimum(self._pad_idx, len(scores))]
        order = np.argsort(-qs, axis=1, kind="stable")
        g = np.take_along_axis(self._gain_padded, order, axis=1)  # [nq, Q]
        gd = g * self._discounts[None, :]
        cum = np.cumsum(gd, axis=1)  # cum[:, k-1] = DCG@k
        w = (
            np.ones(nq)
            if self.query_weights is None
            else np.asarray(self.query_weights, np.float64)
        )
        out = []
        for ki, k in enumerate(self.eval_at):
            dcg = cum[:, min(k, Q) - 1] if Q else np.zeros(nq)
            maxd = self.max_dcgs[:, ki]
            ndcg = np.where(maxd > 0, dcg / np.maximum(maxd, 1e-300), 1.0)
            out.append(float((ndcg * w).sum() / self.sum_query_weights))
        return out

    def eval(self, scores) -> float:
        return self.eval_multi(scores)[0]
