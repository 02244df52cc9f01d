"""Evaluation metrics (host numpy, float64).

Counterpart of lightgbm_tpu/metrics.py's host path (``Metric.eval``), for
the slice's metrics: auc, binary_logloss, binary_error.  Scores are raw
model outputs; the sigmoid is applied inside the metric like the
reference (binary_metric.hpp).  The other metrics are not ported yet and
raise.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional

import numpy as np

_EPS = 1e-15


class Metric:
    name = "none"
    bigger_is_better = False

    def init(self, metadata, num_data: int) -> None:
        self.label = np.asarray(metadata.label, np.float64)
        self.weights = (None if metadata.weights is None
                        else np.asarray(metadata.weights, np.float64))
        self.sum_weights = (float(num_data) if self.weights is None
                            else float(self.weights.sum()))
        self.num_data = num_data

    def _avg(self, loss: np.ndarray) -> float:
        if self.weights is not None:
            return float((loss * self.weights).sum() / self.sum_weights)
        return float(loss.sum() / self.sum_weights)

    def eval(self, scores: np.ndarray) -> float:
        raise NotImplementedError


class BinaryLoglossMetric(Metric):
    """prob = sigmoid(2*sig*score); loss = -log p_y."""

    name = "binary_logloss"

    def __init__(self, config):
        self.sigmoid = float(config.sigmoid)

    def eval(self, scores):
        scores = np.asarray(scores, np.float64).reshape(-1)
        prob = 1.0 / (1.0 + np.exp(-2.0 * self.sigmoid * scores))
        prob = np.clip(prob, _EPS, 1.0 - _EPS)
        loss = np.where(self.label > 0, -np.log(prob), -np.log(1.0 - prob))
        return self._avg(loss)


class BinaryErrorMetric(Metric):
    """Misclassification rate at prob 0.5."""

    name = "binary_error"

    def __init__(self, config):
        self.sigmoid = float(config.sigmoid)

    def eval(self, scores):
        scores = np.asarray(scores, np.float64).reshape(-1)
        err = ((scores > 0) != (self.label > 0)).astype(np.float64)
        return self._avg(err)


class AUCMetric(Metric):
    """Weighted ROC AUC via one sort sweep with tie grouping
    (binary_metric.hpp:181-238)."""

    name = "auc"
    bigger_is_better = True

    def eval(self, scores):
        scores = np.asarray(scores, np.float64).reshape(-1)
        w = self.weights if self.weights is not None else np.ones_like(self.label)
        pos = (self.label > 0).astype(np.float64) * w
        neg = (self.label <= 0).astype(np.float64) * w
        order = np.argsort(-scores, kind="mergesort")
        s, p, ng = scores[order], pos[order], neg[order]
        group_id = np.zeros(len(s), np.int64)
        group_id[1:] = np.cumsum(np.diff(s) != 0)
        npos = np.bincount(group_id, weights=p)
        nneg = np.bincount(group_id, weights=ng)
        cum_neg_before = np.concatenate([[0.0], np.cumsum(nneg)[:-1]])
        auc_sum = (npos * (cum_neg_before + nneg * 0.5)).sum()
        total_pos, total_neg = npos.sum(), nneg.sum()
        if total_pos == 0 or total_neg == 0:
            return 1.0
        return float(1.0 - auc_sum / (total_pos * total_neg))


def _eval(metric: Metric, scores, label, weights=None) -> float:
    md = SimpleNamespace(label=np.asarray(label), weights=weights)
    metric.init(md, len(md.label))
    return metric.eval(scores)


def auc(scores, label, weights=None) -> float:
    """AUC of raw ``scores`` against 0/1 ``label``."""
    return _eval(AUCMetric(), scores, label, weights)


def binary_logloss(scores, label, sigmoid: float = 1.0, weights=None) -> float:
    return _eval(BinaryLoglossMetric(SimpleNamespace(sigmoid=sigmoid)),
                 scores, label, weights)


def binary_error(scores, label, weights=None) -> float:
    return _eval(BinaryErrorMetric(SimpleNamespace(sigmoid=1.0)),
                 scores, label, weights)


def create_metrics(config, metadata=None,
                   num_data: Optional[int] = None) -> List[Metric]:
    """Factory (metric.cpp:9-28); unknown names raise."""
    out: List[Metric] = []
    names = config.metric or ["binary_logloss"]
    for name in names:
        name = name.strip()
        if name == "binary_logloss":
            m: Metric = BinaryLoglossMetric(config)
        elif name == "binary_error":
            m = BinaryErrorMetric(config)
        elif name == "auc":
            m = AUCMetric()
        elif name in ("l2", "mse", "mean_squared_error", "regression", "l1",
                      "mae", "mean_absolute_error", "multi_logloss",
                      "multi_error", "ndcg", "ndcg@"):
            raise NotImplementedError(
                f"metric {name!r} is not ported to lightgbm_tpu_torch yet "
                "(ROADMAP queue A: other objectives)")
        elif name in ("", "none", "null"):
            continue
        else:
            raise ValueError(f"Unknown metric: {name!r}")
        if metadata is not None:
            m.init(metadata,
                   num_data if num_data is not None else len(metadata.label))
        out.append(m)
    return out
