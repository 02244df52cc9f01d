"""Evaluation metrics.

Counterpart of lightgbm_tpu/metrics.py.  Scores are raw model outputs,
class-major ``[K, n]`` for multiclass; the sigmoid or softmax is applied
inside the metric like the reference.  auc, binary_logloss and
binary_error run on the host in float64 (``Metric.eval``); ndcg is the
host metric of ``metrics_rank.py``.  l2, l1, multi_logloss and
multi_error take the path ``GBDT.eval_at`` takes in the JAX package, its
``eval_jax``: ``eval_torch`` computes each row's loss in float32 on the
scores' device, sums the weighted losses in float64 and divides by the
sum of the weights.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from .objectives import exp_f32, sum_classes

_EPS = 1e-15


class Metric:
    name = "none"
    bigger_is_better = False
    eval_torch = None  # device path; the metrics below that have one

    def _dev_arrays(self, device):
        """(label, weights) as float32 tensors on ``device``, weights of 1
        where the data has none; made once per device."""
        key = str(device)
        if getattr(self, "_dev", None) is None or self._dev[0] != key:
            lab = torch.as_tensor(self.label, dtype=torch.float32,
                                  device=device)
            w = (torch.ones_like(lab) if self.weights is None else
                 torch.as_tensor(self.weights, dtype=torch.float32,
                                 device=device))
            self._dev = (key, lab, w)
        return self._dev[1:]

    def _mean(self, loss: torch.Tensor, w: torch.Tensor) -> float:
        """Σ loss·w (float32 products, float64 sum) / sum_weights."""
        return float((loss * w).double().sum() / self.sum_weights)

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


class L2Metric(Metric):
    """Reports RMSE (AverageLoss takes sqrt, regression_metric.hpp:98-101)."""

    name = "l2"

    def eval_torch(self, scores):
        lab, w = self._dev_arrays(scores.device)
        return float(np.sqrt(self._mean((scores.reshape(-1) - lab) ** 2, w)))


class L1Metric(Metric):
    name = "l1"

    def eval_torch(self, scores):
        lab, w = self._dev_arrays(scores.device)
        return self._mean((scores.reshape(-1) - lab).abs(), w)


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


def class_index(lab: torch.Tensor, num_class: int) -> torch.Tensor:
    """The class a float label reads from ``[K, n]`` scores, as the JAX
    package's gather takes it: truncated to an integer, a negative index
    counted from the end, then clamped into 0..K-1."""
    idx = lab.to(torch.int64)
    idx = torch.where(idx < 0, idx + num_class, idx)
    return idx.clamp(0, num_class - 1)


class MultiLoglossMetric(Metric):
    """Softmax logloss (multiclass_metric.hpp)."""

    name = "multi_logloss"

    def eval_torch(self, scores):
        lab, w = self._dev_arrays(scores.device)
        z = scores - scores.amax(dim=0, keepdim=True)
        logp = z - torch.log(sum_classes(exp_f32(z)))[None, :]
        loss = -logp.gather(0, class_index(lab, scores.shape[0])[None])[0]
        return self._mean(loss, w)


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval_torch(self, scores):
        lab, w = self._dev_arrays(scores.device)
        err = (scores.argmax(dim=0) != lab.to(torch.int64)).float()
        return self._mean(err, w)


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
    names = config.metric or _default_metric(config.objective)
    for name in names:
        name = name.strip()
        if name in ("l2", "mse", "mean_squared_error", "regression"):
            m: Metric = L2Metric()
        elif name in ("l1", "mae", "mean_absolute_error"):
            m = L1Metric()
        elif name == "binary_logloss":
            m = BinaryLoglossMetric(config)
        elif name == "binary_error":
            m = BinaryErrorMetric(config)
        elif name == "auc":
            m = AUCMetric()
        elif name == "multi_logloss":
            m = MultiLoglossMetric()
        elif name == "multi_error":
            m = MultiErrorMetric()
        elif name in ("ndcg", "ndcg@"):
            from .metrics_rank import NDCGMetric

            m = NDCGMetric(config)
        elif name in ("", "none", "null"):
            continue
        else:
            raise ValueError(f"Unknown metric: {name!r}")
        if metadata is not None:
            m.init(metadata,
                   num_data if num_data is not None else len(metadata.label))
        out.append(m)
    return out


def _default_metric(objective: str) -> List[str]:
    return {
        "regression": ["l2"],
        "binary": ["binary_logloss"],
        "multiclass": ["multi_logloss"],
        "lambdarank": ["ndcg"],
    }.get(objective, ["l2"])
