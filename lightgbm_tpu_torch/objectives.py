"""Objective functions: per-row gradients and hessians as tensor ops.

Counterpart of lightgbm_tpu/objectives.py: L2 regression, binary logloss
and softmax multiclass; LambdaRank lives in ``objectives_rank.py``.
Scores are class-major ``[num_class, n]`` for multiclass and ``[n]``
otherwise.  Every float32 op runs in the JAX package's order, with its
exp (``exp_f32``) and its flush of subnormal results, so the gradients
are the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(v: float) -> float:
    return float(np.float32(v))


_EXP_POLY = tuple(_f32(p) for p in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))
_F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)
_LOG2E, _LN2_HI, _LN2_LO = (_f32(1.44269504088896341), _f32(0.693359375),
                            _f32(-2.12194440e-4))


def _fma(a, b, c):
    """float32 a*b + c with one rounding of the sum (the product of two
    float32 values is exact in float64); b and c are float32 values."""
    return (a.double() * b + c).float()


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 exp as the JAX package's XLA CPU build computes it: the
    Cephes range reduction and polynomial, with fused multiply-adds.
    Matches ``jnp.exp`` bitwise on float32 inputs, where torch.exp differs
    in the last place for ~9% of them; the gradients, and so the trees,
    then agree with the reference to the histogram's summation order."""
    x = x.clamp(-87.8, 88.8)
    n = torch.floor(_fma(x, _LOG2E, 0.5))
    r = _fma(-n, _LN2_HI, x)
    r = _fma(-n, _LN2_LO, r)
    y = torch.full_like(r, _EXP_POLY[0])
    for p in _EXP_POLY[1:]:
        y = _fma(y, r, p)
    return flush_subnormal((_fma(y, r * r, r) + 1.0) * torch.exp2(n))


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 results to (signed) zero, as XLA's CPU code
    computes them (flush-to-zero)."""
    return torch.where(x.abs() < _F32_MIN_NORMAL, x * 0.0, x)


class ObjectiveFunction:
    name = "none"
    num_class = 1
    sigmoid = -1.0

    def init(self, metadata, num_data: int, device) -> None:
        self.label = torch.as_tensor(
            np.asarray(metadata.label, np.float32), device=device)
        self.weights = (None if metadata.weights is None else torch.as_tensor(
            np.asarray(metadata.weights, np.float32), device=device))
        self.num_data = num_data

    def get_gradients(self, scores: torch.Tensor):
        raise NotImplementedError


class RegressionL2(ObjectiveFunction):
    """L2 regression: g = score - label, h = 1 (x weight)
    (regression_objective.hpp:24-39)."""

    name = "regression"

    def get_gradients(self, scores):
        g = scores - self.label
        h = torch.ones_like(scores)
        if self.weights is not None:
            g, h = g * self.weights, h * self.weights
        return g, h


class BinaryLogloss(ObjectiveFunction):
    """Binary logloss on labels {0,1} -> {-1,+1}: response =
    -2*l*sig / (1 + exp(2*l*sig*s)); hess = |r| * (2*sig - |r|), with
    is_unbalance / scale_pos_weight class weights (binary_objective.hpp:
    40-59)."""

    name = "binary"

    def __init__(self, config):
        if config.sigmoid <= 0:
            raise ValueError("sigmoid parameter must be > 0")
        self.sigmoid = float(config.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lab = np.asarray(metadata.label)
        cnt_pos = int((lab == 1).sum())
        cnt_neg = int(num_data - cnt_pos)
        if cnt_pos == 0 or cnt_neg == 0:
            raise ValueError("Training data only contains one class")
        w_neg, w_pos = 1.0, 1.0
        if self.is_unbalance:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        dev = self.label.device
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        is_pos = self.label > 0
        self._sign = torch.where(is_pos, f32(1.0), f32(-1.0))
        self._lw = torch.where(is_pos, f32(w_pos), f32(w_neg))
        self._sig = f32(self.sigmoid)

    def get_gradients(self, scores):
        sig = self._sig
        response = flush_subnormal(
            -2.0 * self._sign * sig
            / (1.0 + exp_f32(2.0 * self._sign * sig * scores)))
        abs_r = response.abs()
        g = flush_subnormal(response * self._lw)
        h = flush_subnormal(abs_r * (2.0 * sig - abs_r) * self._lw)
        if self.weights is not None:
            g, h = g * self.weights, h * self.weights
        return g, h


class MulticlassSoftmax(ObjectiveFunction):
    """Softmax multiclass (multiclass_objective.hpp:13-94): scores are
    [K, n]; g = p - 1{y=k}, h = 2 p (1-p)."""

    name = "multiclass"

    def __init__(self, config):
        self.num_class = int(config.num_class)
        if self.num_class <= 1:
            raise ValueError("multiclass objective needs num_class > 1")

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        # the float label against each class index, as _multiclass_grads
        # builds it: a label outside 0..K-1 (or not whole) matches no class
        classes = torch.arange(self.num_class, dtype=torch.float32,
                               device=self.label.device)
        self._onehot = (self.label[None, :] == classes[:, None]).float()

    def get_gradients(self, scores):
        p = softmax_classes(scores)
        g = p - self._onehot
        h = flush_subnormal(2.0 * p * (1.0 - p))
        if self.weights is not None:
            g = flush_subnormal(g * self.weights[None, :])
            h = flush_subnormal(h * self.weights[None, :])
        return g, h


def softmax_classes(scores: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(scores, axis=0)`` over ``[K, n]`` as XLA's CPU
    build computes it: exp(z - max) through ``exp_f32``, then division by
    the sum over the K classes, added in class order (written out, so
    that the card and the CPU add in the same order)."""
    e = exp_f32(scores - scores.amax(dim=0, keepdim=True))
    return flush_subnormal(e / sum_classes(e))


def sum_classes(x: torch.Tensor) -> torch.Tensor:
    """Σ over the classes (dim 0) of ``[K, n]``, added in class order as
    XLA adds K < 32 terms."""
    total = x[0]
    for k in range(1, x.shape[0]):
        total = total + x[k]
    return total


_OBJECTIVES = {"regression": "regression", "regression_l2": "regression",
               "mean_squared_error": "regression", "mse": "regression",
               "l2": "regression", "binary": "binary",
               "multiclass": "multiclass", "softmax": "multiclass",
               "lambdarank": "lambdarank"}


def objective_kind(name: str) -> str:
    """The objective an ``objective=`` name selects (the aliases of
    create_objective, objective_function.cpp:9-20); unknown names
    raise."""
    if name not in _OBJECTIVES:
        raise ValueError(f"Unknown objective: {name!r}")
    return _OBJECTIVES[name]


def create_objective(config, metadata=None, num_data=None, device="cpu"):
    """Factory (objective_function.cpp:9-20)."""
    kind = objective_kind(config.objective)
    if kind == "regression":
        obj = RegressionL2()
    elif kind == "binary":
        obj = BinaryLogloss(config)
    elif kind == "multiclass":
        obj = MulticlassSoftmax(config)
    else:
        from .objectives_rank import LambdarankNDCG

        obj = LambdarankNDCG(config)
    if metadata is not None:
        obj.init(metadata,
                 num_data if num_data is not None else len(metadata.label),
                 device)
    return obj
