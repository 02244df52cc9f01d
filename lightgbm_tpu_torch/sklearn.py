"""Scikit-learn API wrappers.

Counterpart of lightgbm_tpu/sklearn.py (the reference's
python-package/lightgbm/sklearn.py): the ``LGBMModel`` base
(sklearn.py:134-460) with fobj/feval adapters from sklearn's
``(y_true, y_pred)`` signatures to the ``(preds, dataset)`` protocol
(sklearn.py:28-133), and ``LGBMRegressor`` / ``LGBMClassifier`` (label
encoding, ``predict_proba``) / ``LGBMRanker`` (sklearn.py:461-642).
Each estimator takes ``device`` (CUDA unless ``"cpu"``), which ``fit``
hands to ``Dataset`` and ``train``.  scikit-learn is optional: with it
the estimators inherit its base classes (``clone``, ``GridSearchCV``);
without it they are plain classes whose ``get_params`` / ``set_params``
follow the estimator contract.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset, LightGBMError
from .engine import train as _train

# soft sklearn dependency (reference sklearn.py:13-25): inherit the real
# base classes when available so clone/GridSearchCV/tags work
try:
    from sklearn.base import (
        BaseEstimator as _SKLBase,
        ClassifierMixin as _SKLClassifierMixin,
        RegressorMixin as _SKLRegressorMixin,
    )
except ImportError:  # pragma: no cover
    _SKLBase = object

    class _SKLClassifierMixin:  # type: ignore[no-redef]
        pass

    class _SKLRegressorMixin:  # type: ignore[no-redef]
        pass


class _ObjectiveFunctionWrapper:
    """sklearn fobj(y_true, y_pred [, weight|group]) -> internal
    fobj(preds, dataset) (sklearn.py:28-87)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            grad, hess = self.func(labels, preds)
        elif argc == 3:
            grad, hess = self.func(labels, preds, dataset.get_field("group"))
        else:
            raise TypeError(f"Self-defined objective should have 2 or 3 arguments, got {argc}")
        weight = dataset.get_weight()
        if weight is not None:
            grad = np.asarray(grad) * weight
            hess = np.asarray(hess) * weight
        return grad, hess


class _EvalFunctionWrapper:
    """sklearn feval(y_true, y_pred [, weight [, group]]) -> internal
    feval(preds, dataset) (sklearn.py:90-133)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        if argc == 4:
            return self.func(
                labels, preds, dataset.get_weight(), dataset.get_field("group")
            )
        raise TypeError(f"Self-defined eval function should have 2 to 4 arguments, got {argc}")


class LGBMModel(_SKLBase):
    """Base estimator (sklearn.py:134-460)."""

    def __init__(
        self,
        boosting_type: str = "gbdt",
        num_leaves: int = 31,
        max_depth: int = -1,
        learning_rate: float = 0.1,
        n_estimators: int = 10,
        max_bin: int = 255,
        subsample_for_bin: int = 50000,
        objective: str = "regression",
        min_split_gain: float = 0.0,
        min_child_weight: float = 5.0,
        min_child_samples: int = 10,
        subsample: float = 1.0,
        subsample_freq: int = 1,
        colsample_bytree: float = 1.0,
        reg_alpha: float = 0.0,
        reg_lambda: float = 0.0,
        scale_pos_weight: float = 1.0,
        is_unbalance: bool = False,
        seed: int = 0,
        nthread: int = -1,
        silent: bool = True,
        sigmoid: float = 1.0,
        drop_rate: float = 0.1,
        max_drop: int = 50,
        skip_drop: float = 0.5,
        uniform_drop: bool = False,
        xgboost_dart_mode: bool = False,
        device=None,
    ):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.max_bin = max_bin
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.scale_pos_weight = scale_pos_weight
        self.is_unbalance = is_unbalance
        self.seed = seed
        self.nthread = nthread
        self.silent = silent
        self.sigmoid = sigmoid
        self.drop_rate = drop_rate
        self.max_drop = max_drop
        self.skip_drop = skip_drop
        self.uniform_drop = uniform_drop
        self.xgboost_dart_mode = xgboost_dart_mode
        self.device = device
        self._Booster: Optional[Booster] = None
        self.best_iteration = -1
        self.evals_result_: Dict = {}

    # --------------------------------------------------- sklearn estimator
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        import inspect

        # subclasses declare (objective=..., **kwargs); enumerate the base
        # class's explicit parameter list instead
        sig = inspect.signature(LGBMModel.__init__)
        return {
            name: getattr(self, name)
            for name, p in sig.parameters.items()
            if name != "self" and p.kind is not inspect.Parameter.VAR_KEYWORD
        }

    def set_params(self, **params) -> "LGBMModel":
        for k, v in params.items():
            setattr(self, k, v)
        return self

    def _to_inner_params(self) -> Dict[str, Any]:
        """Map sklearn names to framework params (sklearn.py:257-292)."""
        p = {
            "boosting_type": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "max_bin": self.max_bin,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "objective": self.objective if not callable(self.objective) else "none",
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "scale_pos_weight": self.scale_pos_weight,
            "is_unbalance": self.is_unbalance,
            "seed": self.seed,
            "sigmoid": self.sigmoid,
            "verbose": 0 if self.silent else 1,
        }
        if self.boosting_type == "dart":
            p.update(
                drop_rate=self.drop_rate, max_drop=self.max_drop,
                skip_drop=self.skip_drop, uniform_drop=self.uniform_drop,
                xgboost_dart_mode=self.xgboost_dart_mode,
            )
        return p

    def fit(
        self,
        X,
        y,
        sample_weight=None,
        init_score=None,
        group=None,
        eval_set=None,
        eval_sample_weight=None,
        eval_init_score=None,
        eval_group=None,
        eval_metric=None,
        early_stopping_rounds=None,
        verbose: bool = False,
        feature_name=None,
        categorical_feature=None,
        callbacks=None,
        _extra_params=None,
    ) -> "LGBMModel":
        params = self._to_inner_params()
        if _extra_params:
            params.update(_extra_params)
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        fobj = _ObjectiveFunctionWrapper(self.objective) if callable(self.objective) else None
        feval = _EvalFunctionWrapper(eval_metric) if callable(eval_metric) else None

        train_set = Dataset(
            X, label=y, weight=sample_weight, group=group, init_score=init_score,
            params=params, feature_name=feature_name,
            categorical_feature=categorical_feature, device=self.device,
        )
        valid_sets = []
        valid_names = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                vw = eval_sample_weight[i] if eval_sample_weight else None
                vg = eval_group[i] if eval_group else None
                vi = eval_init_score[i] if eval_init_score else None
                valid_sets.append(train_set.create_valid(
                    vx, label=vy, weight=vw, group=vg, init_score=vi))
                valid_names.append(f"valid_{i}")

        self.evals_result_ = {}
        self._Booster = _train(
            params,
            train_set,
            num_boost_round=self.n_estimators,
            valid_sets=valid_sets,
            valid_names=valid_names,
            fobj=fobj,
            feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=self.evals_result_,
            verbose_eval=verbose,
            callbacks=callbacks,
            device=self.device,
        )
        self.best_iteration = self._Booster.best_iteration
        return self

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1):
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call fit before predict")
        return self._Booster.predict(X, raw_score=raw_score, num_iteration=num_iteration)

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LightGBMError("No booster found, call fit first")
        return self._Booster

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance()

    @property
    def feature_importance_(self) -> np.ndarray:
        """Normalized split-count importances (reference
        sklearn.py:448-451)."""
        arr = self.booster_.feature_importance().astype(np.float32)
        total = arr.sum()
        return arr / total if total else arr

    def booster(self) -> Booster:
        """Deprecated accessor kept for reference compatibility
        (sklearn.py:454-456); use the ``booster_`` attribute."""
        import warnings

        warnings.warn("Use attribute booster_ instead.", DeprecationWarning)
        return self.booster_

    def feature_importance(self) -> np.ndarray:
        """Deprecated accessor kept for reference compatibility
        (sklearn.py:458-460); use ``feature_importance_``."""
        import warnings

        warnings.warn(
            "Use attribute feature_importance_ instead.", DeprecationWarning
        )
        return self.feature_importance_

    def apply(self, X, num_iteration: int = -1):
        """Per-row leaf indices (sklearn.py predict with pred_leaf)."""
        return self.booster_.predict(X, pred_leaf=True, num_iteration=num_iteration)


class LGBMRegressor(_SKLRegressorMixin, LGBMModel):
    def __init__(self, objective: str = "regression", **kwargs):
        super().__init__(objective=objective, **kwargs)

    def fit(self, X, y, **kwargs):  # noqa: D102
        return super().fit(X, y, **kwargs)


class LGBMClassifier(_SKLClassifierMixin, LGBMModel):
    def __init__(self, objective: str = "binary", **kwargs):
        super().__init__(objective=objective, **kwargs)

    def fit(self, X, y, **kwargs):
        y = np.asarray(y)
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        self.n_classes_ = len(self.classes_)
        extra = {}
        if self.n_classes_ > 2 and not callable(self.objective):
            # leave self.objective untouched (sklearn params are immutable
            # across fits); route the override through fit-time params
            extra = {"objective": "multiclass", "num_class": self.n_classes_}
        # eval_set labels must go through the same encoding as y
        eval_set = kwargs.get("eval_set")
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            encoded = []
            for vx, vy in eval_set:
                vy = np.asarray(vy)
                vy_enc = np.searchsorted(self.classes_, vy)
                in_range = vy_enc < len(self.classes_)
                if not (np.all(in_range) and np.all(self.classes_[np.where(in_range, vy_enc, 0)] == vy)):
                    raise LightGBMError(
                        "eval_set contains labels unseen in training data"
                    )
                encoded.append((vx, vy_enc.astype(np.float64)))
            kwargs["eval_set"] = encoded
        super().fit(X, y_enc.astype(np.float64), _extra_params=extra, **kwargs)
        return self

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1):
        if raw_score:
            return super().predict(X, raw_score=True, num_iteration=num_iteration)
        proba = self.predict_proba(X, num_iteration=num_iteration)
        return self.classes_[np.argmax(proba, axis=1)]

    def predict_proba(self, X, num_iteration: int = -1) -> np.ndarray:
        out = super().predict(X, num_iteration=num_iteration)
        if out.ndim == 1:  # binary: prob of positive class
            return np.column_stack([1.0 - out, out])
        return out


class LGBMRanker(LGBMModel):
    def __init__(self, objective: str = "lambdarank", **kwargs):
        super().__init__(objective=objective, **kwargs)

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            raise LightGBMError("Should set group for ranking task")
        if "eval_set" in kwargs and kwargs["eval_set"] is not None:
            if kwargs.get("eval_group") is None:
                raise LightGBMError("Eval_group cannot be None when eval_set is not None")
        return super().fit(X, y, group=group, **kwargs)
