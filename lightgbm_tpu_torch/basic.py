"""User-facing ``Dataset`` and ``Booster``.

Counterpart of lightgbm_tpu/basic.py for the port's surface: lazy
binning of an in-memory matrix (validation sets aligned to their
reference) with labels, weights, query groups and init scores;
``Booster`` training updates, prediction (``[n]``, or ``[n, K]`` for
multiclass), evaluation and the model text round trip.  Every object
lives on one device, resolved by ``backend.resolve_device``: CUDA unless
``device="cpu"`` is passed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .backend import resolve_device
from .config import Config, key_alias_transform
from .io.dataset import BinnedDataset
from .io.metadata import Metadata
from .models.gbdt import GBDT, check_supported
from .objectives import create_objective


class LightGBMError(Exception):
    """Error raised by the framework (reference basic.py:45)."""


def _to_2d_float(data) -> np.ndarray:
    if hasattr(data, "tocsr"):
        raise NotImplementedError(
            "sparse input is not ported to lightgbm_tpu_torch yet (ROADMAP "
            "queue A6: file and sparse input)")
    if hasattr(data, "values") and not isinstance(data, np.ndarray):
        data = data.values  # pandas
    arr = np.asarray(data, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.ndim != 2:
        raise LightGBMError("data must be 2 dimensional")
    return arr


class Dataset:
    """Training/validation data, binned lazily on first use so that a
    validation set can be aligned to its training set's bin mappers."""

    def __init__(self, data, label=None, max_bin: int = 256,
                 reference: Optional["Dataset"] = None, weight=None,
                 group=None, init_score=None,
                 feature_name: Optional[List[str]] = None,
                 categorical_feature: Optional[Sequence[int]] = None,
                 params: Optional[Dict[str, Any]] = None, device=None):
        self.data = data
        self.label = label
        self.max_bin = int(max_bin)
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = list(categorical_feature or [])
        self.params = dict(params or {})
        self.device = resolve_device(device)
        self._inner: Optional[BinnedDataset] = None

    def construct(self) -> BinnedDataset:
        if self._inner is not None:
            return self._inner
        if isinstance(self.data, str):
            raise NotImplementedError(
                "file input is not ported to lightgbm_tpu_torch yet (ROADMAP "
                "queue A6: file and sparse input)")
        params = key_alias_transform(dict(self.params))
        params.setdefault("max_bin", self.max_bin)
        cfg = Config.from_dict(params)
        if self.label is None:
            raise LightGBMError("label should not be None for training data")
        meta = Metadata(label=np.asarray(self.label), weights=self.weight,
                        init_score=self.init_score)
        if self.group is not None:
            meta.set_field("group", np.asarray(self.group))
        X = _to_2d_float(self.data)
        if self.reference is not None:
            self._inner = self.reference.construct().align_with(X, meta)
        else:
            cats = self.categorical_feature
            if any(isinstance(c, str) for c in cats):
                if not self.feature_name:
                    raise LightGBMError("categorical_feature given by name "
                                        "requires feature_name")
                cats = [c if not isinstance(c, str)
                        else self.feature_name.index(c) for c in cats]
            self._inner = BinnedDataset.from_matrix(
                X, meta, config=cfg, categorical_features=cats,
                feature_names=self.feature_name)
        return self._inner

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params, device=self.device)

    def set_field(self, field_name: str, data) -> None:
        """label, weight, group (or query) or init_score, on the binned
        dataset too once it is built (reference basic.py set_field)."""
        if self._inner is not None:
            self._inner.metadata.set_field(field_name, data)
        if field_name == "label":
            self.label = data
        elif field_name == "weight":
            self.weight = data
        elif field_name in ("group", "query"):
            self.group = data
        elif field_name == "init_score":
            self.init_score = data

    def get_field(self, field_name: str):
        """The field as set; once built, as the binned dataset holds it
        (``group`` as query sizes)."""
        if self._inner is not None:
            return self._inner.metadata.get_field(field_name)
        return {"label": self.label, "weight": self.weight,
                "group": self.group, "query": self.group,
                "init_score": self.init_score}.get(field_name)


class Booster:
    """The boosting model.  Construct with ``train_set`` (training),
    ``model_file`` or ``model_str`` (prediction)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device=None):
        self.params = dict(params or {})
        self.device = resolve_device(device)
        self.name_valid_sets: List[str] = []
        self.train_data_name = "training"
        cfg = Config.from_dict(self.params)
        self.config = cfg
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise LightGBMError("Training data should be Dataset instance")
            check_supported(cfg)
            if cfg.input_model:
                raise NotImplementedError(
                    "continued training is not ported to lightgbm_tpu_torch "
                    "yet (ROADMAP queue A2: the training API surface)")
            inner = train_set.construct()
            objective = None
            if cfg.objective != "none":
                objective = create_objective(cfg, inner.metadata,
                                             inner.num_data, self.device)
            self._gbdt = GBDT(cfg, inner, objective, device=self.device)
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file, "r") as fh:
                    model_str = fh.read()
            self._gbdt = GBDT(cfg, device=self.device)
            self._gbdt.load_model_from_string(model_str)
        else:
            raise LightGBMError(
                "Booster needs at least one of train_set, model_file, "
                "model_str")

    @classmethod
    def model_from_string(cls, model_str: str, device=None,
                          params=None) -> "Booster":
        return cls(params=params, model_str=model_str, device=device)

    @classmethod
    def from_gbdt(cls, gbdt: GBDT, params=None) -> "Booster":
        """A prediction-mode Booster around an existing GBDT."""
        self = cls.__new__(cls)
        self.params = dict(params or {})
        self.device = gbdt.device
        self.config = gbdt.config
        self.name_valid_sets = []
        self.train_data_name = "training"
        self._gbdt = gbdt
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        """Name used for the training set in eval output (reference
        basic.py set_train_data_name)."""
        self.train_data_name = name
        return self

    def add_valid(self, data: Dataset, name: str) -> None:
        self._gbdt.add_valid_dataset(data.construct())
        self.name_valid_sets.append(name)

    def update(self) -> bool:
        """One boosting iteration; True when no further split is possible."""
        return self._gbdt.train_one_iter()

    def eval_train(self):
        return self._eval_at(0, self.train_data_name)

    def eval_valid(self):
        out = []
        for i, name in enumerate(self.name_valid_sets):
            out.extend(self._eval_at(i + 1, name))
        return out

    def _eval_at(self, data_idx: int, name: str):
        gb = self._gbdt
        metrics = (gb.train_metrics if data_idx == 0
                   else gb.valid_metrics[data_idx - 1])
        vals = gb.eval_at(data_idx)
        out = []
        for m in metrics:
            keys = ([f"{m.name}@{k}" for k in m.eval_at]
                    if hasattr(m, "eval_multi") else [m.name])
            out += [(name, key, vals[key], m.bigger_is_better)
                    for key in keys]
        return out

    def predict(self, data, num_iteration: int = -1, raw_score: bool = False):
        """Raw-feature prediction: ``[n]``, or ``[n, K]`` for multiclass
        (softmax probabilities; raw scores with ``raw_score``)."""
        X = _to_2d_float(data)
        if raw_score:
            return self._gbdt.predict_raw_score(X, num_iteration)
        return self._gbdt.predict(X, num_iteration)

    def save_model(self, filename: str, num_iteration: int = -1) -> None:
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration))

    def model_to_string(self, num_iteration: int = -1) -> str:
        return self._gbdt.save_model_to_string(num_iteration)

    def num_trees(self) -> int:
        return self._gbdt.num_trees
