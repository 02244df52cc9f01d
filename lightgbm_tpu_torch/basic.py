"""User-facing ``Dataset`` and ``Booster``.

Counterpart of lightgbm_tpu/basic.py for the port's surface.  A
``Dataset`` is binned lazily from a matrix, a scipy sparse matrix (in
O(nnz)) or a text file (or its binary cache), validation sets aligned to
their reference, with labels, weights, query groups and init scores, and
row subsets sharing the bins.  ``Booster`` does training updates (with a
custom objective's gradients), rollback, parameter resets, continued
training from an init model, prediction of a matrix, a sparse matrix or
a text file (``[n]``, ``[n, K]`` for multiclass, or leaf indices),
evaluation (with a custom metric), the model text and JSON dump,
importances, attributes and pickling.  Every object lives on one device,
resolved by ``backend.resolve_device``: CUDA unless ``device="cpu"`` is
passed.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from .backend import resolve_device
from .config import Config, key_alias_transform
from .io.dataset import BinnedDataset
from .io.metadata import Metadata
from .models.dart import boosting_for_model, create_boosting
from .models.gbdt import GBDT, check_supported
from .objectives import create_objective
from .resilience.atomic import atomic_write


# float64 values of one densified row chunk of a sparse matrix to predict
# (the JAX package's 32M: ~256 MB)
SPARSE_PREDICT_CHUNK_VALUES = 32 << 20


class LightGBMError(Exception):
    """Error raised by the framework (reference basic.py:45)."""


def _to_2d_float(data) -> np.ndarray:
    """numpy / pandas / scipy-sparse rows -> a float64 [n, F] matrix."""
    if hasattr(data, "toarray"):  # scipy sparse
        data = data.toarray()
    elif hasattr(data, "values") and not isinstance(data, np.ndarray):
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
        """Bin lazily (basic.py:1014-1036): a text file path (or its
        binary cache) through ``BinnedDataset.from_file``, a scipy sparse
        matrix in O(nnz) through ``from_csr``, anything else as a dense
        matrix; a reference's bin mappers when one is given."""
        if self._inner is not None:
            return self._inner
        params = key_alias_transform(dict(self.params))
        params.setdefault("max_bin", self.max_bin)
        cfg = Config.from_dict(params)
        cats = self.categorical_feature
        if any(isinstance(c, str) for c in cats):
            if not self.feature_name:
                raise LightGBMError("categorical_feature given by name "
                                    "requires feature_name")
            cats = [c if not isinstance(c, str)
                    else self.feature_name.index(c) for c in cats]
        meta = Metadata(
            label=None if self.label is None else np.asarray(self.label),
            weights=self.weight, init_score=self.init_score)
        if self.group is not None:
            meta.set_field("group", np.asarray(self.group))
        ref = self.reference.construct() if self.reference is not None \
            else None
        if isinstance(self.data, str):
            inner = BinnedDataset.from_file(self.data, config=cfg,
                                            reference=ref,
                                            categorical_features=cats or None)
            # fields given here override the file's (basic.py:120-133)
            if meta.label is not None:
                inner.metadata.set_field("label", meta.label)
            for field in ("weight", "init_score"):
                v = meta.get_field(field)
                if v is not None:
                    inner.metadata.set_field(field, v)
            if meta.query_boundaries is not None:
                inner.metadata.query_boundaries = meta.query_boundaries
                inner.metadata._finish()
            self._inner = inner
            return inner
        if self.label is None:
            raise LightGBMError("label should not be None for training data")
        if hasattr(self.data, "tocsr"):
            csr = self.data.tocsr()
            indptr = np.asarray(csr.indptr, dtype=np.int64)
            indices = np.asarray(csr.indices, dtype=np.int64)
            values = np.asarray(csr.data, dtype=np.float64)
            if ref is not None:
                self._inner = ref.align_with_csr(indptr, indices, values, meta)
            else:
                self._inner = BinnedDataset.from_csr(
                    indptr, indices, values, csr.shape[1], meta, config=cfg,
                    categorical_features=cats,
                    feature_names=self.feature_name)
            return self._inner
        X = _to_2d_float(self.data)
        if ref is not None:
            self._inner = ref.align_with(X, meta)
        else:
            self._inner = BinnedDataset.from_matrix(
                X, meta, config=cfg, categorical_features=cats,
                feature_names=self.feature_name)
        return self._inner

    def save_binary(self, filename: str) -> None:
        """The binned dataset as the JAX package's npz binary cache."""
        self.construct().save_binary(filename)

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

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows ``used_indices`` of this dataset, sharing its bin
        mappers (basic.py:179-189)."""
        out = Dataset.__new__(Dataset)
        out.__dict__.update(
            data=None, label=None, max_bin=self.max_bin, reference=self,
            weight=None, group=None, init_score=None,
            feature_name=self.feature_name,
            categorical_feature=self.categorical_feature,
            params=dict(params or self.params), device=self.device,
            _inner=self.construct().subset(np.asarray(used_indices)))
        return out

    def get_label(self):
        return self.get_field("label")

    def get_weight(self):
        return self.get_field("weight")

    def get_init_score(self):
        return self.get_field("init_score")

    def get_group(self):
        """Query sizes, or None."""
        g = self.get_field("group")
        return None if g is None else np.asarray(g)

    def num_data(self) -> int:
        return self.construct().num_data

    def num_feature(self) -> int:
        return self.construct().num_total_features

    def _reset_or_refuse(self, what: str) -> None:
        """A change to what binning reads, after binning: bin again lazily
        while the raw data is held; a subset holds none, so refuse
        (basic.py:227-236)."""
        if self._inner is None:
            return
        if self.data is None:
            raise LightGBMError(f"cannot change {what} after construction "
                                "once raw data was freed; create a new "
                                "Dataset")
        self._inner = None

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """Categorical columns by index or name, or 'auto' (none)."""
        if isinstance(categorical_feature, str):
            if categorical_feature != "auto":
                raise LightGBMError("categorical_feature must be a list of "
                                    "int/str or 'auto'")
            cats = []
        else:
            cats = list(categorical_feature or [])
        if cats != self.categorical_feature:
            self._reset_or_refuse("categorical_feature")
        self.categorical_feature = cats
        return self

    def set_feature_name(self, feature_name) -> "Dataset":
        """Column names; their count must match the data's."""
        names = list(feature_name) if feature_name is not None else None
        if names is not None:
            expected = None
            if self._inner is not None:
                expected = self._inner.num_total_features
            elif len(getattr(self.data, "shape", ())) == 2:
                expected = self.data.shape[1]
            if expected is not None and len(names) != expected:
                raise LightGBMError(f"expected {expected} feature names, "
                                    f"got {len(names)}")
            if self._inner is not None:
                self._inner.feature_names = names
        self.feature_name = names
        return self

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """Bin this dataset with ``reference``'s bin mappers."""
        if reference is not self.reference:
            self._reset_or_refuse("reference")
        self.reference = reference
        return self


# parameters Booster.reset_parameter applies mid-training: the rate, and
# the sampling keys train_one_iter reads every iteration (gbdt.py:514-553)
RESETTABLE = ("learning_rate", "bagging_fraction", "bagging_freq",
              "feature_fraction")


class Booster:
    """The boosting model.  Construct with ``train_set`` (training; an
    init model through the ``input_model`` parameter continues it),
    ``model_file`` or ``model_str`` (prediction)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device=None):
        self._init_attrs(params, device)
        cfg = self.config
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise LightGBMError("Training data should be Dataset instance")
            check_supported(cfg)
            inner = train_set.construct()
            objective = None
            if cfg.objective != "none":
                objective = create_objective(cfg, inner.metadata,
                                             inner.num_data, self.device)
            self._gbdt = create_boosting(cfg, inner, objective,
                                         device=self.device)
            self._train_dataset = train_set
            if cfg.input_model:
                init = Booster(model_file=cfg.input_model, device=self.device)
                self._gbdt.merge_from(init._gbdt, prepend=True)
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file, "r") as fh:
                    model_str = fh.read()
            # a first line of "dart" loads a DART (boosting.cpp:7-16)
            self._gbdt = boosting_for_model(model_str, cfg, self.device)
            self._gbdt.load_model_from_string(model_str)
        else:
            raise LightGBMError(
                "Booster needs at least one of train_set, model_file, "
                "model_str")

    def _init_attrs(self, params, device) -> None:
        self.params = dict(params or {})
        self.device = resolve_device(device)
        self.config = Config.from_dict(self.params)
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self.name_valid_sets: List[str] = []
        self.train_data_name = "training"
        self._train_dataset: Optional[Dataset] = None
        self._attr: Dict[str, str] = {}

    @classmethod
    def model_from_string(cls, model_str: str, device=None,
                          params=None) -> "Booster":
        return cls(params=params, model_str=model_str, device=device)

    @classmethod
    def from_gbdt(cls, gbdt: GBDT, params=None) -> "Booster":
        """A prediction-mode Booster around an existing GBDT."""
        self = cls.__new__(cls)
        self._init_attrs(params, gbdt.device)
        self.config = gbdt.config
        self._gbdt = gbdt
        return self

    # ------------------------------------------------------------ attributes
    def attr(self, key: str) -> Optional[str]:
        return self._attr.get(key)

    def set_attr(self, **kwargs) -> "Booster":
        """Set string attributes; None deletes one."""
        for key, value in kwargs.items():
            if value is None:
                self._attr.pop(key, None)
            elif not isinstance(value, str):
                raise ValueError("Set attr only accepts strings")
            else:
                self._attr[key] = value
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        """Name used for the training set in eval output (reference
        basic.py set_train_data_name)."""
        self.train_data_name = name
        return self

    # -------------------------------------------------------------- training
    def add_valid(self, data: Dataset, name: str) -> None:
        if not isinstance(data, Dataset):
            raise LightGBMError("Validation data should be Dataset instance")
        self._gbdt.add_valid_dataset(data.construct())
        self.name_valid_sets.append(name)

    def update(self, train_set: Optional[Dataset] = None,
               fobj: Optional[Callable] = None) -> bool:
        """One boosting iteration; True when no further split is possible.
        ``fobj(scores, train_set)`` gets the ``[K·n]`` class-major raw
        scores and returns ``(grad, hess)`` in that layout
        (basic.py:397-413)."""
        if train_set is not None and train_set is not self._train_dataset:
            self._reset_train_data(train_set)
        if fobj is None:
            return self._gbdt.train_one_iter()
        grad, hess = fobj(self._gbdt.predict_at(0).reshape(-1),
                          self._train_dataset)
        grad = np.asarray(grad, np.float32)
        hess = np.asarray(hess, np.float32)
        n = self._gbdt.num_data * self._gbdt.num_class
        if len(grad) != n or len(hess) != n:
            raise LightGBMError(
                f"Lengths of gradient({len(grad)}) and hessian({len(hess)}) "
                f"don't match training rows x classes ({n})")
        return self._gbdt.train_one_iter(grad, hess)

    def _reset_train_data(self, train_set: Dataset) -> None:
        """Train on another dataset from the next iteration on
        (basic.py:415-422)."""
        inner = train_set.construct()
        obj = (create_objective(self.config, inner.metadata, inner.num_data,
                                self.device)
               if self.config.objective != "none" else None)
        self._gbdt.reset_training_data(inner, obj)
        self._train_dataset = train_set

    def rollback_one_iter(self) -> None:
        self._gbdt.rollback_one_iter()

    def reset_parameter(self, params: Dict[str, Any]) -> None:
        """Change ``RESETTABLE`` parameters mid-training (basic.py:427-437).
        Any other key raises: the tree learner's constraints and the
        growth mode are fixed when training starts (the JAX package
        accepts those keys and ignores them: ROADMAP C)."""
        params = key_alias_transform(dict(params))
        for key in params:
            if key not in RESETTABLE:
                raise ValueError(
                    f"reset_parameter: {key!r} cannot change during "
                    f"training; only {', '.join(RESETTABLE)} can")
        for key, value in params.items():
            setattr(self.config, key, type(getattr(self.config, key))(value))
        if "learning_rate" in params:
            self._gbdt.learning_rate = float(params["learning_rate"])
        self.params.update(params)

    # ------------------------------------------------------------------ eval
    def eval(self, data: Union[int, Dataset], name: str, feval=None):
        """Metrics of the training set (0 or its Dataset) or of a
        validation set added to this booster (1.. or its Dataset)."""
        if isinstance(data, int):
            data_idx = data
        elif data is self._train_dataset:
            data_idx = 0
        else:
            inner = data.construct()
            found = [i for i, vs in enumerate(self._gbdt.valid_sets)
                     if vs is inner]
            if not found:
                raise LightGBMError("data is neither this booster's training "
                                    "set nor one of its validation sets")
            data_idx = found[0] + 1
        return self._eval_at(data_idx, name, feval)

    def eval_train(self, feval=None):
        return self._eval_at(0, self.train_data_name, feval)

    def eval_valid(self, feval=None):
        out = []
        for i, name in enumerate(self.name_valid_sets):
            out.extend(self._eval_at(i + 1, name, feval))
        return out

    def _eval_at(self, data_idx: int, name: str, feval=None):
        """(data_name, eval_name, value, bigger_is_better) for each metric,
        then each of ``feval(scores, dataset)``'s results: one
        (eval_name, value, bigger_is_better) triple or a list of them,
        from the ``[K·n]`` class-major raw scores."""
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
        if feval is not None:
            ds = (self._train_dataset if data_idx == 0
                  else _DatasetView(gb.valid_sets[data_idx - 1]))
            ret = feval(gb.predict_at(data_idx).reshape(-1), ds)
            if ret is not None:
                for n_, v_, b_ in (ret if isinstance(ret, list) else [ret]):
                    out.append((name, n_, v_, b_))
        return out

    # --------------------------------------------------------------- predict
    def predict(self, data, num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False, data_has_header: bool = False,
                is_reshape: bool = True):
        """Raw-feature prediction of a matrix, a scipy sparse matrix or a
        text file (``data_has_header`` for its header line): ``[n]``, or
        ``[n, K]`` for multiclass (softmax probabilities; raw scores with
        ``raw_score``); with ``pred_leaf`` each row's leaf in each tree,
        ``[n, trees]`` int32.  ``num_iteration`` <= 0 means
        ``best_iteration`` when early stopping set one, else all.
        ``is_reshape`` is accepted for the JAX package's signature; the
        output is always shaped."""
        if self.best_iteration > 0 and num_iteration <= 0:
            num_iteration = self.best_iteration
        if isinstance(data, str):
            from .io.parser import parse_file

            # strict whatever the training config: a skipped row would
            # shift every later prediction onto the wrong input line
            raw, _ = parse_file(data, has_header=data_has_header,
                                strict=True)
            if raw.shape[1] > self._gbdt.max_feature_idx + 1:
                raw = np.delete(raw, self._gbdt.label_idx, axis=1)
            data = raw
        if hasattr(data, "tocsr"):
            # densify one row chunk at a time, so peak memory is a chunk,
            # not the matrix (basic.py:522-540)
            n_rows, n_cols = data.shape
            chunk_rows = max(1, SPARSE_PREDICT_CHUNK_VALUES // max(1, n_cols))
            if n_rows > chunk_rows:
                csr = data.tocsr()
                return np.concatenate([
                    self.predict(csr[i:i + chunk_rows].toarray(),
                                 num_iteration=num_iteration,
                                 raw_score=raw_score, pred_leaf=pred_leaf)
                    for i in range(0, n_rows, chunk_rows)], axis=0)
        X = _to_2d_float(data)
        if pred_leaf:
            return self._gbdt.predict_leaf_index(X, num_iteration)
        if raw_score:
            return self._gbdt.predict_raw_score(X, num_iteration)
        return self._gbdt.predict(X, num_iteration)

    # ------------------------------------------------------------ model text
    def _iterations(self, num_iteration: int) -> int:
        return self.best_iteration if num_iteration <= 0 else num_iteration

    def save_model(self, filename: str, num_iteration: int = -1) -> None:
        """The model text, written atomically with a ``.sha256`` sidecar
        (the JAX package's ``save_model_to_file``): a preemption mid-save
        never leaves a truncated model under the real name, and the
        serving hot-swap verifies the sidecar."""
        atomic_write(filename, self.model_to_string(num_iteration),
                     checksum=True)

    def model_to_string(self, num_iteration: int = -1) -> str:
        return self._gbdt.save_model_to_string(
            self._iterations(num_iteration))

    def dump_model(self, num_iteration: int = -1) -> Dict[str, Any]:
        """The model as a JSON-ready dict (gbdt.cpp:438-477)."""
        return self._gbdt.dump_model(self._iterations(num_iteration))

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        """Per original column: the splits on it ("split") or their summed
        gain ("gain")."""
        if importance_type not in ("split", "gain"):
            raise ValueError(f"importance_type must be 'split' or 'gain', "
                             f"not {importance_type!r}")
        return self._gbdt.feature_importance_array(importance_type)

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names)

    @property
    def current_iteration(self) -> int:
        return self._gbdt.current_iteration

    def num_trees(self) -> int:
        return self._gbdt.num_trees

    # ---------------------------------------------------------------- pickle
    def __getstate__(self):
        """The model text round trip (basic.py:581-611); the device by
        name, resolved again on load, so a model pickled on the card
        raises on a machine without one rather than moving to the CPU."""
        return {"params": self.params, "device": str(self.device),
                "best_iteration": self.best_iteration,
                "best_score": copy.deepcopy(self.best_score),
                "model_str": self._gbdt.save_model_to_string(-1),
                "attr": dict(self._attr),
                "train_data_name": self.train_data_name}

    def __setstate__(self, state):
        self.__init__(params=state["params"], model_str=state["model_str"],
                      device=state["device"])
        self.best_iteration = state["best_iteration"]
        self.best_score = state["best_score"]
        self._attr = dict(state["attr"])
        self.train_data_name = state["train_data_name"]

    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, memo):
        out = Booster.__new__(Booster)
        out.__setstate__(copy.deepcopy(self.__getstate__()))
        return out


class _DatasetView:
    """What a custom metric gets for a validation set: its label, weight,
    fields and size (basic.py:613-630)."""

    def __init__(self, inner: BinnedDataset):
        self._inner = inner

    def get_label(self):
        return self._inner.metadata.label

    def get_weight(self):
        return self._inner.metadata.weights

    def get_field(self, name):
        return self._inner.metadata.get_field(name)

    def num_data(self):
        return self._inner.num_data
