"""Training and cross-validation entry points (counterpart of
lightgbm_tpu/engine.py).

``train`` turns its keyword conveniences (``early_stopping_rounds``,
``evals_result``, ``verbose_eval``, ``learning_rates``) into callbacks
and runs the boosting loop with a custom objective (``fobj``) and metric
(``feval``), continuing an init model (``init_model``) if given.  A
validation set that is the training set is not added: its name becomes
the booster's ``train_data_name``, under which ``Booster.eval_train``
reports and on which early stopping never stops.  ``cv`` trains one
booster per fold (stratified or query by query where asked) and averages
their metrics: on the whole dataset's bins with the fold's rows as the
root row set where ``_cv_can_share_bins`` allows (bin once: no per-fold
binned copy or upload; folds that are all ``_forest_eligible`` grow as
one forest's lanes each round), else on the fold's row subset; the trees
are the same bitwise.  ``train_many`` trains several models on one
binned dataset, as one forest a round where it may.  Every entry point
runs on ``device`` (None -> CUDA; pass ``"cpu"`` for the plain PyTorch
path).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import callback
from .basic import Booster, Dataset
from .config import Config, key_alias_transform
from .models.gbdt import train_forest_round


def _sorted_callbacks(cbs: List[Callable]):
    """(before, after) lists, each sorted by ``order`` (0 for a user
    callback without one), registration order kept among equals."""
    before = [cb for cb in cbs if getattr(cb, "before_iteration", False)]
    after = [cb for cb in cbs if not getattr(cb, "before_iteration", False)]
    before.sort(key=lambda cb: getattr(cb, "order", 0))
    after.sort(key=lambda cb: getattr(cb, "order", 0))
    return before, after


def _common_params(params, train_set, fobj, init_model, feature_name,
                   categorical_feature):
    """The parameters ``train`` and ``cv`` share: aliases resolved, a
    custom objective as ``objective=none``, a model file as
    ``input_model``; names and categorical columns set on the data."""
    params = key_alias_transform(dict(params))
    if fobj is not None:
        params["objective"] = "none"
    if isinstance(init_model, str):
        params["input_model"] = init_model
    elif isinstance(init_model, Booster):
        params["input_model"] = ""
    if feature_name is not None:
        train_set.feature_name = feature_name
    if categorical_feature is not None:
        train_set.categorical_feature = list(categorical_feature)
    return params


def _continue_from(booster: Booster, init_model, path: str) -> None:
    """Put the init model (a Booster, or the model file ``path``) in front
    of ``booster``'s trees.  ``train`` and ``cv`` call it after adding
    their validation sets, so ``merge_from`` replays its trees into those
    sets one at a time, as training added them: 10 + 10 trees give the
    20-tree run's valid scores bitwise (ROADMAP C4).  A set added to a
    model that already holds trees is replayed in the JAX package's
    chunked order instead (``GBDT.add_valid_dataset``, C6)."""
    if not isinstance(init_model, Booster):
        if not path:
            return
        init_model = Booster(model_file=path, device=booster.device)
    booster._gbdt.merge_from(init_model._gbdt, prepend=True)


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None,
          feval: Optional[Callable] = None,
          init_model=None,
          feature_name: Optional[List[str]] = None,
          categorical_feature: Optional[List[int]] = None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[dict] = None,
          verbose_eval=True,
          learning_rates=None,
          callbacks: Optional[List[Callable]] = None,
          device=None) -> Booster:
    """Train a booster (engine.py:22-139).  ``init_model`` (a model file
    or a Booster) is continued: its trees come first and the iterations
    count on from them."""
    params = _common_params(params, train_set, fobj, init_model,
                            feature_name, categorical_feature)
    merged = dict(train_set.params or {})
    merged.update(params)
    # the dataset keeps the merged parameters (its binning reads them),
    # but not this call's init model, which a later call must not inherit
    init_path = merged.pop("input_model", "")
    train_set.params = dict(merged)
    booster = Booster(params=merged, train_set=train_set, device=device)

    valid_names = valid_names or []
    is_valid_contain_train = False
    for i, vs in enumerate(valid_sets or []):
        name = valid_names[i] if i < len(valid_names) else f"valid_{i}"
        if vs is train_set:  # lightgbm_tpu/engine.py:64-72
            is_valid_contain_train = True
            booster.set_train_data_name(name)
            continue
        if vs.reference is None:
            vs.reference = train_set
        booster.add_valid(vs, name)
    _continue_from(booster, init_model, init_path)
    init_iteration = booster._gbdt.num_init_iteration

    cbs = list(dict.fromkeys(callbacks or []))  # ordered dedupe
    if verbose_eval is True:
        cbs.append(callback.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval:
        cbs.append(callback.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.append(callback.early_stopping(early_stopping_rounds,
                                           verbose=bool(verbose_eval)))
    if learning_rates is not None:
        cbs.append(callback.reset_parameter(learning_rate=learning_rates))
    if evals_result is not None:
        cbs.append(callback.record_evaluation(evals_result))
    before, after = _sorted_callbacks(cbs)

    end = init_iteration + num_boost_round
    evaluation_result_list: list = []
    for i in range(init_iteration, end):
        for cb in before:
            cb(callback.CallbackEnv(model=booster, params=params, iteration=i,
                                    begin_iteration=init_iteration,
                                    end_iteration=end,
                                    evaluation_result_list=None))
        is_finished = booster.update(fobj=fobj)
        evaluation_result_list = []
        if is_valid_contain_train:
            evaluation_result_list.extend(booster.eval_train(feval))
        if booster.name_valid_sets:
            evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in after:
                cb(callback.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=init_iteration, end_iteration=end,
                    evaluation_result_list=evaluation_result_list))
        except callback.EarlyStopException as e:
            evaluation_result_list = e.best_score
            break
        if is_finished:
            break
    best = collections.defaultdict(collections.OrderedDict)
    for data_name, eval_name, score, *_ in evaluation_result_list:
        best[data_name][eval_name] = score
    booster.best_score = dict(best)
    # best_iteration never points past the surviving model (a callback
    # may have rolled trees back); then its score is no longer the model's
    if booster.best_iteration > booster.current_iteration:
        booster.best_iteration = booster.current_iteration
        booster.best_score = {}
    if booster.best_iteration <= 0:
        booster.best_iteration = -1
    return booster


def train_many(params_list: List[Dict[str, Any]], train_set: Dataset,
               num_boost_round: int = 100, device=None) -> List[Booster]:
    """Train N independent models on one binned dataset (engine.py:239-
    301): the data is binned once, from ``train_set`` with the first
    model's parameters merged in, and every round advances all models.
    Where every model is ``_forest_eligible``, a round grows all their
    trees as the lanes of one forest (``train_forest_round``); else each
    model takes its own sequential round.  Either way each model is the
    model ``train`` grows alone from its parameters, bitwise.  Models may
    differ in the constraints, learning rate, sampling, seeds and
    objective; ``num_leaves`` and ``max_bin`` must match (else
    ``ValueError``).  Returns the boosters in input order."""
    if not params_list:
        return []
    plist = [key_alias_transform(dict(p)) for p in params_list]
    merged = dict(train_set.params or {})
    merged.update(plist[0])
    # the one binning serves every model: a model asking for another
    # max_bin would silently get it, so it is refused with num_leaves
    bins = {Config.from_dict(dict(merged, **p)).max_bin for p in plist}
    train_set.params = merged
    train_set.construct()
    boosters = [Booster(params=p, train_set=train_set, device=device)
                for p in plist]
    gb = [b._gbdt for b in boosters]
    if len(bins) > 1 or len({g.max_leaves for g in gb}) > 1:
        raise ValueError(
            "train_many: num_leaves and max_bin must match across models; "
            "vary the learning rate, regularization, sampling and seeds "
            "per model instead")
    batched = all(g._forest_eligible() for g in gb)
    done = [False] * len(gb)
    for _ in range(num_boost_round):
        idx = [i for i, d in enumerate(done) if not d]
        if not idx:
            break
        if batched:
            stops = train_forest_round([gb[i] for i in idx])
        else:
            stops = [boosters[i].update() for i in idx]
        for i, stop in zip(idx, stops):
            done[i] = bool(stop)
    return boosters


class CVBooster:
    """The fold boosters of ``cv`` (engine.py:142-159); a method called
    on it is called on every fold's booster, returning their results."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]

        return handler_function


def _make_n_folds(full_data: Dataset, nfold: int, seed: int,
                  stratified: bool, shuffle: bool):
    """(train rows, test rows) of each fold (engine.py:162-201): whole
    queries for ranking data, class by class when ``stratified``."""
    inner = full_data.construct()
    num_data = inner.num_data
    qb = inner.metadata.query_boundaries
    rng = np.random.RandomState(seed)
    if qb is not None:
        qb = np.asarray(qb)
        nq = len(qb) - 1
        perm = rng.permutation(nq) if shuffle else np.arange(nq)
        tests = [np.concatenate([np.arange(qb[q], qb[q + 1])
                                 for q in perm[k::nfold]] or [[]])
                 .astype(np.int64) for k in range(nfold)]
    elif stratified:
        label = np.asarray(full_data.get_label())
        parts = [[] for _ in range(nfold)]
        for c in np.unique(label):
            idx = np.nonzero(label == c)[0]
            idx = rng.permutation(idx) if shuffle else idx
            for k in range(nfold):
                parts[k].append(idx[k::nfold])
        tests = [np.concatenate(p) for p in parts]
    else:
        perm = rng.permutation(num_data) if shuffle else np.arange(num_data)
        tests = [perm[k::nfold] for k in range(nfold)]
    folds = []
    for test in tests:
        mask = np.zeros(num_data, bool)
        mask[test] = True
        folds.append((np.nonzero(~mask)[0], np.nonzero(mask)[0]))
    return folds


def _cv_can_share_bins(params, inner, fpreproc, fobj) -> bool:
    """Whether ``cv`` may train every fold on the whole dataset's bins
    with the fold's rows as a base row mask (engine.py:204-236): nothing
    in training may read data-wide statistics.  Not with ``fpreproc`` or
    ``fobj`` (user code sees the dataset), query groups (per-query
    objectives), bagging (the draw is over all rows), ``is_unbalance``
    or ``scale_pos_weight`` (class weights from the whole label vector),
    or any boosting but gbdt."""
    if fpreproc is not None or fobj is not None:
        return False
    if inner.metadata.query_boundaries is not None:
        return False
    try:
        probe = Config.from_dict(dict(params))
    except Exception:  # noqa: BLE001 — an invalid config takes the subset
        return False
    return (probe.boosting_type == "gbdt"
            and (probe.bagging_fraction >= 1.0 or probe.bagging_freq <= 0)
            and not probe.is_unbalance
            and probe.scale_pos_weight == 1.0)


def _agg_cv_result(raw_results):
    """Mean and standard deviation over the folds (engine.py:306-319):
    ("cv_agg", "<data> <metric>", mean, bigger_is_better, std)."""
    cvmap = collections.OrderedDict()
    metric_type = {}
    for one_result in raw_results:
        for data_name, eval_name, value, bigger, *_ in one_result:
            key = f"{data_name} {eval_name}"
            metric_type[key] = bigger
            cvmap.setdefault(key, []).append(value)
    return [("cv_agg", k, float(np.mean(v)), metric_type[k],
             float(np.std(v))) for k, v in cvmap.items()]


def cv(params: Dict[str, Any], train_set: Dataset,
       num_boost_round: int = 10, nfold: int = 5, stratified: bool = False,
       shuffle: bool = True, metrics: Optional[List[str]] = None,
       fobj: Optional[Callable] = None, feval: Optional[Callable] = None,
       init_model=None, feature_name=None, categorical_feature=None,
       early_stopping_rounds: Optional[int] = None,
       fpreproc: Optional[Callable] = None, verbose_eval=None,
       show_stdv: bool = True, seed: int = 0,
       callbacks: Optional[List[Callable]] = None,
       device=None) -> Dict[str, List[float]]:
    """K-fold cross validation (engine.py:322-450): one booster per fold,
    trained on the fold's row subset and evaluated on its held-out rows;
    each continues ``init_model`` (a model file or a Booster) if given.
    ``fpreproc(train, test, params)`` may replace each fold's data and
    parameters.  Returns ``{"<data> <metric>-mean": [...], "...-stdv":
    [...]}``, cut at the best iteration when early stopping stops."""
    params = _common_params(params, train_set, fobj, init_model,
                            feature_name, categorical_feature)
    if metrics:
        params["metric"] = metrics
    cvfolds = CVBooster()
    inner = train_set.construct()
    share_bins = _cv_can_share_bins(params, inner, fpreproc, fobj)
    shared_all = True
    for train_idx, test_idx in _make_n_folds(train_set, nfold, seed,
                                             stratified, shuffle):
        te = train_set.subset(np.sort(test_idx))
        tparams = dict(params)
        bst = None
        if share_bins:
            # bin once: the fold trains on the whole dataset's bins with
            # its rows as the root row set, bitwise the subset run
            init_path = tparams.pop("input_model", "")
            cand = Booster(params=tparams, train_set=train_set,
                           device=device)
            mask = np.zeros(inner.num_data, np.float32)
            mask[train_idx] = 1.0
            try:
                cand._gbdt.set_base_row_mask(mask)
                bst = cand
            except ValueError:
                tparams = dict(params)
        if bst is None:
            shared_all = False
            tr = train_set.subset(np.sort(train_idx))
            if fpreproc is not None:
                tr, te, tparams = fpreproc(tr, te, tparams.copy())
            init_path = tparams.pop("input_model", "")
            tr.params.update(tparams)
            bst = Booster(params=tparams, train_set=tr, device=device)
        bst.add_valid(te, "valid")
        _continue_from(bst, init_model, init_path)
        cvfolds.append(bst)
    # bin-once folds that may grow as lanes: one forest a round advances
    # every fold (engine.py:398-407)
    batch_folds = (share_bins and shared_all and fobj is None and all(
        b._gbdt._forest_eligible() for b in cvfolds.boosters))

    cbs = list(dict.fromkeys(callbacks or []))  # ordered dedupe
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.append(callback.early_stopping(early_stopping_rounds,
                                           verbose=False))
    if verbose_eval is True:
        cbs.append(callback.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and verbose_eval:
        cbs.append(callback.print_evaluation(verbose_eval, show_stdv))
    before, after = _sorted_callbacks(cbs)

    results = collections.defaultdict(list)
    for i in range(num_boost_round):
        for cb in before:
            for bst in cvfolds.boosters:
                cb(callback.CallbackEnv(
                    model=bst, params=params, iteration=i, begin_iteration=0,
                    end_iteration=num_boost_round,
                    evaluation_result_list=None))
        fold_results = []
        if batch_folds:
            train_forest_round([b._gbdt for b in cvfolds.boosters])
        for bst in cvfolds.boosters:
            if not batch_folds:
                bst.update(fobj=fobj)
            fold_results.append(bst.eval_valid(feval))
        res = _agg_cv_result(fold_results)
        for _, key, mean, _, std in res:
            results[key + "-mean"].append(mean)
            results[key + "-stdv"].append(std)
        try:
            for cb in after:
                cb(callback.CallbackEnv(
                    model=cvfolds, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=res))
        except callback.EarlyStopException as e:
            cvfolds.best_iteration = e.best_iteration + 1
            for key in results:
                results[key] = results[key][:e.best_iteration + 1]
            break
    return dict(results)
