"""The port's ``Dataset.subset`` and ``cv`` against the JAX package's on
the CPU.

The JAX side runs ``cv`` with ``forest_batching="off"`` and
``hist_impl="matmul"``: its bin-once path (one shared binned matrix, a
row mask per fold) is by its own contract bitwise its subset path, and
so is the port's (tests/test_torch_forest.py holds the two bitwise).
Fold indices
must equal the JAX package's exactly, the means and standard deviations
to rtol 1e-5, the truncated histories of early stopping in length.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu.engine as jax_engine

import lightgbm_tpu_torch as lt
import lightgbm_tpu_torch.engine as port_engine

PARAMS = {"objective": "binary", "min_data_in_leaf": 20,
          "hist_impl": "matmul", "tree_growth": "leafwise",
          "forest_batching": "off", "num_leaves": 15, "verbose": -1}


def _data(n=900, seed=11):
    """Binary rows, a random init score (see
    test_torch_engine_api._binary) and weights."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    z = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] - 0.3 * X[:, 3]
    y = (z + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return (X, y, (0.3 * rng.randn(n)).astype(np.float32),
            rng.rand(n).astype(np.float32) + 0.5)


# ------------------------------------------------------------------ subset
@pytest.mark.parametrize("fields", ["label", "all"])
def test_dataset_subset(fields):
    X, y, init, w = _data()
    kw = ({} if fields == "label"
          else {"init_score": init, "weight": w, "group": [30] * 30})
    full = lt.Dataset(X, label=y, device="cpu", **kw)
    idx = np.sort(np.random.RandomState(0).choice(900, 400, replace=False))
    sub = full.subset(idx)
    inner, part = full.construct(), sub.construct()
    assert sub.reference is full and sub.device == full.device
    assert part.bin_mappers is inner.bin_mappers
    assert np.array_equal(part.X_bin, inner.X_bin[idx])
    assert sub.num_data() == 400 and sub.num_feature() == 6
    np.testing.assert_array_equal(sub.get_label(), y[idx])
    if fields == "all":
        np.testing.assert_array_equal(sub.get_weight(), w[idx])
        np.testing.assert_array_equal(sub.get_init_score(), init[idx])
        assert sub.get_group().sum() == 400
        assert np.array_equal(sub.get_group(),
                              np.bincount(idx // 30, minlength=30)[
                                  np.bincount(idx // 30, minlength=30) > 0])
    jax_part = lgb.Dataset(X, label=y, **kw).subset(idx).construct()
    assert np.array_equal(part.X_bin, jax_part.X_bin)


# ------------------------------------------------------------------- folds
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("kind", ["plain", "stratified", "query"])
def test_make_n_folds_matches_jax(kind, shuffle):
    X, y, _, _ = _data()
    y3 = (y + (X[:, 4] > 1)).astype(np.float32)  # three uneven classes
    group = [30] * 30 if kind == "query" else None
    full_t = lt.Dataset(X, label=y3, group=group, device="cpu")
    full_j = lgb.Dataset(X, label=y3, group=group)
    ours = port_engine._make_n_folds(full_t, 4, 7, kind == "stratified",
                                     shuffle)
    ref = jax_engine._make_n_folds(full_j, 4, {}, 7, kind == "stratified",
                                   shuffle)
    assert len(ours) == 4
    for (a, b), (c, d) in zip(ours, ref):
        assert np.array_equal(a, c) and np.array_equal(b, d)
        assert np.array_equal(np.sort(np.concatenate([a, b])),
                              np.arange(900))


# ---------------------------------------------------------------------- cv
def _fpreproc(train, test, params):
    params["learning_rate"] = 0.2
    return train, test, params


CASES = {
    "plain": {},
    "stratified": {"stratified": True},
    "no-shuffle": {"shuffle": False, "seed": 3},
    "metrics": {"metrics": ["auc", "binary_error"], "stratified": True},
    "fpreproc": {"fpreproc": _fpreproc},
    "early-stopping": {"num_boost_round": 30, "early_stopping_rounds": 2,
                       "params": {"learning_rate": 0.6}},
    "regression": {"params": {"objective": "regression"}, "nfold": 4},
}


@pytest.mark.parametrize("case", list(CASES))
def test_cv_matches_jax(case):
    X, y, init, _ = _data()
    kw = dict(CASES[case])
    params = dict(PARAMS, **kw.pop("params", {}))
    kw.setdefault("num_boost_round", 5)
    kw.setdefault("nfold", 3)
    if params["objective"] == "regression":
        y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]).astype(np.float32)
    ref = jax_engine.cv(dict(params), lgb.Dataset(X, label=y,
                                                  init_score=init), **kw)
    ours = lt.cv(dict(params), lt.Dataset(X, label=y, init_score=init,
                                          device="cpu"), device="cpu", **kw)
    assert list(ours) == list(ref)
    for key in ref:
        assert len(ours[key]) == len(ref[key]), key
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5,
                                   atol=1e-9, err_msg=key)
    n = len(ours[next(iter(ours))])
    if case == "early-stopping":
        assert n < 30
    else:
        assert n == kw["num_boost_round"]
    if case == "metrics":
        assert list(ours) == ["valid auc-mean", "valid auc-stdv",
                              "valid binary_error-mean",
                              "valid binary_error-stdv"]


def test_cv_means_are_the_fold_boosters_means():
    """The history's last means are the mean over the fold boosters' own
    eval_valid, and a callback sees the fold boosters."""
    X, y, init, _ = _data()
    seen = {}

    def grab(env):
        seen["folds"] = env.model

    out = lt.cv(dict(PARAMS, metric=["binary_logloss", "auc"]),
                lt.Dataset(X, label=y, init_score=init, device="cpu"),
                num_boost_round=4, nfold=3, stratified=True,
                callbacks=[grab], device="cpu")
    folds = seen["folds"]
    assert isinstance(folds, lt.CVBooster) and len(folds.boosters) == 3
    evals = folds.eval_valid()
    for j, name in enumerate(("binary_logloss", "auc")):
        vals = [e[j][2] for e in evals]
        assert out[f"valid {name}-mean"][-1] == float(np.mean(vals))
        assert out[f"valid {name}-stdv"][-1] == float(np.std(vals))
    assert [b.current_iteration for b in folds.boosters] == [4, 4, 4]


def test_cv_with_fobj_and_init_model(tmp_path):
    X, y, init, _ = _data(600)
    path = str(tmp_path / "m.txt")
    lt.train(dict(PARAMS), lt.Dataset(X, label=y, device="cpu"), 3,
             verbose_eval=False, device="cpu").save_model(path)

    def logistic(preds, dataset):
        p = 1.0 / (1.0 + np.exp(-preds))
        return p - dataset.get_label(), p * (1.0 - p)

    seen = {}
    out = lt.cv(dict(PARAMS, metric="binary_logloss"),
                lt.Dataset(X, label=y, device="cpu"), num_boost_round=2,
                nfold=3, fobj=logistic, init_model=path,
                callbacks=[lambda env: seen.setdefault("f", env.model)],
                device="cpu")
    assert len(out["valid binary_logloss-mean"]) == 2
    assert [b.num_trees() for b in seen["f"].boosters] == [5, 5, 5]
    assert all(b.params["objective"] == "none" for b in seen["f"].boosters)


def test_train_many_raises_naming_a7():
    """``train_many`` raised naming A7 until the forest was ported: it now
    trains, each model the model ``train`` grows alone, and what it
    cannot batch (``num_leaves`` that differ) raises ``ValueError``."""
    X, y, _, _ = _data(200)
    p = dict(PARAMS, forest_batching="on")
    got = lt.train_many([p, dict(p, lambda_l2=2.0)],
                        lt.Dataset(X, label=y, device="cpu"), 3,
                        device="cpu")
    for q, bst in zip([p, dict(p, lambda_l2=2.0)], got):
        alone = lt.train(q, lt.Dataset(X, label=y, device="cpu"), 3,
                         device="cpu")
        assert bst.model_to_string() == alone.model_to_string()
    with pytest.raises(ValueError, match="num_leaves"):
        lt.train_many([p, dict(p, num_leaves=7)],
                      lt.Dataset(X, label=y, device="cpu"), device="cpu")
