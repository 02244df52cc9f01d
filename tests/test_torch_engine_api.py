"""The port's ``train`` surface against the JAX package's on the CPU:
early stopping, ``evals_result``, ``learning_rates``, user callbacks,
the printed evaluation, custom objectives and metrics.

The same seeded numpy data goes through ``lightgbm_tpu.engine.train``
(leaf-wise order route, the Pallas histogram in interpret mode:
``hist_impl="matmul"``; ``forest_batching="off"`` for multiclass) and
``lightgbm_tpu_torch.train(..., device="cpu")``.  Trees are held by
``test_torch_objectives.assert_same_trees`` (structure exact, values
rtol 1e-5 / atol 1e-6); evaluation histories and printed values to rtol
1e-5; ``best_iteration`` and callback sequences exactly.
"""

import re

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.engine as jax_engine

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.objectives import create_objective

from test_torch_objectives import assert_same_trees

BASE = {"min_data_in_leaf": 20, "hist_impl": "matmul",
        "tree_growth": "leafwise", "forest_batching": "off",
        "num_leaves": 15, "verbose": -1}
BINARY = dict(BASE, objective="binary", metric=["binary_logloss", "auc"])


def _binary(n=1500, seed=3):
    """Features, labels and an init score: from raw scores of 0 the
    binary (and softmax) gradients take two values and the hessians one,
    so splits of equal gain in exact arithmetic abound and float32 noise
    in each package's histogram order picks among them; a random init
    score makes every row's gradient its own."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    z = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] - 0.4 * X[:, 3] ** 2
    y = (z + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return X, y, (0.3 * rng.randn(n)).astype(np.float32)


def _regression(n=1000, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    y = (X[:, 0] - 0.7 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(n)) \
        .astype(np.float32)
    return X, y


def _dataset(pkg, X, y, init=None):
    if pkg is lt:
        return lt.Dataset(X, label=y, init_score=init, device="cpu")
    return lgb.Dataset(X, label=y, init_score=init)


def _pair(params, X, y, Xv=None, yv=None, init=None, init_v=None,
          with_train=False, **kw):
    """(jax booster, port booster, jax evals, port evals) of one train
    call on both packages; the valid set (and the training set, named
    "tr", when ``with_train``) in ``valid_sets``."""
    out = []
    for pkg, extra in ((jax_engine, {}), (lt, {"device": "cpu"})):
        ds = _dataset(pkg, X, y, init)
        sets, names = [], []
        if with_train:
            sets, names = [ds], ["tr"]
        if Xv is not None:
            sets.append(ds.create_valid(Xv, label=yv, init_score=init_v))
            names.append("va")
        evals = {}
        b = pkg.train(dict(params), ds, valid_sets=sets, valid_names=names,
                      evals_result=evals, verbose_eval=False, **kw, **extra)
        out.append((b, evals))
    (bj, ej), (bt, et) = out
    return bj, bt, ej, et


def assert_same_evals(ej, et):
    assert list(et) == list(ej)
    for name in ej:
        assert list(et[name]) == list(ej[name])
        for metric in ej[name]:
            np.testing.assert_allclose(et[name][metric], ej[name][metric],
                                       rtol=1e-5, err_msg=f"{name} {metric}")


# ------------------------------------------------------------ early stopping
@pytest.fixture(scope="module")
def early_pair():
    """At a learning rate of 0.3 the valid logloss turns up after ~10
    rounds and early stopping stops 3 rounds later.  (A rate of 1-3 stops
    sooner, but there float32 noise picks among a leaf's equal-gain
    thresholds over empty bins differently in the two packages' orders.)"""
    X, y, init = _binary()
    return _pair(BINARY, X[:1100], y[:1100], X[1100:], y[1100:],
                 init[:1100], init[1100:], with_train=True,
                 num_boost_round=40, early_stopping_rounds=3,
                 learning_rates=[0.3] * 40) + (X[1100:],)


def test_early_stopping_best_iteration(early_pair):
    bj, bt, ej, et, _ = early_pair
    assert bt.best_iteration == bj.best_iteration
    assert 0 < bt.best_iteration < bt.current_iteration < 40
    assert bt.current_iteration == bj.current_iteration
    # the best round by the callback's rule, from the history
    va = et["va"]
    best = [int(np.argmin(va["binary_logloss"])), int(np.argmax(va["auc"]))]
    assert bt.best_iteration - 1 in best


def test_early_stopping_evals_result(early_pair):
    bj, bt, ej, et, _ = early_pair
    assert list(et) == ["tr", "va"]
    assert len(et["va"]["auc"]) == bt.current_iteration
    assert_same_evals(ej, et)


def test_early_stopping_trees_and_predict_default(early_pair):
    bj, bt, _, _, Xv = early_pair
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    p = bt.predict(Xv, raw_score=True)
    assert np.array_equal(p, bt.predict(Xv, num_iteration=bt.best_iteration,
                                        raw_score=True))
    assert not np.array_equal(p, bt.predict(Xv, num_iteration=10 ** 6,
                                            raw_score=True))
    np.testing.assert_allclose(p, bj.predict(Xv, raw_score=True),
                               rtol=1e-5, atol=1e-6)
    assert bt.model_to_string().count("Tree=") == bt.best_iteration


def test_early_stopping_best_score(early_pair):
    """``best_score`` holds every set's metrics at the best iteration."""
    _, bt, _, et, _ = early_pair
    i = bt.best_iteration - 1
    assert bt.best_score == {name: {m: v[i] for m, v in et[name].items()}
                             for name in et}


def test_early_stopping_never_stops_on_the_training_set():
    """Only the training set in valid_sets: its metrics never stop."""
    X, y, _ = _binary(600)
    for pkg in (jax_engine, lt):
        kw = {"device": "cpu"} if pkg is lt else {}
        ds = _dataset(pkg, X, y)
        b = pkg.train(dict(BINARY), ds, 12, valid_sets=[ds],
                      valid_names=["fit"], early_stopping_rounds=1,
                      learning_rates=[0.1] * 6 + [1.5] * 6,
                      verbose_eval=False, **kw)
        assert b.current_iteration == 12
        assert b.best_iteration == -1


# ------------------------------------------------------------ learning rates
@pytest.mark.parametrize("kind", ["list", "callable"])
def test_learning_rates(kind):
    X, y = _regression()
    rates = ([0.05] * 4 + [0.3] * 4 if kind == "list"
             else (lambda i: 0.2 * 0.8 ** i))
    params = dict(BASE, objective="regression")
    bj, bt, ej, et = _pair(params, X, y, with_train=True, num_boost_round=8,
                           learning_rates=rates)
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    assert_same_evals(ej, et)
    assert bt._gbdt.learning_rate == pytest.approx(
        0.3 if kind == "list" else 0.2 * 0.8 ** 7)


def test_learning_rates_list_length_checked():
    X, y = _regression(200)
    with pytest.raises(ValueError, match="num_boost_round"):
        lt.train(dict(BASE, objective="regression"),
                 lt.Dataset(X, label=y, device="cpu"), 5,
                 learning_rates=[0.1] * 4, device="cpu")


# ----------------------------------------------------------------- callbacks
def _recording_callbacks(log):
    def before(env):
        log.append(("before", env.iteration, env.evaluation_result_list))

    before.before_iteration = True
    before.order = 5

    def plain(env):  # no order: 0, ahead of print (10) and record (20)
        log.append(("plain", env.iteration, len(env.evaluation_result_list)))

    def late(env):  # between record_evaluation (20) and early stopping (30)
        log.append(("late", env.iteration, env.model.current_iteration))

    late.order = 25
    return [late, before, plain, late]  # late twice: deduplicated


def test_callback_order_and_before_iteration():
    X, y, _ = _binary(800)
    logs = []
    for pkg in (jax_engine, lt):
        kw = {"device": "cpu"} if pkg is lt else {}
        ds = _dataset(pkg, X, y)
        log = []
        pkg.train(dict(BINARY), ds, 3, valid_sets=[ds],
                  callbacks=_recording_callbacks(log), verbose_eval=False,
                  **kw)
        logs.append(log)
    assert logs[1] == logs[0]
    assert logs[1][:3] == [("before", 0, None), ("plain", 0, 2),
                           ("late", 0, 1)]
    assert len(logs[1]) == 9


def test_record_evaluation_as_callback():
    X, y, _ = _binary(800)
    with pytest.raises(TypeError):
        lt.record_evaluation([])
    hist = {"stale": {}}
    rec = lt.record_evaluation(hist)
    assert hist == {}
    ds = lt.Dataset(X[:600], label=y[:600], device="cpu")
    b = lt.train(dict(BINARY), ds, 4,
                 valid_sets=[ds.create_valid(X[600:], label=y[600:])],
                 callbacks=[rec], verbose_eval=False, device="cpu")
    assert list(hist) == ["valid_0"]
    assert list(hist["valid_0"]) == ["binary_logloss", "auc"]
    got = [v for _, _, v, _ in b.eval_valid()]
    assert [hist["valid_0"][m][-1] for m in hist["valid_0"]] == got


_LINE = re.compile(r"(\w+)'s (\w+):([-+0-9.e]+)")


def _parse_printed(text):
    """Printed lines with every value taken out, and the values."""
    shapes, values = [], []
    for line in text.strip().splitlines():
        values += [float(v) for _, _, v in _LINE.findall(line)]
        shapes.append(_LINE.sub(lambda m: f"{m[1]}'s {m[2]}:#", line))
    return shapes, values


@pytest.mark.parametrize("verbose_eval", [True, 2])
def test_print_evaluation_lines(capsys, verbose_eval):
    X, y, init = _binary()
    printed = []
    for pkg in (jax_engine, lt):
        kw = {"device": "cpu"} if pkg is lt else {}
        ds = _dataset(pkg, X[:1100], y[:1100], init[:1100])
        capsys.readouterr()
        pkg.train(dict(BINARY), ds, 40,
                  valid_sets=[ds.create_valid(X[1100:], label=y[1100:],
                                              init_score=init[1100:])],
                  valid_names=["va"], early_stopping_rounds=3,
                  learning_rates=[0.3] * 40,
                  verbose_eval=verbose_eval, **kw)
        printed.append(_parse_printed(capsys.readouterr().out))
    (shape_j, val_j), (shape_t, val_t) = printed
    assert shape_t == shape_j
    # printing (order 10) runs before early stopping (30) announces itself
    first = 0 if verbose_eval == 2 else 1
    assert shape_t[first] == ("Training until validation scores don't "
                              "improve for 3 rounds.")
    assert shape_t[first + 1 if first == 0 else 0] == (
        f"[{verbose_eval if verbose_eval == 2 else 1}]\t"
        "va's binary_logloss:#\tva's auc:#")
    assert "Early stopping, best iteration is:" in shape_t
    np.testing.assert_allclose(val_t, val_j, rtol=1e-5)


# -------------------------------------------------------- custom objectives
def l2_obj(preds, dataset):
    grad = preds - dataset.get_label()
    return grad, np.ones_like(grad)


def rmse_feval(preds, dataset):
    return ("custom_rmse",
            float(np.sqrt(np.mean((preds - dataset.get_label()) ** 2))),
            False)


def test_fobj_feval_against_jax():
    """tests/test_engine_api.py's l2_obj / rmse_feval pair: both packages
    grow the same trees and report the same custom metric."""
    X, y = _regression()
    params = dict(BASE, metric="l2", min_sum_hessian_in_leaf=1.0)
    bj, bt, ej, et = _pair(params, X[:800], y[:800], X[800:], y[800:],
                           with_train=True, num_boost_round=10, fobj=l2_obj,
                           feval=rmse_feval)
    assert bt.params["objective"] == "none"
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    assert list(et["tr"]) == ["l2", "custom_rmse"]
    assert_same_evals(ej, et)
    np.testing.assert_allclose(et["va"]["custom_rmse"], et["va"]["l2"],
                               rtol=1e-5)
    np.testing.assert_allclose(bt.predict(X[800:]),
                               bj.predict(X[800:], raw_score=True),
                               rtol=1e-5, atol=1e-6)


def _softmax_obj(K):
    def fobj(preds, dataset):
        s = preds.reshape(K, -1).astype(np.float64)
        p = np.exp(s - s.max(0))
        p /= p.sum(0)
        onehot = np.arange(K)[:, None] == dataset.get_label()[None, :]
        grad = p - onehot
        hess = K / (K - 1.0) * p * (1.0 - p)
        return grad.reshape(-1), hess.reshape(-1)

    return fobj


def test_multiclass_fobj_class_major():
    rng = np.random.RandomState(31)
    X = rng.randn(900, 6)
    z = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.4 * rng.randn(900)
    y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float32)
    init = (0.3 * rng.randn(3, 900)).astype(np.float32)  # see _binary
    params = dict(BASE, num_class=3, metric=["multi_logloss"])
    bj, bt, ej, et = _pair(params, X[:700], y[:700], X[700:], y[700:],
                           init[:, :700].reshape(-1),
                           init[:, 700:].reshape(-1), num_boost_round=4,
                           fobj=_softmax_obj(3))
    assert bt.num_trees() == 12
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    assert_same_evals(ej, et)
    np.testing.assert_allclose(bt.predict(X[700:], raw_score=True),
                               bj.predict(X[700:], raw_score=True),
                               rtol=1e-5, atol=1e-6)


def test_fobj_with_builtin_gradients_is_bitwise():
    """An fobj returning the built-in binary objective's gradients grows
    the built-in run's trees bit for bit."""
    X, y, _ = _binary(1000)
    obj = create_objective(Config(objective="binary"),
                           lt.Dataset(X, label=y, device="cpu")
                           .construct().metadata, len(y), "cpu")

    def builtin(preds, dataset):
        g, h = obj.get_gradients(torch.from_numpy(preds))
        return g.numpy(), h.numpy()

    params = dict(BASE, objective="binary")
    runs = [lt.train(dict(params), lt.Dataset(X, label=y, device="cpu"), 6,
                     fobj=f, verbose_eval=False, device="cpu")
            for f in (None, builtin)]
    for a, b in zip(runs[0]._gbdt.models, runs[1]._gbdt.models):
        assert a.num_leaves == b.num_leaves > 1
        for k in ("split_feature", "threshold_bin", "threshold_real",
                  "left_child", "right_child", "leaf_value", "split_gain",
                  "internal_value", "internal_count", "leaf_count"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(runs[0]._gbdt._scores, runs[1]._gbdt._scores)


def test_objective_none_without_fobj_raises():
    X, y = _regression(200)
    ds = lt.Dataset(X, label=y, device="cpu")
    bst = lt.Booster({"objective": "none", "verbose": -1}, ds, device="cpu")
    with pytest.raises(lt.LightGBMError, match="fobj"):
        bst.update()
    with pytest.raises(lt.LightGBMError, match="fobj"):
        lt.train({"objective": "none", "verbose": -1}, ds, 1, device="cpu")


def test_fobj_length_checked():
    X, y = _regression(200)
    bst = lt.Booster({"objective": "none", "verbose": -1},
                     lt.Dataset(X, label=y, device="cpu"), device="cpu")
    with pytest.raises(lt.LightGBMError, match="don't match"):
        bst.update(fobj=lambda p, d: (p[:-1], p[:-1]))
    assert bst.current_iteration == 0
