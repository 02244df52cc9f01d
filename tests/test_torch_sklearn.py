"""The port's scikit-learn estimators against the JAX package's.

tests/test_sklearn_api.py's cases run through ``lightgbm_tpu.sklearn`` and
``lightgbm_tpu_torch.sklearn`` (``device="cpu"``) on the same seeded data:
binary, multiclass, string labels, a regressor with an ``eval_set`` early
stop, a ranker, a custom objective, ``clone``, pickling and importances.
Trees are held as the engine tests hold them
(test_torch_objectives.assert_same_trees: structure exact, values rtol
1e-5 / atol 1e-6), predictions to rtol 1e-5.  The binary and softmax data
carry a random init score, for the reason tests/test_torch_engine_api.py
gives.  The same estimators run with ``sklearn`` blocked in
``sys.modules``, as on the card's machine, which has no scikit-learn.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import lightgbm_tpu.sklearn as jsk

import lightgbm_tpu_torch.sklearn as tsk

from test_torch_objectives import assert_same_trees

JAX_EXTRA = {"hist_impl": "matmul", "forest_batching": "off"}
CPU = dict(device="cpu")


def _fit_both(cls_name, X, y, fit_kw=None, **kw):
    """Fit the JAX estimator (with its interpret-mode kernels,
    ``JAX_EXTRA``, as the engine tests run it) and the port's on the same
    data; their trees must agree."""
    fit_kw = fit_kw or {}
    j = getattr(jsk, cls_name)(**kw)
    inner = j._to_inner_params
    j._to_inner_params = lambda: dict(inner(), **JAX_EXTRA)
    j.fit(X, y, **fit_kw)
    t = getattr(tsk, cls_name)(**kw, **CPU)
    t.fit(X, y, **fit_kw)
    assert_same_trees(j.booster_._gbdt.models, t.booster_._gbdt.models)
    return j, t


def _binary(n=800, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    y = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.5 * rng.randn(n) > 0)
    return X, y.astype(int), (0.3 * rng.randn(n)).astype(np.float32)


def test_classifier_binary():
    X, y, init = _binary()
    j, t = _fit_both("LGBMClassifier", X, y, {"init_score": init},
                     n_estimators=6, num_leaves=15, min_child_samples=20)
    np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    np.testing.assert_array_equal(t.classes_, j.classes_)
    np.testing.assert_array_equal(t.feature_importances_,
                                  j.feature_importances_)
    np.testing.assert_allclose(t.feature_importance_, j.feature_importance_)
    np.testing.assert_array_equal(t.apply(X), j.apply(X))


def test_classifier_multiclass():
    rng = np.random.RandomState(1)
    X = rng.randn(900, 5)
    y = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5])
    init = (0.3 * rng.randn(900 * 3)).astype(np.float32)
    j, t = _fit_both("LGBMClassifier", X, y, {"init_score": init},
                     n_estimators=4, num_leaves=7)
    assert t.n_classes_ == 3
    p = t.predict_proba(X)
    np.testing.assert_allclose(p, j.predict_proba(X), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(p.sum(1), 1.0, rtol=1e-6)


def test_classifier_string_labels_and_eval_set():
    X, y, init = _binary(seed=2)
    labels = np.array(["neg", "pos"])[y]
    fit_kw = {"init_score": init[:600],
              "eval_set": [(X[600:], labels[600:])],
              "eval_init_score": [init[600:]],
              "eval_metric": "binary_logloss"}
    j, t = _fit_both("LGBMClassifier", X[:600], labels[:600], fit_kw,
                     n_estimators=5, num_leaves=7)
    assert set(t.predict(X[600:])) <= {"neg", "pos"}
    np.testing.assert_array_equal(t.predict(X[600:]), j.predict(X[600:]))
    np.testing.assert_allclose(
        t.evals_result_["valid_0"]["binary_logloss"],
        j.evals_result_["valid_0"]["binary_logloss"], rtol=1e-5)
    with pytest.raises(tsk.LightGBMError, match="unseen"):
        tsk.LGBMClassifier(**CPU).fit(X[:50], labels[:50],
                                      eval_set=[(X[:5], ["a"] * 5)])


def test_regressor_eval_set_early_stop():
    rng = np.random.RandomState(3)
    X = rng.randn(1000, 6)
    y = X[:, 0] - 0.7 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(1000)
    fit_kw = {"eval_set": [(X[700:], y[700:])],
              "early_stopping_rounds": 3, "eval_metric": "l2"}
    j, t = _fit_both("LGBMRegressor", X[:700], y[:700], fit_kw,
                     n_estimators=200, learning_rate=0.3, num_leaves=7)
    assert t.best_iteration == j.best_iteration
    assert 0 < t.best_iteration < 200
    np.testing.assert_allclose(t.predict(X[700:]), j.predict(X[700:]),
                               rtol=1e-5, atol=1e-6)


def test_ranker():
    rng = np.random.RandomState(4)
    X = rng.randn(1200, 5)
    rel = np.clip((X[:, 0] * 1.5 + 2).astype(int), 0, 4)
    group = np.full(40, 30)
    j, t = _fit_both("LGBMRanker", X, rel, {"group": group},
                     n_estimators=4, num_leaves=7)
    np.testing.assert_allclose(t.predict(X), j.predict(X), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(tsk.LightGBMError, match="group"):
        tsk.LGBMRanker(**CPU).fit(X, rel)


def test_custom_objective():
    X, y, _ = _binary(seed=5)

    def logloss(y_true, y_pred):
        p = 1.0 / (1.0 + np.exp(-y_pred))
        return p - y_true, p * (1.0 - p)

    j, t = _fit_both("LGBMRegressor", X, y.astype(float), None,
                     objective=logloss, n_estimators=4, num_leaves=7)
    np.testing.assert_allclose(t.predict(X), j.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_clone_get_set_params_and_pickle():
    base = pytest.importorskip("sklearn.base")
    X, y, _ = _binary(seed=6)
    est = tsk.LGBMClassifier(n_estimators=3, num_leaves=7, **CPU)
    params = est.get_params()
    assert params["device"] == "cpu" and params["num_leaves"] == 7
    assert set(params) == set(jsk.LGBMModel().get_params()) | {"device"}
    c = base.clone(est)
    assert c.get_params() == params and c is not est
    est.set_params(num_leaves=5).fit(X, y)
    assert est.booster_._gbdt.models[0].num_leaves <= 5
    again = pickle.loads(pickle.dumps(est))
    np.testing.assert_array_equal(again.predict_proba(X),
                                  est.predict_proba(X))


def test_estimators_without_sklearn():
    """The card's machine has no scikit-learn: the fallback base classes
    fit, predict and get/set their parameters."""
    code = textwrap.dedent("""
        import sys
        sys.modules["sklearn"] = None
        import numpy as np
        import lightgbm_tpu_torch as lt
        from lightgbm_tpu_torch import sklearn as tsk
        assert tsk._SKLBase is object
        rng = np.random.RandomState(0)
        X = rng.randn(400, 4)
        y = (X[:, 0] > 0).astype(int)
        est = lt.LGBMClassifier(n_estimators=3, num_leaves=7, device="cpu")
        assert est.get_params()["num_leaves"] == 7
        est.set_params(num_leaves=5).fit(X, y)
        bst = lt.train(est._to_inner_params(),
                       lt.Dataset(X, label=y.astype(float),
                                  params=est._to_inner_params(),
                                  device="cpu"), 3, device="cpu")
        assert est.booster_.model_to_string() == bst.model_to_string()
        p = est.predict_proba(X)
        assert np.array_equal(p[:, 1], bst.predict(X))
        assert list(est.predict(X)) == list((p[:, 1] > 0.5).astype(int))
        print("ok")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
