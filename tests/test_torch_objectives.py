"""Regression, the metrics and the training API's validation sets: the
port's ``train(..., device="cpu")`` against the JAX package's on the same
data.

Trees are held as in tests/test_torch_slice.py: the JAX side runs its
leaf-wise order route with the single-leaf Pallas histogram in interpret
mode (``hist_impl="matmul"``), the port its plain versions; every tree
must be structurally identical, leaf and internal values agree to rtol
1e-5 / atol 1e-6.  The device-path metrics (l1, l2) are held to the JAX
package's ``eval_jax`` (the path its ``GBDT.eval_at`` takes) at 1e-6
relative.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.engine as jax_engine
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.metadata import Metadata as JaxMetadata
from lightgbm_tpu.metrics import create_metrics as jax_create_metrics
from lightgbm_tpu.objectives import _l2_grads
from lightgbm_tpu.objectives import create_objective as jax_create_objective

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.metrics import create_metrics
from lightgbm_tpu_torch.objectives import create_objective

STRUCT = ("split_feature", "threshold_bin", "decision_type", "left_child",
          "right_child", "leaf_count", "leaf_parent", "leaf_depth")
PARAMS = {"min_data_in_leaf": 20, "hist_impl": "matmul",
          "tree_growth": "leafwise", "verbose": -1}


def assert_same_trees(jax_models, port_models):
    """Structurally identical trees; values to the slice test's rule."""
    assert len(jax_models) == len(port_models)
    for a, b in zip(jax_models, port_models):
        assert int(a.num_leaves) == b.num_leaves > 1
        for k in STRUCT + ("split_feature_real", "threshold_real"):
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=k)
        for k in ("leaf_value", "internal_value", "internal_count"):
            np.testing.assert_allclose(getattr(b, k).numpy(),
                                       np.asarray(getattr(a, k)),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def _regression_data(n=600, seed=21):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    y = (X[:, 0] - 0.7 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(n)) \
        .astype(np.float32)
    return X, y, rng.rand(n).astype(np.float32) + 0.5


@pytest.mark.parametrize("weighted", [False, True])
def test_regression_gradients_bitwise(weighted):
    rng = np.random.RandomState(0)
    s = (rng.randn(20_000) * 3).astype(np.float32)
    y = (rng.randn(20_000) * 2).astype(np.float32)
    w = rng.rand(20_000).astype(np.float32) if weighted else None
    obj = create_objective(Config(objective="mse"),
                           JaxMetadata(label=y, weights=w), y.size)
    assert obj.name == "regression"
    g, h = obj.get_gradients(torch.from_numpy(s))
    gj, hj = _l2_grads(jnp.asarray(s), jnp.asarray(y),
                       None if w is None else jnp.asarray(w))
    np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(h.numpy(), np.asarray(hj))


@pytest.mark.parametrize("name", ["regression", "regression_l2",
                                  "mean_squared_error", "mse", "l2", "binary",
                                  "multiclass", "softmax", "lambdarank"])
def test_objective_aliases_and_default_metrics(name):
    """Each objective name selects the JAX package's objective and its
    default metric (metrics.py:270-310)."""
    extra = {"num_class": 3} if name in ("multiclass", "softmax") else {}
    ref = jax_create_objective(JaxConfig(objective=name, **extra))
    ours = create_objective(Config(objective=name, **extra))
    assert type(ours).__name__ == type(ref).__name__
    assert ours.name == ref.name
    jax_names = [m.name for m in jax_create_metrics(
        JaxConfig(objective=ref.name, **extra))]
    port_names = [m.name for m in create_metrics(
        Config(objective=ref.name, **extra))]
    assert port_names == jax_names


@pytest.mark.parametrize("name", ["l2", "mse", "mean_squared_error",
                                  "regression", "l1", "mae",
                                  "mean_absolute_error"])
@pytest.mark.parametrize("weighted", [False, True])
def test_regression_metrics_match_jax_eval_at(name, weighted):
    rng = np.random.RandomState(2)
    s = (rng.randn(5000) * 2).astype(np.float32)
    y = (rng.randn(5000) + 0.3).astype(np.float32)
    w = rng.rand(5000).astype(np.float32) if weighted else None
    ref = jax_create_metrics(JaxConfig(metric=[name]),
                             JaxMetadata(label=y, weights=w))[0]
    ours = create_metrics(Config(metric=[name]),
                          JaxMetadata(label=y, weights=w))[0]
    assert ours.name == ref.name
    want = float(ref.eval_jax_jit(jnp.asarray(s)))
    assert ours.eval_torch(torch.from_numpy(s)) == pytest.approx(want,
                                                                 rel=1e-6)


@pytest.fixture(scope="module")
def regression_pair():
    X, y, w = _regression_data()
    Xv, yv, _ = _regression_data(300, seed=22)
    params = dict(PARAMS, objective="regression", num_leaves=15,
                  metric=["l2", "l1"], bagging_fraction=0.8, bagging_freq=1,
                  feature_fraction=0.8)
    dj = lgb.Dataset(X, label=y, weight=w, max_bin=63)
    bj = jax_engine.train(dict(params), dj, num_boost_round=4,
                          valid_sets=[dj.create_valid(Xv, label=yv)],
                          valid_names=["va"], verbose_eval=False)
    dt = lt.Dataset(X, label=y, weight=w, max_bin=63, device="cpu")
    bt = lt.train(dict(params), dt, num_boost_round=4,
                  valid_sets=[dt.create_valid(Xv, label=yv)],
                  valid_names=["va"], device="cpu")
    return X, Xv, bj, bt


def test_regression_trees_match_jax(regression_pair):
    _, _, bj, bt = regression_pair
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)


def test_regression_predict_and_eval_match_jax(regression_pair):
    X, Xv, bj, bt = regression_pair
    for Z in (X, Xv):
        np.testing.assert_allclose(bt.predict(Z), bj.predict(Z), atol=1e-5)
        np.testing.assert_allclose(bt.predict(Z, raw_score=True),
                                   bj.predict(Z, raw_score=True), atol=1e-5)
    for i in (0, 1):
        ref = bj._gbdt.eval_at(i)
        ours = bt._gbdt.eval_at(i)
        assert list(ours) == list(ref) == ["l2", "l1"]
        for k in ref:
            assert ours[k] == pytest.approx(ref[k], rel=1e-6)
    assert [t[:2] for t in bt.eval_valid()] == [("va", "l2"), ("va", "l1")]


def model_header(text):
    return text.split("Tree=0")[0]


def test_regression_model_text(regression_pair):
    """The port's model text has the JAX package's header and loads there;
    the JAX package's text loads in the port and predicts as the JAX
    package does."""
    X, _, bj, bt = regression_pair
    text = bj.model_to_string()
    assert "objective=regression" in text
    ours = bt.model_to_string()
    assert model_header(ours) == model_header(text)
    np.testing.assert_allclose(
        lgb.Booster(model_str=ours).predict(X), bt.predict(X), rtol=1e-6,
        atol=1e-6)
    loaded = lt.Booster(model_str=text, device="cpu")
    np.testing.assert_allclose(loaded.predict(X), bj.predict(X), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------ C2: valid_sets with train
@pytest.fixture(scope="module")
def train_in_valid_sets():
    rng = np.random.RandomState(8)
    X = rng.randn(500, 5)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    Xv = rng.randn(200, 5)
    yv = (Xv[:, 0] + Xv[:, 1] * Xv[:, 2] > 0).astype(np.float32)
    params = dict(PARAMS, objective="binary", num_leaves=7,
                  metric=["auc", "binary_logloss"])
    dj = lgb.Dataset(X, label=y)
    bj = jax_engine.train(dict(params), dj, num_boost_round=3,
                          valid_sets=[dj, dj.create_valid(Xv, label=yv)],
                          valid_names=["tr", "va"], verbose_eval=False)
    dt = lt.Dataset(X, label=y, device="cpu")
    bt = lt.train(dict(params), dt, num_boost_round=3,
                  valid_sets=[dt, dt.create_valid(Xv, label=yv)],
                  valid_names=["tr", "va"], device="cpu")
    return bj, bt


def test_valid_set_that_is_the_training_set_is_skipped(train_in_valid_sets):
    """lightgbm_tpu/engine.py:64-72: the training set is not added as a
    validation set (no second copy of its bins, no second walk of every
    tree); its name becomes the booster's training-data name."""
    bj, bt = train_in_valid_sets
    assert len(bt._gbdt._valid_bins) == len(bt._gbdt._valid_scores) == 1
    assert bt.name_valid_sets == bj.name_valid_sets == ["va"]
    assert bt.train_data_name == bj.train_data_name == "tr"
    assert bt.model_to_string() == bj.model_to_string()


@pytest.mark.parametrize("which", ["eval_train", "eval_valid"])
def test_eval_with_training_set_in_valid_sets(train_in_valid_sets, which):
    bj, bt = train_in_valid_sets
    ref, ours = getattr(bj, which)(), getattr(bt, which)()
    assert [r[:2] + r[3:] for r in ours] == [r[:2] + r[3:] for r in ref]
    assert ours[0][0] == ("tr" if which == "eval_train" else "va")
    for a, b in zip(ours, ref):
        assert a[2] == pytest.approx(b[2], rel=1e-6)


def test_set_train_data_name():
    X, y, _ = _regression_data(200)
    bt = lt.train(dict(PARAMS, objective="regression", num_leaves=4),
                  lt.Dataset(X, label=y, device="cpu"), 1, device="cpu")
    assert bt.eval_train()[0][:2] == ("training", "l2")
    assert bt.set_train_data_name("fit") is bt
    assert bt.eval_train()[0][:2] == ("fit", "l2")


# -------------------------------------------------------------- refusals
def test_unknown_objective_and_class_count_raise():
    X, y, _ = _regression_data(200)
    for params, err, match in (
            ({"objective": "poisson"}, ValueError, "Unknown objective"),
            ({"objective": "regression", "num_class": 3}, ValueError,
             "num_class"),
            ({"objective": "multiclass", "num_class": 1}, ValueError,
             "num_class"),
            ({"objective": "none"}, lt.LightGBMError, "fobj")):
        with pytest.raises(err, match=match):
            lt.train(dict(params, verbose=-1),
                     lt.Dataset(X, label=y, device="cpu"), 1, device="cpu")


@pytest.mark.cuda
def test_card_regression_gradients_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's regression phase "
                    "runs this check there)")
    rng = np.random.RandomState(3)
    s = (rng.randn(50_000) * 3).astype(np.float32)
    y = (rng.randn(50_000) * 2).astype(np.float32)
    w = rng.rand(50_000).astype(np.float32)
    out = []
    for dev in ("cuda", "cpu"):
        obj = create_objective(Config(objective="regression"),
                               JaxMetadata(label=y, weights=w), y.size, dev)
        out.append([t.cpu() for t in obj.get_gradients(
            torch.from_numpy(s).to(dev))])
    for a, b in zip(*out):
        assert torch.equal(a, b)
