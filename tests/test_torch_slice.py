"""The whole slice: the port's ``train(..., device="cpu")`` against the JAX
package's ``engine.train`` on the same data.

The JAX side runs its leaf-wise learner on the order-based route with the
single-leaf Pallas histogram in interpret mode (``hist_impl="matmul"``,
the tests/test_pallas_histogram.py setup); the port runs the same route
with its plain PyTorch versions.  Every tree must be structurally
identical.  Leaf and internal values agree to rtol 1e-5 / atol 1e-6.
split_gain is held to rtol 1e-4: it is (gain of the split) minus (gain
of the parent), two large nearly equal numbers, so the f32 summation
order of the histograms shows in its 5th digit — the JAX package's own
two histogram routes (matmul vs segment) differ by 2.5e-5 on the first
case.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.engine as jax_engine
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.learners.serial import TreeLearnerParams as JaxParams
from lightgbm_tpu.learners.serial import grow_tree as jax_grow_tree
from lightgbm_tpu.metrics import AUCMetric as JaxAUC
from lightgbm_tpu.io.metadata import Metadata as JaxMetadata

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.learners.serial import TreeLearnerParams, grow_tree
from lightgbm_tpu_torch.metrics import auc

STRUCT = ("split_feature", "threshold_bin", "decision_type", "left_child",
          "right_child", "leaf_count", "leaf_parent", "leaf_depth")


def _case_small():
    rng = np.random.RandomState(12)
    X = rng.randn(3000, 6)
    y = (X[:, 0] - X[:, 1] * X[:, 2] > 0).astype(np.float32)
    return X, y, {"num_leaves": 15}, 32


def _case_wide():
    rng = np.random.RandomState(3)
    X = rng.randn(2000, 28)
    y = (X[:, 0] + X[:, 3] * X[:, 5] - 0.5 * X[:, 7] > 0).astype(np.float32)
    return X, y, {"num_leaves": 31, "bagging_fraction": 0.8,
                  "bagging_freq": 1, "feature_fraction": 0.8}, 63


def _train_both(X, y, extra, max_bin):
    params = {"objective": "binary", "min_data_in_leaf": 20,
              "hist_impl": "matmul", "tree_growth": "leafwise",
              "verbose": -1, **extra}
    bj = jax_engine.train(dict(params), lgb.Dataset(X, label=y,
                                                    max_bin=max_bin),
                          num_boost_round=3, verbose_eval=False)
    bt = lt.train(dict(params), lt.Dataset(X, label=y, max_bin=max_bin,
                                           device="cpu"),
                  num_boost_round=3, device="cpu")
    return bj, bt


@pytest.fixture(scope="module", params=["small", "wide"])
def trained(request):
    X, y, extra, mb = {"small": _case_small, "wide": _case_wide}[
        request.param]()
    return X, y, _train_both(X, y, extra, mb)


def test_trees_structurally_identical(trained):
    _, _, (bj, bt) = trained
    tj, tt = bj._gbdt.models, bt._gbdt.models
    assert len(tj) == len(tt) == 3
    for a, b in zip(tj, tt):
        assert int(a.num_leaves) == b.num_leaves
        for k in STRUCT:
            np.testing.assert_array_equal(
                getattr(b, k).numpy(), np.asarray(getattr(a, k)), err_msg=k)
        np.testing.assert_array_equal(b.split_feature_real.numpy(),
                                      np.asarray(a.split_feature_real))
        np.testing.assert_array_equal(b.threshold_real.numpy(),
                                      np.asarray(a.threshold_real))


def test_tree_values(trained):
    _, _, (bj, bt) = trained
    for a, b in zip(bj._gbdt.models, bt._gbdt.models):
        for k in ("leaf_value", "internal_value", "internal_count"):
            np.testing.assert_allclose(getattr(b, k).numpy(),
                                       np.asarray(getattr(a, k)),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(b.split_gain.numpy(),
                                   np.asarray(a.split_gain), rtol=1e-4,
                                   atol=1e-6)


def test_predict_and_auc(trained):
    X, y, (bj, bt) = trained
    pj, pt = bj.predict(X), bt.predict(X)
    np.testing.assert_allclose(pt, pj, atol=1e-5)
    raw_j = bj.predict(X, raw_score=True)
    a_port, a_jax = auc(bt.predict(X, raw_score=True), y), auc(raw_j, y)
    assert abs(a_port - a_jax) <= 1e-6
    # the port's AUC is the JAX package's metric
    m = JaxAUC()
    m.init(JaxMetadata(label=y), len(y))
    assert auc(raw_j, y) == pytest.approx(m.eval(raw_j), abs=1e-12)


def test_grow_tree_leaf_ids_match():
    """One tree from the same grad/hess: identical row -> leaf map."""
    rng = np.random.RandomState(4)
    n, F, B, L = 3000, 7, 24, 31
    bins = rng.randint(0, B, size=(F, n)).astype(np.uint8)
    grad = rng.randn(n).astype(np.float32)
    hess = (np.abs(rng.randn(n)) + 0.1).astype(np.float32)
    bag = (rng.rand(n) < 0.9).astype(np.float32)
    fmask = np.ones(F, bool)
    fmask[2] = False
    nbpf = np.full(F, B, np.int32)
    iscat = np.zeros(F, bool)
    iscat[4] = True
    cfg = dict(min_data_in_leaf=10, min_sum_hessian_in_leaf=1e-3,
               lambda_l2=0.5)
    tj, lid_j = jax_grow_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(bag), jnp.asarray(fmask), jnp.asarray(nbpf),
        jnp.asarray(iscat), JaxParams.from_config(JaxConfig(**cfg)),
        num_bins=B, max_leaves=L)
    tt, lid_t = grow_tree(
        torch.from_numpy(bins), torch.from_numpy(grad),
        torch.from_numpy(hess), torch.from_numpy(bag),
        torch.from_numpy(fmask), torch.from_numpy(nbpf),
        torch.from_numpy(iscat), TreeLearnerParams.from_config(Config(**cfg)),
        num_bins=B, max_leaves=L)
    assert tt.num_leaves == int(tj.num_leaves) > 2
    np.testing.assert_array_equal(lid_t.numpy(), np.asarray(lid_j))
    for k in STRUCT:
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(tj, k)), err_msg=k)
    np.testing.assert_allclose(tt.leaf_value.numpy(),
                               np.asarray(tj.leaf_value), rtol=1e-5,
                               atol=1e-6)


def test_binary_gradients_bitwise():
    """The port's binary gradients are the JAX package's, bit for bit
    (objectives.exp_f32 is XLA's float32 exp)."""
    from lightgbm_tpu.objectives import _binary_grads
    from lightgbm_tpu_torch.objectives import exp_f32

    rng = np.random.RandomState(0)
    s = np.concatenate([rng.randn(50_000) * 3,
                        rng.rand(20_000) * 170 - 85]).astype(np.float32)
    np.testing.assert_array_equal(exp_f32(torch.from_numpy(s)).numpy(),
                                  np.asarray(jnp.exp(jnp.asarray(s))))
    y = (rng.rand(s.size) > 0.5).astype(np.float32)
    cfg = Config(objective="binary", scale_pos_weight=1.5)
    obj = lt.objectives.create_objective(cfg, JaxMetadata(label=y), y.size)
    g, h = obj.get_gradients(torch.from_numpy(s))
    gj, hj = _binary_grads(jnp.asarray(s), jnp.asarray(y), None,
                           jnp.float32(1.0), jnp.float32(1.0),
                           jnp.float32(1.5))
    np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(h.numpy(), np.asarray(hj))


@pytest.mark.parametrize("name", ["auc", "binary_logloss", "binary_error"])
def test_metrics_match_jax(name):
    from lightgbm_tpu.metrics import create_metrics as jax_create_metrics
    from lightgbm_tpu_torch import metrics

    rng = np.random.RandomState(2)
    s = rng.randn(5000) * 2
    s[::50] = 0.0  # tied scores
    y = (rng.rand(5000) < 1 / (1 + np.exp(-s))).astype(np.float32)
    w = rng.rand(5000).astype(np.float32)
    for weights in (None, w):
        ref = jax_create_metrics(JaxConfig(metric=[name]),
                                 JaxMetadata(label=y, weights=weights))[0]
        ours = getattr(metrics, name)(s, y, weights=weights)
        assert ours == pytest.approx(ref.eval(s), rel=1e-12, abs=1e-15)
