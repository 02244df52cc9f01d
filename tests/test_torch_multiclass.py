"""Multiclass: the port's softmax objective, its metrics, its ``[K, n]``
boosting loop and its model text against the JAX package's.

The JAX side trains with ``forest_batching="off"``: its batched forest
lanes fail under this JAX version (learners/forest.py:89), and the JAX
package pins them as bitwise equal to the sequential per-class loop used
here.  Trees are held as in tests/test_torch_slice.py (structure exact,
values to rtol 1e-5 / atol 1e-6); the gradients bit for bit; the
device-path metrics (multi_logloss, multi_error) to the JAX package's
``eval_jax`` at 1e-6 relative.
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
from lightgbm_tpu.objectives import _multiclass_grads

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import trees_from_numpy
from lightgbm_tpu_torch.metrics import create_metrics
from lightgbm_tpu_torch.objectives import create_objective

from test_torch_objectives import assert_same_trees, model_header

K = 3
PARAMS = {"objective": "multiclass", "num_class": K, "min_data_in_leaf": 20,
          "hist_impl": "matmul", "tree_growth": "leafwise",
          "forest_batching": "off", "num_leaves": 15,
          "metric": ["multi_logloss", "multi_error"], "verbose": -1}
ODD_LABELS = [-1.0, -5.0, 3.0, 7.0, 2.5, 0.5, -0.5]  # outside 0..K-1


def _data(n=600, seed=31):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    z = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.4 * rng.randn(n)
    y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float32)
    return X, y


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("num_class", [3, 5])
def test_multiclass_gradients_bitwise(weighted, num_class):
    """Softmax through exp_f32, the class sum in class order: the JAX
    package's _multiclass_grads bit for bit, with extreme and subnormal
    scores and labels outside the classes (matching no class)."""
    rng = np.random.RandomState(num_class)
    n = 20_000
    scale = np.array([0.1, 3.0, 30.0])[rng.randint(0, 3, (num_class, n))]
    s = (rng.randn(num_class, n) * scale).astype(np.float32)
    s[:, :50] = rng.choice([-100.0, 0.0, 100.0, 1e-30, -1e-30],
                           (num_class, 50))
    y = rng.randint(0, num_class, n).astype(np.float32)
    y[:len(ODD_LABELS)] = ODD_LABELS
    w = rng.rand(n).astype(np.float32) if weighted else None
    obj = create_objective(Config(objective="softmax", num_class=num_class),
                           JaxMetadata(label=y, weights=w), n)
    g, h = obj.get_gradients(torch.from_numpy(s))
    gj, hj = _multiclass_grads(jnp.asarray(s), jnp.asarray(y),
                               None if w is None else jnp.asarray(w))
    np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(h.numpy(), np.asarray(hj))


@pytest.mark.parametrize("name", ["multi_logloss", "multi_error"])
@pytest.mark.parametrize("weighted", [False, True])
def test_multiclass_metrics_match_jax_eval_at(name, weighted):
    """Including labels outside 0..K-1: JAX's gather counts a negative
    index from the end and clamps the rest, which ``class_index``
    reproduces."""
    rng = np.random.RandomState(4)
    n = 5000
    s = (rng.randn(K, n) * 2).astype(np.float32)
    s[:, 10:20] = 1.0  # ties across classes
    y = rng.randint(0, K, n).astype(np.float32)
    y[:len(ODD_LABELS)] = ODD_LABELS
    w = rng.rand(n).astype(np.float32) if weighted else None
    ref = jax_create_metrics(JaxConfig(metric=[name], num_class=K),
                             JaxMetadata(label=y, weights=w))[0]
    ours = create_metrics(Config(metric=[name], num_class=K),
                          JaxMetadata(label=y, weights=w))[0]
    want = float(ref.eval_jax_jit(jnp.asarray(s)))
    assert ours.eval_torch(torch.from_numpy(s)) == pytest.approx(want,
                                                                 rel=1e-6)


def _train_pair(extra, rounds=3):
    X, y = _data()
    Xv, yv = _data(300, seed=32)
    params = dict(PARAMS, **extra)
    dj = lgb.Dataset(X, label=y, max_bin=63)
    bj = jax_engine.train(dict(params), dj, num_boost_round=rounds,
                          valid_sets=[dj.create_valid(Xv, label=yv)],
                          valid_names=["va"], verbose_eval=False)
    dt = lt.Dataset(X, label=y, max_bin=63, device="cpu")
    bt = lt.train(dict(params), dt, num_boost_round=rounds,
                  valid_sets=[dt.create_valid(Xv, label=yv)],
                  valid_names=["va"], device="cpu")
    return X, Xv, bj, bt


@pytest.fixture(scope="module", params=["all-features", "feature-fraction"])
def multiclass_pair(request):
    """feature_fraction 0.7 and K > 1: an iteration draws K feature
    samples from the one feature RNG, in class order before any tree
    grows, as the JAX package draws them (gbdt.py:719-724); one sample an
    iteration, or one stream per class, would grow other trees from the
    second class on."""
    extra = {"all-features": {},
             "feature-fraction": {"feature_fraction": 0.7}}[request.param]
    return _train_pair(extra)


def test_multiclass_trees_match_jax(multiclass_pair):
    _, _, bj, bt = multiclass_pair
    assert bt.num_trees() == bj.num_trees() == 3 * K
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)


def test_multiclass_scores_and_eval_match_jax(multiclass_pair):
    _, _, bj, bt = multiclass_pair
    for i in (0, 1):
        scores = (bt._gbdt._scores if i == 0 else bt._gbdt._valid_scores[0])
        assert scores.shape[0] == K
        np.testing.assert_allclose(scores.numpy(), bj._gbdt.predict_at(i),
                                   atol=1e-5)
        ref, ours = bj._gbdt.eval_at(i), bt._gbdt.eval_at(i)
        assert list(ours) == list(ref) == ["multi_logloss", "multi_error"]
        for k in ref:
            assert ours[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-9)


def test_multiclass_predict_matches_jax(multiclass_pair):
    X, Xv, bj, bt = multiclass_pair
    for Z in (X, Xv):
        p = bt.predict(Z)
        assert p.shape == (len(Z), K)
        np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-6)
        np.testing.assert_allclose(p, bj.predict(Z), atol=1e-5)
        raw = bt.predict(Z, raw_score=True)
        assert raw.shape == (len(Z), K)
        np.testing.assert_allclose(raw, bj.predict(Z, raw_score=True),
                                   atol=1e-5)
        np.testing.assert_allclose(bt.predict(Z, num_iteration=1),
                                   bj.predict(Z, num_iteration=1), atol=1e-5)


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_multiclass_model_text_round_trip(multiclass_pair, direction):
    X, _, bj, bt = multiclass_pair
    src, make = ((bt, lambda t: lgb.Booster(model_str=t))
                 if direction == "port-to-jax" else
                 (bj, lambda t: lt.Booster(model_str=t, device="cpu")))
    text = src.model_to_string()
    assert "num_class=3" in text and "objective=multiclass" in text
    assert model_header(text) == model_header(
        (bj if src is bt else bt).model_to_string())
    dst = make(text)
    assert dst.num_trees() == 3 * K
    np.testing.assert_allclose(dst.predict(X), src.predict(X), atol=1e-5)
    np.testing.assert_allclose(dst.predict(X, raw_score=True),
                               src.predict(X, raw_score=True), atol=1e-5)
    one = src.model_to_string(num_iteration=1)
    assert one.count("Tree=") == K


def test_trees_from_numpy_multiclass(multiclass_pair):
    import jax

    X, _, bj, _ = multiclass_pair
    gb = bj._gbdt
    _, booster = trees_from_numpy(
        [jax.tree.map(np.asarray, t)._asdict() for t in gb.models],
        device="cpu", objective="multiclass", num_class=K,
        max_feature_idx=gb.max_feature_idx)
    np.testing.assert_allclose(booster.predict(X), bj.predict(X), atol=1e-5)


def test_multiclass_init_score():
    """A class-major [K * n] init_score seeds the [K, n] scores, as the
    JAX package reads it."""
    X, y = _data(300)
    init = np.random.RandomState(1).randn(K * len(y))
    dt = lt.Dataset(X, label=y, init_score=init, device="cpu")
    bt = lt.train(dict(PARAMS), dt, num_boost_round=1, device="cpu")
    dj = lgb.Dataset(X, label=y, init_score=init)
    bj = jax_engine.train(dict(PARAMS), dj, num_boost_round=1,
                          verbose_eval=False)
    np.testing.assert_allclose(bt._gbdt._scores.numpy(),
                               bj._gbdt.predict_at(0), atol=1e-5)
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)


@pytest.mark.cuda
def test_card_multiclass_gradients_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's multiclass phase "
                    "runs this check there)")
    rng = np.random.RandomState(6)
    n = 50_000
    s = (rng.randn(5, n) * 4).astype(np.float32)
    y = rng.randint(0, 5, n).astype(np.float32)
    w = rng.rand(n).astype(np.float32)
    out = []
    for dev in ("cuda", "cpu"):
        obj = create_objective(Config(objective="multiclass", num_class=5),
                               JaxMetadata(label=y, weights=w), n, dev)
        out.append([t.cpu() for t in obj.get_gradients(
            torch.from_numpy(s).to(dev))])
    for a, b in zip(*out):
        assert torch.equal(a, b)
