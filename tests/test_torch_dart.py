"""The port's DART against the JAX package's on the CPU.

The same seeded numpy data (with a random init score: from raw scores of
0 the binary and softmax gradients take two values, and float32 noise
then picks among equal-gain splits differently in the two packages'
histogram orders) trains ``boosting_type=dart`` in both packages, binary
and 3-class multiclass, over uniform and weighted drops,
``xgboost_dart_mode``, ``skip_drop`` 0 and 1, ``max_drop`` and an init
model.  Held:

* the drop sets of every iteration are equal (numpy RandomState draws);
* the trees' structure is equal exactly (split features, ``threshold_bin``,
  children, ...), leaf values and the train / valid scores within rtol
  1e-5, atol 1e-6: the float32 histogram sums are taken in another order
  on the CPU (``test_torch_objectives.assert_same_trees``'s rule);
* with the JAX package's trees, scores and drop generator carried into
  the port, DART's own updates (the subtraction of the dropped trees,
  the renormalisation of the train and valid scores and ``shrink``)
  match bitwise: tree growth is stubbed out in both packages;
* with an init model, drop indices index ``models`` from 0 and so reach
  the init model's trees, as the JAX package's do;
* a ``dart`` model text round-trips through both packages' loaders.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.models.dart import DART as JaxDART
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.convert import tree_from_numpy
from lightgbm_tpu_torch.models.dart import DART as PortDART
from lightgbm_tpu_torch.models.gbdt import GBDT as PortGBDT

from test_torch_objectives import assert_same_trees

N, NV, F = 1200, 400, 6
ROUNDS = 10
RTOL, ATOL = 1e-5, 1e-6
BASE = {"boosting_type": "dart", "num_leaves": 15, "min_data_in_leaf": 20,
        "learning_rate": 0.3, "hist_impl": "matmul",
        "forest_batching": "off", "verbose": -1}


def _data(num_class, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(N + NV, F)
    z = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] - 0.4 * X[:, 3] ** 2
    z = z + 0.5 * rng.randn(N + NV)
    if num_class == 1:
        y = (z > 0).astype(np.float32)
    else:
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float32)
    init = (0.3 * rng.randn(num_class * (N + NV))).astype(np.float32)
    init = init.reshape(num_class, N + NV)
    return X, y, init


def _params(num_class, **extra):
    p = dict(BASE, **extra)
    if num_class == 1:
        return dict(p, objective="binary")
    return dict(p, objective="multiclass", num_class=num_class)


def _recording(monkeypatch, cls):
    """Every ``_select_drops`` result of ``cls``, in order."""
    drops = []
    orig = cls._select_drops

    def rec(self):
        out = orig(self)
        drops.append(list(out))
        return out

    monkeypatch.setattr(cls, "_select_drops", rec)
    return drops


def _sets(pkg, X, y, init, K):
    kw = {"device": "cpu"} if pkg is lt else {}
    flat = (lambda a: a.reshape(-1)) if K > 1 else (lambda a: a[0])
    tr = pkg.Dataset(X[:N], label=y[:N], init_score=flat(init[:, :N]), **kw)
    va = tr.create_valid(X[N:], label=y[N:], init_score=flat(init[:, N:]))
    return tr, va


def _train_pair(monkeypatch, num_class, rounds=ROUNDS, init_model=None,
                **extra):
    """(JAX booster, port booster, JAX drop sets, port drop sets)."""
    X, y, init = _data(num_class)
    params = _params(num_class, **extra)
    jdrops = _recording(monkeypatch, JaxDART)
    pdrops = _recording(monkeypatch, PortDART)
    out = []
    for pkg, kw in ((lgb, {}), (lt, {"device": "cpu"})):
        tr, va = _sets(pkg, X, y, init, num_class)
        im = init_model if init_model is None or pkg is lgb else \
            lt.Booster(model_str=init_model.model_to_string(), device="cpu")
        out.append(pkg.train(dict(params), tr, rounds, valid_sets=[va],
                             valid_names=["va"], init_model=im,
                             verbose_eval=False, **kw))
    return out[0], out[1], jdrops, pdrops


CASES = {
    "binary-weighted": (1, {"skip_drop": 0.0}),
    "binary-uniform-xgb-maxdrop": (1, {"skip_drop": 0.0, "uniform_drop": True,
                                       "xgboost_dart_mode": True,
                                       "max_drop": 2, "drop_rate": 0.5}),
    "binary-default-skip": (1, {}),
    "binary-skip-all": (1, {"skip_drop": 1.0, "uniform_drop": True}),
    "multiclass-weighted": (3, {"skip_drop": 0.0, "drop_rate": 0.3}),
    "multiclass-uniform-xgb-maxdrop": (3, {"skip_drop": 0.0,
                                           "uniform_drop": True,
                                           "xgboost_dart_mode": True,
                                           "max_drop": 1}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dart_matches_jax(monkeypatch, case):
    K, extra = CASES[case]
    jb, pb, jdrops, pdrops = _train_pair(monkeypatch, K, **extra)
    assert pdrops == jdrops and len(pdrops) == ROUNDS
    dropped = sum(len(d) for d in pdrops)
    if extra.get("skip_drop") == 1.0:
        assert dropped == 0
    elif extra.get("skip_drop") == 0.0:
        assert dropped > 0
    jg, pg = jb._gbdt, pb._gbdt
    assert type(pg) is PortDART and pg.name == "dart"
    assert_same_trees(jg.models, pg.models)
    np.testing.assert_allclose(pg.predict_at(0), np.asarray(jg._scores),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pg.predict_at(1),
                               np.asarray(jg._valid_scores[0]),
                               rtol=RTOL, atol=ATOL)
    assert pg.tree_weight == pytest.approx(jg.tree_weight, rel=0, abs=0)
    assert pg.sum_weight == jg.sum_weight


def _carried(jg, X, y, init, K, params):
    """A port DART holding the JAX booster's trees, scores, drop generator
    and tree weights, on the same data."""
    tr, va = _sets(lt, X, y, init, K)
    pb = lt.Booster(dict(params), tr, device="cpu")
    pb.add_valid(va, "va")
    pg = pb._gbdt
    pg.models = [tree_from_numpy({k: np.asarray(v)
                                  for k, v in t._asdict().items()}, "cpu")
                 for t in jg.models]
    pg._models_changed()
    pg.iter_ = jg.iter_
    pg._scores = torch.from_numpy(np.array(jg._scores))
    pg._valid_scores = [torch.from_numpy(np.array(v))
                        for v in jg._valid_scores]
    pg._drop_rng.set_state(jg._drop_rng.get_state())
    pg.tree_weight = list(jg.tree_weight)
    pg.sum_weight = jg.sum_weight
    return pg


@pytest.mark.parametrize("K,extra", [
    (1, {"skip_drop": 0.0, "drop_rate": 0.5}),
    (1, {"skip_drop": 0.0, "uniform_drop": True, "xgboost_dart_mode": True,
         "drop_rate": 0.6}),
    (3, {"skip_drop": 0.0, "drop_rate": 0.5}),
], ids=["binary-weighted", "binary-uniform-xgb", "multiclass-weighted"])
def test_dart_updates_bitwise_on_jax_trees(monkeypatch, K, extra):
    """The drop, the renormalisation and ``shrink`` on identical trees
    and scores: bitwise the JAX package's, iteration after iteration
    (tree growth stubbed out in both packages)."""
    X, y, init = _data(K, seed=8)
    params = _params(K, **extra)
    jtr, jva = _sets(lgb, X, y, init, K)
    jb = lgb.train(dict(params), jtr, 6, valid_sets=[jva],
                   valid_names=["va"], verbose_eval=False)
    jg = jb._gbdt
    pg = _carried(jg, X, y, init, K, params)
    monkeypatch.setattr(JaxGBDT, "train_one_iter",
                        lambda self, grad=None, hess=None: False)
    monkeypatch.setattr(PortGBDT, "train_one_iter",
                        lambda self, grad=None, hess=None: False)
    jdrops = _recording(monkeypatch, JaxDART)
    pdrops = _recording(monkeypatch, PortDART)
    for _ in range(4):
        jg.train_one_iter()
        pg.train_one_iter()
        np.testing.assert_array_equal(pg._scores.numpy(),
                                      np.asarray(jg._scores))
        np.testing.assert_array_equal(pg._valid_scores[0].numpy(),
                                      np.asarray(jg._valid_scores[0]))
        for a, b in zip(jg.models, pg.models):
            np.testing.assert_array_equal(b.leaf_value.numpy(),
                                          np.asarray(a.leaf_value))
            np.testing.assert_array_equal(b.internal_value.numpy(),
                                          np.asarray(a.internal_value))
    assert pdrops == jdrops and sum(map(len, pdrops)) > 0
    assert pg.tree_weight == jg.tree_weight and pg.sum_weight == jg.sum_weight


def test_dart_drops_reach_the_init_model(monkeypatch):
    """Continued from a 3-iteration model: the drops index ``models`` from
    0, so the init model's trees are dropped and shrunk, in both packages
    alike (their leaf values bitwise after training)."""
    X, y, init = _data(1)
    tr, _ = _sets(lgb, X, y, init, 1)
    start = lgb.train(_params(1, boosting_type="gbdt"), tr, 3,
                      verbose_eval=False)
    jb, pb, jdrops, pdrops = _train_pair(
        monkeypatch, 1, rounds=6, init_model=start, skip_drop=0.0,
        uniform_drop=True, drop_rate=0.5)
    assert pdrops == jdrops
    assert any(i < 3 for d in pdrops for i in d)
    jg, pg = jb._gbdt, pb._gbdt
    assert pg.num_init_iteration == jg.num_init_iteration == 3
    assert len(pg.models) == len(jg.models) == 9
    shrunk = 0
    for j in range(3):
        a, b = jg.models[j], pg.models[j]
        np.testing.assert_array_equal(b.leaf_value.numpy(),
                                      np.asarray(a.leaf_value))
        shrunk += not np.array_equal(np.asarray(a.leaf_value),
                                     np.asarray(start._gbdt.models[j]
                                                .leaf_value))
    assert shrunk > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dart_model_text_round_trips(writer):
    X, y, init = _data(1)
    params = _params(1, skip_drop=0.0)
    if writer == "jax":
        tr, _ = _sets(lgb, X, y, init, 1)
        text = lgb.train(dict(params), tr, 4,
                         verbose_eval=False).model_to_string()
    else:
        tr, _ = _sets(lt, X, y, init, 1)
        text = lt.train(dict(params), tr, 4, verbose_eval=False,
                        device="cpu").model_to_string()
    assert text.startswith("dart\n")
    port = lt.Booster(model_str=text, device="cpu")
    assert type(port._gbdt) is PortDART
    assert port.model_to_string() == text
    jax_b = lgb.Booster(model_str=port.model_to_string())
    assert type(jax_b._gbdt) is JaxDART
    assert jax_b.model_to_string() == text
    np.testing.assert_array_equal(
        port.predict(X[N:], raw_score=True),
        np.asarray(jax_b.predict(X[N:], raw_score=True), np.float64))


def test_sklearn_dart_keys_reach_the_config():
    X, y, _ = _data(1)
    clf = lt.LGBMClassifier(boosting_type="dart", n_estimators=3,
                            drop_rate=0.4, max_drop=7, skip_drop=0.2,
                            uniform_drop=True, xgboost_dart_mode=True,
                            device="cpu").fit(X[:N], y[:N])
    gb = clf.booster_._gbdt
    assert type(gb) is PortDART
    cfg = gb.config
    assert (cfg.drop_rate, cfg.max_drop, cfg.skip_drop, cfg.uniform_drop,
            cfg.xgboost_dart_mode) == (0.4, 7, 0.2, True, True)


def test_dart_on_sparse_input_builds_no_dense_host_copy(monkeypatch):
    """DART walks the training and valid rows through ``bins_T``, which
    sparse storage fills from its entries: no ``dense_bins`` host copy of
    either set is made (the walk over an int32 copy of the rows is gone)."""
    import scipy.sparse as sp

    from lightgbm_tpu_torch.io.dataset import BinnedDataset

    X, y, _ = _data(1)
    X = np.where(np.abs(X) > 1.6, X, 0.0)  # density ~0.11: CSR storage
    tr = lt.Dataset(sp.csr_matrix(X[:N]), label=y[:N], device="cpu")
    va = tr.create_valid(sp.csr_matrix(X[N:]), label=y[N:])

    def refuse(self):
        raise AssertionError("a dense host copy of sparse bins")

    monkeypatch.setattr(BinnedDataset, "dense_bins", refuse)
    bst = lt.train(_params(1, skip_drop=0.0, drop_rate=0.5,
                           tree_growth="depthwise"), tr, 6,
                   valid_sets=[va], valid_names=["va"], verbose_eval=False,
                   device="cpu")
    gb = bst._gbdt
    assert gb.train_set.is_sparse and gb.valid_sets[0].is_sparse
    assert len(gb.models) == 6
    np.testing.assert_allclose(gb.predict_at(1)[0],
                               bst.predict(X[N:], raw_score=True),
                               rtol=1e-5, atol=1e-6)
