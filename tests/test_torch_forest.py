"""The port's forest (learners/forest.py, ops/forest.py, ``train_many``,
``task=train_many``, cv's bin-once folds) on the CPU.

* F1's and F3's plain versions (ops/forest.py) bitwise against the order
  route's ``histogram_single_leaf`` / ``search2_rows`` on each lane's rows:
  lanes above 2,048 rows, u16 bins, idle lanes, empty targets and lanes
  with their own feature masks and constraints.
* ``grow_forest`` lane by lane bitwise against ``grow_tree`` on the order
  route (``tobytes`` of every tree array and of the leaf map), with and
  without bagging, with lanes on their own root row sets.
* Multiclass lanes, ``train_many`` and cv's bin-once folds (lanes or not)
  bitwise against the class loop, ``train`` alone and the subset-trained
  folds; a 5,000-row fold with its held-out rows interleaved, where a
  row set with held-out rows in its 2,048-row blocks would move every
  block boundary after them.
* ``train_many`` and cv against the JAX package run with
  ``forest_batching="off"`` (its lanes do not import under this jax:
  ROADMAP queue C), trees by ``assert_same_trees`` and cv histories to
  rtol 1e-5, the API tests' rules.
* Every cv share gate falls back to subsets; ``task=train_many`` writes
  model i equal to ``task=train seed=i``; the knob is validated and the
  ``auto`` gate sits at 2,048 / 2,049 rows.

Kernels F1 and F3 run only on the card: tests/test_torch_forest_card.py
(marked ``cuda``) and chip_smoke.py phase 24 hold them bitwise against
these plain versions.
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.engine as jax_engine

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch import engine as port_engine
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.learners import forest
from lightgbm_tpu_torch.learners.forest import grow_forest
from lightgbm_tpu_torch.learners.serial import TreeLearnerParams, grow_tree
from lightgbm_tpu_torch.models.gbdt import train_forest_round
from lightgbm_tpu_torch.models.tree import TREE_FIELDS
from lightgbm_tpu_torch.ops.cuda_forest import forest_histogram, forest_search
from lightgbm_tpu_torch.ops.cuda_histogram import histogram_single_leaf
from lightgbm_tpu_torch.ops.cuda_search import pack_meta, search2_rows

from test_torch_objectives import assert_same_trees

CPU = {"device": "cpu"}
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "verbose": -1}


def _lanes(rng, B, n, F, nb, dt):
    bins = torch.from_numpy(rng.randint(0, nb, (F, n)).astype(dt))
    g = torch.from_numpy(rng.randn(B, n).astype(np.float32))
    h = torch.from_numpy(np.abs(rng.randn(B, n)).astype(np.float32))
    m = torch.from_numpy((rng.rand(B, n) < 0.8).astype(np.float32))
    return bins, g, h, m


@pytest.mark.parametrize("dt,nb", [(np.uint8, 40), (np.uint16, 300)])
def test_f1_plain_is_the_order_routes_histogram_per_lane(dt, nb):
    rng = np.random.RandomState(1)
    B, n, F = 6, 5000, 7
    bins, g, h, m = _lanes(rng, B, n, F, nb, dt)
    lid = torch.from_numpy(rng.randint(-1, 2, (B, n)).astype(np.int32))
    lid[0] = 0  # all 5,000 rows: three 2,048-row blocks
    # lane 1 idle, lane 2 an empty leaf
    target = torch.tensor([0, -1, 5, 1, 0, 1], dtype=torch.int32)
    got = forest_histogram(bins, g, h, m, lid, target, nb)
    assert got.shape == (B, F, nb, 3)
    for b in range(B):
        t = int(target[b])
        rows = torch.nonzero(lid[b] == t).flatten()
        if t < 0:
            want = torch.zeros(F, nb, 3)
        else:
            want = histogram_single_leaf(
                bins.view(torch.int16)[:, rows].view(torch.uint16)
                if dt == np.uint16 else bins[:, rows],
                g[b, rows], h[b, rows], m[b, rows], nb)
        assert got[b].numpy().tobytes() == want.numpy().tobytes(), b
    assert int(got[2].abs().sum()) == 0
    with pytest.raises(ValueError, match="max_rows"):
        forest_histogram(bins, g, h, m, lid, target, nb, max_rows=100)


def test_f3_plain_is_search2_rows_per_lane():
    rng = np.random.RandomState(2)
    A, F, nb, n = 5, 6, 16, 700
    bins, g, h, m = _lanes(rng, 2 * A, n, F, nb, np.uint8)
    lid = torch.zeros((2 * A, n), dtype=torch.int32)
    hists = forest_histogram(bins, g, h, m, lid,
                             torch.zeros(2 * A, dtype=torch.int32), nb)
    h_l, h_r = hists[:A].contiguous(), hists[A:].contiguous()
    is_cat = torch.zeros(F, dtype=torch.bool)
    is_cat[2] = True
    fm = torch.from_numpy(rng.rand(A, F) < 0.7)
    fm[3] = False  # no feature: no winner
    meta = torch.stack([pack_meta(fm[a], torch.full((F,), nb), is_cat,
                                  "cpu") for a in range(A)])
    tot = lambda x: x[:, 0].sum(1)  # noqa: E731
    scal = torch.cat([torch.tensor([[1.0], [1.0], [0.0], [1.0], [1.0]]),
                      tot(h_l), tot(h_r),
                      torch.tensor([[20.0, 1e-3, 0.0, 0.0, 0.0],
                                    [5.0, 1e-3, 0.5, 2.0, 0.0],
                                    [20.0, 1e-3, 0.0, 0.0, 0.0],
                                    [1.0, 0.0, 0.0, 1.0, 0.0],
                                    [50.0, 1.0, 1.0, 10.0, 0.5]])], 1)
    got = forest_search(h_l, h_r, meta, scal)
    assert got.shape == (A, 2, 16)
    for a in range(A):
        want = search2_rows(h_l[a], h_r[a], scal[a].tolist(), meta[a])
        assert got[a].numpy().tobytes() == want.numpy().tobytes(), a
    assert float(got[3, 0, 1]) == -1.0 and float(got[2, 0, 1]) == -1.0
    assert float(got[0, 0, 1]) >= 0


def _same_tree(a, b):
    assert a.num_leaves == b.num_leaves
    for k in TREE_FIELDS:
        if k != "num_leaves":
            assert getattr(a, k).numpy().tobytes() == \
                getattr(b, k).numpy().tobytes(), k


@pytest.mark.parametrize("bagging", [False, True])
def test_grow_forest_lanes_are_grow_tree_bitwise(bagging):
    rng = np.random.RandomState(3)
    B, n, F, nb, L = 5, 3000, 8, 32, 15
    bins, g, h, m = _lanes(rng, B, n, F, nb, np.uint8)
    if not bagging:
        m = torch.ones_like(m)
    fm = torch.from_numpy(rng.rand(B, F) < 0.8)
    nbpf = torch.full((F,), nb, dtype=torch.int32)
    cat = torch.zeros(F, dtype=torch.bool)
    cat[2] = True
    params = [TreeLearnerParams(20.0, 1e-3, 0.0, l2, 0.0, depth)
              for l2, depth in [(0.0, 0), (1.0, 3), (5.0, 0), (0.5, 2),
                                (0.0, 0)]]
    roots = [None, torch.from_numpy(np.sort(rng.choice(n, 2100, False))),
             None, torch.arange(0, n, 2), None]
    trees, lid = grow_forest(bins, g, h, m, fm, nbpf, cat, params, nb, L,
                             root_rows=roots)
    assert lid.shape == (B, n) and lid.dtype == torch.int32
    for b in range(B):
        tree, leaf = grow_tree(bins, g[b], h[b], m[b], fm[b], nbpf, cat,
                               params[b], nb, L, root_rows=roots[b])
        _same_tree(tree, trees[b])
        assert leaf.numpy().tobytes() == lid[b].numpy().tobytes(), b
    assert trees[1].num_leaves < L  # max_depth 3 under 15 leaves


def test_multiclass_lanes_are_the_class_loop_bitwise():
    rng = np.random.RandomState(4)
    X = rng.randn(1200, 6)
    y = np.digitize(X[:, 0] + X[:, 1] * X[:, 2], [-0.7, 0.7]) \
        .astype(np.float32)
    p = dict(BASE, objective="multiclass", num_class=3,
             feature_fraction=0.8)
    before = forest.DISPATCHES
    on = lt.train(dict(p, forest_batching="auto"),
                  lt.Dataset(X, label=y, **CPU), 5, **CPU)
    assert forest.DISPATCHES == before + 5
    off = lt.train(dict(p, forest_batching="off"),
                   lt.Dataset(X, label=y, **CPU), 5, **CPU)
    assert forest.DISPATCHES == before + 5
    assert on.model_to_string() == off.model_to_string()


def _models():
    return [dict(BASE, learning_rate=0.05, lambda_l2=0.0,
                 feature_fraction=0.7, feature_fraction_seed=2, seed=0),
            dict(BASE, learning_rate=0.2, lambda_l2=5.0,
                 feature_fraction=1.0, seed=1, min_data_in_leaf=40),
            dict(BASE, learning_rate=0.4, lambda_l1=0.5,
                 feature_fraction=0.6, feature_fraction_seed=9,
                 bagging_fraction=0.7, bagging_freq=1, seed=2)]


def _binary(n, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    z = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] - 0.4 * X[:, 3] ** 2
    y = (z + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return X, y, (0.3 * rng.randn(n)).astype(np.float32)


def test_train_many_is_train_alone_bitwise():
    X, y, init = _binary(1500)
    before = forest.DISPATCHES
    got = lt.train_many(_models(), lt.Dataset(X, label=y, init_score=init,
                                               **CPU), 4, **CPU)
    assert forest.DISPATCHES == before + 4  # one forest a round
    for p, bst in zip(_models(), got):
        alone = lt.train(p, lt.Dataset(X, label=y, init_score=init, **CPU),
                         4, **CPU)
        assert bst.model_to_string() == alone.model_to_string()
        assert bst.num_trees() == 4


def test_train_many_matches_jax_train_many_off():
    X, y, init = _binary(800)
    plist = _models()[:2]
    ref = jax_engine.train_many(
        [dict(p, forest_batching="off", hist_impl="matmul") for p in plist],
        lgb.Dataset(X, label=y, init_score=init), 3)
    got = lt.train_many(plist, lt.Dataset(X, label=y, init_score=init,
                                          **CPU), 3, **CPU)
    for a, b in zip(ref, got):
        assert_same_trees(a._gbdt.models, b._gbdt.models)


@pytest.mark.parametrize("key,value", [("num_leaves", 7), ("max_bin", 15)])
def test_train_many_refuses_other_shapes(key, value):
    X, y, _ = _binary(300)
    with pytest.raises(ValueError, match="num_leaves and max_bin"):
        lt.train_many([dict(BASE), dict(BASE, **{key: value})],
                      lt.Dataset(X, label=y, **CPU), 2, **CPU)


def test_train_forest_round_refuses_unshared_bins():
    X, y, _ = _binary(300)
    a = lt.Booster(dict(BASE), lt.Dataset(X, label=y, **CPU), **CPU)
    b = lt.Booster(dict(BASE), lt.Dataset(X, label=y, **CPU), **CPU)
    with pytest.raises(ValueError, match="share one binned"):
        train_forest_round([a._gbdt, b._gbdt])


def _cv_folds(params, ds, rounds=5, **kw):
    seen = {}
    hist = lt.cv(dict(params), ds, num_boost_round=rounds, nfold=3,
                 callbacks=[lambda env: seen.setdefault("f", env.model)],
                 **CPU, **kw)
    return hist, seen["f"].boosters


@pytest.mark.parametrize("knob", ["off", "on"])
def test_cv_bin_once_is_the_subset_run_bitwise(knob):
    """7,500 rows, 3 shuffled folds: each fold trains on 5,000 rows with
    its 2,500 held-out rows interleaved among them."""
    X, y, init = _binary(7500, seed=6)
    p = dict(BASE, metric=["binary_logloss", "auc"], forest_batching=knob)
    ds = lt.Dataset(X, label=y, init_score=init, **CPU)
    before = forest.DISPATCHES
    once, folds = _cv_folds(p, ds)
    assert forest.DISPATCHES == before + (5 if knob == "on" else 0)
    shared = ds.construct().bins_T("cpu")
    for b in folds:
        assert b._gbdt._bins_T is shared
        assert b._gbdt._root_rows.numel() == 5000
    sub, sub_folds = _cv_folds(p, ds,
                               fpreproc=lambda tr, te, q: (tr, te, q))
    assert all(b._gbdt._root_rows is None for b in sub_folds)
    assert [b.model_to_string() for b in folds] == \
        [b.model_to_string() for b in sub_folds]
    assert once == sub


def test_cv_lanes_match_jax_cv_off():
    X, y, init = _binary(1500, seed=7)
    p = dict(BASE, metric=["binary_logloss", "auc"])
    ref = jax_engine.cv(dict(p, forest_batching="off", hist_impl="matmul"),
                        lgb.Dataset(X, label=y, init_score=init),
                        num_boost_round=4, nfold=3, stratified=True)
    before = forest.DISPATCHES
    ours = lt.cv(dict(p), lt.Dataset(X, label=y, init_score=init, **CPU),
                 num_boost_round=4, nfold=3, stratified=True, **CPU)
    assert forest.DISPATCHES == before + 4  # the folds as lanes
    assert list(ours) == list(ref)
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5,
                                   atol=1e-9, err_msg=key)


def _logistic(preds, dataset):
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - dataset.get_label(), p * (1.0 - p)


@pytest.mark.parametrize("case", ["fobj", "group", "bagging", "is_unbalance",
                                  "scale_pos_weight", "dart", "depthwise"])
def test_cv_share_gates_fall_back_to_subsets(case):
    X, y, _ = _binary(600, seed=8)
    p, kw, group = dict(BASE), {}, None
    if case == "fobj":
        kw["fobj"] = _logistic
    elif case == "group":
        p["objective"] = "lambdarank"
        group = np.full(30, 20)
    elif case == "bagging":
        p.update(bagging_fraction=0.8, bagging_freq=1)
    elif case == "is_unbalance":
        p["is_unbalance"] = True
    elif case == "scale_pos_weight":
        p["scale_pos_weight"] = 2.0
    elif case == "dart":
        p["boosting_type"] = "dart"
    else:  # set_base_row_mask refuses level-wise growth
        p["tree_growth"] = "depthwise"
    ds = lt.Dataset(X, label=y, group=group, **CPU)
    if case != "depthwise":
        assert not port_engine._cv_can_share_bins(
            dict(p), ds.construct(), None, kw.get("fobj"))
    _, folds = _cv_folds(p, ds, rounds=1, **kw)
    for b in folds:
        assert b._gbdt._root_rows is None
        assert b._gbdt.num_data < 600


def test_cv_shares_bins_by_default():
    X, y, _ = _binary(600, seed=8)
    ds = lt.Dataset(X, label=y, **CPU)
    assert port_engine._cv_can_share_bins(dict(BASE), ds.construct(), None,
                                          None)
    _, folds = _cv_folds(BASE, ds, rounds=1)
    assert all(b._gbdt.num_data == 600 for b in folds)


def test_task_train_many_writes_train_models(tmp_path):
    X, y, _ = _binary(300, seed=9)
    data = tmp_path / "d.csv"
    np.savetxt(data, np.column_stack([y, X]), fmt="%.17g", delimiter=",")
    common = [f"data={data}", "objective=binary", "num_iterations=4",
              "num_leaves=7", "min_data_in_leaf=10", "feature_fraction=0.8",
              "verbose=-1"]
    out = tmp_path / "m.txt"
    assert tcli.main(["task=train_many", "num_models=3",
                      f"output_model={out}"] + common, device="cpu") == 0
    assert not os.path.exists(out)
    for i in range(3):
        one = tmp_path / f"alone{i}.txt"
        assert tcli.main(["task=train", f"seed={i}", f"output_model={one}"]
                         + common, device="cpu") == 0
        assert (tmp_path / f"m.txt.{i}").read_text() == one.read_text()
    assert tcli.main(["task=train_many", "num_models=0", f"data={data}"],
                     device="cpu") == 1


def test_forest_batching_knob_is_validated():
    with pytest.raises(ValueError, match="forest_batching"):
        Config.from_dict({"forest_batching": "sometimes"})
    for knob in ("auto", "on", "off"):
        assert Config.from_dict({"forest_batching": knob}).forest_batching \
            == knob


@pytest.mark.parametrize("n,knob,want", [
    (2048, "auto", True), (2049, "auto", False), (2049, "on", True),
    (100, "off", False)])
def test_auto_gate_sits_at_2048_rows(n, knob, want):
    X, y, _ = _binary(n, seed=10)
    bst = lt.Booster(dict(BASE, forest_batching=knob),
                     lt.Dataset(X, label=y, **CPU), **CPU)
    assert bst._gbdt._forest_eligible() is want


def test_auto_gate_reads_its_knob(monkeypatch):
    X, y, _ = _binary(300, seed=10)
    bst = lt.Booster(dict(BASE), lt.Dataset(X, label=y, **CPU), **CPU)
    monkeypatch.setenv("LGBM_TPU_FOREST_MAX_ROWS", "299")
    assert not bst._gbdt._forest_eligible()
    monkeypatch.setenv("LGBM_TPU_FOREST_MAX_ROWS", "300")
    assert bst._gbdt._forest_eligible()


@pytest.mark.parametrize("extra", [
    {"boosting_type": "dart"}, {"hist_dtype": "float64"},
    {"histogram_pool_size": 0.001}, {"tree_growth": "depthwise"},
    {"nonfinite_policy": "raise"}])
def test_sequential_configurations_are_not_eligible(extra):
    X, y, _ = _binary(300, seed=11)
    bst = lt.Booster(dict(BASE, forest_batching="on", **extra),
                     lt.Dataset(X, label=y, **CPU), **CPU)
    assert not bst._gbdt._forest_eligible()
