"""The port's ``Booster`` surface on the CPU: rollback, exact snapshots,
continued training, the JSON dump, importances, leaf prediction,
parameter resets, attributes and pickling; and ``Dataset``'s accessors.

Continued training is held to the port's own uninterrupted run, bitwise:
the JAX package's continued training rebinds thresholds one bin off
where float32 rounded a bound up (ROADMAP C4), so its continued trees
are not a reference.  Rebinding a model's own trees must give back every
node's ``threshold_bin``.  Against the JAX package (same seeded data,
``hist_impl="matmul"``): the dump's structure exactly and its floats to
rtol 1e-5, split importance and leaf indices exactly, gain importance to
rtol 1e-4 (the ``split_gain`` rule, which the dump's gains follow too).
"""

import copy
import json
import pickle

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.engine as jax_engine

import lightgbm_tpu_torch as lt

from test_torch_objectives import assert_same_trees

PARAMS = {"objective": "binary", "min_data_in_leaf": 20,
          "hist_impl": "matmul", "tree_growth": "leafwise",
          "num_leaves": 15, "metric": ["binary_logloss"], "verbose": -1}
TREE_KEYS = ("split_feature", "split_feature_real", "threshold_bin",
             "threshold_real", "decision_type", "left_child", "right_child",
             "split_gain", "internal_value", "internal_count", "leaf_value",
             "leaf_count", "leaf_parent")


def _data(n=2000, seed=7):
    """2,000 rows x 8 features, binary, with a random init score (see
    test_torch_engine_api._binary) and one categorical column."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[:, 7] = rng.randint(0, 6, n)
    z = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.5 * (X[:, 7] % 3 == 1)
    y = (z + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return X, y, (0.3 * rng.randn(n)).astype(np.float32)


def _ds(X, y, init=None, **kw):
    return lt.Dataset(X, label=y, init_score=init, categorical_feature=[7],
                      device="cpu", **kw)


def _train(rounds, X, y, init=None, valid=None, params=PARAMS, **kw):
    ds = _ds(X, y, init)
    sets = [] if valid is None else [ds.create_valid(*valid)]
    return lt.train(dict(params), ds, rounds, valid_sets=sets,
                    verbose_eval=False, device="cpu", **kw)


def _same_tree(a, b):
    """Every field bitwise, over the used nodes and leaves."""
    nl = a.num_leaves
    assert nl == b.num_leaves
    for k in TREE_KEYS:
        n = nl if k.startswith("leaf") else nl - 1
        assert torch.equal(getattr(a, k)[:n], getattr(b, k)[:n]), k


# ------------------------------------------------------------------ rollback
def test_rollback_one_iter():
    X, y, init = _data()
    bst = _train(4, X[:1500], y[:1500], init[:1500],
                 (X[1500:], y[1500:], None, None, init[1500:]))
    gb = bst._gbdt
    before = (gb.predict_at(0), gb.predict_at(1))
    bst.update()
    assert bst.current_iteration == 5
    bst.rollback_one_iter()
    assert bst.current_iteration == gb.iter_ == 4 and bst.num_trees() == 4
    for a, b in zip(before, (gb.predict_at(0), gb.predict_at(1))):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert bst.eval_valid()[0][2] == pytest.approx(
        _train(4, X[:1500], y[:1500], init[:1500],
               (X[1500:], y[1500:], None, None, init[1500:]))
        .eval_valid()[0][2], rel=1e-6)


def test_rollback_keeps_init_model_trees(tmp_path):
    X, y, _ = _data(600)
    path = str(tmp_path / "m.txt")
    _train(3, X, y).save_model(path)
    bst = lt.Booster(dict(PARAMS, input_model=path), _ds(X, y), device="cpu")
    bst.update()
    bst.rollback_one_iter()
    bst.rollback_one_iter()  # nothing of this booster's own left
    assert bst.current_iteration == 3


def test_snapshot_restore_is_bitwise():
    X, y, init = _data()
    params = dict(PARAMS, bagging_fraction=0.8, bagging_freq=1,
                  feature_fraction=0.9)
    bst = _train(2, X[:1500], y[:1500], init[:1500],
                 (X[1500:], y[1500:], None, None, init[1500:]),
                 params=params)
    gb = bst._gbdt
    snap = gb.snapshot_state()
    runs = []
    for _ in range(2):  # the snapshot stays reusable
        gb.restore_state(snap)
        for _ in range(3):
            bst.update()
        runs.append((list(gb.models), gb._scores.clone(),
                     gb._valid_scores[0].clone(), gb._bag_mask.clone()))
    (m1, s1, v1, b1), (m2, s2, v2, b2) = runs
    assert len(m1) == len(m2) == 5
    for a, b in zip(m1, m2):
        _same_tree(a, b)
    assert torch.equal(s1, s2) and torch.equal(v1, v2)
    assert torch.equal(b1, b2) and float(b1.sum()) == 1200.0
    assert not torch.equal(m1[2].leaf_value, m1[3].leaf_value)


# --------------------------------------------------------- continued training
@pytest.fixture(scope="module")
def continued(tmp_path_factory):
    """10 trees with a valid set, saved; and 20 uninterrupted trees."""
    X, y, init = _data()
    valid = (X[1500:], y[1500:], None, None, init[1500:])
    b10 = _train(10, X[:1500], y[:1500], init[:1500], valid)
    b20 = _train(20, X[:1500], y[:1500], init[:1500], valid)
    path = str(tmp_path_factory.mktemp("continued") / "m10.txt")
    b10.save_model(path)
    return X, y, init, valid, b10, b20, path


def _init_model(kind, b10, path):
    if kind == "file":
        return path
    if kind == "string":
        return lt.Booster(model_str=b10.model_to_string(), device="cpu")
    return b10


def test_rebind_recovers_every_threshold_bin(continued):
    """C4: rebinding the text of a model's own trees gives back each
    node's bin, numerical and categorical."""
    X, y, init, _, b10, _, path = continued
    gb = lt.Booster(dict(PARAMS), _ds(X[:1500], y[:1500]), device="cpu")._gbdt
    bounds = gb._bounds_mat.numpy()
    loaded = lt.Booster(model_file=path, device="cpu")._gbdt.models
    cats = 0
    for own, text in zip(b10._gbdt.models, loaded):
        re = gb._rebind_tree(text, bounds)
        n = own.num_leaves - 1
        for k in ("split_feature", "threshold_bin", "decision_type"):
            assert torch.equal(re.__dict__[k][:n], own.__dict__[k][:n]), k
        cats += int((own.decision_type[:n] == 1).sum())
    assert cats > 0


@pytest.mark.parametrize("kind", ["file", "string", "booster"])
def test_continued_scores_replay_bitwise(continued, kind):
    X, y, init, valid, b10, _, path = continued
    ds = _ds(X[:1500], y[:1500], init[:1500])
    bst = lt.train(dict(PARAMS), ds, 0, valid_sets=[ds.create_valid(*valid)],
                   init_model=_init_model(kind, b10, path),
                   verbose_eval=False, device="cpu")
    assert bst.current_iteration == 10 and bst._gbdt.iter_ == 0
    assert np.array_equal(bst._gbdt.predict_at(0), b10._gbdt.predict_at(0))
    assert np.array_equal(bst._gbdt.predict_at(1), b10._gbdt.predict_at(1))


@pytest.mark.parametrize("kind", ["file", "string", "booster"])
def test_continued_10_plus_10_equals_20(continued, kind):
    X, y, init, valid, b10, b20, path = continued
    ds = _ds(X[:1500], y[:1500], init[:1500])
    evals = {}
    bst = lt.train(dict(PARAMS), ds, 10, valid_sets=[ds.create_valid(*valid)],
                   valid_names=["valid_0"], evals_result=evals,
                   init_model=_init_model(kind, b10, path),
                   verbose_eval=False, device="cpu")
    assert bst.current_iteration == 20
    assert bst.model_to_string() == b20.model_to_string()
    for a, b in zip(bst._gbdt.models[10:], b20._gbdt.models[10:]):
        _same_tree(a, b)
    assert torch.equal(bst._gbdt._scores, b20._gbdt._scores)
    assert torch.equal(bst._gbdt._valid_scores[0], b20._gbdt._valid_scores[0])
    assert evals["valid_0"]["binary_logloss"][-1] == \
        b20.eval_valid()[0][2]


def test_continue_from_jax_model_file(tmp_path):
    """A model file the JAX package wrote: the replayed train and valid
    scores equal that model's raw predict within 1e-6."""
    X, y, _ = _data()
    path = str(tmp_path / "jax.txt")
    bj = jax_engine.train(dict(PARAMS), lgb.Dataset(
        X[:1500], label=y[:1500], categorical_feature=[7]), 10,
        verbose_eval=False)
    bj.save_model(path)
    ds = _ds(X[:1500], y[:1500])
    bst = lt.Booster(dict(PARAMS, input_model=path), ds, device="cpu")
    bst.add_valid(ds.create_valid(X[1500:], y[1500:]), "va")
    for i, rows in ((0, slice(0, 1500)), (1, slice(1500, None))):
        np.testing.assert_allclose(
            bst._gbdt.predict_at(i)[0],
            bj.predict(X[rows], raw_score=True), rtol=0, atol=1e-6)
        assert np.array_equal(
            bst._gbdt.predict_at(i)[0],
            lt.Booster(model_file=path, device="cpu").predict(
                X[rows], raw_score=True).astype(np.float32))


# --------------------------------------------------- the model against JAX's
@pytest.fixture(scope="module")
def jax_pair():
    X, y, init = _data()
    bj = jax_engine.train(dict(PARAMS), lgb.Dataset(
        X, label=y, init_score=init, categorical_feature=[7]), 8,
        verbose_eval=False)
    bt = _train(8, X, y, init)
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    return X, bj, bt


def _assert_same_json(a, b, path="$"):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same_json(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, z) in enumerate(zip(a, b)):
            _assert_same_json(x, z, f"{path}[{i}]")
    elif isinstance(a, float):  # split gains: rtol 1e-4, the gain rule
        rel = 1e-4 if path.endswith("split_gain") else 1e-5
        assert b == pytest.approx(a, rel=rel, abs=1e-6), path
    else:
        assert a == b, path


def test_dump_model_matches_jax(jax_pair):
    _, bj, bt = jax_pair
    ours = bt.dump_model()
    _assert_same_json(bj.dump_model(), ours)
    assert len(ours["tree_info"]) == 8
    assert json.loads(json.dumps(ours))["tree_info"][3]["num_leaves"] == \
        bt._gbdt.models[3].num_leaves
    assert len(bt.dump_model(num_iteration=3)["tree_info"]) == 3


def test_feature_importance_matches_jax(jax_pair):
    _, bj, bt = jax_pair
    split = bt.feature_importance("split")
    assert np.array_equal(split, bj.feature_importance("split"))
    assert split.sum() == sum(t.num_leaves - 1 for t in bt._gbdt.models)
    np.testing.assert_allclose(bt.feature_importance("gain"),
                               bj.feature_importance("gain"), rtol=1e-4)
    with pytest.raises(ValueError, match="importance_type"):
        bt.feature_importance("cover")
    assert bt.feature_name() == [f"Column_{i}" for i in range(8)]


def test_pred_leaf_matches_jax(jax_pair):
    X, bj, bt = jax_pair
    leaves = bt.predict(X[:300], pred_leaf=True)
    assert leaves.shape == (300, 8) and leaves.dtype == np.int32
    assert np.array_equal(leaves, bj.predict(X[:300], pred_leaf=True))
    assert np.array_equal(bt.predict(X[:300], pred_leaf=True,
                                     num_iteration=3), leaves[:, :3])
    # a row's raw score is the sum of its leaves' values
    lv = np.stack([t.leaf_value.numpy()[leaves[:, i]]
                   for i, t in enumerate(bt._gbdt.models)], 1)
    np.testing.assert_allclose(lv.sum(1), bt.predict(X[:300], raw_score=True),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- parameters
def _reset_run(pkg):
    X, y, init = _data(1200)
    if pkg is lt:
        bst = lt.Booster(dict(PARAMS), _ds(X, y, init), device="cpu")
    else:
        bst = lgb.Booster(dict(PARAMS), lgb.Dataset(
            X, label=y, init_score=init, categorical_feature=[7]))
    for i in range(6):
        if i == 3:
            bst.reset_parameter({"learning_rate": 0.3,
                                 "bagging_fraction": 0.7, "bagging_freq": 1,
                                 "feature_fraction": 0.6})
        bst.update()
    return bst


def test_reset_parameter_applied_as_jax():
    """The rate and the sampling keys apply from the next iteration on,
    drawing as the JAX package draws."""
    bj, bt = _reset_run(lgb), _reset_run(lt)
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    assert bt._gbdt.learning_rate == 0.3 and bt.params["bagging_freq"] == 1
    assert float(bt._gbdt._bag_mask.sum()) == 840.0


@pytest.mark.parametrize("key", ["min_data_in_leaf", "min_sum_hessian_in_leaf",
                                 "lambda_l1", "lambda_l2",
                                 "min_gain_to_split", "max_depth",
                                 "num_leaves", "tree_growth"])
def test_reset_parameter_refuses_what_jax_ignores(key):
    """A key the JAX package accepts and ignores (the tree learner's,
    fixed when training starts) raises, naming the key."""
    X, y, _ = _data(300)
    bst = lt.Booster(dict(PARAMS), _ds(X, y), device="cpu")
    value = "depthwise" if key == "tree_growth" else 3
    before = getattr(bst.config, key)
    with pytest.raises(ValueError, match=key):
        bst.reset_parameter({key: value})
    assert getattr(bst.config, key) == before
    assert bst.params.get(key) == PARAMS.get(key)


def test_jax_ignores_a_tree_learner_reset():
    """The difference pinned on the JAX side: its min_data_in_leaf reset
    leaves the trees as they were (ROADMAP C)."""
    X, y, _ = _data(600)
    models = []
    for reset in (False, True):
        bst = lgb.Booster(dict(PARAMS), lgb.Dataset(X, label=y))
        bst.update()
        if reset:
            bst.reset_parameter({"min_data_in_leaf": 200})
            assert bst.config.min_data_in_leaf == 200
        bst.update()
        models.append(bst.model_to_string())
    assert models[0] == models[1]


# -------------------------------------------------- attributes and pickling
def test_attr_set_attr():
    X, y, _ = _data(300)
    bst = _train(1, X, y)
    assert bst.attr("a") is None
    assert bst.set_attr(a="1", b="2") is bst
    assert (bst.attr("a"), bst.attr("b")) == ("1", "2")
    bst.set_attr(a=None)
    assert bst.attr("a") is None and bst.attr("b") == "2"
    with pytest.raises(ValueError, match="strings"):
        bst.set_attr(c=3)


@pytest.mark.parametrize("how", ["pickle", "copy", "deepcopy"])
def test_booster_round_trips(how):
    X, y, init = _data()
    bst = _train(20, X[:1500], y[:1500], init[:1500],
                 (X[1500:], y[1500:], None, None, init[1500:]),
                 early_stopping_rounds=2, learning_rates=[0.5] * 20)
    assert 0 < bst.best_iteration < 20
    bst.set_attr(note="x").set_train_data_name("fit")
    out = {"pickle": lambda b: pickle.loads(pickle.dumps(b)),
           "copy": copy.copy, "deepcopy": copy.deepcopy}[how](bst)
    assert out is not bst and out.device == torch.device("cpu")
    assert out.best_iteration == bst.best_iteration
    assert out.best_score == bst.best_score
    assert out.attr("note") == "x" and out.train_data_name == "fit"
    assert out.model_to_string() == bst.model_to_string()
    assert np.array_equal(out.predict(X[1500:]), bst.predict(X[1500:]))
    assert out.params == bst.params and out.params is not bst.params


def test_pickle_keeps_the_device():
    """A model pickled on the card names the card: loading it without one
    raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the state loads there")
    X, y, _ = _data(300)
    state = _train(1, X, y).__getstate__()
    assert state["device"] == "cpu"
    state["device"] = "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lt.Booster.__new__(lt.Booster).__setstate__(state)


def test_predict_refuses_files(tmp_path):
    X, y, _ = _data(300)
    with pytest.raises(NotImplementedError, match="A6"):
        _train(1, X, y).predict(str(tmp_path / "rows.csv"))


# --------------------------------------------------------------- Dataset
def test_dataset_accessors():
    X, y, init = _data(400)
    w = np.linspace(0.5, 1.5, 400).astype(np.float32)
    ds = lt.Dataset(X, label=y, weight=w, init_score=init, group=[100] * 4,
                    device="cpu")
    assert np.array_equal(ds.get_group(), [100] * 4)
    assert ds.get_label() is y
    ds.construct()
    assert ds.num_data() == 400 and ds.num_feature() == 8
    np.testing.assert_array_equal(ds.get_label(), y)
    np.testing.assert_array_equal(ds.get_weight(), w)
    np.testing.assert_array_equal(ds.get_init_score(), init)
    np.testing.assert_array_equal(ds.get_group(), [100] * 4)


def test_dataset_setters_rebin_or_refuse():
    X, y, _ = _data(400)
    ds = lt.Dataset(X, label=y, device="cpu")
    with pytest.raises(lt.LightGBMError, match="expected 8"):
        ds.set_feature_name(["a"])
    names = [f"f{i}" for i in range(8)]
    inner = ds.construct()
    assert ds.set_feature_name(names) is ds
    assert inner.feature_names == names and ds.construct() is inner
    ds.set_categorical_feature([7])  # raw data held: bins again
    rebinned = ds.construct()
    assert rebinned is not inner and rebinned.is_categorical[7]
    ref = lt.Dataset(X[:200], label=y[:200], device="cpu")
    assert ds.set_reference(ref).reference is ref
    sub = ds.subset(np.arange(100))
    sub.set_categorical_feature([7])  # unchanged: nothing to do
    with pytest.raises(lt.LightGBMError, match="freed"):
        sub.set_categorical_feature("auto")
    with pytest.raises(lt.LightGBMError, match="freed"):
        sub.set_reference(ref)
    with pytest.raises(lt.LightGBMError, match="list of int"):
        ds.set_categorical_feature("all")


def test_init_model_is_not_inherited_by_the_next_train(tmp_path):
    """The dataset keeps train's merged parameters, but not its init
    model: a second train on the same dataset starts from scratch."""
    X, y, _ = _data(600)
    path = str(tmp_path / "m.txt")
    _train(3, X, y).save_model(path)
    ds = _ds(X, y)
    assert lt.train(dict(PARAMS), ds, 2, init_model=path, verbose_eval=False,
                    device="cpu").current_iteration == 5
    assert "input_model" not in ds.params
    assert lt.train(dict(PARAMS), ds, 2, verbose_eval=False,
                    device="cpu").current_iteration == 2


def test_predict_at_is_a_copy():
    """The scores handed to a custom objective or metric are a copy: the
    caller may write them, and training does not change them after."""
    X, y, _ = _data(600)
    bst = _train(2, X, y)
    gb = bst._gbdt
    s = gb.predict_at(0)
    kept = s.copy()
    s[:] = 1e6
    bst.update()
    assert np.array_equal(s, np.full_like(s, 1e6))
    assert not np.array_equal(gb.predict_at(0), kept)
    assert float(gb._scores.abs().max()) < 100
