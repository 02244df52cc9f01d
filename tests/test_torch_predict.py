"""Prediction of the port against the JAX package, bitwise.

The JAX package trains every model here on the CPU; its text loads into
the port with ``device="cpu"``, where ``Booster.predict`` runs P1's plain
version (``models/tree.py`` ``ensemble_sum_raw`` / ``ensemble_leaves_raw``
on ``PackedTrees``).  Each tree's output is an exact leaf value, so the
two packages agree bitwise as long as every row reaches the same leaf and
the leaf values are added in the same order: in tree order, within chunks
of ``GBDT._iter_chunk`` iterations.  Categorical splits route through
XLA's saturating float -> int32 cast (NaN -> 0), ``f32_to_i32_xla``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu.models import tree as jax_tree
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models import tree as port_tree
from lightgbm_tpu_torch.models.gbdt import GBDT as PortGBDT
from lightgbm_tpu_torch.ops import predict as port_predict

CPU = dict(device="cpu")
N, F, CAT = 400, 5, 1  # rows, features, the categorical column
SPECIAL = (np.nan, np.inf, -np.inf, 3e9, -3e9)


def _data(seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F)
    X[:, CAT] = rng.randint(0, 6, N)
    y = ((X[:, CAT] == 0) | (X[:, CAT] == 4) ^ (X[:, 0] > 0.3)).astype(
        np.float32)
    return X, y


def _queries(X):
    """The training rows' first 150, then rows with NaN, +-inf and +-3e9
    in each feature (the categorical one included) and category 0 and
    the int32 ends in the categorical column."""
    Q = [X[:150]]
    base = X[150:150 + len(SPECIAL) * F].copy()
    for j, v in enumerate(SPECIAL):
        for f in range(F):
            base[j * F + f, f] = v
    Q.append(base)
    ends = X[200:206].copy()
    ends[:, CAT] = [0, -0.0, 2147483647.0, -2147483648.0, 0.9, -0.9]
    Q.append(ends)
    return np.concatenate(Q)


def _jax_train(params, X, y, rounds, **ds_kw):
    p = {"num_leaves": 15, "min_data_in_leaf": 10, "learning_rate": 0.3,
         "verbose": -1, "forest_batching": "off", **params}
    return lgb.train(p, lgb.Dataset(X, label=y, **ds_kw),
                     num_boost_round=rounds)


def _model(kind):
    X, y = _data()
    if kind == "binary":
        return _jax_train({"objective": "binary"}, X, y, 8)
    if kind == "categorical":
        return _jax_train({"objective": "binary"}, X, y, 8,
                          categorical_feature=[CAT])
    if kind == "multiclass":
        y3 = np.where(X[:, CAT] == 0, 2, (np.abs(X[:, 0]) * 2).astype(int) % 2)
        return _jax_train({"objective": "multiclass", "num_class": 3}, X,
                          y3.astype(np.float32), 4,
                          categorical_feature=[CAT])
    if kind == "stumps":
        return _jax_train({"objective": "binary",
                           "min_gain_to_split": 1e9}, X, y, 3)
    if kind == "mixed":  # 31-leaf trees, then 7-leaf and categorical ones
        big = _jax_train({"objective": "binary", "num_leaves": 31,
                          "min_data_in_leaf": 5}, X, y, 3)
        small = _jax_train({"objective": "binary", "num_leaves": 7}, X, y,
                           3, categorical_feature=[CAT])
        big._gbdt.merge_from(small._gbdt)
        return big
    raise ValueError(kind)


KINDS = ("binary", "categorical", "multiclass", "stumps", "mixed")


@pytest.fixture(scope="module")
def models():
    return {k: _model(k) for k in KINDS}


def _port(jb):
    return lt.Booster(model_str=jb.model_to_string(), **CPU)


def test_f32_to_i32_xla_is_xla_convert():
    v = np.array([np.nan, -np.nan, np.inf, -np.inf, 3e9, -3e9, 2 ** 31,
                  -(2 ** 31), 2147483520.0, -2147483904.0, 0.5, -0.5,
                  1.9999, -1.9999, 5.0, -0.0, 1e-45, 16777217.0], np.float32)
    want = np.asarray(jnp.asarray(v).astype(jnp.int32))
    got = port_tree.f32_to_i32_xla(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[2] == 2 ** 31 - 1 and got[3] == -(2 ** 31)


def test_categorical_zero_is_a_split(models):
    """The categorical models split on category 0, so a NaN there (XLA:
    category 0; torch's own cast: -2**31) is routed by the C5 fix."""
    for kind in ("categorical", "multiclass"):
        gb = models[kind]._gbdt
        cats = [float(t.threshold_real[i]) for t in gb.models
                for i in range(int(t.num_leaves) - 1)
                if int(t.decision_type[i]) == 1]
        assert 0.0 in cats, kind


@pytest.mark.parametrize("kind", KINDS)
def test_predict_matches_jax_bitwise(models, kind):
    jb = models[kind]
    pb = _port(jb)
    Q = _queries(_data()[0])
    for kw in ({"raw_score": True}, {}, {"pred_leaf": True},
               {"raw_score": True, "num_iteration": 2},
               {"pred_leaf": True, "num_iteration": 2}):
        want = np.asarray(jb.predict(Q, **kw))
        got = pb.predict(Q, **kw)
        assert got.shape == want.shape, kw
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


@pytest.mark.parametrize("kind", ("categorical", "multiclass"))
def test_best_iteration_is_the_default(models, kind):
    jb = models[kind]
    pb = _port(jb)
    Q = _queries(_data()[0])
    jb.best_iteration = pb.best_iteration = 3
    try:
        for kw in ({"raw_score": True}, {}, {"pred_leaf": True}):
            np.testing.assert_array_equal(pb.predict(Q, **kw),
                                          np.asarray(jb.predict(Q, **kw)))
        np.testing.assert_array_equal(
            pb.predict(Q, raw_score=True),
            pb.predict(Q, raw_score=True, num_iteration=3))
    finally:
        jb.best_iteration = -1


@pytest.mark.parametrize("kind", KINDS)
def test_ensemble_functions_match_jax(models, kind):
    """``ensemble_sum_raw`` / ``ensemble_leaves_raw`` on PackedTrees
    against the JAX functions of the same names on the stacked trees."""
    jb = models[kind]
    gb = jb._gbdt
    K, T = gb.num_class, len(gb.models)
    Q = np.ascontiguousarray(_queries(_data()[0]), np.float32)
    stacked = jax_tree.stack_trees(gb.models)
    grouped = jax.tree.map(lambda a: a.reshape((T // K, K) + a.shape[1:]),
                           stacked)
    want_sum = np.asarray(jax_tree.ensemble_sum_raw(grouped, jnp.asarray(Q)))
    want_leaves = np.asarray(jax_tree.ensemble_leaves_raw(stacked,
                                                          jnp.asarray(Q)))
    p = _port(jb)._gbdt._packed()
    Xt = torch.from_numpy(Q)
    assert p.num_trees == T and p.num_class == K
    got_sum = port_tree.ensemble_sum_raw(p, Xt, T, T // K).numpy()
    got_leaves = port_tree.ensemble_leaves_raw(p, Xt, T).numpy()
    np.testing.assert_array_equal(got_sum, want_sum)
    np.testing.assert_array_equal(got_leaves, want_leaves)
    # the dispatch takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        port_predict.ensemble_sum(p, Xt, T, T // K).numpy(), want_sum)


def _merged(jb, copies):
    """``copies`` copies of ``jb``'s trees one after the other, as a JAX
    Booster and the port's Booster of its text."""
    text = jb.model_to_string()
    big = lgb.Booster(model_str=text)
    for _ in range(copies - 1):
        big._gbdt.merge_from(lgb.Booster(model_str=text)._gbdt)
    return big, _port(big)


def test_default_chunks_above_walk_cells_match_jax(models, monkeypatch):
    """At rows x trees above 16M the default ``_iter_chunk`` splits the
    sum into chunks on both packages: the port agrees bitwise, and its
    plain version walks no more than ``WALK_CELLS`` rows x trees at once."""
    jb, pb = _merged(models["binary"], 8)  # 64 trees
    T = pb.num_trees()
    Q = np.resize(_queries(_data()[0]), (270_000, F))
    assert Q.shape[0] * T > port_tree.WALK_CELLS
    assert pb._gbdt._iter_chunk(Q.shape[0]) < T  # 59: chunks of 59 and 5
    cells = []
    walk = port_tree._walk_packed

    def counted(p, X, t0, t1):
        cells.append(X.shape[0] * (t1 - t0))
        return walk(p, X, t0, t1)

    monkeypatch.setattr(port_tree, "_walk_packed", counted)
    got = pb.predict(Q, raw_score=True)
    np.testing.assert_array_equal(got, np.asarray(jb.predict(
        Q, raw_score=True)))
    assert len(cells) == 2 and max(cells) <= port_tree.WALK_CELLS


def test_blocked_leaf_walk_matches_jax(models, monkeypatch):
    """``ensemble_leaves_raw`` walks ``WALK_CELLS // n`` trees at a time;
    with the bound cut to 1,000 cells the blocks of 3 trees give the
    JAX package's leaves."""
    jb, pb = _merged(models["mixed"], 2)
    Q = _queries(_data()[0])
    monkeypatch.setattr(port_tree, "WALK_CELLS", 1000)
    np.testing.assert_array_equal(pb.predict(Q, pred_leaf=True),
                                  np.asarray(jb.predict(Q, pred_leaf=True)))


@pytest.mark.parametrize("kind", ("binary", "multiclass", "mixed"))
def test_chunked_order_matches_jax(models, kind, monkeypatch):
    """Both packages summing in chunks of 3 iterations agree bitwise, and
    the chunked order is another float order than one chunk."""
    jb = models[kind]
    pb = _port(jb)
    Q = _queries(_data()[0])
    one = pb.predict(Q, raw_score=True)
    monkeypatch.setattr(JaxGBDT, "_iter_chunk", lambda self, n: 3)
    monkeypatch.setattr(PortGBDT, "_iter_chunk", lambda self, n: 3)
    want = np.asarray(jb.predict(Q, raw_score=True))
    got = pb.predict(Q, raw_score=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pb.predict(Q), np.asarray(jb.predict(Q)))
    if kind == "binary":  # 8 iterations: chunks of 3, 3, 2
        assert (got != one).any()


def test_iter_chunk_is_jax_rule():
    g = PortGBDT(lt.Config(objective="multiclass", num_class=5), **CPU)
    jg = JaxGBDT(lgb.Config(objective="multiclass", num_class=5))
    for n in (1, 1000, 3_200_001, 10 ** 7):
        assert g._iter_chunk(n) == jg._iter_chunk(n)


# ------------------------------------------------------------ stale packs
def _trained(rounds=4, **extra):
    X, y = _data()
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "learning_rate": 0.3, **extra}
    ds = lt.Dataset(X, label=y, **CPU)
    return lt.train(params, ds, rounds, **CPU), ds, X, params


def _fresh(bst, X):
    """The same model, packed anew: its text in a new Booster."""
    return lt.Booster(model_str=bst.model_to_string(), **CPU).predict(
        X, raw_score=True)


def test_rollback_and_retrain_repack():
    bst, _, X, _ = _trained()
    p4 = bst.predict(X, raw_score=True)  # packs 4 trees
    bst.rollback_one_iter()
    p3 = bst.predict(X, raw_score=True)
    np.testing.assert_array_equal(p3, _fresh(bst, X))
    assert bst.num_trees() == 3 and (p3 != p4).any()
    bst.update()
    np.testing.assert_array_equal(bst.predict(X, raw_score=True),
                                  _fresh(bst, X))


def test_continued_training_with_mixed_budgets_repacks():
    """An init model of 31 leaves continued at 7 leaves."""
    big, ds, X, params = _trained(num_leaves=31, min_data_in_leaf=5)
    big.predict(X, raw_score=True)
    more = lt.train(dict(params, num_leaves=7), ds, 3, init_model=big,
                    **CPU)
    leaves = [t.num_leaves for t in more._gbdt.models]
    assert more.num_trees() == 7 and max(leaves[:4]) > 7 >= max(leaves[4:])
    got = more.predict(X, raw_score=True)
    np.testing.assert_array_equal(got, _fresh(more, X))
    jb = lgb.Booster(model_str=more.model_to_string())
    np.testing.assert_array_equal(got, np.asarray(jb.predict(
        X, raw_score=True)))


def test_restore_state_and_merge_repack():
    bst, _, X, _ = _trained(rounds=2)
    gb = bst._gbdt
    snap = gb.snapshot_state()
    bst.update()
    bst.update()
    p4 = bst.predict(X, raw_score=True)
    gb.restore_state(snap)
    p2 = bst.predict(X, raw_score=True)
    assert bst.num_trees() == 2 and (p2 != p4).any()
    np.testing.assert_array_equal(p2, _fresh(bst, X))
    other, _, _, _ = _trained(rounds=1, num_leaves=3)
    gb.merge_from(other._gbdt)
    np.testing.assert_array_equal(bst.predict(X, raw_score=True),
                                  _fresh(bst, X))
    text = bst.model_to_string()
    gb.load_model_from_string(other.model_to_string())
    np.testing.assert_array_equal(bst.predict(X, raw_score=True),
                                  _fresh(other, X))
    assert text != bst.model_to_string()


def test_malformed_tree_is_refused():
    bst, _, _, _ = _trained(rounds=1)
    t = bst._gbdt.models[0]
    bad = t.replace(left_child=torch.zeros_like(t.left_child))  # a cycle
    with pytest.raises(ValueError, match="malformed"):
        port_tree.pack_trees([bad])


@pytest.mark.cuda
def test_p1_matches_plain_on_card(models):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    from lightgbm_tpu_torch.ops.cuda_predict import (ensemble_leaves_cuda,
                                                     ensemble_sum_cuda)

    Q = np.ascontiguousarray(_queries(_data()[0]), np.float32)
    # the queries' columns spread over 5,000 features, 4,096 rows: the wide
    # configuration (X read from global memory)
    rng = np.random.RandomState(14)
    perm = rng.choice(5000, F, replace=False)
    Qw = rng.randn(4096, 5000).astype(np.float32)
    Qw[:, perm] = np.resize(Q, (4096, F))
    to = torch.as_tensor(perm, dtype=torch.int32)

    def spread(t):
        sf = t.split_feature_real
        return t.replace(split_feature_real=torch.where(
            sf >= 0, to[sf.clamp(min=0).long()], sf))

    for kind in KINDS:
        gb = _port(models[kind])._gbdt
        T, K = len(gb.models), gb.num_class
        cases = [(gb.models, Q, None), (gb.models, Q[:1], None),
                 (gb.models, Q[:8], None),
                 # 8 tree slots a block, chunks of 3 iterations: group
                 # boundaries inside chunks, records through L1 and staged
                 (gb.models, Q, (32, True, 0)), (gb.models, Q, (32, True, 64)),
                 ([spread(t) for t in gb.models], Qw, None)]
        for trees, X, config in cases:
            p = port_tree.pack_trees(trees, K, "cpu")
            pc = port_tree.pack_trees(trees, K, "cuda")
            Xc = torch.from_numpy(np.ascontiguousarray(X)).cuda()
            Xh = torch.from_numpy(np.ascontiguousarray(X))
            for chunk in (1, 3, T // K):
                assert torch.equal(
                    ensemble_sum_cuda(pc, Xc, T, chunk, config).cpu(),
                    port_tree.ensemble_sum_raw(p, Xh, T, chunk))
            assert torch.equal(ensemble_leaves_cuda(pc, Xc, T, config).cpu(),
                               port_tree.ensemble_leaves_raw(p, Xh, T))
