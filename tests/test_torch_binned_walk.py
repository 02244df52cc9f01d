"""Kernel P2's plain version against the JAX package's compositions,
bitwise.

P2 walks trees over binned rows for every score update of training
(the valid updates and replay, rollback, the init model's replay, DART).
Its plain version (``models/tree.py`` ``binned_update_`` /
``binned_replay_``, over ``binned_table``'s node table and ``[F, n]``
bins in their stored dtype) must give the JAX package's eager ops bit for
bit: ``s = s.at[c].add(f32(scale) * predict_binned(tree, X))`` chained in
order (each product and each add rounded to float32), and
``add_valid_dataset``'s chunk sums of ``ensemble_sum_binned``.  The JAX
trees are carried into the port with ``convert.tree_from_numpy`` (bin
space), so both walk identical trees over identical bins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.models.tree import (ensemble_sum_binned, predict_binned,
                                      predict_leaf_binned, stack_trees)

from lightgbm_tpu_torch.convert import tree_from_numpy
from lightgbm_tpu_torch.models import tree as pt
from lightgbm_tpu_torch.ops import predict as ops_predict

N, F, CAT = 900, 5, 1  # rows, features, the categorical column
KEEP = 2.0 / 3.0  # DART's keep at k = 2 drops


def _data(seed=11):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F)
    X[:, CAT] = rng.randint(0, 7, N)
    z = X[:, 0] + 0.8 * X[:, 2] * (X[:, CAT] % 3 == 1) + 0.3 * rng.randn(N)
    return X, z


def _booster(kind):
    """(JAX booster, its bins [n, F] in the stored dtype, K)."""
    X, z = _data()
    p = {"num_leaves": 15, "min_data_in_leaf": 10, "learning_rate": 0.3,
         "verbose": -1, "forest_batching": "off", "objective": "binary"}
    y, K, kw = (z > 0).astype(np.float32), 1, {}
    if kind == "categorical":
        kw = {"categorical_feature": [CAT]}
    elif kind == "multiclass":
        y = np.digitize(z, [-0.5, 0.5]).astype(np.float32)
        p.update(objective="multiclass", num_class=3)
        K, kw = 3, {"categorical_feature": [CAT]}
    elif kind == "uint16":
        p["max_bin"] = 300
    elif kind == "stumps":
        p["min_gain_to_split"] = 1e9
    jb = lgb.train(p, lgb.Dataset(X, label=y, **kw), num_boost_round=4)
    return jb, jb._gbdt.train_set.dense_bins(), K


KINDS = ("binary", "categorical", "multiclass", "uint16", "stumps")


@pytest.fixture(scope="module")
def boosters():
    return {k: _booster(k) for k in KINDS}


def _port_trees(jb):
    return [tree_from_numpy({k: np.asarray(v) for k, v in t._asdict().items()},
                            "cpu") for t in jb._gbdt.models]


def _bins_T(bins):
    return torch.from_numpy(np.ascontiguousarray(bins.T))


def _init(K, seed=3):
    return (np.random.RandomState(seed).randn(K, N) * 2).astype(np.float32)


def test_cases_cover_the_dtypes_and_node_kinds(boosters):
    assert boosters["uint16"][1].dtype == np.uint16
    assert boosters["binary"][1].dtype == np.uint8
    cat = boosters["categorical"][0]._gbdt.models
    assert any((np.asarray(t.decision_type)[:int(t.num_leaves) - 1] == 1).any()
               for t in cat)
    stumps = boosters["stumps"][0]._gbdt.models
    assert all(int(t.num_leaves) == 1 for t in stumps)
    assert int(boosters["uint16"][1].max()) > 255


@pytest.mark.parametrize("kind", KINDS)
def test_table_matches_tree_arrays(boosters, kind):
    """Each record is its tree's node with global children; the roots,
    the leaf values and the walk's bound come from the trees."""
    jb, _, _ = boosters[kind]
    trees = _port_trees(jb)
    table = pt.binned_table(trees)
    assert table.node.dtype == torch.int32 and table.node.shape[1] == 4
    rec = table.node.numpy().astype(np.int64)
    no = lo = 0
    for t, tree in enumerate(trees):
        nl = tree.num_leaves
        ni = nl - 1
        assert table.root[t] == (no if ni else ~lo)
        np.testing.assert_array_equal(table.leaf_value[lo:lo + nl].numpy(),
                                      tree.leaf_value[:nl].numpy())
        r = rec[no:no + ni]
        np.testing.assert_array_equal(
            r[:, 0] & 0x7FFFFFFF,
            np.maximum(tree.split_feature[:ni].numpy(), 0))
        np.testing.assert_array_equal(r[:, 0] < 0,
                                      tree.decision_type[:ni].numpy() == 1)
        np.testing.assert_array_equal(r[:, 1], tree.threshold_bin[:ni].numpy())
        for col, field in ((2, "left_child"), (3, "right_child")):
            ch = getattr(tree, field)[:ni].numpy().astype(np.int64)
            np.testing.assert_array_equal(
                r[:, col], np.where(ch >= 0, ch + no, ~(~ch + lo)))
        no, lo = no + ni, lo + nl
    assert table.node.shape[0] == no and table.leaf_value.shape[0] == lo
    assert table.max_steps == max(t.num_leaves - 1 for t in trees)


@pytest.mark.parametrize("kind", KINDS)
def test_device_roots_and_offsets_match_the_host(boosters, kind):
    """``root_dev`` is the host ``root``; ``node_offset`` / ``leaf_offset``
    are each tree's first record and first leaf, for a table of the
    model's trees and for one of a single tree."""
    trees = _port_trees(boosters[kind][0])
    for part in (trees, trees[-1:], trees[1:3]):
        table = pt.binned_table(part)
        assert table.root_dev.dtype == torch.int32
        assert table.root_dev.tolist() == table.root
        ni = [max(t.num_leaves, 1) - 1 for t in part]
        nl = [max(t.num_leaves, 1) for t in part]
        assert table.node_offset.tolist() == list(np.cumsum([0] + ni))
        assert table.leaf_offset.tolist() == list(np.cumsum([0] + nl))
        for t in table.root_dev, table.node_offset, table.leaf_offset:
            assert t.is_contiguous() and t.dtype == torch.int32


@pytest.mark.parametrize("kind", KINDS)
def test_leaves_match_the_reference_walk(boosters, kind):
    """The table walk's leaf (local) is the per-tree walk's, row by row."""
    jb, bins, _ = boosters[kind]
    trees = _port_trees(jb)
    table = pt.binned_table(trees)
    X_binT = _bins_T(bins)
    lo = 0
    for t, tree in enumerate(trees):
        got = pt.binned_leaves(table, t, X_binT) - lo
        want = np.asarray(predict_leaf_binned(jb._gbdt.models[t],
                                              jnp.asarray(bins)))
        np.testing.assert_array_equal(got.numpy(), want)
        lo += tree.num_leaves


def _jax_chain(jb, bins, init, order, classes, scales):
    s = jnp.asarray(init)
    X = jnp.asarray(bins)
    for t, c, sc in zip(order, classes, scales):
        s = s.at[c].add(sc * predict_binned(jb._gbdt.models[t], X))
    return np.asarray(s)


def _calls(T, K, scale):
    """The ``(first tree, trees, c0, scale)`` calls of
    test_update_matches_jax_chain: the whole list at c0 = 0 with one scale
    (or, "mixed", tree by tree with the scales cycling), then for K > 1
    the list again at c0 = 1."""
    cycle = [1.0, -1.0, KEEP, KEEP - 1.0]
    calls = ([(t, 1, t % K, cycle[t % 4]) for t in range(T)]
             if scale == "mixed" else [(0, T, 0, scale)])
    if K > 1:
        calls.append((0, T, 1, 1.0 if scale == "mixed" else scale))
    return calls


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scale", [1.0, -1.0, KEEP, KEEP - 1.0, "mixed"])
def test_update_matches_jax_chain(boosters, kind, scale):
    """binned_update_ == ``s.at[c].add(scale * predict_binned(t, X))`` in
    list order, bitwise: listed tree t to class ``(c0 + t) % K``, one
    scale a call; chained calls (tree by tree with the scales cycling, and
    for K > 1 the list again shifted by one class) chain the same adds."""
    jb, bins, K = boosters[kind]
    trees = _port_trees(jb)
    T = len(trees)
    order, classes, scales = [], [], []
    for t0, cnt, c0, sc in _calls(T, K, scale):
        order += list(range(t0, t0 + cnt))
        classes += [(c0 + i) % K for i in range(cnt)]
        scales += [sc] * cnt
    init = _init(K)
    want = _jax_chain(jb, bins, init, order, classes, scales)
    got = torch.from_numpy(init.copy())
    again = torch.from_numpy(init.copy())
    for t0, cnt, c0, sc in _calls(T, K, scale):
        table = pt.binned_table(trees[t0:t0 + cnt])
        out = pt.binned_update_(got, table, _bins_T(bins), c0, sc)
        assert out is got
        # the dispatcher takes the plain version for a CPU tensor
        ops_predict.ensemble_update_binned_(again, table, _bins_T(bins), c0,
                                            sc)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(again.numpy(), want)


# each caller's P2 call and the per-tree classes and scales it passed
# before the class offset and the one scale were kernel arguments:
# (name, K, listed trees as indices into the model, c0, the old classes,
# the train scale)
def _caller_cases():
    cases = []
    for K in (1, 3):
        for k in range(K):  # train_one_iter: the new tree of class k
            cases.append((f"new_tree_K{K}_class{k}", K, [k], k, [k], 1.0))
        cases.append((f"rollback_K{K}", K, list(range(K)), 0, list(range(K)),
                      -1.0))
        n = 2 * K  # merge_from: the init model's trees, i % K
        cases.append((f"merge_K{K}", K, list(range(n)), 0,
                      [i % K for i in range(n)], 1.0))
        for sc in (-1.0, KEEP, KEEP - 1.0):  # DART: drops 0 and 1
            drops = [0, 1]
            cases.append((f"dart_K{K}_scale{sc:.3f}", K,
                          [i * K + c for i in drops for c in range(K)], 0,
                          [c for _ in drops for c in range(K)], sc))
    return cases


@pytest.mark.parametrize("case", _caller_cases(), ids=lambda c: c[0])
def test_callers_match_their_per_tree_lists(boosters, case):
    """Every caller's ``(c0, scale)`` call == the JAX chain over the
    per-tree class and scale lists the caller used to pass: the new tree
    of class k, rollback over ``range(K)``, ``merge_from``'s ``i % K``,
    DART's drops (subtract, renormalise, the valid sets' keep - 1)."""
    _, K, idx, c0, classes, sc = case
    jb, bins, k_model = boosters["binary" if K == 1 else "multiclass"]
    assert k_model == K
    trees = _port_trees(jb)
    init = _init(K, seed=13)
    want = _jax_chain(jb, bins, init, idx, classes, [sc] * len(idx))
    got = pt.binned_update_(torch.from_numpy(init.copy()),
                            pt.binned_table([trees[i] for i in idx]),
                            _bins_T(bins), c0, sc)
    assert [(c0 + t) % K for t in range(len(idx))] == classes
    np.testing.assert_array_equal(got.numpy(), want)


def test_products_round_apart_from_the_sum(boosters):
    """``s + f32(keep) * d`` with the product rounded first is what the
    JAX package computes; a fused multiply-add would differ somewhere."""
    jb, bins, _ = boosters["binary"]
    trees = _port_trees(jb)
    init = _init(1, seed=9)
    got = pt.binned_update_(torch.from_numpy(init.copy()),
                            pt.binned_table(trees), _bins_T(bins), 0,
                            KEEP).numpy()
    fused = init.astype(np.float64)
    for t in jb._gbdt.models:
        d = np.asarray(predict_binned(t, jnp.asarray(bins)), np.float64)
        fused = (fused + np.float64(np.float32(KEEP)) * d).astype(np.float32) \
            .astype(np.float64)
    assert (got != fused.astype(np.float32)).any()


@pytest.mark.parametrize("scale", [KEEP, KEEP - 1.0, 0.1, 1.0 / 3.0])
def test_a_python_scale_rounds_as_a_float32_tensor(scale):
    """The plain version's 0-d float32 scale gives the float32 product of
    f32(scale) and the value, the product P2 takes as a float argument;
    a Python float scale would give the same on the CPU."""
    v = torch.from_numpy(np.random.RandomState(2).randn(1000)
                         .astype(np.float32))
    want = (v.numpy() * np.float32(scale)).astype(np.float32)
    np.testing.assert_array_equal(
        (v * torch.tensor(scale, dtype=torch.float32)).numpy(), want)
    np.testing.assert_array_equal((v * scale).numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("chunk", [1, 3, 100])
def test_replay_matches_jax_chunk_sums(boosters, kind, chunk):
    """binned_replay_ == the init scores plus, chunk by chunk in order,
    ``ensemble_sum_binned`` of ``chunk`` iterations (gbdt.py:478-489)."""
    jb, bins, K = boosters[kind]
    models = jb._gbdt.models
    n_iter = len(models) // K
    stacked = jax.tree.map(
        lambda a: a.reshape((n_iter, K) + a.shape[1:]), stack_trees(models))
    init = _init(K, seed=5)
    acc = jnp.asarray(init)
    for lo in range(0, n_iter, chunk):
        part = jax.tree.map(lambda a: a[lo:lo + chunk], stacked)
        acc = acc + ensemble_sum_binned(part, jnp.asarray(bins))
    table = pt.binned_table(_port_trees(jb))
    got = torch.from_numpy(init.copy())
    pt.binned_replay_(got, table, _bins_T(bins), K, chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(acc))
    again = torch.from_numpy(init.copy())
    ops_predict.ensemble_replay_binned_(again, table, _bins_T(bins), K, chunk)
    np.testing.assert_array_equal(again.numpy(), np.asarray(acc))


def test_empty_table_changes_nothing():
    table = pt.binned_table([])
    assert table.num_trees == 0 and table.node.shape == (0, 4)
    s = torch.ones(1, 5)
    pt.binned_update_(s, table, torch.zeros(2, 5, dtype=torch.uint8), 0, 1.0)
    pt.binned_replay_(s, table, torch.zeros(2, 5, dtype=torch.uint8), 1, 4)
    assert torch.equal(s, torch.ones(1, 5))
