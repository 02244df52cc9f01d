"""The valid-set replay of ``add_valid_dataset`` against the JAX package's,
bitwise.

A validation set added to a model that already holds trees gets their
sum on top of its init scores.  The JAX package (models/gbdt.py:478-489)
sums each chunk of ``_iter_chunk`` iterations from zero, in tree order,
and adds the chunk sums in order to the init scores; the port does the
same, so the two agree bit for bit when they hold the same trees.  The
JAX booster's trees are carried into the port's GBDT with
``convert.tree_from_numpy`` (in bin space: both packages bin the same
data alike), so both replay identical trees.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.convert import tree_from_numpy
from lightgbm_tpu_torch.models.gbdt import GBDT as PortGBDT
from lightgbm_tpu_torch.models.tree import predict_binned

N, NV, F = 1500, 1000, 6


def _data(seed, num_class):
    rng = np.random.RandomState(seed)
    X = rng.randn(N + NV, F)
    z = X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(N + NV)
    if num_class == 1:
        y = (z > 0).astype(np.float32)
    else:
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float32)
    init = rng.randn(num_class * NV) * 3.0
    return X[:N], y[:N], X[N:], y[N:], init


def _params(num_class):
    p = {"num_leaves": 15, "min_data_in_leaf": 10, "learning_rate": 0.37,
         "verbose": -1, "forest_batching": "off"}
    if num_class == 1:
        return dict(p, objective="binary")
    return dict(p, objective="multiclass", num_class=num_class)


def _replayed(num_class, rounds, chunk, monkeypatch):
    """(JAX valid scores, the port's) after ``add_valid`` of a set with an
    init score on a model of ``rounds`` iterations."""
    if chunk is not None:
        monkeypatch.setattr(JaxGBDT, "_iter_chunk", lambda self, n: chunk)
        monkeypatch.setattr(PortGBDT, "_iter_chunk", lambda self, n: chunk)
    X, y, Xv, yv, init = _data(3 + num_class, num_class)
    params = _params(num_class)
    jtrain = lgb.Dataset(X, label=y)
    jb = lgb.train(params, jtrain, num_boost_round=rounds)
    jb.add_valid(lgb.Dataset(Xv, label=yv, init_score=init,
                             reference=jtrain), "va")
    want = np.asarray(jb._gbdt._valid_scores[-1])

    ptrain = lt.Dataset(X, label=y, device="cpu")
    pb = lt.train(params, ptrain, 1, device="cpu")
    gb = pb._gbdt
    gb.models = [tree_from_numpy({k: np.asarray(v)
                                  for k, v in t._asdict().items()}, "cpu")
                 for t in jb._gbdt.models]
    gb._models_changed()
    pb.add_valid(ptrain.create_valid(Xv, label=yv, init_score=init), "va")
    got = gb._valid_scores[-1].numpy()
    return want, got, gb


@pytest.mark.parametrize("num_class,rounds,chunk", [
    (1, 4, None),   # one chunk on top of a nonzero init score
    (1, 7, 2),      # chunks of 2, 2, 2 and 1 iterations
    (3, 5, 2),      # three classes, chunks of 2, 2 and 1
    (3, 2, None),   # three classes, one chunk
])
def test_valid_replay_matches_jax_bitwise(num_class, rounds, chunk,
                                          monkeypatch):
    want, got, gb = _replayed(num_class, rounds, chunk, monkeypatch)
    assert got.shape == want.shape == (num_class, NV)
    np.testing.assert_array_equal(got, want)
    assert len(gb.models) == rounds * num_class


def test_replay_order_is_not_tree_by_tree(monkeypatch):
    """Adding each tree straight into the init scores is another float
    order: on this set it gives other scores than the replay."""
    want, got, gb = _replayed(1, 4, None, monkeypatch)
    vb = gb._valid_bins[-1].T  # [F, n] stored bins -> rows
    init = _data(4, 1)[4]
    acc = torch.from_numpy(init.astype(np.float32).reshape(1, NV))
    for i, tree in enumerate(gb.models):
        acc[i % gb.num_class] += predict_binned(tree, vb)
    assert (acc.numpy() != got).any()
