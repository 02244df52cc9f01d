"""Depthwise and hybrid growth of the port against the JAX package's.

The port's ``grow_tree_depthwise`` (learners/depthwise.py), the hybrid
resume (``serial.grow_tree`` with ``init_tree``) and ``grow_tree_hybrid``
run with their plain PyTorch versions on the CPU; the JAX growers run with
their segment-sum level histogram, as tests/test_depthwise.py calls them,
on that file's setups (the leaf budget, ``max_depth``, the no-split
stump) and on a case with random gradients, bagging, a feature mask and a
categorical feature.  The trees must be structurally identical (every
STRUCT field, and the row -> leaf map); values agree to
tests/test_torch_slice.py's tolerances (leaf and internal values rtol
1e-5 / atol 1e-6, split_gain rtol 1e-4: the port sums histogram rows in
2048-row blocks, the segment sum in one run).  ``train(...,
tree_growth=depthwise|hybrid, device="cpu")`` is held against
``lightgbm_tpu.engine.train`` with ``hist_impl="matmul"``, where the JAX
side runs its sorted (K1'') and single-leaf (K1) Pallas kernels in
interpret mode.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.engine as jax_engine
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.learners.depthwise import (
    grow_tree_depthwise as jax_depthwise)
from lightgbm_tpu.learners.hybrid import grow_tree_hybrid as jax_hybrid
from lightgbm_tpu.learners.serial import TreeLearnerParams as JaxParams
from lightgbm_tpu.learners.serial import grow_tree as jax_grow_tree

import lightgbm_tpu_torch as lt
import lightgbm_tpu_torch.learners.depthwise as port_depthwise
import lightgbm_tpu_torch.learners.serial as port_serial
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.learners.depthwise import grow_tree_depthwise
from lightgbm_tpu_torch.learners.hybrid import (HYBRID_STOP_FACTOR,
                                                grow_tree_hybrid)
from lightgbm_tpu_torch.learners.serial import TreeLearnerParams, grow_tree
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.models.tree import Tree, predict_leaf_binned
from lightgbm_tpu_torch.ops.cuda_histogram import histogram_record_window

STRUCT = ("split_feature", "threshold_bin", "decision_type", "left_child",
          "right_child", "leaf_count", "leaf_parent", "leaf_depth")
VALUES = ("leaf_value", "internal_value", "internal_count")


def _setup(n=4000, f=8, n_bins=32, seed=0):
    """tests/test_depthwise.py's binned problem: grad/hess at score 0."""
    rng = np.random.RandomState(seed)
    X_bin = rng.randint(0, n_bins, size=(n, f)).astype(np.uint8)
    z = (X_bin[:, 0].astype(float) - n_bins / 2) + 0.5 * (
        X_bin[:, 1].astype(float) - n_bins / 2)
    y = (z + rng.randn(n) * 3 > 0).astype(np.float32)
    p = np.full(n, 0.5)
    return dict(bins=np.ascontiguousarray(X_bin.T),
                grad=(p - y).astype(np.float32),
                hess=(2 * p * (1 - p)).astype(np.float32),
                bag=np.ones(n, np.float32), fmask=np.ones(f, bool),
                nbpf=np.full(f, n_bins, np.int32), iscat=np.zeros(f, bool),
                B=n_bins)


def _random_case():
    """Random gradients, bagging, a masked feature, a categorical one."""
    rng = np.random.RandomState(4)
    n, f, B = 6000, 7, 24
    d = dict(bins=rng.randint(0, B, size=(f, n)).astype(np.uint8),
             grad=rng.randn(n).astype(np.float32),
             hess=(np.abs(rng.randn(n)) + 0.1).astype(np.float32),
             bag=(rng.rand(n) < 0.9).astype(np.float32),
             fmask=np.ones(f, bool), nbpf=np.full(f, B, np.int32),
             iscat=np.zeros(f, bool), B=B)
    d["fmask"][2] = False
    d["iscat"][4] = True
    return d


# (name, setup, max_leaves, config): tests/test_depthwise.py's cases
CASES = {
    "budget31": (lambda: _setup(), 31, dict(min_data_in_leaf=20)),
    "budget4": (lambda: _setup(n=8000), 4, dict(min_data_in_leaf=5)),
    "budget7": (lambda: _setup(n=8000), 7, dict(min_data_in_leaf=5)),
    "budget15": (lambda: _setup(n=8000), 15, dict(min_data_in_leaf=5)),
    "max_depth3": (lambda: _setup(n=8000), 63,
                   dict(min_data_in_leaf=5, max_depth=3)),
    "unconstrained": (lambda: _setup(n=2000, f=4, n_bins=8), 127,
                      dict(min_data_in_leaf=200)),
    "random": (_random_case, 31,
               dict(min_data_in_leaf=10, lambda_l2=0.5)),
}


def _args(d, cfg, lib):
    if lib == "jax":
        arrs = [jnp.asarray(d[k]) for k in ("bins", "grad", "hess", "bag",
                                             "fmask", "nbpf", "iscat")]
        return arrs + [JaxParams.from_config(JaxConfig(**cfg))]
    arrs = [torch.from_numpy(d[k]) for k in ("bins", "grad", "hess", "bag",
                                              "fmask", "nbpf", "iscat")]
    return arrs + [TreeLearnerParams.from_config(Config(**cfg))]


def _config(extra, L):
    return dict({"min_sum_hessian_in_leaf": 1.0, "num_leaves": L}, **extra)


def _assert_same_tree(tt, lid_t, tj, lid_j):
    assert tt.num_leaves == int(tj.num_leaves)
    for k in STRUCT:
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(tj, k)), err_msg=k)
    np.testing.assert_array_equal(lid_t.numpy(), np.asarray(lid_j))
    for k in VALUES:
        np.testing.assert_allclose(getattr(tt, k).numpy(),
                                   np.asarray(getattr(tj, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tt.split_gain.numpy(),
                               np.asarray(tj.split_gain), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_depthwise_matches_jax(name):
    make, L, extra = CASES[name]
    d, cfg = make(), _config(extra, L)
    tj, lid_j = jax_depthwise(*_args(d, cfg, "jax"), num_bins=d["B"],
                              max_leaves=L)
    tt, lid_t = grow_tree_depthwise(*_args(d, cfg, "port"), num_bins=d["B"],
                                    max_leaves=L)
    _assert_same_tree(tt, lid_t, tj, lid_j)
    assert tt.num_leaves > 2
    # the row -> leaf map is the tree's own decision program
    walked = predict_leaf_binned(tt, torch.from_numpy(d["bins"]).T)
    np.testing.assert_array_equal(walked.numpy(), lid_t.numpy())


def test_no_split_possible_gives_stump():
    n = 500
    d = dict(bins=np.zeros((3, n), np.uint8),
             grad=np.random.RandomState(0).randn(n).astype(np.float32),
             hess=np.ones(n, np.float32), bag=np.ones(n, np.float32),
             fmask=np.ones(3, bool), nbpf=np.full(3, 4, np.int32),
             iscat=np.zeros(3, bool), B=4)
    cfg = _config(dict(min_data_in_leaf=20), 15)
    tj, lid_j = jax_depthwise(*_args(d, cfg, "jax"), num_bins=4,
                              max_leaves=15)
    port_serial.HOST_SYNCS = 0
    tt, lid_t = grow_tree_depthwise(*_args(d, cfg, "port"), num_bins=4,
                                    max_leaves=15)
    assert tt.num_leaves == int(tj.num_leaves) == 1
    assert not lid_t.any()
    _assert_same_tree(tt, lid_t, tj, lid_j)
    assert port_serial.HOST_SYNCS == 1  # the root level's read


@pytest.mark.parametrize("name", ["budget31", "budget15", "random"])
def test_one_host_read_per_level(name):
    make, L, extra = CASES[name]
    d, cfg = make(), _config(extra, L)
    port_serial.HOST_SYNCS = 0
    port_depthwise.LEVELS = port_depthwise.LEVEL_SPLITS = 0
    tt, _ = grow_tree_depthwise(*_args(d, cfg, "port"), num_bins=d["B"],
                                max_leaves=L)
    depth = int(tt.leaf_depth[:tt.num_leaves].max())
    # a level that splits nothing still reads its rows, then stops
    assert port_depthwise.LEVELS == depth + (tt.num_leaves < L)
    assert port_serial.HOST_SYNCS == port_depthwise.LEVELS
    assert port_depthwise.LEVEL_SPLITS == tt.num_leaves - 1


def _host_tree(tj) -> Tree:
    """A JAX tree as the port's Tree on the CPU."""
    fields = {k: torch.from_numpy(np.asarray(getattr(tj, k)).copy())
              for k in ("split_feature", "split_feature_real",
                        "threshold_bin", "threshold_real", "decision_type",
                        "left_child", "right_child", "split_gain",
                        "internal_value", "internal_count", "leaf_value",
                        "leaf_count", "leaf_parent", "leaf_depth")}
    return Tree(num_leaves=int(tj.num_leaves), **fields)


@pytest.mark.parametrize("name", ["budget31", "budget15", "random"])
def test_resume_matches_jax(name):
    """The same phase-1 tree (the JAX package's) resumed by both."""
    make, L, extra = CASES[name]
    d, cfg = make(), _config(extra, L)
    ja, ta = _args(d, cfg, "jax"), _args(d, cfg, "port")
    t1, lid1 = jax_depthwise(*ja, num_bins=d["B"], max_leaves=L,
                             stop_before_budget=4)
    assert 1 < int(t1.num_leaves) < L
    tj, lid_j = jax_grow_tree(*ja, num_bins=d["B"], max_leaves=L,
                              init_tree=t1, init_leaf_id=lid1)
    port_serial.HOST_SYNCS = 0
    tt, lid_t = grow_tree(*ta, num_bins=d["B"], max_leaves=L,
                          init_tree=_host_tree(t1),
                          init_leaf_id=torch.from_numpy(np.array(lid1)))
    _assert_same_tree(tt, lid_t, tj, lid_j)
    # one read for the resume, two per best-first split
    assert port_serial.HOST_SYNCS == 1 + 2 * (tt.num_leaves
                                              - int(t1.num_leaves))


def test_resume_refuses_the_record_route():
    d, cfg = _setup(n=500), _config(dict(min_data_in_leaf=20), 7)
    ta = _args(d, cfg, "port")
    t1, lid1 = grow_tree_depthwise(*ta, num_bins=d["B"], max_leaves=7,
                                   stop_before_budget=4, tree_device="cpu")
    with pytest.raises(ValueError, match="order route"):
        grow_tree(*ta, num_bins=d["B"], max_leaves=7,
                  hist_fn_raw=histogram_record_window, init_tree=t1,
                  init_leaf_id=lid1)


@pytest.mark.parametrize("name", ["budget31", "budget15", "max_depth3",
                                  "random"])
def test_hybrid_matches_jax(name):
    make, L, extra = CASES[name]
    d, cfg = make(), _config(extra, L)
    tj, lid_j = jax_hybrid(*_args(d, cfg, "jax"), num_bins=d["B"],
                           max_leaves=L)
    tt, lid_t = grow_tree_hybrid(*_args(d, cfg, "port"), num_bins=d["B"],
                                 max_leaves=L)
    _assert_same_tree(tt, lid_t, tj, lid_j)


def test_hybrid_phase1_never_truncates():
    """tests/test_hybrid.py's bound on the port: phase 1 hands over with
    at most ~L/2 leaves."""
    rng = np.random.RandomState(3)
    n, F, B, L = 20_000, 10, 32, 31
    d = dict(bins=rng.randint(0, B, size=(F, n)).astype(np.uint8),
             grad=rng.randn(n).astype(np.float32),
             hess=(np.abs(rng.randn(n)) + 0.1).astype(np.float32),
             bag=np.ones(n, np.float32), fmask=np.ones(F, bool),
             nbpf=np.full(F, B, np.int32), iscat=np.zeros(F, bool), B=B)
    t1, _ = grow_tree_depthwise(*_args(d, dict(min_data_in_leaf=5), "port"),
                                num_bins=B, max_leaves=L,
                                stop_before_budget=HYBRID_STOP_FACTOR)
    assert t1.num_leaves * 2 <= L + 1


# ------------------------------------------------------------ the slice
def _case_small():
    rng = np.random.RandomState(12)
    X = rng.randn(2000, 6)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + 0.3 * rng.randn(2000) > 0).astype(
        np.float32)
    return X, y, {"num_leaves": 15}, 32


def _case_bagged():
    rng = np.random.RandomState(3)
    X = rng.randn(1500, 10)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + 0.3 * rng.randn(1500) > 0).astype(
        np.float32)
    return X, y, {"num_leaves": 31, "bagging_fraction": 0.8,
                  "bagging_freq": 1, "feature_fraction": 0.8}, 63


@pytest.fixture(scope="module",
                params=[("depthwise", "small"), ("hybrid", "small"),
                        ("depthwise", "bagged"), ("hybrid", "bagged")],
                ids=lambda p: "-".join(p))
def trained(request):
    growth, case = request.param
    X, y, extra, mb = {"small": _case_small, "bagged": _case_bagged}[case]()
    params = {"objective": "binary", "min_data_in_leaf": 20,
              "hist_impl": "matmul", "tree_growth": growth, "verbose": -1,
              **extra}
    bj = jax_engine.train(dict(params), lgb.Dataset(X, label=y, max_bin=mb),
                          num_boost_round=3, verbose_eval=False)
    bt = lt.train(dict(params), lt.Dataset(X, label=y, max_bin=mb,
                                           device="cpu"),
                  num_boost_round=3, device="cpu")
    return X, bj, bt


def test_train_trees_match_jax(trained):
    _, bj, bt = trained
    tj, tt = bj._gbdt.models, bt._gbdt.models
    assert len(tj) == len(tt) == 3
    for a, b in zip(tj, tt):
        assert int(a.num_leaves) == b.num_leaves > 4
        for k in STRUCT + ("split_feature_real", "threshold_real"):
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=k)
        for k in VALUES:
            np.testing.assert_allclose(getattr(b, k).numpy(),
                                       np.asarray(getattr(a, k)), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(b.split_gain.numpy(),
                                   np.asarray(a.split_gain), rtol=1e-4,
                                   atol=1e-6)


def test_train_predictions_match_jax(trained):
    X, bj, bt = trained
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


@pytest.mark.parametrize("growth", ["leafwise", "depthwise", "hybrid"])
def test_uint16_bins_train_like_jax(growth):
    """More than 256 bins (uint16) on the CPU, where leaf-wise and hybrid
    growth gather bins on the order route: the JAX package's trees (its
    segment-sum histograms)."""
    rng = np.random.RandomState(8)
    X = rng.randn(1800, 4)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(1800) > 0).astype(
        np.float32)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 400,
              "min_data_in_leaf": 20, "tree_growth": growth, "verbose": -1}
    bj = jax_engine.train(dict(params), lgb.Dataset(X, label=y, max_bin=400),
                          num_boost_round=2, verbose_eval=False)
    bt = lt.train(dict(params), lt.Dataset(X, label=y, max_bin=400,
                                           device="cpu"), 2, device="cpu")
    assert bt._gbdt._bins_T.dtype == torch.uint16
    for a, b in zip(bj._gbdt.models, bt._gbdt.models):
        assert int(a.num_leaves) == b.num_leaves > 4
        for k in STRUCT:
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=k)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


def test_level_growth_keeps_the_leafwise_route_knobs(monkeypatch):
    """Under bsub the leaf-wise learner leaves the record and mega routes
    (gbdt.py:418-424); the card's default is the record-window histogram."""
    X, y, _, _ = _case_small()
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1},
                   lt.Dataset(X, label=y, device="cpu"), 1, device="cpu")
    gb = bst._gbdt
    assert gb._leafwise_hist_fn_raw() is None  # the CPU: the order route
    gb.device = torch.device("cuda")  # the route choice only reads the type
    monkeypatch.delenv("LGBM_TPU_HIST_KERNEL", raising=False)
    assert gb._leafwise_hist_fn_raw() is histogram_record_window
    monkeypatch.setenv("LGBM_TPU_HIST_KERNEL", "bsub")
    assert gb._leafwise_hist_fn_raw() is None
    monkeypatch.setenv("LGBM_TPU_HIST_KERNEL", "v3")
    with pytest.raises(ValueError, match="variant"):
        gb._leafwise_hist_fn_raw()


@pytest.mark.parametrize("growth", ["depthwise", "hybrid"])
def test_gbdt_grows_through_the_level_histogram(growth, monkeypatch):
    """``train`` hands the learner the level histogram (and, for hybrid,
    the single-leaf one), as gbdt.py:274-293 does."""
    import lightgbm_tpu_torch.models.gbdt as port_gbdt

    X, y, _, _ = _case_small()
    seen = []
    for name in ("grow_tree_depthwise", "grow_tree_hybrid"):
        real = getattr(port_gbdt, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen.append((_name, sorted(kw)))
            return _real(*a, **kw)
        monkeypatch.setattr(port_gbdt, name, spy)
    lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
              "tree_growth": growth},
             lt.Dataset(X, label=y, device="cpu"), 2, device="cpu")
    want = (["hist_fn"] if growth == "depthwise"
            else ["hist_fn", "level_hist_fn"])
    assert seen == [(f"grow_tree_{growth}", want)] * 2


def test_gbdt_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GBDT(Config(objective="binary"))
    assert GBDT(Config(objective="binary"), device="cpu").device.type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("growth", ["depthwise", "hybrid"])
def test_card_trees_match_cpu_trees(growth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    X, y, extra, mb = _case_bagged()
    params = {"objective": "binary", "tree_growth": growth, "verbose": -1,
              **extra}
    trees = [lt.train(dict(params), lt.Dataset(X, label=y, max_bin=mb,
                                               device=dev),
                      2, device=dev)._gbdt.models for dev in ("cuda", "cpu")]
    for a, b in zip(*trees):
        assert a.num_leaves == b.num_leaves
        for k in STRUCT:
            assert torch.equal(getattr(a, k).cpu(), getattr(b, k)), k
