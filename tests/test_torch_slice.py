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

The record route (``grow_tree(..., hist_fn_raw=...)``) is held against the
JAX package's record route (its raw histogram and fused search-update
kernels in interpret mode, the mega kernel switched off) on
tests/test_opt_layout.py's four cases, whose integer-valued gradients make
every histogram sum exact in any order; and against the port's own order
route, which it must match bitwise.  The mega route (``grow_tree(...,
hist_fn_raw=..., fuse_hist=True)``) is held against the JAX package's mega
route (``split_step_window`` in interpret mode) on the same four cases.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.engine as jax_engine
import lightgbm_tpu.learners.serial as jax_serial
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.learners.serial import TreeLearnerParams as JaxParams
from lightgbm_tpu.learners.serial import grow_tree as jax_grow_tree
from lightgbm_tpu.metrics import AUCMetric as JaxAUC
from lightgbm_tpu.io.metadata import Metadata as JaxMetadata
from lightgbm_tpu.ops.pallas_histogram import histogram_single_leaf_raw

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
import lightgbm_tpu_torch.learners.serial as port_serial
import lightgbm_tpu_torch.models.gbdt as port_gbdt
from lightgbm_tpu_torch.learners.serial import TreeLearnerParams, grow_tree
from lightgbm_tpu_torch.metrics import auc
from lightgbm_tpu_torch.models.gbdt import GBDT, fuse_hist_fits
from lightgbm_tpu_torch.ops.cuda_histogram import histogram_record_window

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


# ------------------------------------------------------------ record route
TREE_FIELDS = STRUCT + ("split_gain", "internal_value", "internal_count",
                        "leaf_value")


def _opt_case(name):
    """tests/test_opt_layout.py's cases: (bins [F, n], grad, hess, bag,
    fmask, nbpf, iscat, num_bins, min_data)."""
    if name == "u16_feature_mask":
        rng = np.random.RandomState(5)
        n, F, B = 3000, 5, 300
        bins = rng.randint(0, B, (n, F)).T.astype(np.uint16)
        grad = rng.randint(-8, 9, n).astype(np.float32)
        hess = rng.randint(1, 5, n).astype(np.float32)
        fmask = np.array([True, False, True, True, False])
        return (bins, grad, hess, np.ones(n, np.float32), fmask,
                np.full(F, B, np.int32), np.zeros(F, bool), B, 3)
    seed = {"seed0": 0, "seed3": 3, "bagging_categorical": 1}[name]
    rng = np.random.RandomState(seed)
    n, F, B = 4000, 7, 23
    bins = rng.randint(0, B, (n, F)).T.astype(np.uint8)
    grad = rng.randint(-8, 9, n).astype(np.float32)
    hess = rng.randint(1, 5, n).astype(np.float32)
    bag, iscat, min_data = np.ones(n, np.float32), np.zeros(F, bool), 1
    if name == "bagging_categorical":
        bag = (np.random.RandomState(7).rand(n) < 0.7).astype(np.float32)
        iscat[2] = True
        min_data = 5
    return (bins, grad, hess, bag, np.ones(F, bool), np.full(F, B, np.int32),
            iscat, B, min_data)


@pytest.mark.parametrize("name", ["seed0", "seed3", "bagging_categorical",
                                  "u16_feature_mask"])
def test_record_route_matches_jax_record_route(name, monkeypatch):
    bins, grad, hess, bag, fmask, nbpf, iscat, B, min_data = _opt_case(name)
    L = 16
    # the JAX record route: raw histogram + partition_window +
    # search2_update_pallas (serial.py:817-829/874-889/944-965), not the
    # mega kernel; read in grow_tree's Python, so no stale trace
    monkeypatch.setattr(jax_serial, "_FUSE_HIST_ENV", False)

    def raw(b, g, h, m):
        return histogram_single_leaf_raw(b, g, h, m, num_bins=B,
                                         interpret=True)

    f32 = jnp.float32
    tj, lid_j = jax_grow_tree(
        *(jnp.asarray(a) for a in (bins, grad, hess, bag, fmask, nbpf,
                                   iscat)),
        JaxParams(f32(min_data), f32(0), f32(0), f32(0), f32(0),
                  jnp.int32(-1)),
        num_bins=B, max_leaves=L, hist_fn_raw=raw)
    tt, lid_t = grow_tree(
        *(torch.from_numpy(a) for a in (bins, grad, hess, bag, fmask, nbpf,
                                        iscat)),
        TreeLearnerParams(float(min_data), 0.0, 0.0, 0.0, 0.0, -1),
        num_bins=B, max_leaves=L, hist_fn_raw=histogram_record_window)
    assert tt.num_leaves == int(tj.num_leaves) > 4
    for k in STRUCT:
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(tj, k)), err_msg=k)
    np.testing.assert_array_equal(lid_t.numpy(), np.asarray(lid_j))
    for k in ("leaf_value", "internal_value", "split_gain"):
        np.testing.assert_allclose(getattr(tt, k).numpy(),
                                   np.asarray(getattr(tj, k)), rtol=2e-5,
                                   atol=2e-5, err_msg=k)
    used = tt.split_feature.numpy()[:tt.num_leaves - 1]
    assert not np.isin(used, np.flatnonzero(~fmask)).any()


def _train_routes(monkeypatch, route: str):
    """The wide case through ``train`` on the CPU, on the mega or record
    route (the card's, forced here) or the order route; returns the
    booster and every tree's leaf_id."""
    X, y, extra, max_bin = _case_wide()
    leaf_ids = []
    grow = GBDT.grow

    def spy(self, *a):
        out = grow(self, *a)
        leaf_ids.append(out[1].clone())
        return out

    params = {"objective": "binary", "min_data_in_leaf": 20,
              "verbose": -1, **extra}
    raw = None if route == "order" else histogram_record_window
    with monkeypatch.context() as mp:
        mp.setattr(GBDT, "grow", spy)
        mp.setattr(GBDT, "_leafwise_hist_fn_raw", lambda self: raw)
        mp.setenv("LGBM_TPU_FUSE_HIST", "0" if route == "record" else "1")
        bst = lt.train(params, lt.Dataset(X, label=y, max_bin=max_bin,
                                          device="cpu"),
                       num_boost_round=3, device="cpu")
    return bst, leaf_ids


def test_record_route_bitwise_equals_order_route(monkeypatch):
    b_rec, lid_rec = _train_routes(monkeypatch, "record")
    b_ord, lid_ord = _train_routes(monkeypatch, "order")
    trees_r, trees_o = b_rec._gbdt.models, b_ord._gbdt.models
    assert len(trees_r) == len(trees_o) == 3
    for a, b in zip(trees_r, trees_o):
        assert a.num_leaves == b.num_leaves > 4
        for k in TREE_FIELDS:
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert len(lid_rec) == len(lid_ord) == 3
    for a, b in zip(lid_rec, lid_ord):
        assert torch.equal(a, b)
    assert torch.equal(b_rec._gbdt._scores, b_ord._gbdt._scores)


def test_record_route_is_off_on_the_cpu():
    X, y = _case_small()[:2]
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1},
                   lt.Dataset(X, label=y, device="cpu"), 1, device="cpu")
    assert bst._gbdt._leafwise_hist_fn_raw() is None


# -------------------------------------------------------------- mega route
@pytest.mark.parametrize("name", ["seed0", "seed3", "bagging_categorical",
                                  "u16_feature_mask"])
def test_mega_route_matches_jax_mega_route(name, monkeypatch):
    import lightgbm_tpu.ops.record as jax_record

    bins, grad, hess, bag, fmask, nbpf, iscat, B, min_data = _opt_case(name)
    L = 16
    # the JAX mega route (serial.py:774-816): split_step_window + the
    # placement, both in interpret mode.  The spy fails the test if the
    # JAX side took another route; grow_tree imports the kernel from the
    # module when it traces, and the fresh ``raw`` closure forces a trace.
    monkeypatch.setattr(jax_serial, "_FUSE_HIST_ENV", True)
    calls = []
    step = jax_record.split_step_window

    def spy(*a, **kw):
        calls.append(kw["cap"])
        return step(*a, **kw)

    monkeypatch.setattr(jax_record, "split_step_window", spy)

    def raw(b, g, h, m):
        return histogram_single_leaf_raw(b, g, h, m, num_bins=B,
                                         interpret=True)

    f32 = jnp.float32
    tj, lid_j = jax_grow_tree(
        *(jnp.asarray(a) for a in (bins, grad, hess, bag, fmask, nbpf,
                                   iscat)),
        JaxParams(f32(min_data), f32(0), f32(0), f32(0), f32(0),
                  jnp.int32(-1)),
        num_bins=B, max_leaves=L, hist_fn_raw=raw)
    assert calls, "the JAX side did not take its mega route"
    tt, lid_t = grow_tree(
        *(torch.from_numpy(a) for a in (bins, grad, hess, bag, fmask, nbpf,
                                        iscat)),
        TreeLearnerParams(float(min_data), 0.0, 0.0, 0.0, 0.0, -1),
        num_bins=B, max_leaves=L, hist_fn_raw=histogram_record_window,
        fuse_hist=True)
    assert tt.num_leaves == int(tj.num_leaves) > 4
    for k in STRUCT:
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(tj, k)), err_msg=k)
    np.testing.assert_array_equal(lid_t.numpy(), np.asarray(lid_j))
    for k in ("leaf_value", "internal_value", "split_gain"):
        np.testing.assert_allclose(getattr(tt, k).numpy(),
                                   np.asarray(getattr(tj, k)), rtol=2e-5,
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("F,B", [(28, 255), (1100, 256), (248, 256),
                                 (256, 256), (7, 23), (5, 300), (64, 1000)])
def test_fuse_hist_gate_is_the_jax_gate(F, B):
    """The port's gate is serial.py:520-536's under prefix routing: the
    bench shape takes the mega route, F=1100 x 256 bins the record
    route."""
    from lightgbm_tpu.ops.pallas_histogram import FGROUP
    from lightgbm_tpu.ops.record import ROUTING

    assert ROUTING == "prefix"  # the JAX default, whose gate is 4 MiB
    jax_gate = (jax_serial._round_up(F, FGROUP)
                * jax_serial._round_up(B, 128) * 16 <= (1 << 22))
    assert fuse_hist_fits(F, B) == jax_gate
    assert fuse_hist_fits(28, 255) and not fuse_hist_fits(1100, 256)


def test_route_knobs(monkeypatch):
    """``train`` hands grow_tree the route the knobs select: the order
    route on the CPU; with a record-window histogram (the card's) the mega
    route by default and the record route under LGBM_TPU_FUSE_HIST=0,
    read per call."""
    X, y = _case_small()[:2]
    seen = []

    def spy(*a, **kw):
        seen.append((kw["hist_fn_raw"], kw["fuse_hist"]))
        return grow_tree(*a, **kw)

    monkeypatch.setattr(port_gbdt, "grow_tree", spy)
    monkeypatch.delenv("LGBM_TPU_FUSE_HIST", raising=False)
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1},
                   lt.Dataset(X, label=y, device="cpu"), 1, device="cpu")
    assert seen == [(None, False)]
    gb = bst._gbdt
    monkeypatch.setattr(GBDT, "_leafwise_hist_fn_raw",
                        lambda self: histogram_record_window)
    for env, fuse in ((None, True), ("0", False), ("1", True)):
        if env is None:
            monkeypatch.delenv("LGBM_TPU_FUSE_HIST", raising=False)
        else:
            monkeypatch.setenv("LGBM_TPU_FUSE_HIST", env)
        gb.train_one_iter()
        assert seen[-1] == (histogram_record_window, fuse)


def test_mega_route_host_syncs(monkeypatch):
    """Through ``train`` on the CPU with the mega route forced: one host
    sync per split and two per tree at the root, against two per split on
    the record route."""
    syncs = {}
    for route in ("mega", "record"):
        port_serial.HOST_SYNCS = 0
        bst, _ = _train_routes(monkeypatch, route)
        splits = sum(t.num_leaves - 1 for t in bst._gbdt.models)
        syncs[route] = (port_serial.HOST_SYNCS, splits)
    assert syncs["mega"][0] == 2 * 3 + syncs["mega"][1]
    assert syncs["record"][0] == 2 * 3 + 2 * syncs["record"][1]
