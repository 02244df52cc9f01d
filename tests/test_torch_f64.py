"""``hist_dtype=float64`` in the port against the JAX package under x64.

The JAX package grows float64 trees on its segment-sum route (no Pallas
kernel under float64, models/gbdt.py:395-399): ``histogram_feature_major``
and ``histogram_by_leaf`` summed in float64, the jnp search in float64
and a float64 best-split table, cast to a float32 tree at the end.  The
port sums the objective's float32 row stats widened to float64, in its
kernels' 2,048-row chunk order (kernels 1-f64, 1''-f64 and 3-f64 on the
card, the plain versions here).  At most 2,048 rows a leaf that order is
each bin's rows in row order, the JAX package's, so:

* the plain float64 histograms are bitwise the JAX package's there, and
  above it the counts are bitwise and the sums within rtol 1e-12;
* the float64 search rows, the root sums and the pooled slot count are
  bitwise the JAX package's;
* whole trainings through ``lt.train`` (leaf-wise, pooled, regression,
  multiclass K = 3, DART, a custom ``fobj``) of two rounds at 1,500 rows
  give trees bitwise in every field and equal predictions; at 5,000 rows
  the trees are structurally identical and every float field within one
  float32 ulp.  (From the third tree on, the two packages' float32 train
  scores part in the last bit on some rows, in float32 as well, so later
  trees are not compared here.)

The JAX package's depthwise and hybrid growers raise under x64 (ROADMAP
C9), so the port's float64 depthwise and hybrid trees are held on
exact-sum data (gradients on a dyadic grid: every sum is exact in
float32 and float64) against the JAX package's float32 trees and the
port's own float32 trees, and their first two levels on rounding sums
against the JAX package's float64 histogram and search composed level by
level (where a float32 ranking would tie, too).  The envelope (more than 2**24 rows only under
float64), the CLI and the training API close the file.  The kernels
themselves are held against these plain versions on the card
(tests/test_torch_f64_card.py, chip_smoke.py phase 22)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.engine as jax_engine
from lightgbm_tpu.compat import enable_x64
from lightgbm_tpu.ops.histogram import histogram_by_leaf as jax_by_leaf
from lightgbm_tpu.ops.histogram import histogram_feature_major as jax_fm
from lightgbm_tpu.ops.split import find_best_split_leaves as jax_find

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.learners.serial import _root_sums
from lightgbm_tpu_torch.models.gbdt import (F32_COUNT_EXACT_ROWS, GBDT,
                                            check_count_envelope)
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ops import KERNEL_COUNTERS, cuda_histogram
from lightgbm_tpu_torch.ops import cuda_search
from lightgbm_tpu_torch.ops.cuda_histogram import (histogram_by_leaf_sorted,
                                                   histogram_single_leaf)
from lightgbm_tpu_torch.ops.cuda_search import pack_meta, search2_rows

F64 = torch.float64
STRUCT = ("split_feature", "threshold_bin", "decision_type", "left_child",
          "right_child", "leaf_count", "leaf_parent", "leaf_depth",
          "split_feature_real")
FLOATS = ("threshold_real", "split_gain", "internal_value",
          "internal_count", "leaf_value")


def _rows(n, F, B, dt=np.uint8, seed=0):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, n)).astype(dt)
    g = rng.randn(n).astype(np.float32)
    h = (np.abs(rng.randn(n)) + 0.01).astype(np.float32)
    m = (rng.rand(n) < 0.8).astype(np.float32)
    return bins, g, h, m


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------ histograms
@pytest.mark.parametrize("F,n,B,dt", [(5, 700, 37, np.uint8),
                                      (6, 2048, 255, np.uint8),
                                      (3, 1500, 300, np.uint16),
                                      (4, 5000, 63, np.uint8)],
                         ids=["700", "2048", "u16x300", "5000"])
def test_single_leaf_matches_jax(F, n, B, dt):
    """The plain float64 single-row-set histogram (kernel 1-f64's) against
    the JAX package's float64 segment sum: bitwise at <= 2,048 rows; above
    that the counts bitwise and the sums within rtol 1e-12."""
    bins, g, h, m = _rows(n, F, B, dt)
    port = histogram_single_leaf(*_t(bins, g, h, m), B,
                                 acc_dtype=F64).numpy()
    with enable_x64(True):
        ref = np.asarray(jax_fm(jnp.asarray(bins),
                                jnp.asarray(g).astype(jnp.float64),
                                jnp.asarray(h).astype(jnp.float64),
                                jnp.asarray(m), num_bins=B))
    assert port.dtype == ref.dtype == np.float64
    if n <= 2048:
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_array_equal(port[..., 2], ref[..., 2])
        np.testing.assert_allclose(port, ref, rtol=1e-12, atol=0)
    # the float32 path is unchanged by the dtype argument
    np.testing.assert_array_equal(
        histogram_single_leaf(*_t(bins, g, h, m), B).numpy(),
        histogram_single_leaf(*_t(bins, g, h, m), B,
                              acc_dtype=torch.float32).numpy())


@pytest.mark.parametrize("n,L,big", [(3000, 7, False), (6000, 3, True)],
                         ids=["small-leaves", "big-leaf"])
def test_level_histogram_matches_jax(n, L, big):
    """The plain float64 level histogram (kernel 1''-f64's) against the JAX
    package's float64 ``histogram_by_leaf``: bitwise where every leaf holds
    at most 2,048 rows (one of them empty); a leaf of more rows keeps its
    counts bitwise and its sums within rtol 1e-12."""
    F, B = 5, 63
    bins, g, h, m = _rows(n, F, B, seed=3)
    rng = np.random.RandomState(4)
    if big:
        lid = np.where(rng.rand(n) < 0.8, 0, rng.randint(1, L, n))
    else:
        lid = rng.randint(0, L - 1, n)  # leaf L-1 stays empty
    lid = lid.astype(np.int32)
    port = histogram_by_leaf_sorted(
        *_t(bins), torch.from_numpy(lid), *_t(g, h, m), B, L,
        acc_dtype=F64).numpy()
    with enable_x64(True):
        ref = np.asarray(jax_by_leaf(
            jnp.asarray(bins), jnp.asarray(lid),
            jnp.asarray(g).astype(jnp.float64),
            jnp.asarray(h).astype(jnp.float64), jnp.asarray(m),
            num_bins=B, num_leaves=L))
    assert port.dtype == np.float64
    if not big:
        assert np.bincount(lid, minlength=L).max() <= 2048
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_array_equal(port[..., 2], ref[..., 2])
        np.testing.assert_allclose(port, ref, rtol=1e-12, atol=0)


def test_root_sums_match_jax():
    """The float64 root sums: the float32 rows widened, then summed in row
    order — the JAX package's one-segment segment_sum (serial.py:585-589)
    bitwise; the count exact."""
    _, g, h, m = _rows(70_001, 1, 2, seed=9)
    port = _root_sums(*_t(g, h, m), F64)
    with enable_x64(True):
        gd = jnp.asarray(g).astype(jnp.float64)
        hd = jnp.asarray(h).astype(jnp.float64)
        mm = jnp.asarray(m)
        ref = np.asarray(jax.ops.segment_sum(
            jnp.stack([gd * mm, hd * mm], -1), jnp.zeros(g.size, jnp.int32),
            num_segments=1)[0])
    assert port.dtype == np.float64
    np.testing.assert_array_equal(port[:2], ref)
    assert port[2] == m.sum(dtype=np.float64)


# ---------------------------------------------------------------- search
@pytest.mark.parametrize("seed", range(8))
def test_search_rows_match_jax(seed):
    """``search2_rows`` on float64 histograms (kernel 3-f64's plain
    version) against the JAX package's ``find_best_split_leaves`` under
    x64: all eleven fields bitwise, float64 rows."""
    rng = np.random.RandomState(seed)
    F, B = 6, 300
    hists, tots = [], []
    for _ in range(2):
        bins, g, h, m = _rows(2500, F, B, seed=rng.randint(1 << 30))
        hd = histogram_single_leaf(*_t(bins, g, h, m), B, acc_dtype=F64)
        hists.append(hd)
        tots.append(_root_sums(*_t(g, h, m), F64))
    nbpf = rng.randint(20, B + 1, F).astype(np.int32)
    is_cat = np.zeros(F, bool)
    is_cat[rng.randint(F)] = True
    fmask = rng.rand(F) < 0.85
    consts = [20.0, 1e-3, 0.0 if seed % 2 else 0.5, 1.0, 0.0]
    meta = pack_meta(torch.from_numpy(fmask), torch.from_numpy(nbpf),
                     torch.from_numpy(is_cat), "cpu")
    (lsg, lsh, lc), (rsg, rsh, rc) = tots
    rows = search2_rows(hists[0], hists[1],
                        [1.0, lsg, lsh, lc, rsg, rsh, rc] + consts,
                        meta).numpy()
    assert rows.dtype == np.float64 and not rows[:, 11:].any()
    with enable_x64(True):
        res = jax_find(jnp.asarray(np.stack([x.numpy() for x in hists])),
                       jnp.asarray([lsg, rsg]), jnp.asarray([lsh, rsh]),
                       jnp.asarray([lc, rc]), jnp.asarray(fmask),
                       jnp.asarray(nbpf), jnp.asarray(is_cat),
                       *[jnp.float32(c) for c in consts],
                       jnp.asarray([True, True]))
        ref = np.stack([np.asarray(a).astype(np.float64) for a in res], 1)
    np.testing.assert_array_equal(rows[:, :11], ref)


# ------------------------------------------------------------ whole slice
def _data(n, objective, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    z = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] - 0.4 * X[:, 3] ** 2
    if objective == "regression":
        return X, (z + 0.3 * rng.randn(n)).astype(np.float32)
    if objective == "multiclass":
        return X, np.digitize(z, [-0.5, 0.5]).astype(np.float32)
    return X, (z + 0.5 * rng.randn(n) > 0).astype(np.float32)


def _logloss_fobj(preds, train_data):
    """The binary logloss gradients in numpy, for both packages."""
    y = np.asarray(train_data.get_label(), np.float64)
    p = 1.0 / (1.0 + np.exp(-np.asarray(preds, np.float64)))
    return (p - y).astype(np.float32), (p * (1.0 - p)).astype(np.float32)


CASES = {
    "leafwise": ({"objective": "binary"}, None),
    # a 3-slot pool of 8-byte slots (F * B * 3 * 8 bytes each)
    "pooled": ({"objective": "binary", "histogram_pool_size": 0.03}, None),
    "regression": ({"objective": "regression"}, None),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, None),
    "dart": ({"objective": "binary", "boosting_type": "dart",
              "drop_rate": 0.5, "skip_drop": 0.0}, None),
    "fobj": ({"objective": "none"}, _logloss_fobj),
}


def _train_both(name, n, rounds=2):
    extra, fobj = CASES[name]
    params = {"num_leaves": 15, "min_data_in_leaf": 10, "max_bin": 63,
              "hist_dtype": "float64", "verbose": -1, **extra}
    X, y = _data(n, "binary" if fobj else extra["objective"])
    bj = jax_engine.train(dict(params), lgb.Dataset(X, label=y, max_bin=63),
                          num_boost_round=rounds, fobj=fobj,
                          verbose_eval=False)
    bt = lt.train(dict(params), lt.Dataset(X, label=y, max_bin=63,
                                           device="cpu"),
                  num_boost_round=rounds, fobj=fobj, device="cpu")
    return X, bj, bt


def _ulps(a, b):
    """Float32 ulps between a and b, elementwise."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    gap = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return gap / np.spacing(np.maximum(np.abs(a), np.abs(b)))


@pytest.mark.parametrize("name", list(CASES))
def test_trains_bitwise_as_jax_at_small_leaves(name):
    """At 1,500 rows (every leaf within one 2,048-row chunk) the float64
    trees of two rounds are the JAX package's bitwise in every field, and
    so are the raw predictions."""
    X, bj, bt = _train_both(name, 1500)
    tj, tt = bj._gbdt.models, bt._gbdt.models
    assert len(tj) == len(tt) > 0
    assert sum(t.num_leaves for t in tt) > 2 * len(tt)
    for a, b in zip(tj, tt):
        assert int(a.num_leaves) == b.num_leaves
        for k in STRUCT + FLOATS:
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=k)
    np.testing.assert_array_equal(bt.predict(X, raw_score=True),
                                  np.asarray(bj.predict(X, raw_score=True)))
    if name == "pooled":
        slots = bt._gbdt._hist_pool_slots()
        assert slots == bj._gbdt._hist_pool_slots()
        assert 2 <= slots < 15


@pytest.mark.parametrize("name", ["leafwise", "pooled", "multiclass"])
def test_trains_as_jax_above_a_chunk(name):
    """At 5,000 rows (leaves of several 2,048-row chunks, summed in
    another order than the JAX package's row order) the trees are
    structurally identical and every float field is within one float32
    ulp."""
    _, bj, bt = _train_both(name, 5000, rounds=2)
    for a, b in zip(bj._gbdt.models, bt._gbdt.models):
        assert int(a.num_leaves) == b.num_leaves
        for k in STRUCT:
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=k)
        for k in FLOATS:
            assert _ulps(getattr(b, k).numpy(),
                         np.asarray(getattr(a, k))).max() <= 1, k


# ----------------------------------------------- depthwise and hybrid (C9)
def _dyadic_fobj(preds, train_data):
    """Gradients on a dyadic grid, fixed by the label and the row: every
    histogram sum is exact in float32 and in float64."""
    y = np.asarray(train_data.get_label())
    n = y.size
    g = np.where(y > 0, -1.0, 1.0) * np.where(np.arange(n) % 3, 1.0, 0.5)
    return g.astype(np.float32), np.ones(n, np.float32)


def _exact(pkg, hist_dtype, growth, Dataset, **kw):
    X, y = _data(3000, "binary", seed=8)
    params = {"objective": "none", "num_leaves": 15, "min_data_in_leaf": 20,
              "max_bin": 63, "tree_growth": growth, "hist_dtype": hist_dtype,
              "verbose": -1}
    return pkg.train(params, Dataset(X, label=y, max_bin=63, **kw), 3,
                     fobj=_dyadic_fobj, **kw).__getattribute__(
                         "_gbdt").models


@pytest.mark.parametrize("growth", ["depthwise", "hybrid"])
def test_depthwise_hybrid_on_exact_sums(growth):
    """Where the JAX package raises under float64 (ROADMAP C9): on exact-sum
    data the port's float64 trees are the JAX package's float32 trees
    structurally and the port's own float32 trees bitwise in structure
    and leaf values."""
    with pytest.raises(TypeError):  # C9: the JAX package's own fault
        _exact(jax_engine, "float64", growth, lgb.Dataset)
    f64 = _exact(lt, "float64", growth, lt.Dataset, device="cpu")
    f32 = _exact(lt, "float32", growth, lt.Dataset, device="cpu")
    ref = _exact(jax_engine, "float32", growth, lgb.Dataset)
    assert sum(t.num_leaves for t in f64) > 3 * 8
    for a, b, c in zip(ref, f32, f64):
        assert int(a.num_leaves) == b.num_leaves == c.num_leaves
        for k in STRUCT:
            np.testing.assert_array_equal(c.__getattribute__(k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=k)
            np.testing.assert_array_equal(c.__getattribute__(k).numpy(),
                                          getattr(b, k).numpy(), err_msg=k)
        np.testing.assert_array_equal(c.leaf_value.numpy(),
                                      b.leaf_value.numpy())


def _level_data(case):
    """Rows and float32 gradients fixed by the row.  "gaussian": the sums
    round, and round differently in float32 and float64.  "mirrored": rows
    A and B alike but for feature 0, which parts them at the root, and B's
    gradients the negation of A's with one of them moved by a float32 ulp:
    level 1's two gains differ in float64 and tie in float32, so the order
    of its nodes shows the precision of the level's ranking."""
    if case == "gaussian":
        X, _ = _data(3000, "binary", seed=8)
        rng = np.random.RandomState(11)
        return X, (rng.randn(3000).astype(np.float32),
                   (np.abs(rng.randn(3000)) + 0.1).astype(np.float32))
    rng = np.random.RandomState(12)
    half = 1500
    Xa = rng.randn(half, 5)
    X = np.vstack([np.c_[np.zeros(half), Xa], np.c_[np.ones(half), Xa]])
    ga = (np.where(Xa[:, 1] > 0, 1.0, -0.2)
          + 0.3 * rng.randn(half)).astype(np.float32)
    ha = (np.abs(rng.randn(half)) + 0.1).astype(np.float32)
    g, h = np.concatenate([ga, -ga]), np.concatenate([ha, ha])
    g[half + 1] = np.nextafter(g[half + 1], np.float32(np.inf))
    return X, (g, h)


def _jax_levels(bins, g, h, nbpf, is_cat, consts, num_bins):
    """The first two levels of the JAX package's depthwise grower composed
    from its x64 building blocks (the grower itself raises, C9): the
    float64 ``histogram_by_leaf``, the leaf totals of
    learners/depthwise.py:108 and ``find_best_split_leaves``; the rows go
    right of the root split for level 1.  Each level's SplitResult as
    float64 numpy arrays."""
    F, n = bins.shape
    levels, lid = [], np.zeros(n, np.int32)
    with enable_x64(True):
        gd, hd = (jnp.asarray(a).astype(jnp.float64) for a in (g, h))
        for K in (1, 2):
            hist = jax_by_leaf(jnp.asarray(bins), jnp.asarray(lid), gd, hd,
                               jnp.ones(n, jnp.float32), num_bins=num_bins,
                               num_leaves=K)
            tot = jnp.sum(hist[:, 0, :, :], axis=1)
            res = jax_find(hist, tot[:, 0], tot[:, 1], tot[:, 2],
                           jnp.ones(F, bool), jnp.asarray(nbpf),
                           jnp.asarray(is_cat),
                           *[jnp.float32(c) for c in consts],
                           jnp.ones(K, bool))
            levels.append({k: np.asarray(v).astype(np.float64)
                           for k, v in res._asdict().items()})
            f, t = int(res.feature[0]), int(res.threshold[0])
            lid = (bins[f] > t).astype(np.int32)
    return levels


@pytest.mark.parametrize("case", ["gaussian", "mirrored"])
def test_depthwise_float64_levels_match_jax_composition(case):
    """The port's float64 depthwise tree of two levels against the JAX
    package's x64 histogram and search composed level by level: structure
    bitwise (the level's splits numbered in float64 gain order), and
    split_gain, internal_value, internal_count and leaf_value each the
    float64 value rounded once to float32 (the level results stay float64
    until the tree tables).  The port's float32 tree differs from it."""
    X, (g, h) = _level_data(case)
    params = {"objective": "none", "num_leaves": 4, "max_depth": 2,
              "min_data_in_leaf": 20, "max_bin": 63, "learning_rate": 1.0,
              "tree_growth": "depthwise", "verbose": -1}
    trees = {}
    for dt in ("float32", "float64"):
        bst = lt.train(dict(params, hist_dtype=dt),
                       lt.Dataset(X, label=np.zeros(len(g)), max_bin=63,
                                  device="cpu"), 1,
                       fobj=lambda preds, data: (g, h), device="cpu")
        trees[dt] = bst._gbdt.models[0]
    gb = bst._gbdt
    prm = gb._params
    consts = [prm.min_data_in_leaf, prm.min_sum_hessian_in_leaf,
              prm.lambda_l1, prm.lambda_l2, prm.min_gain_to_split]
    l0, l1 = _jax_levels(gb._bins_T.numpy(), g, h, gb._nbpf.numpy(),
                         gb._is_cat.numpy(), consts, gb._num_bins)
    assert (l1["gain"] > 0).all()
    if case == "mirrored":  # float32 would rank leaf 0 first
        assert l1["gain"][1] > l1["gain"][0]
        assert np.float32(l1["gain"][1]) == np.float32(l1["gain"][0])
    # level 1's splits take nodes 1, 2 in gain order, their right children
    # leaves 2, 3 (Tree::Split numbering)
    order = np.argsort(-l1["gain"], kind="stable")
    parent_out = (l0["left_output"][0], l0["right_output"][0])
    feat = [l0["feature"][0]] + [l1["feature"][lv] for lv in order]
    thr = [l0["threshold"][0]] + [l1["threshold"][lv] for lv in order]
    gain = [l0["gain"][0]] + [l1["gain"][lv] for lv in order]
    value = [0.0] + [parent_out[lv] for lv in order]
    count = [l0["left_count"][0] + l0["right_count"][0]] + [
        l1["left_count"][lv] + l1["right_count"][lv] for lv in order]
    leaf = np.zeros(4)
    for slot, lv in enumerate(order):
        leaf[lv] = l1["left_output"][lv]
        leaf[2 + slot] = l1["right_output"][lv]
    t64 = trees["float64"]
    assert t64.num_leaves == 4
    np.testing.assert_array_equal(t64.split_feature[:3].numpy(), feat)
    np.testing.assert_array_equal(t64.threshold_bin[:3].numpy(), thr)
    for k, want in (("split_gain", gain), ("internal_value", value),
                    ("internal_count", count), ("leaf_value", leaf)):
        got = getattr(t64, k).numpy()[:len(want)]
        np.testing.assert_array_equal(got, np.asarray(want, np.float32),
                                      err_msg=k)
    t32 = trees["float32"]
    assert any(not np.array_equal(getattr(t32, k).numpy(),
                                  getattr(t64, k).numpy())
               for k in ("split_gain", "internal_value", "leaf_value"))


# ----------------------------------------------------- envelope, pool, API
def test_count_envelope_boundary():
    """The port's ``check_count_envelope`` is the JAX package's rule
    (learners/serial.py:81-90; tests/test_tree_learner.py:283)."""
    assert F32_COUNT_EXACT_ROWS == 2 ** 24
    check_count_envelope(2 ** 24, "float32")
    check_count_envelope(2 ** 24 + 1, "float64")
    with pytest.raises(ValueError, match="hist_dtype=float64"):
        check_count_envelope(2 ** 24 + 1, "float32")


@pytest.mark.parametrize("hist_dtype", ["float32", "float64"])
def test_count_envelope_enforced_by_reset_training_data(monkeypatch,
                                                        hist_dtype):
    """A dataset of 2**24 + 1 rows (the row count patched): float32 is
    refused naming hist_dtype=float64, float64 is accepted."""
    X, y = _data(64, "binary")
    cfg = Config(objective="binary", num_leaves=4, hist_dtype=hist_dtype)
    ds = lt.Dataset(X, label=y, device="cpu").construct()
    monkeypatch.setattr(BinnedDataset, "num_data",
                        property(lambda self: 2 ** 24 + 1))
    obj = create_objective(cfg, ds.metadata, 64)
    if hist_dtype == "float32":
        with pytest.raises(ValueError, match="hist_dtype=float64"):
            GBDT(cfg, ds, obj, device="cpu")
    else:
        assert GBDT(cfg, ds, obj, device="cpu").num_data == 2 ** 24 + 1


def test_f64_counters_and_wrappers():
    """The float64 kernels are counted, and their wrappers take only CUDA
    tensors (no plain fallback), counting nothing when they raise."""
    for name in ("K1-f64", "K1″-f64", "K3-f64"):
        assert name in KERNEL_COUNTERS
    bins, g, h, m = _t(*_rows(100, 2, 8))
    before = (cuda_histogram.F64_LAUNCHES, cuda_histogram.LEVEL_F64_LAUNCHES,
              cuda_search.F64_LAUNCHES)
    with pytest.raises(ValueError):
        cuda_histogram.histogram_single_leaf_f64_cuda(bins, g, h, m, 8)
    with pytest.raises(ValueError):
        cuda_histogram.histogram_by_leaf_sorted_f64_cuda(
            bins, torch.zeros(100, dtype=torch.int32), g, h, m, 8, 1)
    hist = histogram_single_leaf(bins, g, h, m, 8, acc_dtype=F64)
    meta = pack_meta(torch.ones(2, dtype=torch.bool),
                     torch.full((2,), 8), torch.zeros(2, dtype=torch.bool),
                     "cpu")
    with pytest.raises(ValueError):
        cuda_search._search2_rows_cuda(hist, hist, [1.0] * 12, meta)
    with pytest.raises(TypeError):
        histogram_single_leaf(bins, g, h, m, 8, acc_dtype=torch.float16)
    assert (cuda_histogram.F64_LAUNCHES, cuda_histogram.LEVEL_F64_LAUNCHES,
            cuda_search.F64_LAUNCHES) == before


def test_entry_points_train_float64(tmp_path):
    """``Booster.update``, ``cv`` and the CLI train with hist_dtype=float64
    (the sklearn estimators, like the JAX package's, take no hist_dtype);
    ``update`` and the CLI give the in-memory model bitwise."""
    X, y = _data(1200, "binary")
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
              "hist_dtype": "float64", "verbose": -1}
    ds = lt.Dataset(X, label=y, max_bin=63, device="cpu")
    mem = lt.train(dict(params), ds, 4, device="cpu")
    bst = lt.Booster(params=dict(params), train_set=ds, device="cpu")
    for _ in range(4):
        bst.update()
    assert bst.model_to_string() == mem.model_to_string()
    res = lt.cv(dict(params), lt.Dataset(X, label=y, device="cpu"), 3,
                nfold=3, device="cpu")
    assert len(next(iter(res.values()))) == 3
    path = tmp_path / "train.csv"
    np.savetxt(path, np.column_stack([y, X]), fmt="%.17g", delimiter=",")
    conf = tmp_path / "train.conf"
    conf.write_text(f"task = train\nobjective = binary\ndata = {path}\n"
                    "num_trees = 4\nnum_leaves = 7\nmax_bin = 63\n"
                    f"hist_dtype = float64\noutput_model = {tmp_path}/m.txt\n")
    assert cli.main([f"config={conf}"], device="cpu") == 0

    def trees(text):
        return text[text.index("Tree=0"):]

    assert trees((tmp_path / "m.txt").read_text()) == trees(
        mem.model_to_string())
