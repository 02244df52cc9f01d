"""The histogram pool of the PyTorch port (leaf-wise growth under
``histogram_pool_size``), its pooled split step (the plain version of
kernel 5) and the record write-back (the plain version of kernel 9),
against the JAX package.

* Slot counts: ``GBDT._hist_pool_slots`` equals the JAX GBDT's on the
  CPU, exactly (integers).
* The pooled step against the JAX package's subtraction followed by
  ``search2_pallas_raw`` in interpret mode on the same children converted
  to its raw ``[2, Fp, 4, Bp]`` layout: the written slots bitwise (the
  subtraction is elementwise float32), feature and threshold exactly; the
  float fields bitwise on integer-valued (exact-sum) histograms, to rtol
  1e-5 / atol 1e-6 on real-valued ones (the Pallas suffix sums are a
  triangular matmul, the port's a blocked scan).
* Pooled ``grow_tree`` against the JAX ``grow_tree`` on both pooled
  routes (canonical, and ``hist_fn_raw`` in interpret mode as in
  tests/test_opt_layout.py) on tests/test_hist_pool.py's exact-sum
  problem: split features, thresholds, leaf counts and leaf ids bitwise,
  leaf values to rtol 1e-6; and against the port's own unpooled trees,
  bitwise in every field.
* ``train`` with ``histogram_pool_size`` against the JAX package's
  ``train`` on the CPU: the same trees (structure exactly, values to rtol
  1e-5 / atol 1e-6 as tests/test_torch_slice.py holds them).
* ``write_window`` against the JAX ``write_window(interpret=True)``,
  bitwise, negative and clamped begins included.

Tests marked ``cuda`` hold kernels 5, 9 and kernel 3 at F = 2000 against
their plain versions; they skip without a card (chip_smoke.py runs the
same checks there).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.engine as jax_engine
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.learners.serial import TreeLearnerParams as JaxParams
from lightgbm_tpu.learners.serial import grow_tree as jax_grow_tree
from lightgbm_tpu.ops.pallas_histogram import histogram_single_leaf_raw
from lightgbm_tpu.ops.pallas_search import search2_pallas_raw
from lightgbm_tpu.ops.record import TILE as JAX_TILE
from lightgbm_tpu.ops.record import write_window as jax_write_window

import lightgbm_tpu_torch as lt
import lightgbm_tpu_torch.learners.serial as port_serial
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.learners.serial import TreeLearnerParams, grow_tree
from lightgbm_tpu_torch.ops import cuda_record, cuda_search
from lightgbm_tpu_torch.ops.cuda_histogram import histogram_record_window
from lightgbm_tpu_torch.ops.cuda_search import (pack_meta, search2_pool,
                                                search2_rows)
from lightgbm_tpu_torch.ops.record import write_window

STRUCT = ("split_feature", "threshold_bin", "decision_type", "left_child",
          "right_child", "leaf_count", "leaf_parent", "leaf_depth")
TREE_FIELDS = STRUCT + ("split_gain", "internal_value", "internal_count",
                        "leaf_value")


# ------------------------------------------------------------ slot counts
@pytest.mark.parametrize("F,max_bin,mb,L,want", [
    (28, 255, 4.0, 255, 48),    # the bench shape: 85,680 B a slot
    (6, 64, 0.05, 63, None),    # an interior count
    (10, 32, 0.01, 31, 2),      # two slots
    (10, 32, 0.001, 31, 2),     # under one slot: clamped to 2
    (10, 32, 1.0, 31, 31),      # more than num_leaves: clamped to L
    (5, 16, 0.0, 15, 0),        # no pool
], ids=["bench", "interior", "two", "clamp2", "clampL", "off"])
def test_slot_count_matches_jax(F, max_bin, mb, L, want):
    rng = np.random.RandomState(F)
    X = rng.randn(2000, F)
    y = (X[:, 0] > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": L, "max_bin": max_bin,
              "histogram_pool_size": mb, "verbose": -1}
    bj = lgb.Booster(dict(params), lgb.Dataset(X, label=y, max_bin=max_bin))
    bt = lt.Booster(dict(params), lt.Dataset(X, label=y, max_bin=max_bin,
                                             device="cpu"), device="cpu")
    slots = bt._gbdt._hist_pool_slots()
    assert slots == bj._gbdt._hist_pool_slots()
    assert want is None or slots == want
    if want is None:
        assert 2 < slots < L


# -------------------------------------------------------- the pooled step
_P = 5


def _children(seed, exact, F=9, B=31):
    """Two children's [F, B, 3] histograms; integer-valued when
    ``exact``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        if exact:
            g = rng.randint(-8, 9, (F, B)).astype(np.float32)
            h = rng.randint(1, 5, (F, B)).astype(np.float32)
        else:
            g = rng.randn(F, B).astype(np.float32)
            h = (np.abs(rng.randn(F, B)) + 0.1).astype(np.float32)
        c = rng.randint(1, 50, (F, B)).astype(np.float32)
        out.append(np.stack([g, h, c], -1))
    return out


def _raw(x, Fp, Bp):
    """[F, B, 3] -> the JAX raw layout [Fp, 4, Bp] (zero padded)."""
    F, B, _ = x.shape
    out = np.zeros((Fp, 4, Bp), np.float32)
    out[:F, :3, :B] = x.transpose(0, 2, 1)
    return out


STEP_CASES = [(seed, exact, resident, sil)
              for seed, exact in ((0, True), (1, False), (2, True),
                                  (3, False))
              for resident in (True, False) for sil in (True, False)]
STEP_IDS = [f"{'exact' if e else 'real'}{s}-"
            f"{'resident' if r else 'recomputed'}-"
            f"small_{'left' if sil else 'right'}"
            for s, e, r, sil in STEP_CASES]


@pytest.mark.parametrize("case", STEP_CASES, ids=STEP_IDS)
def test_pooled_step_matches_jax_raw_search(case):
    seed, exact, resident, small_is_left = case
    hl, hr = _children(seed, exact)
    F, B, _ = hl.shape
    parent = hl + hr
    small = hl if small_is_left else hr
    rng = np.random.RandomState(seed + 50)
    pool = rng.randn(_P, F, B, 3).astype(np.float32)
    # resident: the parent sits in slot 1, which the left child takes;
    # recomputed: the parent comes as a tensor, the children take 3 and 0
    if resident:
        pool[1] = parent
        s1, s2, arg = 1, 4, 1
    else:
        s1, s2, arg = 3, 0, torch.from_numpy(parent)
    fmask = np.ones(F, bool)
    fmask[5] = False
    iscat = np.zeros(F, bool)
    iscat[3] = True
    nbpf = np.full(F, B, np.int32)
    nbpf[7] = B - 9
    # the search sees the routed children; their totals from feature 2
    large = parent - small
    h_left, h_right = (small, large) if small_is_left else (large, small)
    tot = [float(v) for h in (h_left, h_right) for v in h[2].sum(axis=0)]
    consts = [3.0, 0.5, 0.25, 1.0, 0.0]
    scal = [1.0, *tot, *consts]
    t = torch.from_numpy
    ours = t(pool.copy())
    rows = search2_pool(ours, t(small), arg, s1, s2, small_is_left, scal,
                        pack_meta(t(fmask), t(nbpf), t(iscat), "cpu"))
    # the JAX pooled raw route: subtraction and routing in XLA, then K5
    jl, jr = np.asarray(jnp.asarray(parent) - jnp.asarray(small)), small
    jl, jr = (jr, jl) if small_is_left else (jl, jr)
    np.testing.assert_array_equal(ours[s1].numpy(), jl)
    np.testing.assert_array_equal(ours[s2].numpy(), jr)
    untouched = [i for i in range(_P) if i not in (s1, s2)]
    np.testing.assert_array_equal(ours[untouched].numpy(), pool[untouched])
    Fp, Bp = -(-F // 8) * 8, -(-B // 128) * 128
    f = jnp.float32
    ref = search2_pallas_raw(
        jnp.asarray(np.stack([_raw(jl, Fp, Bp), _raw(jr, Fp, Bp)])),
        *[f(v) for v in tot], jnp.bool_(True), jnp.asarray(fmask),
        jnp.asarray(nbpf), jnp.asarray(iscat), *[f(v) for v in consts],
        interpret=True)
    got = rows.numpy()
    for c, r in enumerate(ref):
        want = np.array([float(np.asarray(x)) for x in r], np.float32)
        np.testing.assert_array_equal(got[c, 1:3], want[1:3])
        if exact:
            np.testing.assert_array_equal(got[c, :11], want)
        else:
            np.testing.assert_allclose(got[c, :11], want, rtol=1e-5,
                                       atol=1e-6)
    # the step's search is the two-child search of the written slots
    assert torch.equal(rows, search2_rows(ours[s1], ours[s2], scal,
                                          pack_meta(t(fmask), t(nbpf),
                                                    t(iscat), "cpu")))


@pytest.mark.parametrize("s1,s2,parent", [(1, 1, 1), (0, 2, 2), (0, 5, 1),
                                          (-1, 2, 1), (0, 1, 9)],
                         ids=["s1==s2", "s2==parent", "s2-outside",
                              "s1-outside", "parent-outside"])
def test_pooled_step_refuses_bad_slots(s1, s2, parent):
    hl, _ = _children(0, True)
    F, B, _ = hl.shape
    meta = pack_meta(torch.ones(F, dtype=torch.bool), torch.full((F,), B),
                     torch.zeros(F, dtype=torch.bool), "cpu")
    with pytest.raises(ValueError):
        search2_pool(torch.zeros((_P, F, B, 3)), torch.from_numpy(hl),
                     parent, s1, s2, True, [1.0] + [0.0] * 6
                     + [1.0, 0.0, 0.0, 1.0, 0.0], meta)


# ------------------------------------------------------------ pooled trees
def _problem(n=3000, F=10, B=32, seed=11):
    """tests/test_hist_pool.py's problem: grad in {±1, ±0.5}, hess 1, so
    every histogram sum is exact and a recomputed parent is bit-equal to
    the resident one."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(F, n)).astype(np.uint8)
    grad = rng.choice([-1.0, -0.5, 0.5, 1.0], size=n).astype(np.float32)
    return (bins, grad, np.ones(n, np.float32), np.ones(n, np.float32),
            np.ones(F, bool), np.full(F, B, np.int32), np.zeros(F, bool))


_CFG = dict(min_data_in_leaf=5, min_sum_hessian_in_leaf=1e-3)
_B, _L = 32, 31


def _port_tree(arrs, pool, raw):
    return grow_tree(*(torch.from_numpy(a) for a in arrs),
                     TreeLearnerParams.from_config(Config(**_CFG)),
                     num_bins=_B, max_leaves=_L, hist_pool=pool,
                     hist_fn_raw=histogram_record_window if raw else None)


@pytest.mark.parametrize("pool", [4, 2])
@pytest.mark.parametrize("route", ["canonical", "raw"])
def test_grow_tree_pooled_matches_jax(route, pool, monkeypatch):
    arrs = _problem()
    raw = route == "raw"
    steps = []
    step = port_serial.search2_pool
    monkeypatch.setattr(port_serial, "search2_pool",
                        lambda *a: steps.append(a[3:5]) or step(*a))
    port_serial.POOL_RECOMPUTES = 0
    tt, lid_t = _port_tree(arrs, pool, raw)
    recomputes = port_serial.POOL_RECOMPUTES

    def raw_fn(b, g, h, m):
        return histogram_single_leaf_raw(b, g, h, m, num_bins=_B,
                                         interpret=True)

    tj, lid_j = jax_grow_tree(
        *(jnp.asarray(a) for a in arrs),
        JaxParams.from_config(JaxConfig(**_CFG)), num_bins=_B,
        max_leaves=_L, hist_pool=pool, hist_fn_raw=raw_fn if raw else None)
    assert tt.num_leaves == int(tj.num_leaves) == _L
    for k in ("split_feature", "threshold_bin", "leaf_count"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(tj, k)), err_msg=k)
    np.testing.assert_array_equal(lid_t.numpy(), np.asarray(lid_j))
    np.testing.assert_allclose(tt.leaf_value.numpy(),
                               np.asarray(tj.leaf_value), rtol=1e-6)
    # 30 splits through max(pool, 2) slots: parents were evicted and
    # rebuilt; the raw route stepped through search2_pool at every split
    assert recomputes > 0
    assert len(steps) == (_L - 1 if raw else 0)
    assert all(s1 != s2 and max(s1, s2) < max(pool, 2) for s1, s2 in steps)


@pytest.mark.parametrize("pool", [4, 2])
def test_pooled_trees_bitwise_equal_unpooled(pool):
    arrs = _problem(seed=12)
    t0, lid0 = _port_tree(arrs, 0, False)
    for raw in (False, True):
        t1, lid1 = _port_tree(arrs, pool, raw)
        assert t1.num_leaves == t0.num_leaves == _L
        for k in TREE_FIELDS:
            assert torch.equal(getattr(t1, k), getattr(t0, k)), k
        assert torch.equal(lid1, lid0)


def test_pooled_resume_refused():
    arrs = _problem(n=200)
    tree, lid = _port_tree(arrs, 0, False)
    with pytest.raises(ValueError, match="unpooled"):
        grow_tree(*(torch.from_numpy(a) for a in arrs),
                  TreeLearnerParams.from_config(Config(**_CFG)),
                  num_bins=_B, max_leaves=_L, hist_pool=4, init_tree=tree,
                  init_leaf_id=lid)


def test_train_pooled_matches_jax():
    rng = np.random.RandomState(12)
    X = rng.randn(3000, 6)
    y = (X[:, 0] - X[:, 1] * X[:, 2] > 0).astype(np.float32)
    params = {"objective": "binary", "min_data_in_leaf": 20,
              "num_leaves": 15, "hist_impl": "matmul",
              "tree_growth": "leafwise", "histogram_pool_size": 0.01,
              "verbose": -1}
    bj = jax_engine.train(dict(params), lgb.Dataset(X, label=y, max_bin=32),
                          num_boost_round=3, verbose_eval=False)
    port_serial.POOL_RECOMPUTES = 0
    bt = lt.train(dict(params), lt.Dataset(X, label=y, max_bin=32,
                                           device="cpu"),
                  num_boost_round=3, device="cpu")
    slots = bt._gbdt._hist_pool_slots()
    assert slots == bj._gbdt._hist_pool_slots() == 4
    assert port_serial.POOL_RECOMPUTES > 0
    assert len(bt._gbdt.models) == len(bj._gbdt.models) == 3
    for a, b in zip(bj._gbdt.models, bt._gbdt.models):
        assert b.num_leaves == int(a.num_leaves) == 15
        for k in STRUCT + ("split_feature_real", "threshold_real"):
            np.testing.assert_array_equal(
                getattr(b, k).numpy(), np.asarray(getattr(a, k)), err_msg=k)
        for k in ("leaf_value", "internal_value", "internal_count"):
            np.testing.assert_allclose(getattr(b, k).numpy(),
                                       np.asarray(getattr(a, k)),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


# ------------------------------------------------------- record write-back
@pytest.mark.parametrize("begin,cap", [
    (0, 2 * JAX_TILE), (1, 2 * JAX_TILE), (37, 2 * JAX_TILE),
    (500, 2 * JAX_TILE), (JAX_TILE - 1, 2 * JAX_TILE), (-5, 2 * JAX_TILE),
    (-10 ** 6, 2 * JAX_TILE), (7 * JAX_TILE, 2 * JAX_TILE),
    (10 ** 9, 2 * JAX_TILE), (123, 777), (0, 8 * JAX_TILE), (1, 777),
    (2, 777), (3, 777)],
    ids=["0", "1", "37", "500", "tile-1", "negative", "far-negative",
         "past-end", "far", "ragged", "whole", "odd-cap-1", "odd-cap-2",
         "odd-cap-3"])
def test_write_window_matches_jax(begin, cap):
    rng = np.random.RandomState(begin % 97 + cap)
    rec = rng.randint(-2 ** 30, 2 ** 30, (16, 8 * JAX_TILE)).astype(np.int32)
    out = rng.randint(-2 ** 30, 2 ** 30, (16, cap)).astype(np.int32)
    want = np.asarray(jax_write_window(jnp.asarray(rec), jnp.asarray(out),
                                       jnp.int32(begin), cap,
                                       interpret=True))
    ours = torch.from_numpy(rec.copy())
    assert write_window(ours, torch.from_numpy(out), begin) is ours
    np.testing.assert_array_equal(ours.numpy(), want)


@pytest.mark.parametrize("begin", [0, 1, 2, 3])
def test_write_window_one_row_matches_jax(begin):
    rng = np.random.RandomState(begin)
    rec = rng.randint(-2 ** 30, 2 ** 30, (1, 3000)).astype(np.int32)
    out = rng.randint(-2 ** 30, 2 ** 30, (1, 777)).astype(np.int32)
    want = np.asarray(jax_write_window(jnp.asarray(rec), jnp.asarray(out),
                                       jnp.int32(begin), 777,
                                       interpret=True))
    ours = torch.from_numpy(rec.copy())
    write_window(ours, torch.from_numpy(out), begin)
    np.testing.assert_array_equal(ours.numpy(), want)


def test_write_window_refuses_bad_windows():
    rec = torch.zeros((6, 100), dtype=torch.int32)
    for out in (torch.zeros((5, 10), dtype=torch.int32),
                torch.zeros((6, 101), dtype=torch.int32),
                torch.zeros((6, 10), dtype=torch.int64)):
        with pytest.raises(ValueError):
            write_window(rec, out, 0)


# ------------------------------------------------- kernels 5, 9 and wide 3
def test_cuda_entries_have_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the entries would launch kernels")
    hl, hr = _children(0, True)
    F, B, _ = hl.shape
    meta = pack_meta(torch.ones(F, dtype=torch.bool), torch.full((F,), B),
                     torch.zeros(F, dtype=torch.bool), "cpu")
    scal = [1.0] + [0.0] * 6 + [1.0, 0.0, 0.0, 1.0, 0.0]
    before = (cuda_search.POOL_LAUNCHES, cuda_record.WRITE_LAUNCHES)
    with pytest.raises((RuntimeError, ValueError)):
        cuda_search._search2_pool_cuda(
            torch.zeros((_P, F, B, 3)), torch.from_numpy(hl), 1, 1, 2, True,
            scal, meta)
    with pytest.raises((RuntimeError, ValueError)):
        cuda_record.write_window_cuda(torch.zeros((6, 100), dtype=torch.int32),
                                      torch.zeros((6, 10), dtype=torch.int32),
                                      0)
    assert (cuda_search.POOL_LAUNCHES, cuda_record.WRITE_LAUNCHES) == before


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")


@pytest.mark.cuda
@pytest.mark.parametrize("F,B", [(28, 255), (2000, 256)])
def test_pool_kernel_matches_plain_on_card(F, B):
    _needs_card()
    rng = np.random.RandomState(F)
    t = torch.from_numpy
    hl = rng.randn(F, B, 3).astype(np.float32)
    hr = rng.randn(F, B, 3).astype(np.float32)
    meta = pack_meta(torch.ones(F, dtype=torch.bool), torch.full((F,), B),
                     torch.zeros(F, dtype=torch.bool), "cpu")
    scal = [1.0, *hl[0].sum(0), *hr[0].sum(0), 1.0, 0.0, 0.0, 1.0, 0.0]
    for resident in (True, False):
        for sil in (True, False):
            pool = rng.randn(4, F, B, 3).astype(np.float32)
            pool[2] = hl + hr
            parent = 2 if resident else t(hl + hr)
            s1, s2 = (2, 0) if resident else (3, 1)
            small = t(hl if sil else hr)
            cpu, dev = t(pool.copy()), t(pool.copy()).cuda()
            a = search2_pool(cpu, small, parent, s1, s2, sil, scal, meta)
            b = search2_pool(dev, small.cuda(), parent if resident
                             else parent.cuda(), s1, s2, sil, scal,
                             meta.cuda())
            assert torch.equal(cpu, dev.cpu())
            assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_wide_search_kernel_matches_plain_on_card():
    _needs_card()
    F, B = 2000, 256
    rng = np.random.RandomState(3)
    hl = torch.from_numpy(rng.randn(F, B, 3).astype(np.float32))
    hr = torch.from_numpy(rng.randn(F, B, 3).astype(np.float32))
    meta = pack_meta(torch.ones(F, dtype=torch.bool), torch.full((F,), B),
                     torch.zeros(F, dtype=torch.bool), "cpu")
    scal = [1.0, *hl[0].sum(0).tolist(), *hr[0].sum(0).tolist(), 1.0, 0.0,
            0.0, 1.0, 0.0]
    a = search2_rows(hl, hr, scal, meta)
    b = search2_rows(hl.cuda(), hr.cuda(), scal, meta.cuda())
    assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_write_kernel_matches_plain_on_card():
    _needs_card()
    rng = np.random.RandomState(9)
    # rows of a multiple of 4 words and not, one row, odd window widths
    for W, n, cap in ((12, 5000, 1234), (12, 5001, 1235), (1, 5000, 777)):
        rec = torch.from_numpy(rng.randint(-2 ** 30, 2 ** 30, (W, n))
                               .astype(np.int32))
        out = torch.from_numpy(rng.randint(-2 ** 30, 2 ** 30, (W, cap))
                               .astype(np.int32))
        for begin in (0, 1, 2, 3, 37, 500, 511, 4000):
            a = write_window(rec.clone(), out, begin)
            b = write_window(rec.cuda(), out.cuda(), begin)
            assert torch.equal(a, b.cpu())
