"""Kernel 3-f64's step form (``search2_update`` / ``search2_pool`` and
``F64Step`` on float64 buffers) against the JAX package under x64.

The float64 routes of the JAX package split a leaf as ``parent - small``
in jnp float64, the two children routed by which one is smaller, then
``find_best_split_leaves`` on the stacked children
(lightgbm_tpu/learners/serial.py:457-468).  The port does the same in one
call of kernel 3-f64's step form on the card; here its plain versions
(ops/split.py, what the CPU runs and what the kernel is held to on the
card) are held bitwise against that composition: the children written
to the buffer and the [2, 16] rows, at B = 7 / 255 / 300 / 600 / 5000,
both routings, a resident parent and a recomputed one, and crafted ties
(equal gains across features and across bins).  Then the learners: the
float64 leaf-wise, pooled and hybrid trees through ``F64Step`` are
bitwise the trees of the composition the learner ran before (PyTorch
subtraction, the root-form search, two row copies), each split taking
the step form it should (update unpooled and in hybrid's resume, pool
under the pool), the root the root form; the counters and the configuration
``search64_config`` picks.  The kernel's holds on the card are in
tests/test_torch_f64_card.py and chip_smoke.py phase 22."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.compat import enable_x64
from lightgbm_tpu.ops.split import find_best_split_leaves as jax_find

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.learners import serial
from lightgbm_tpu_torch.ops import KERNEL_COUNTERS, cuda_search
from lightgbm_tpu_torch.ops.cuda_histogram import histogram_single_leaf
from lightgbm_tpu_torch.ops.cuda_search import (F64Step, pack_meta,
                                                search2_pool, search2_rows,
                                                search2_update,
                                                search64_config)

F64 = torch.float64
TREE = ("split_feature", "threshold_bin", "decision_type", "left_child",
        "right_child", "leaf_count", "leaf_parent", "leaf_depth",
        "split_gain", "internal_value", "internal_count", "leaf_value",
        "threshold_real")


def _hist(bins, g, h, m, B):
    return histogram_single_leaf(*[torch.from_numpy(a) for a in
                                   (bins, g, h, m)], B, acc_dtype=F64)


def _case(F, B, seed, tie=False):
    """A parent's float64 histogram, its smaller child's, the totals of
    both children, meta and the constants.  ``tie``: every feature the
    same column with every other bin empty, so equal gains meet across
    features and across thresholds."""
    rng = np.random.RandomState(seed)
    n = 3000
    if tie:
        col = 2 * rng.randint(0, B // 2, n)
        bins = np.tile(col, (F, 1)).astype(np.uint16)
        g = np.where(rng.rand(n) < 0.5, -1.0, 1.0).astype(np.float32)
        h = np.ones(n, np.float32)
    else:
        bins = rng.randint(0, B, (F, n)).astype(np.uint16)
        g = rng.randn(n).astype(np.float32)
        h = (np.abs(rng.randn(n)) + 0.01).astype(np.float32)
    m = (rng.rand(n) < 0.9).astype(np.float32)
    go_left = rng.rand(n) < 0.35 + 0.3 * rng.rand()
    parent = _hist(bins, g, h, m, B)
    small = _hist(bins, g, h, m * go_left, B)
    nbpf = (rng.randint(max(2, B // 2), B + 1, F) if not tie
            else np.full(F, B))
    is_cat = np.zeros(F, bool)
    if not tie and F > 2:
        is_cat[rng.randint(F)] = True
    fmask = rng.rand(F) < 0.9 if not tie else np.ones(F, bool)
    meta = pack_meta(torch.from_numpy(fmask), torch.from_numpy(nbpf),
                     torch.from_numpy(is_cat), "cpu")
    consts = [10.0, 1e-3, 0.0 if seed % 2 else 0.5, 1.0, 0.0]
    return parent, small, meta, (fmask, nbpf, is_cat), consts


def _jax_step(parent, small, small_is_left, scal, info):
    """The JAX package's float64 composition: ``parent - small`` in jnp
    float64, routed, and the two children searched together."""
    fmask, nbpf, is_cat = info
    can, lsg, lsh, lc, rsg, rsh, rc = scal[:7]
    with enable_x64(True):
        large = jnp.asarray(parent.numpy()) - jnp.asarray(small.numpy())
        sm = jnp.asarray(small.numpy())
        left, right = (sm, large) if small_is_left else (large, sm)
        res = jax_find(jnp.stack([left, right]), jnp.asarray([lsg, rsg]),
                       jnp.asarray([lsh, rsh]), jnp.asarray([lc, rc]),
                       jnp.asarray(fmask), jnp.asarray(nbpf),
                       jnp.asarray(is_cat),
                       *[jnp.float32(c) for c in scal[7:]],
                       jnp.asarray([bool(can), bool(can)]))
        rows = np.stack([np.asarray(a).astype(np.float64) for a in res], 1)
        return np.asarray(left), np.asarray(right), rows


def _scal(parent, small, small_is_left, consts):
    """The two children's totals from feature 0's cells (float64 sums)."""
    tp = parent[0].sum(0).tolist()
    ts = small[0].sum(0).tolist()
    tl = [a - b for a, b in zip(tp, ts)]
    left, right = (ts, tl) if small_is_left else (tl, ts)
    return [1.0, *left, *right] + consts


@pytest.mark.parametrize("F,B", [(5, 7), (6, 255), (5, 300), (4, 600),
                                 (3, 5000)])
@pytest.mark.parametrize("small_is_left", [True, False],
                         ids=["small-left", "small-right"])
@pytest.mark.parametrize("where", ["resident", "recomputed", "tie"])
def test_step_plain_matches_jax_composition(F, B, small_is_left, where):
    """The float64 step form's plain versions (what the CPU runs and the
    kernel is held to on the card): the children written to the buffer
    and the [2, 16] rows bitwise the JAX package's composition."""
    tie = where == "tie"
    parent, small, meta, info, consts = _case(F, B, seed=F * B, tie=tie)
    scal = _scal(parent, small, small_is_left, consts)
    left, right, ref = _jax_step(parent, small, small_is_left, scal, info)
    buf = torch.zeros((4, F, B, 3), dtype=F64)
    if where == "recomputed":
        rows = search2_pool(buf, small, parent.clone(), 1, 3, small_is_left,
                            scal, meta)
        s1, s2 = 1, 3
    else:
        buf[2] = parent
        rows = search2_update(buf, small, 2, 0, small_is_left, scal, meta)
        s1, s2 = 2, 0
    assert rows.dtype == F64 and not rows[:, 11:].any()
    np.testing.assert_array_equal(buf[s1].numpy(), left)
    np.testing.assert_array_equal(buf[s2].numpy(), right)
    np.testing.assert_array_equal(rows[:, :11].numpy(), ref)
    if tie:  # every feature ties: the smallest wins, and of the two
        # thresholds around an empty (odd) bin the larger
        assert rows[0, 1] == 0 and rows[0, 2] % 2 == 1
    # the pooled form with a resident parent is the update form
    pool = torch.zeros((4, F, B, 3), dtype=F64)
    pool[2] = parent
    again = search2_pool(pool, small, 2, 2, 1, small_is_left, scal, meta)
    assert torch.equal(again, rows) and torch.equal(pool[2], buf[s1])


class _Composition(F64Step):
    """The float64 split as the learner ran it before the step form: the
    larger child by PyTorch subtraction, the root-form search of both,
    then the two rows copied into the buffer; records which form each
    split took."""

    calls = []

    def _step(self, h_parent, h_small, s1, s2, small_is_left, scal):
        h_large = h_parent - h_small
        h_left, h_right = ((h_small, h_large) if small_is_left
                           else (h_large, h_small))
        rows = search2_rows(h_left, h_right, scal, self.meta)
        self.buf[s1] = h_left
        self.buf[s2] = h_right
        return rows

    def update(self, h_small, parent, new_leaf, small_is_left, scal):
        self.calls.append("update")
        return self._step(self.buf[parent], h_small, parent, new_leaf,
                          small_is_left, scal)

    def pool(self, h_small, parent, s1, s2, small_is_left, scal):
        self.calls.append("pool")
        h_parent = parent if isinstance(parent, torch.Tensor) else \
            self.buf[parent]
        return self._step(h_parent, h_small, s1, s2, small_is_left, scal)


class _Recorder(F64Step):
    calls = []

    def update(self, *args):
        self.calls.append("update")
        return super().update(*args)

    def pool(self, *args):
        self.calls.append("pool")
        return super().pool(*args)


def _grow(growth, extra, monkeypatch, step_cls):
    monkeypatch.setattr(serial, "F64Step", step_cls)
    step_cls.calls = []
    rng = np.random.RandomState(3)
    X = rng.randn(4000, 7)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.randn(4000) > 0)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "min_data_in_leaf": 10, "hist_dtype": "float64",
              "tree_growth": growth, "verbose": -1, **extra}
    bst = lt.train(params, lt.Dataset(X, label=y.astype(np.float32),
                                      max_bin=63, device="cpu"), 3,
                   device="cpu")
    return bst._gbdt.models, list(step_cls.calls), \
        bst._gbdt._hist_pool_slots()


@pytest.mark.parametrize("growth,extra,form", [
    ("leafwise", {}, "update"),
    ("leafwise", {"histogram_pool_size": 0.02}, "pool"),
    ("hybrid", {}, "update")], ids=["leafwise", "pooled", "hybrid"])
def test_learners_trees_unchanged_by_the_step_form(growth, extra, form,
                                                   monkeypatch):
    """Float64 leaf-wise, pooled and hybrid trees through the step form are
    bitwise the trees of the composition it replaced, every split taking
    the form its route should, and the root one root-form search."""
    before = cuda_search.F64_LAUNCHES, cuda_search.F64_STEP_LAUNCHES
    old, old_calls, _ = _grow(growth, extra, monkeypatch, _Composition)
    new, new_calls, slots = _grow(growth, extra, monkeypatch, _Recorder)
    assert len(old) == len(new) == 3
    for a, b in zip(old, new):
        assert a.num_leaves == b.num_leaves
        for k in TREE:
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    splits = sum(t.num_leaves - 1 for t in new)
    assert new_calls == old_calls
    if growth == "hybrid":  # the level phase splits without the step form
        assert 0 < len(new_calls) < splits and set(new_calls) == {form}
    else:
        assert new_calls == [form] * splits
    if form == "pool":  # fewer slots than leaves: parents get rebuilt
        assert 2 <= slots < 15
    # the CPU runs the plain versions: no kernel counted
    assert (cuda_search.F64_LAUNCHES,
            cuda_search.F64_STEP_LAUNCHES) == before


def test_step_counters_and_cpu_path(monkeypatch):
    """The step form has its own counter; on CPU tensors every float64
    entry runs the plain version and never reaches the C library."""
    assert KERNEL_COUNTERS["K3-f64 step"] == ("cuda_search",
                                              "F64_STEP_LAUNCHES")
    assert KERNEL_COUNTERS["K3-f64"] == ("cuda_search", "F64_LAUNCHES")

    def no_lib():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(cuda_search, "_lib", no_lib)
    parent, small, meta, _, consts = _case(4, 40, seed=1)
    scal = _scal(parent, small, True, consts)
    buf = torch.zeros((3, 4, 40, 3), dtype=F64)
    buf[0] = parent
    step = F64Step(buf, meta)
    assert not step.cuda
    rows = step.update(small, 0, 1, True, scal)
    pooled = step.pool(small, parent, 2, 1, True, scal)
    assert torch.equal(rows, pooled) and rows.dtype == F64
    assert (cuda_search.F64_LAUNCHES, cuda_search.F64_STEP_LAUNCHES) == (0, 0)
    with pytest.raises(ValueError):  # the slot checks of search2_pool
        search2_pool(buf, small, 1, 2, 2, True, scal, meta)


@pytest.mark.parametrize("F,B", [(1, 7), (6, 255), (28, 255), (64, 255),
                                 (32, 256), (33, 255), (28, 257),
                                 (2000, 255), (5000, 255), (28, 5000)])
def test_search64_config(F, B, monkeypatch):
    """One cluster of at most 8 blocks of at most 8 warps, as many warps
    as pairs where they fit, at B <= 256 and F up to the switch; the
    ticketed grid elsewhere; a forced configuration wins."""
    cluster, warps = search64_config(F, B)
    most = cuda_search.MAX_CLUSTER * cuda_search.CLUSTER_WARPS
    if B > cuda_search.CLUSTER_BINS or F > cuda_search.F64_CLUSTER_MAX_F:
        assert (cluster, warps) == (0, 0)
    else:
        assert 1 <= cluster <= cuda_search.MAX_CLUSTER
        assert 1 <= warps <= cuda_search.CLUSTER_WARPS
        assert cluster * warps >= min(2 * F, most)
        assert cluster * (warps - 1) < 2 * F  # no block of idle warps
    monkeypatch.setattr(cuda_search, "_forced_config", (0, 0))
    assert search64_config(F, B) == (0, 0)
