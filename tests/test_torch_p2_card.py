"""Kernel P2's wrapper (ops/cuda_predict_binned.py): it takes only CUDA
tensors and counts only the launches it makes; on the card it is bitwise
its plain version (models/tree.py ``binned_update_`` /
``binned_replay_``) in every configuration ``p2_config`` picks, each
reached by its shape (``test_holds_cover_every_configuration`` checks
that on the CPU): the bins tiled at 256 rows, one a thread, with the
records staged (one tree of 15 leaves) or read through L1 (a tree of
1,000 leaves), tiled at fewer rows with several tree slots (a list of
trees over few rows, or F = 136 uint16 bins), and read from global
memory (the wide configuration, F = 2,000) at 256 rows or fewer; at 1,
255, 257 and 3,000 rows, uint8 and uint16 bins, K = 1 and 5, class
offsets 0 and K - 1; and at 700,000 rows (16-byte tile loads, and byte
loads when a feature's bins are not 16-byte aligned).  No JAX here: the
card test's trees come from the port's own CPU training and a random
tree (chip_smoke.py holds P2 at the bench shape)."""

import functools

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models import tree as pt
from lightgbm_tpu_torch.ops import cuda_predict_binned as P2
from lightgbm_tpu_torch.ops import predict as ops_predict

N_TRAIN = 3000
WIDE_F = 2000  # the wide configuration: 2,000 uint8 bins a row
NARROW_F = 136  # uint16 bins whose 256-row tile does not fit: 128 rows
DEEP_LEAVES = 1000  # a tree of more records than a tile stages
SMS = 132  # an H100 SXM's streaming processors, for the CPU's check


@functools.lru_cache(maxsize=None)
def _trees(K=1, max_bin=63, cat=False, stumps=False, rounds=4, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(N_TRAIN, 6)
    X[:, 1] = rng.randint(0, 5, N_TRAIN)
    z = X[:, 0] + X[:, 2] * (X[:, 1] == 2) + 0.3 * rng.randn(N_TRAIN)
    y = ((z > 0).astype(np.float32) if K == 1
         else np.digitize(z, np.linspace(-1, 1, K - 1)).astype(np.float32))
    params = {"objective": "binary" if K == 1 else "multiclass",
              "num_leaves": 15, "min_data_in_leaf": 5, "max_bin": max_bin,
              "verbose": -1}
    if K > 1:
        params["num_class"] = K
    if stumps:
        params["min_gain_to_split"] = 1e9
    ds = lt.Dataset(X, label=y, categorical_feature=[1] if cat else None,
                    device="cpu")
    bst = lt.train(params, ds, rounds, device="cpu")
    return bst._gbdt.models, bst._gbdt._bins_T


def test_wrapper_takes_only_cuda_tensors():
    trees, bins = _trees()
    table = pt.binned_table(trees)
    scores = torch.zeros(1, bins.shape[1])
    before = P2.LAUNCHES
    with pytest.raises((ValueError, RuntimeError)):
        P2.binned_update_cuda_(scores, table, bins, 0, 1.0)
    with pytest.raises((ValueError, RuntimeError)):
        P2.binned_replay_cuda_(scores, table, bins, 1, 2)
    assert P2.LAUNCHES == before
    # the dispatcher sends a CPU tensor to the plain version
    ops_predict.ensemble_update_binned_(scores, table, bins, 0, 1.0)
    assert P2.LAUNCHES == before and bool(scores.abs().sum() > 0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")


def _cuda_trees(trees):
    return [t.replace(**{f: getattr(t, f).cuda() for f in pt.TREE_FIELDS})
            for t in trees]


def _configs(trees, bins, K, sms=SMS):
    """The configurations p2_config picks for ``trees`` over ``bins``, in
    update mode and (whole iterations) replay mode."""
    table = pt.binned_table(trees)
    F, n = bins.shape
    return {P2.p2_config(n, F, bins.element_size(), len(trees), K, sms,
                         table.max_steps, replay)
            for replay in (False, True) if not replay or len(trees) % K == 0}


def _hold(trees, bins, K, c0, chunk=2):
    """P2 in p2_config's configuration against the plain version on the
    CPU, bitwise, in update mode (class offset ``c0``, the scales DART and
    rollback give) and replay mode; two launches equal."""
    T = len(trees)
    n = bins.shape[1]
    init = torch.from_numpy(
        np.random.RandomState(n).randn(K, n).astype(np.float32))
    cpu_table = pt.binned_table(trees)
    table = pt.binned_table(_cuda_trees(trees))
    gbins = bins.cuda()
    for scale in (1.0, -1.0, 2 / 3, 2 / 3 - 1):
        want = pt.binned_update_(init.clone(), cpu_table, bins, c0, scale)
        before = P2.LAUNCHES
        got = P2.binned_update_cuda_(init.cuda(), table, gbins, c0, scale)
        again = P2.binned_update_cuda_(init.cuda(), table, gbins, c0, scale)
        torch.cuda.synchronize()
        assert P2.LAUNCHES == before + 2
        assert torch.equal(got, again)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    if T % K == 0:
        rwant = pt.binned_replay_(init.clone(), cpu_table, bins, K, chunk)
        rgot = P2.binned_replay_cuda_(init.cuda(), table, gbins, K, chunk)
        ragain = P2.binned_replay_cuda_(init.cuda(), table, gbins, K, chunk)
        torch.cuda.synchronize()
        assert torch.equal(rgot, ragain)
        np.testing.assert_array_equal(rgot.cpu().numpy(), rwant.numpy())


def _deep_tree(F=6, nbins=63, seed=9):
    """A random tree of DEEP_LEAVES leaves over ``F`` features of
    ``nbins`` bins, grown as LightGBM grows one: split k turns a random
    leaf j into internal node k, with leaf j on its left and the new leaf
    k + 1 on its right; a fifth of the nodes categorical."""
    rng = np.random.RandomState(seed)
    L = DEEP_LEAVES
    lc, rc = np.zeros(L - 1, np.int32), np.zeros(L - 1, np.int32)
    at = {0: None}  # leaf -> (its parent node, side)
    for k in range(L - 1):
        j = rng.randint(k + 1)
        if at[j] is not None:
            node, side = at[j]
            (lc if side == 0 else rc)[node] = k
        lc[k], rc[k] = ~j, ~(k + 1)
        at[j], at[k + 1] = (k, 0), (k, 1)
    return pt.empty_tree(L).replace(
        num_leaves=L,
        split_feature=torch.from_numpy(rng.randint(0, F, L - 1)
                                       .astype(np.int32)),
        threshold_bin=torch.from_numpy(rng.randint(0, nbins, L - 1)
                                       .astype(np.int32)),
        decision_type=torch.from_numpy((rng.rand(L - 1) < 0.2)
                                       .astype(np.int32)),
        left_child=torch.from_numpy(lc), right_child=torch.from_numpy(rc),
        leaf_value=torch.from_numpy(rng.randn(L).astype(np.float32)))


def _spread(trees, bins, F, dtype, seed):
    """The trees' columns spread over ``F`` features of ``dtype`` (the
    others random bins): a wider row over the same walks."""
    rng = np.random.RandomState(seed)
    perm = torch.from_numpy(rng.choice(F, bins.shape[0],
                                       replace=False).astype(np.int32))
    wide = [t.replace(split_feature=torch.where(
        t.split_feature >= 0, perm[t.split_feature.clamp(min=0).long()],
        t.split_feature)) for t in trees]
    u16 = dtype == torch.uint16
    wb = rng.randint(0, 300 if u16 else 63, (F, bins.shape[1])).astype(
        np.uint16 if u16 else np.uint8)
    wb[perm.numpy()] = bins.to(torch.int32).numpy()
    return wide, torch.from_numpy(wb)


KINDS = {"u8": {}, "u16": {"max_bin": 300}, "categorical": {"cat": True},
         "stumps": {"stumps": True}, "multiclass5": {"K": 5, "cat": True}}
ROWS = [1, 255, 257, N_TRAIN]
MANY = [700_000, 700_001]


def _hold_cases():
    """Every hold below as (test, trees, bins, K): the lists it holds."""
    for kind, kw in KINDS.items():
        trees, bins = _trees(rounds=6, **kw)
        for n in ROWS:
            sub = bins[:, :n]
            yield "kernel", trees, sub, kw.get("K", 1)
            yield "kernel", trees[-1:], sub, kw.get("K", 1)
    trees, bins = _trees(rounds=6)
    deep = [_deep_tree(seed=s) for s in range(3)]
    for n in ROWS:
        yield "deep", deep[:1], bins[:, :n], 1
        yield "deep", deep, bins[:, :n], 1
    for n in (1, 257, N_TRAIN):
        for F, dtype in ((WIDE_F, torch.uint8), (NARROW_F, torch.uint16)):
            wide, wb = _spread(trees, bins[:, :n], F, dtype, 20)
            yield "spread", wide, wb, 1
            yield "spread", wide[-1:], wb, 1


def _kind_of(cfg):
    rows, tiled, _, stage = cfg
    return ("staged" if stage else "tiled" if tiled else "global",
            "one row a thread" if rows == P2.THREADS else "tree slots")


def test_holds_cover_every_configuration():
    """The card holds reach every kind of configuration p2_config picks:
    256 rows one a thread with the records staged, through L1 or the bins
    from global memory, and fewer rows with tree slots, the bins tiled or
    from global memory."""
    seen = set()
    for _, trees, bins, K in _hold_cases():
        seen |= {_kind_of(c) for c in _configs(trees, bins, K)}
    assert seen == {("staged", "one row a thread"),
                    ("tiled", "one row a thread"),
                    ("global", "one row a thread"),
                    ("tiled", "tree slots"), ("global", "tree slots")}
    # the deep tree is walked through L1, the narrow uint16 tile at 128
    deep = [_deep_tree()]
    assert pt.binned_table(deep).max_steps > P2.STAGE_RECORDS
    _, bins = _trees(rounds=6)
    assert _configs(deep, bins, 1) == {(256, True, 1, 0)}
    wide, wb = _spread(_trees(rounds=6)[0][-1:], bins, NARROW_F,
                       torch.uint16, 20)
    assert _configs(wide, wb, 1) == {(128, True, 2, 0)}
    for n in MANY:
        assert _configs(_trees(rounds=6)[0], bins[:, :1].expand(-1, n), 1) \
            == {(256, True, 1, 84)}


@pytest.mark.cuda
@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_kernel_matches_plain_on_card(kind, n):
    """All 6 trees (30 at K = 5) over few rows: tree slots; the new tree
    alone: 256 rows, its records staged."""
    _card()
    kw = KINDS[kind]
    K = kw.get("K", 1)
    trees, bins = _trees(rounds=6, **kw)
    assert (bins.dtype == torch.uint16) == (kind == "u16")
    bins = bins[:, :n].contiguous()
    for c0 in sorted({0, K - 1}):
        _hold(trees, bins, K, c0)
        _hold(trees[-1:], bins, K, c0)  # the new tree of class c0


@pytest.mark.cuda
@pytest.mark.parametrize("n", ROWS)
def test_deep_trees_on_card(n):
    """Trees of 1,000 leaves: more records than a tile stages, so one is
    walked at 256 rows with its records read through L1, and three with
    tree slots."""
    _card()
    _, bins = _trees(rounds=6)
    deep = [_deep_tree(seed=s) for s in range(3)]
    bins = bins[:, :n].contiguous()
    _hold(deep[:1], bins, 1, 0)
    _hold(deep, bins, 1, 0, chunk=1)


@pytest.mark.cuda
@pytest.mark.parametrize("F,dtype", [(WIDE_F, torch.uint8),
                                     (NARROW_F, torch.uint16)], ids=str)
@pytest.mark.parametrize("n", [1, 257, N_TRAIN])
def test_wide_bins_on_card(n, F, dtype):
    """The trees' 6 columns spread over 2,000 uint8 features: too wide
    for a tile of 32 rows, so p2_config reads the bins from global
    memory, at 256 rows (one tree) and with tree slots (six); over 136
    uint16 features the one tree's tile is cut to 128 rows."""
    _card()
    trees, bins = _trees(rounds=6)
    wide, wb = _spread(trees, bins[:, :n], F, dtype, 20)
    _hold(wide, wb, 1, 0)
    _hold(wide[-1:], wb, 1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", MANY)
def test_many_rows_on_card(n):
    """700,000 rows: thousands of tiles of 256 rows, the last one partial;
    at 700,001 rows a feature's bins are not 16-byte aligned and every
    tile loads with byte loads.  Six trees with their records staged,
    and a deep tree through L1."""
    _card()
    trees, bins = _trees(rounds=6)
    big = torch.from_numpy(np.random.RandomState(7).randint(
        0, 64, (bins.shape[0], n)).astype(np.uint8))
    _hold(trees, big, 1, 0, chunk=4)
    _hold([_deep_tree()], big, 1, 0)
