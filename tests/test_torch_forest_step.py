"""One forest step of the port on the CPU: ``forest_step_plain`` (F1's and
F3's step forms as the plain PyTorch composition, ops/forest.py) and
``ForestStep`` (ops/cuda_forest.py) on CPU tensors.

* The leaf map and the left counts against a numpy partition, numerical
  and categorical splits, uint8 and uint16 bins; the smaller side by
  positional count, a tie (2 * nleft == pcnt) going left.
* Inactive lanes' map rows and buffer rows left bitwise unchanged.
* The two buffer rows written at (lane, leaf) and (lane, new_leaf): the
  smaller child bitwise its own histogram, the larger bitwise parent -
  smaller; the rows bitwise ``forest_search_plain`` on them with the
  left count in slot 11.
* ``ForestStep`` on CPU tensors takes the plain path, counts no launch
  and gives ``forest_step_plain``'s map, buffer and rows bitwise; its
  root forms give ``forest_histogram_plain`` and ``forest_search_plain``.

The kernels themselves run only on the card:
tests/test_torch_forest_card.py (marked ``cuda``) and chip_smoke.py
phase 24 hold them bitwise against these plain versions.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import cuda_forest, launch_counts
from lightgbm_tpu_torch.ops.cuda_forest import ForestStep
from lightgbm_tpu_torch.ops.cuda_search import pack_meta
from lightgbm_tpu_torch.ops.forest import (forest_histogram_plain,
                                           forest_search_plain,
                                           forest_step_plain)


def _forest(seed, B, n, F, nb, dt, leaves, L):
    """Seeded lanes: bins, gradients, a leaf map over ``leaves`` leaves
    (-1: outside a lane's root set), meta, a random buffer."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, nb, (F, n)).astype(dt)
    g = rng.randn(B, n).astype(np.float32)
    h = np.abs(rng.randn(B, n)).astype(np.float32)
    m = (rng.rand(B, n) < 0.8).astype(np.float32)
    lid = rng.randint(-1, leaves, (B, n)).astype(np.int32)
    is_cat = np.zeros(F, bool)
    is_cat[1] = True
    meta = torch.stack([pack_meta(torch.from_numpy(rng.rand(F) < 0.8),
                                  torch.full((F,), nb),
                                  torch.from_numpy(is_cat), "cpu")
                        for _ in range(B)])
    hists = torch.from_numpy(rng.rand(B, L, F, nb, 3).astype(np.float32))
    t = [torch.from_numpy(x) for x in (bins, g, h, m, lid)]
    return rng, t, meta, hists, is_cat


def _spec(rng, lid, bins, lanes, leaves, is_cat, nb, new_leaf):
    """A step of ``lanes``: each splits leaf ``leaves[i]`` on a random
    feature at a random threshold; the numpy partition's left counts."""
    F = bins.shape[0]
    feats = rng.randint(0, F, len(lanes))
    thrs = rng.randint(0, nb, len(lanes))
    pcnt, nleft, go_right = [], [], []
    for b, bl, f, t in zip(lanes, leaves, feats, thrs):
        member = lid[b] == bl
        left = bins[f] == t if is_cat[f] else bins[f] <= t
        pcnt.append(int(member.sum()))
        nleft.append(int((member & left).sum()))
        go_right.append(member & ~left)
    scal = np.column_stack([
        np.ones(len(lanes)), rng.rand(len(lanes), 6) * 100,
        np.tile([5.0, 1e-3, 0.0, 1.0, 0.0], (len(lanes), 1))]
    ).astype(np.float32)
    return ((np.asarray(lanes), np.asarray(leaves), feats, thrs,
             is_cat[feats], np.asarray(pcnt), new_leaf, scal),
            np.asarray(nleft), go_right)


@pytest.mark.parametrize("dt,nb,cat", [(np.uint8, 40, False),
                                       (np.uint16, 300, False),
                                       (np.uint8, 40, True),
                                       (np.uint16, 300, True)])
def test_step_partition_is_the_numpy_partition(dt, nb, cat):
    B, n, F, leaves, L = 4, 3000, 5, 3, 6
    rng, (bins, g, h, m, lid), meta, hists, is_cat = _forest(
        11 + nb + cat, B, n, F, nb, dt, leaves, L)
    is_cat[:] = cat
    meta[:, :, 2] = int(cat)
    lid0 = lid.numpy().copy()
    spec, nleft, go_right = _spec(rng, lid0, bins.numpy(), range(B),
                                  rng.randint(0, leaves, B), is_cat, nb,
                                  leaves)
    rows = forest_step_plain(bins, g, h, m, lid, meta, hists, nb, *spec)
    want = lid0.copy()
    for b in range(B):
        want[b][go_right[b]] = leaves
    assert lid.numpy().tobytes() == want.tobytes()
    assert rows[:, 0, 11].tolist() == nleft.astype(np.float32).tolist()
    assert rows.shape == (B, 2, 16)


@pytest.mark.parametrize("tie", [True, False])
def test_step_smaller_side_ties_to_the_left(tie):
    """A leaf of 2k rows whose left side holds k (tie: left) or k + 1
    (right is smaller): the left or the right row is the direct
    histogram of its child, the other parent - smaller."""
    B, n, F, nb, L = 1, 64, 2, 8, 3
    bins = torch.zeros((F, n), dtype=torch.uint8)
    k = 16
    bins[0, :2 * k] = torch.tensor([0] * (k + (0 if tie else 1))
                                   + [5] * (k - (0 if tie else 1)))
    lid = torch.full((B, n), -1, dtype=torch.int32)
    lid[0, :2 * k] = 0
    rng = np.random.RandomState(5)
    g = torch.from_numpy(rng.randn(B, n).astype(np.float32))
    h = torch.from_numpy(np.abs(rng.randn(B, n)).astype(np.float32))
    m = torch.ones((B, n))
    meta = pack_meta(torch.ones(F, dtype=torch.bool), torch.full((F,), nb),
                     torch.zeros(F, dtype=torch.bool), "cpu")[None]
    hists = torch.zeros((B, L, F, nb, 3))
    hists[:, 0] = forest_histogram_plain(bins, g, h, m, lid,
                                         torch.zeros(1, dtype=torch.int32),
                                         nb)
    parent = hists[0, 0].clone()
    scal = np.array([[1, 0, 1, 16, 0, 1, 16, 1, 0, 0, 1, 0]], np.float32)
    rows = forest_step_plain(bins, g, h, m, lid, meta, hists, nb, [0], [0],
                             [0], [0], [False], [2 * k], 1, scal)
    nleft = k + (0 if tie else 1)
    assert float(rows[0, 0, 11]) == nleft
    direct = [forest_histogram_plain(bins, g, h, m, lid,
                                     torch.tensor([c], dtype=torch.int32),
                                     nb)[0] for c in (0, 1)]
    small = 0 if tie else 1  # the left child when 2 * nleft <= pcnt
    assert hists[0, small].numpy().tobytes() == \
        direct[small].numpy().tobytes()
    assert hists[0, 1 - small].numpy().tobytes() == \
        (parent - direct[small]).numpy().tobytes()


@pytest.mark.parametrize("dt,nb", [(np.uint8, 40), (np.uint16, 300)])
def test_step_leaves_inactive_lanes_and_writes_both_rows(dt, nb):
    B, n, F, leaves, L = 5, 4500, 4, 3, 5
    rng, (bins, g, h, m, lid), meta, hists, is_cat = _forest(
        17 + nb, B, n, F, nb, dt, leaves, L)
    lanes = [0, 2, 3]  # ascending; lanes 1 and 4 sit this step out
    bls = [2, 0, 1]
    new_leaf = leaves
    spec, nleft, _ = _spec(rng, lid.numpy(), bins.numpy(), lanes, bls,
                           is_cat, nb, new_leaf)
    lid0, hists0 = lid.clone(), hists.clone()
    rows = forest_step_plain(bins, g, h, m, lid, meta, hists, nb, *spec)
    for b in (1, 4):
        assert lid[b].numpy().tobytes() == lid0[b].numpy().tobytes()
        assert hists[b].numpy().tobytes() == hists0[b].numpy().tobytes()
    pcnt = spec[5]

    def lane_hist(b, leaf):
        tgt = torch.full((B,), -1, dtype=torch.int32)
        tgt[b] = leaf
        return forest_histogram_plain(bins, g, h, m, lid, tgt, nb)[b]

    for i, (b, bl) in enumerate(zip(lanes, bls)):
        left, right = lane_hist(b, bl), lane_hist(b, new_leaf)
        small_left = 2 * nleft[i] <= pcnt[i]
        small, large = (0, 1) if small_left else (1, 0)
        slot = (bl, new_leaf)
        want_small = (left, right)[small]
        assert hists[b, slot[small]].numpy().tobytes() == \
            want_small.numpy().tobytes()
        assert hists[b, slot[large]].numpy().tobytes() == \
            (hists0[b, bl] - want_small).numpy().tobytes()
        for s in range(L):  # every other row of the lane untouched
            if s not in slot:
                assert hists[b, s].numpy().tobytes() == \
                    hists0[b, s].numpy().tobytes()
        want = forest_search_plain(
            hists[b, bl][None], hists[b, new_leaf][None], meta[b][None],
            torch.from_numpy(spec[7][i:i + 1]))[0]
        want[0, 11] = nleft[i]
        assert rows[i].numpy().tobytes() == want.numpy().tobytes()


def test_forest_step_on_cpu_takes_the_plain_path():
    B, n, F, nb, leaves, L = 4, 2500, 6, 32, 3, 5
    rng, (bins, g, h, m, lid), meta, hists, is_cat = _forest(
        23, B, n, F, nb, np.uint8, leaves, L)
    lid[:, :200] = 0
    spec, _, _ = _spec(rng, lid.numpy(), bins.numpy(), [1, 3], [0, 2],
                       is_cat, nb, leaves)
    before = launch_counts()
    lid_p, hists_p = lid.clone(), hists.clone()
    want = forest_step_plain(bins, g, h, m, lid_p, meta, hists_p, nb, *spec)
    fs = ForestStep(bins, g, h, m, lid, nb, meta=meta, hists=hists)
    assert not fs.cuda
    got = fs.step(*spec)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    assert lid.numpy().tobytes() == lid_p.numpy().tobytes()
    assert hists.numpy().tobytes() == hists_p.numpy().tobytes()
    # the root form: leaf 0 of every lane into hists[:, 0], searched as
    # both children
    scal = np.tile(np.array([1, 0, 1, 50, 0, 1, 50, 5, 1e-3, 0, 1, 0],
                            np.float32), (B, 1))
    rows = fs.root(scal)
    h0 = forest_histogram_plain(bins, g, h, m, lid,
                                torch.zeros(B, dtype=torch.int32), nb)
    assert hists[:, 0].numpy().tobytes() == h0.numpy().tobytes()
    assert rows.numpy().tobytes() == forest_search_plain(
        h0, h0, meta, torch.from_numpy(scal)).numpy().tobytes()
    hists[:, 0] = 0
    assert fs.root_histogram().numpy().tobytes() == h0.numpy().tobytes()
    assert launch_counts() == before
    assert cuda_forest.LAUNCHES == before["F1"]
