"""Kernels F1 and F3 (csrc/forest.cu) on the card against their plain
versions.

F1's and F3's root forms (``ForestStep.root_histogram``,
``root_search``) are each held bitwise against the plain version on the
CPU (ops/forest.py), two calls equal: lanes of 100 to 5,000 rows
(several 2,048-row blocks, the root in two lane batches), u8 and u16
bins, F = 28 and 136, a lane with an empty root, every feature masked in
a lane.  Their step forms (``ForestStep.step``)
against ``forest_step_plain``: the leaf map, the buffer and the rows,
bitwise, with inactive lanes, a tie and categorical splits; F1 a call at
most three kernels and F3 one, and a step call allocates nothing.  Then
``grow_forest`` on the card grows the CPU's trees and leaf maps bitwise,
through F1 and F3 only.  No JAX here
(tests/test_torch_forest.py holds the plain versions against the order
route and the JAX package; chip_smoke.py phase 24 holds the kernels at
the bench shapes)::

    python3 -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_forest_card.py
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.learners.forest import grow_forest
from lightgbm_tpu_torch.learners.serial import TreeLearnerParams
from lightgbm_tpu_torch.models.tree import TREE_FIELDS
from lightgbm_tpu_torch.ops import (cuda_forest, launch_counts,
                                    reset_launch_counts)
from lightgbm_tpu_torch.ops.cuda_forest import ForestStep
from lightgbm_tpu_torch.ops.cuda_search import pack_meta
from lightgbm_tpu_torch.ops.forest import (forest_histogram_plain,
                                           forest_search_plain,
                                           forest_step_plain)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")


def _case(B, n, F, nb, dt, leaves, seed):
    """CPU tensors of the roots: bins, gradients, a map over ``leaves``
    leaves (-1 outside; lane 2 has no row of leaf 0), meta with every
    feature of the last lane masked, an L = 2 buffer."""
    rng = np.random.RandomState(seed)
    lid = rng.randint(-1, leaves, (B, n)).astype(np.int32)
    if B > 2:
        lid[2][lid[2] == 0] = -1  # an empty root
    fm = rng.rand(B, F) < 0.8
    fm[-1] = False
    meta = torch.stack([pack_meta(torch.from_numpy(fm[a]),
                                  torch.full((F,), nb),
                                  torch.from_numpy(rng.rand(F) < 0.1), "cpu")
                        for a in range(B)])
    t = [torch.from_numpy(rng.randint(0, nb, (F, n)).astype(dt)),
         torch.from_numpy(rng.randn(B, n).astype(np.float32)),
         torch.from_numpy(np.abs(rng.randn(B, n)).astype(np.float32)),
         torch.from_numpy((rng.rand(B, n) < 0.8).astype(np.float32)),
         torch.from_numpy(lid)]
    return t, meta, torch.zeros((B, 2, F, nb, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,F,nb,dt,leaves", [
    (1, 100, 28, 255, np.uint8, 1), (8, 2048, 28, 255, np.uint8, 4),
    (8, 5000, 136, 300, np.uint16, 2), (64, 5000, 28, 255, np.uint8, 8)])
def test_f1_matches_plain_on_card(B, n, F, nb, dt, leaves):
    _card()
    cpu, meta, hists = _case(B, n, F, nb, dt, leaves, seed=B + n)
    want = forest_histogram_plain(*cpu, torch.zeros(B, dtype=torch.int32),
                                  nb)
    fs = ForestStep(*(t.cuda() for t in cpu), nb, meta=meta.cuda(),
                    hists=hists.cuda())
    calls = cuda_forest.LAUNCHES
    a = fs.root_histogram().clone()
    calls = cuda_forest.LAUNCHES - calls
    b = fs.root_histogram()
    torch.cuda.synchronize()
    # above one 2,048-row chunk the scratch (sized at the steps' bound)
    # holds fewer roots than lanes: two calls
    assert calls == (1 if n <= 2048 or B == 1 else 2)
    assert torch.equal(a, b)
    assert a.cpu().numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("A,F,nb", [(1, 28, 255), (8, 136, 300),
                                    (64, 28, 255)])
def test_f3_matches_plain_on_card(A, F, nb):
    _card()
    rng = np.random.RandomState(A + F)
    cpu, meta, hists = _case(A, 3000, F, nb, np.uint8, 1, seed=A)
    h0 = forest_histogram_plain(*cpu, torch.zeros(A, dtype=torch.int32), nb)
    hists[:, 0] = h0
    tot = h0[:, 0].sum(1).numpy()
    scal = np.column_stack([
        rng.rand(A) < 0.9, tot, tot, rng.choice([1.0, 20.0], A),
        rng.choice([0.0, 1e-3], A), rng.choice([0.0, 0.5], A),
        rng.choice([0.5, 10.0], A), rng.choice([0.0, 0.1], A)]).astype(
            np.float32)
    want = forest_search_plain(h0, h0, meta, torch.from_numpy(scal))
    fs = ForestStep(*(t.cuda() for t in cpu), nb, meta=meta.cuda(),
                    hists=hists.cuda())
    a = fs.root_search(scal).clone()
    b = fs.root_search(scal)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert a.cpu().numpy().tobytes() == want.numpy().tobytes()


def _step_case(B, n, F, nb, dt, L, seed):
    """CPU tensors of a step: a map over three leaves (-1 outside the root
    sets), meta with a categorical feature, a random buffer; lanes 0, 2,
    ... split leaf 1 on their own feature and threshold (lane 0: the
    categorical feature; lane 2: a tie, the threshold picked where
    2 * nleft == pcnt when the data allow)."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, nb, (F, n)).astype(dt)
    lid = rng.randint(-1, 3, (B, n)).astype(np.int32)
    is_cat = np.zeros(F, bool)
    is_cat[0] = True
    t = [torch.from_numpy(x) for x in (
        bins, rng.randn(B, n).astype(np.float32),
        np.abs(rng.randn(B, n)).astype(np.float32),
        (rng.rand(B, n) < 0.8).astype(np.float32), lid)]
    meta = torch.stack([pack_meta(torch.from_numpy(rng.rand(F) < 0.8),
                                  torch.full((F,), nb),
                                  torch.from_numpy(is_cat), "cpu")
                        for _ in range(B)])
    hists = torch.from_numpy(rng.rand(B, L, F, nb, 3).astype(np.float32))
    lanes = np.arange(0, B, 2)
    feats = rng.randint(1, F, len(lanes))
    feats[0] = 0
    thrs = rng.randint(0, nb, len(lanes))
    for i, b in enumerate(lanes):
        member = lid[b] == 1
        if i == 1:  # the tie: 2 * nleft == pcnt on the median bin
            v = np.sort(bins[feats[i]][member])
            if len(v) % 2 == 0 and len(v) and v[len(v) // 2 - 1] < \
                    v[len(v) // 2]:
                thrs[i] = v[len(v) // 2 - 1]
    pcnt = np.array([(lid[b] == 1).sum() for b in lanes])
    scal = np.column_stack([np.ones(len(lanes)),
                            rng.rand(len(lanes), 6) * 100,
                            np.tile([5.0, 1e-3, 0.0, 1.0, 0.0],
                                    (len(lanes), 1))]).astype(np.float32)
    spec = (lanes, np.ones(len(lanes), np.int64), feats, thrs,
            is_cat[feats], pcnt, 3, scal)
    return t, meta, hists, spec


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,F,nb,dt", [
    (1, 100, 28, 255, np.uint8), (8, 2048, 28, 255, np.uint8),
    (8, 5000, 136, 300, np.uint16), (64, 5000, 28, 255, np.uint8)])
def test_step_forms_match_plain_on_card(B, n, F, nb, dt):
    _card()
    L = 5
    cpu, meta, hists, spec = _step_case(B, n, F, nb, dt, L, seed=B + n)
    lid_p, hists_p = cpu[4].clone(), hists.clone()
    want = forest_step_plain(*cpu[:4], lid_p, meta, hists_p, nb, *spec)
    dev = [t.cuda() for t in cpu]
    hd = hists.cuda()
    fs = ForestStep(*dev, nb, meta=meta.cuda(), hists=hd)
    got = fs.step(*spec)
    torch.cuda.synchronize()
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
    assert dev[4].cpu().numpy().tobytes() == lid_p.numpy().tobytes()
    assert hd.cpu().numpy().tobytes() == hists_p.numpy().tobytes()
    # the root forms: leaf 0 of every lane into hists[:, 0]
    scal = np.tile(spec[7][:1], (B, 1))
    want_h0 = forest_histogram_plain(*cpu[:4], lid_p,
                                     torch.zeros(B, dtype=torch.int32), nb)
    rows = fs.root(scal)
    torch.cuda.synchronize()
    assert hd[:, 0].cpu().numpy().tobytes() == want_h0.numpy().tobytes()
    assert rows.cpu().numpy().tobytes() == forest_search_plain(
        want_h0, want_h0, meta, torch.from_numpy(scal)).numpy().tobytes()


def _kernels_a_call(fn):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "Memcpy" not in e.name]


@pytest.mark.cuda
def test_step_launches_and_allocates_nothing():
    _card()
    B, n, F, nb, L = 8, 5000, 28, 255, 5
    cpu, meta, hists, spec = _step_case(B, n, F, nb, np.uint8, L, seed=3)
    dev = [t.cuda() for t in cpu]
    fs = ForestStep(*dev, nb, meta=meta.cuda(), hists=hists.cuda())
    f1 = _kernels_a_call(lambda: fs.split_histogram(*spec))
    f3 = _kernels_a_call(fs.search)
    calls = cuda_forest.LAUNCHES
    root = _kernels_a_call(fs.root_histogram)
    calls = (cuda_forest.LAUNCHES - calls) // 2  # two calls of it
    # the root form runs as many lanes a call as the scratch holds
    assert 1 <= len(f1) <= 3 and len(f3) == 1, (f1, f3)
    assert calls >= 1 and len(root) <= 3 * calls, root
    fs.step(*spec)
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()["allocation.all.allocated"]
    fs.step(*spec)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == stats


@pytest.mark.cuda
def test_grow_forest_on_card_is_the_cpu_forest():
    _card()
    rng = np.random.RandomState(7)
    B, n, F, nb, L = 6, 5000, 12, 64, 15
    bins = torch.from_numpy(rng.randint(0, nb, (F, n)).astype(np.uint8))
    g = torch.from_numpy(rng.randn(B, n).astype(np.float32))
    h = torch.from_numpy(np.abs(rng.randn(B, n)).astype(np.float32) + .1)
    m = torch.from_numpy((rng.rand(B, n) < 0.8).astype(np.float32))
    fm = torch.from_numpy(rng.rand(B, F) < 0.8)
    nbpf = torch.full((F,), nb, dtype=torch.int32)
    cat = torch.zeros(F, dtype=torch.bool)
    params = [TreeLearnerParams(20.0, 1e-3, 0.0, float(b), 0.0, 0)
              for b in range(B)]
    roots = [None, torch.arange(0, n, 3)] + [None] * (B - 2)
    want, wlid = grow_forest(bins, g, h, m, fm, nbpf, cat, params, nb, L,
                             root_rows=roots)
    reset_launch_counts()
    got, lid = grow_forest(*(t.cuda() for t in (bins, g, h, m, fm, nbpf,
                                                cat)), params, nb, L,
                           root_rows=[None if r is None else r.cuda()
                                      for r in roots])
    counts = launch_counts()
    assert counts["F1"] > 0 and counts["F3"] > 0
    assert all(v == 0 for k, v in counts.items() if k not in ("F1", "F3"))
    assert lid.cpu().numpy().tobytes() == wlid.numpy().tobytes()
    for a, b in zip(want, got):
        assert a.num_leaves == b.num_leaves
        for k in TREE_FIELDS:
            if k != "num_leaves":
                assert getattr(a, k).numpy().tobytes() == \
                    getattr(b, k).cpu().numpy().tobytes(), k
