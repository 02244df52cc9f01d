"""Kernels F1 and F3 (csrc/forest.cu) on the card against their plain
versions.

F1 (``forest_histogram``) and F3 (``forest_search``) are each held
bitwise against the plain version on the CPU (ops/forest.py), two
launches equal: lanes of 100 to 5,000 rows (several 2,048-row blocks),
u8 and u16 bins, F = 28 and 136, idle lanes and empty targets, every
feature masked in a lane; then ``grow_forest`` on the card grows the
CPU's trees and leaf maps bitwise, through F1 and F3 only.  No JAX here
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
from lightgbm_tpu_torch.ops import launch_counts, reset_launch_counts
from lightgbm_tpu_torch.ops.cuda_forest import forest_histogram, forest_search
from lightgbm_tpu_torch.ops.cuda_search import pack_meta


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")


def _case(B, n, F, nb, dt, leaves, seed):
    rng = np.random.RandomState(seed)
    t = [torch.from_numpy(rng.randint(0, nb, (F, n)).astype(dt)),
         torch.from_numpy(rng.randn(B, n).astype(np.float32)),
         torch.from_numpy(np.abs(rng.randn(B, n)).astype(np.float32)),
         torch.from_numpy((rng.rand(B, n) < 0.8).astype(np.float32)),
         torch.from_numpy(rng.randint(-1, leaves, (B, n)).astype(np.int32))]
    tgt = rng.randint(0, leaves, B).astype(np.int32)
    tgt[0] = -1  # idle
    if B > 2:
        tgt[2] = leaves  # no row
    return t + [torch.from_numpy(tgt)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,F,nb,dt,leaves", [
    (1, 100, 28, 255, np.uint8, 1), (8, 2048, 28, 255, np.uint8, 4),
    (8, 5000, 136, 300, np.uint16, 2), (64, 5000, 28, 255, np.uint8, 8)])
def test_f1_matches_plain_on_card(B, n, F, nb, dt, leaves):
    _card()
    cpu = _case(B, n, F, nb, dt, leaves, seed=B + n)
    want = forest_histogram(*cpu, nb)
    dev = [t.cuda() for t in cpu]
    a = forest_histogram(*dev, nb)
    b = forest_histogram(*dev, nb)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert a.cpu().numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("A,F,nb", [(1, 28, 255), (8, 136, 300),
                                    (64, 28, 255)])
def test_f3_matches_plain_on_card(A, F, nb):
    _card()
    rng = np.random.RandomState(A + F)
    cpu = _case(2 * A, 3000, F, nb, np.uint8, 1, seed=A)
    cpu[5][:] = 0
    cpu[4][:] = 0
    hists = forest_histogram(*cpu, nb)
    h_l, h_r = hists[:A].contiguous(), hists[A:].contiguous()
    fm = rng.rand(A, F) < 0.8
    fm[-1] = False
    meta = torch.stack([pack_meta(torch.from_numpy(fm[a]),
                                  torch.full((F,), nb),
                                  torch.from_numpy(rng.rand(F) < 0.1), "cpu")
                        for a in range(A)])
    scal = torch.from_numpy(np.column_stack([
        rng.rand(A) < 0.9, h_l[:, 0].sum(1).numpy(), h_r[:, 0].sum(1).numpy(),
        rng.choice([1.0, 20.0], A), rng.choice([0.0, 1e-3], A),
        rng.choice([0.0, 0.5], A), rng.choice([0.5, 10.0], A),
        rng.choice([0.0, 0.1], A)]).astype(np.float32))
    want = forest_search(h_l, h_r, meta, scal)
    dev = [t.cuda() for t in (h_l, h_r, meta, scal)]
    a = forest_search(*dev)
    b = forest_search(*dev)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert a.cpu().numpy().tobytes() == want.numpy().tobytes()


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
