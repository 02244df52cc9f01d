"""The float64 kernels on the card against their plain versions.

Kernel 1-f64 (``histogram_single_leaf``), kernel 1''-f64
(``histogram_by_leaf_sorted``) and kernel 3-f64 (``search2_rows`` on
float64 histograms) are each held bitwise against the plain version on
the CPU, two launches equal, at shapes that reach the kernels' branches
(u16 bins above the count table, several chunks, empty chunks and
leaves, categorical features, every scan level); then float64 training on
the card (leaf-wise, pooled, depthwise, hybrid) grows the CPU's trees
bitwise and launches no float32 histogram or search kernel.  No JAX here
(tests/test_torch_f64.py holds the plain versions against the JAX
package; chip_smoke.py phase 22 holds the kernels at the bench shape)::

    python3 -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_f64_card.py
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import launch_counts, reset_launch_counts
from lightgbm_tpu_torch.ops.cuda_histogram import (histogram_by_leaf_sorted,
                                                   histogram_single_leaf)
from lightgbm_tpu_torch.ops.cuda_search import pack_meta, search2_rows

F64 = torch.float64
TREE = ("split_feature", "threshold_bin", "decision_type", "left_child",
        "right_child", "leaf_count", "leaf_parent", "leaf_depth",
        "split_gain", "internal_value", "internal_count", "leaf_value",
        "threshold_real")
FLOAT32_KERNELS = ("K1", "K1'", "K3", "K4", "K5", "K6", "K7", "K8", "K1″",
                   "K2", "S1")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")


def _rows(n, F, B, dt, seed):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, n)).astype(dt)
    stats = (rng.randn(n).astype(np.float32),
             np.abs(rng.randn(n)).astype(np.float32),
             (rng.rand(n) < 0.8).astype(np.float32))
    return [torch.from_numpy(a) for a in (bins,) + stats]


@pytest.mark.cuda
@pytest.mark.parametrize("F,n,B,dt", [(28, 0, 255, np.uint8),
                                      (28, 1, 255, np.uint8),
                                      (5, 2049, 37, np.uint8),
                                      (29, 130_001, 255, np.uint8),
                                      (3, 20_000, 5000, np.uint16)],
                         ids=["0", "1", "2049", "130001", "u16x5000"])
def test_k1_f64_matches_plain(F, n, B, dt):
    _card()
    cpu = _rows(n, F, B, dt, seed=n)
    dev = [t.cuda() for t in cpu]
    a = histogram_single_leaf(*dev, B, acc_dtype=F64)
    b = histogram_single_leaf(*dev, B, acc_dtype=F64)
    assert a.dtype == F64 and torch.equal(a, b)
    assert torch.equal(a.cpu(), histogram_single_leaf(*cpu, B,
                                                      acc_dtype=F64))


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,B,dt", [(100_000, 255, 255, np.uint8),
                                      (30_000, 4, 5000, np.uint16),
                                      (9_000, 40, 63, np.uint8)],
                         ids=["255-leaves", "u16x5000", "empty-leaves"])
def test_k1pp_f64_matches_plain(n, L, B, dt):
    _card()
    bins, g, h, m = _rows(n, 7, B, dt, seed=L)
    rng = np.random.RandomState(L)
    lid = rng.randint(0, L, n)
    if L == 40:
        lid = 3 * rng.randint(0, L // 3, n)  # two thirds of the leaves empty
    lid = torch.from_numpy(lid.astype(np.int32))
    cpu = (bins, lid, g, h, m)
    dev = [t.cuda() for t in cpu]
    a = histogram_by_leaf_sorted(*dev, B, L, acc_dtype=F64)
    b = histogram_by_leaf_sorted(*dev, B, L, acc_dtype=F64)
    assert a.dtype == F64 and torch.equal(a, b)
    assert torch.equal(a.cpu(), histogram_by_leaf_sorted(*cpu, B, L,
                                                         acc_dtype=F64))


@pytest.mark.cuda
@pytest.mark.parametrize("F,B", [(28, 255), (6, 7), (6, 300), (4, 600),
                                 (3, 5000), (136, 255)])
def test_k3_f64_matches_plain(F, B):
    _card()
    rng = np.random.RandomState(F * B)
    for case in range(10):
        hists = []
        for _ in range(2):
            bins, g, h, m = _rows(3000, F, B, np.uint16, rng.randint(1 << 30))
            hists.append(histogram_single_leaf(bins, g, h, m, B,
                                               acc_dtype=F64))
        tot = [h[0].sum(0).tolist() for h in hists]
        meta = pack_meta(torch.from_numpy(rng.rand(F) < 0.9),
                         torch.from_numpy(rng.randint(2, B + 1, F)),
                         torch.from_numpy(rng.rand(F) < 0.2), "cpu")
        scal = [1.0, *tot[0], *tot[1], 20.0, 1e-3, 0.1 * (case % 2), 1.0,
                0.0]
        want = search2_rows(hists[0], hists[1], scal, meta)
        got = search2_rows(hists[0].cuda(), hists[1].cuda(), scal,
                           meta.cuda())
        assert got.dtype == F64 and torch.equal(got.cpu(), want), case


def _grow(device, growth, extra=None):
    rng = np.random.RandomState(2)
    X = rng.randn(20_000, 8)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.randn(20_000) > 0)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "hist_dtype": "float64", "tree_growth": growth, "verbose": -1,
              **(extra or {})}
    reset_launch_counts()
    bst = lt.train(params, lt.Dataset(X, label=y.astype(np.float32),
                                      max_bin=63, device=device), 3,
                   device=device)
    return bst._gbdt.models, launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("growth,extra", [("leafwise", None),
                                          ("leafwise",
                                           {"histogram_pool_size": 0.05}),
                                          ("depthwise", None),
                                          ("hybrid", None)],
                         ids=["leafwise", "pooled", "depthwise", "hybrid"])
def test_float64_training_on_card_matches_cpu(growth, extra):
    _card()
    card, counts = _grow("cuda", growth, extra)
    cpu, _ = _grow("cpu", growth, extra)
    for a, b in zip(card, cpu):
        assert a.num_leaves == b.num_leaves
        for k in TREE:
            assert torch.equal(getattr(a, k).cpu(), getattr(b, k)), k
    assert not any(counts[k] for k in FLOAT32_KERNELS), counts
    if growth == "depthwise":
        assert counts["K1″-f64"] > 0 and counts["K1-f64"] == 0
    else:
        assert counts["K1-f64"] > 0 and counts["K3-f64"] > 0
