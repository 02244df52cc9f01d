"""Kernel S1's host-side plan (ops/cuda_sparse_hist.py) on the CPU.

S1 (csrc/sparse_histogram.cu) launches one block per (segment, leaf tile)
and one per (feature of several segments, leaf tile); a block holds the
[Lt, B, 3] cells of its tile in shared memory.  ``leaf_tiles`` cuts the
leaves, ``tile_smem`` is the block's shared memory (the C entry's own
sum, which refuses a tile above SMEM_MAX).  Checked here for shapes from
one-hot data (B = 2, 255 leaves) to 128 x 255 and 255 x 300:

* the tiles cover every leaf exactly once, none empty, each within the
  shared-memory budget, and no fewer tiles would fit;
* over a real segment table (ops/sparse_hist.csc_from_csr, one and many
  segments a feature), the blocks as the kernel maps them write every
  (leaf, feature) of the output exactly once and every (slab, leaf) of
  the scratch exactly once, each feature's segments stay the fixed,
  contiguous cut of its entries in order, and the fold reads a feature's
  slabs in segment order;
* the wrapper refuses a leaf whose bins alone exceed the budget and a
  CPU tensor;
* ``GBDT._level_hist_fn`` sends a sparse set to S1 only up to
  ``MAX_BINS`` (17,319) bins, on every device, and above it to the dense
  level route; on the card (marked ``cuda``) a 20,000-bin sparse set
  trains through K1'' and grows the CPU's trees.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.ops import launch_counts, reset_launch_counts
from lightgbm_tpu_torch.ops import sparse_hist
from lightgbm_tpu_torch.ops.cuda_sparse_hist import (
    MAX_BINS, SMEM_MAX, leaf_tiles, sparse_histogram_by_leaf_cuda, tile_smem)

SHAPES = [(255, 2), (237, 2), (1, 2), (16, 255), (64, 255), (128, 255),
          (200, 300), (255, 300), (9, 300), (7, 5000)]


@pytest.mark.parametrize("L,B", SHAPES)
def test_tiles_cover_every_leaf_once_within_budget(L, B):
    lt, tiles = leaf_tiles(L, B)
    spans = [range(t * lt, min(L, t * lt + lt)) for t in range(tiles)]
    assert all(len(r) > 0 for r in spans)
    assert [leaf for r in spans for leaf in r] == list(range(L))
    assert tile_smem(lt, B) <= SMEM_MAX
    # the fewest tiles: one tile fewer would not fit
    assert tiles == 1 or tile_smem(-(-L // (tiles - 1)), B) > SMEM_MAX


def test_tiles_of_the_main_shapes():
    """One-hot data and 16 x 255 bins in one tile; 128 x 255 in two."""
    assert leaf_tiles(255, 2) == (255, 1)
    assert leaf_tiles(16, 255) == (16, 1)
    assert leaf_tiles(128, 255) == (64, 2)
    assert leaf_tiles(255, 300)[1] == 5


def _blocks(csc, L, B):
    """The writes of S1's blocks as csrc/sparse_histogram.cu maps them:
    (destination, feature or slot, leaf) of every cell row written, and
    each stored block's entry range."""
    lt, tiles = leaf_tiles(L, B)
    feat = csc["seg_feat"].numpy()
    slot = csc["seg_slot"].numpy()
    begin, end = csc["seg_begin"].numpy(), csc["seg_end"].numpy()
    writes, reads = [], []
    for b in range(len(feat) * tiles):  # s1_stored_kernel
        s, l0 = b // tiles, (b % tiles) * lt
        leaves = range(l0, min(L, l0 + lt))
        reads.append((s, int(begin[s]), int(end[s])))
        if slot[s] < 0:
            writes += [("out", int(feat[s]), leaf) for leaf in leaves]
        else:
            writes += [("slab", int(slot[s]), leaf) for leaf in leaves]
    ff, fs, fn = (csc[k].numpy() for k in ("fold_feat", "fold_slot",
                                           "fold_nseg"))
    for b in range(len(ff) * tiles):  # s1_fold_kernel
        j, l0 = b // tiles, (b % tiles) * lt
        writes += [("out", int(ff[j]), leaf)
                   for leaf in range(l0, min(L, l0 + lt))]
    return writes, reads


@pytest.mark.parametrize("L,B,seg", [(255, 2, 4096), (255, 2, 16),
                                     (128, 255, 65536), (128, 255, 32),
                                     (255, 300, 48), (16, 255, 65536)])
def test_blocks_write_each_cell_row_once(L, B, seg):
    rng = np.random.RandomState(L + B + seg)
    n, F = 3000, 12
    indptr = np.concatenate([[0], np.cumsum(rng.poisson(2, n))])
    col = rng.randint(0, F, int(indptr[-1]))
    col[:400] = 3  # a feature of many entries: several segments
    bins = rng.randint(0, B, len(col)).astype(np.uint16 if B > 255
                                              else np.uint8)
    csc = sparse_hist.csc_from_csr(indptr, col, bins,
                                   rng.randint(0, B, F).astype(np.int32), F,
                                   "cpu", seg)
    writes, reads = _blocks(csc, L, B)
    nslots = csc["num_slots"]
    assert len(writes) == len(set(writes))
    assert {w for w in writes if w[0] == "out"} == {
        ("out", f, leaf) for f in range(F) for leaf in range(L)}
    assert {w for w in writes if w[0] == "slab"} == {
        ("slab", k, leaf) for k in range(nslots) for leaf in range(L)}
    # the segments: the fixed cut of each feature's entries, in order
    col_ptr = csc["col_ptr"].numpy()
    feat = csc["seg_feat"].numpy()
    for f in range(F):
        mine = sorted({(b, e) for s, b, e in reads if feat[s] == f})
        assert mine[0][0] == col_ptr[f] and mine[-1][1] == col_ptr[f + 1]
        assert all(a[1] == b[0] for a, b in zip(mine, mine[1:]))
        assert all(e - b <= seg for b, e in mine)
    # the fold reads a feature's slabs in segment order
    slot = csc["seg_slot"].numpy()
    for f, s0, k in zip(*(csc[x].numpy() for x in ("fold_feat", "fold_slot",
                                                   "fold_nseg"))):
        assert list(slot[feat == f]) == list(range(s0, s0 + k))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="bins in shared memory"):
        leaf_tiles(1, 20_000)
    csc = sparse_hist.csc_from_csr(np.array([0, 1]), np.array([0]),
                                   np.array([1], np.uint8),
                                   np.zeros(1, np.int32), 1, "cpu")
    one = torch.ones(1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sparse_histogram_by_leaf_cuda(csc, torch.zeros(1, dtype=torch.int32),
                                      one, one, one, 2, 2)


@pytest.mark.parametrize("bins,device", [(17_319, "cpu"), (17_320, "cpu"),
                                         (17_319, "cuda"),
                                         (17_320, "cuda")])
def test_dispatch_sends_sets_s1_cannot_hold_to_the_dense_route(bins,
                                                               device):
    """S1 takes a sparse set whose one leaf of bins fits its block; one
    bin more goes to the dense level route, whatever the device (the
    dispatch reads no card)."""
    assert MAX_BINS == 17_319
    leaf_tiles(1, MAX_BINS)
    with pytest.raises(ValueError):
        leaf_tiles(1, MAX_BINS + 1)
    ds = SimpleNamespace(is_sparse=True, density=0.01,
                         sparse_device=lambda dev: {})
    gb = SimpleNamespace(train_set=ds, _num_bins=bins, device=device,
                         _acc_dtype=torch.float32,
                         config=SimpleNamespace(hist_dtype="float32",
                                                sparse_hist_density=0.05))
    name = GBDT._level_hist_fn(gb).__qualname__
    want = "make_sparse_hist_fn" if bins <= MAX_BINS else "make_level_hist_fn"
    assert name.startswith(want), name


def _grow_wide(device):
    """Two depthwise trees on a sparse set of 20,000 bins (density 0.04)."""
    rng = np.random.RandomState(0)
    n, F = 100_000, 20
    X = np.zeros((n, F))
    on = rng.rand(n, F) < 0.01
    on[:, 0] = rng.rand(n) < 0.6  # 60,000 distinct values: 20,000 bins
    X[on] = rng.randn(on.sum())
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
    params = {"objective": "binary", "tree_growth": "depthwise",
              "max_bin": 20_000, "num_leaves": 15, "verbose": -1}
    ds = lt.Dataset(sp.csr_matrix(X), label=y, params=params, device=device)
    reset_launch_counts()
    bst = lt.train(params, ds, 2, device=device)
    inner = ds.construct()
    assert inner.is_sparse and inner.density <= 0.05
    assert bst._gbdt._num_bins > MAX_BINS
    return bst._gbdt.models, launch_counts()


@pytest.mark.cuda
def test_wide_sparse_set_trains_on_card_as_on_cpu():
    """A sparse set S1 cannot hold trains on the card through K1'' (no
    S1 launch) and grows the CPU's trees bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the dense level route's K1'')")
    card, counts = _grow_wide("cuda")
    cpu, _ = _grow_wide("cpu")
    assert counts["S1"] == 0 and counts["K1″"] > 0, counts
    for a, b in zip(card, cpu):
        assert a.num_leaves == b.num_leaves
        for k in ("split_feature", "threshold_bin", "left_child",
                  "right_child", "leaf_count", "split_gain", "leaf_value"):
            assert torch.equal(getattr(a, k).cpu(), getattr(b, k)), k
