"""Kernel P2's host-side plan (ops/cuda_predict_binned.py) on the CPU.

P2 (csrc/predict_binned.cu) takes a tile of R rows a block, their [F, R]
bins in shared memory when the tile fits, and walks S = 256 / R listed
trees at once; a tile of 256 rows stages its trees' records.
``p2_config`` picks (rows, tiled, slots, stage) from the shapes alone.
Checked here:

* the tile's bytes at F = 28, 136 and 2,000 in uint8 and uint16, its
  padded row (the next feature 8 banks on per bin byte), the rows cut to
  the floor before the tile is given up, the wide configuration above
  the budget, the many-class cut, and every choice within the kernel's
  own limits (stage a multiple of 4 holding the largest tree, staging
  only at 256 rows, 48 KB);
* the tree slots for lists of 1, 30 and 100 trees at few and many rows;
* the blocks cover every row once when n is not a multiple of R.

That the kernel adds in the plain version's order in every configuration
is held on the card (tests/test_torch_p2_card.py, chip_smoke.py).
"""

import numpy as np
import pytest

from lightgbm_tpu_torch.ops.cuda_predict_binned import (
    MIN_TILED_ROWS, SMEM_BYTES, STAGE_RECORDS, THREADS, p2_config,
    smem_bytes, stage_leaves, tile_stride)

SMS = 132  # an H100 SXM
BENCH = 254  # internal nodes of a 255-leaf tree


def _ok_for_the_kernel(cfg, n, F, bb, T, K, max_nodes, replay):
    rows, tiled, slots, stage = cfg
    assert rows * slots == THREADS and THREADS % rows == 0
    assert stage % 4 == 0 and stage >= 0
    if stage:
        assert tiled and rows == THREADS and max_nodes <= stage
        assert stage_leaves(stage) >= max_nodes + 1
    assert smem_bytes(rows, F, bb, K, replay, tiled, stage) <= SMEM_BYTES


@pytest.mark.parametrize("F,bb,want", [
    (28, 1, (256, True, 1, 256)),     # the bench rows: staged, 8 KB tile
    (28, 2, (256, True, 1, 256)),     # uint16: 16 KB tile
    (136, 1, (256, True, 1, 256)),    # LambdaRank: 38 KB tile
    (136, 2, (128, True, 2, 0)),      # cut to 128 rows and two slots
    (2000, 1, (256, False, 1, 0)),    # wide: 2,000 bins a row
    (2000, 2, (256, False, 1, 0)),
])
def test_one_tree_over_1m_rows(F, bb, want):
    cfg = p2_config(1_000_000, F, bb, 1, 1, SMS, BENCH)
    assert cfg == want
    _ok_for_the_kernel(cfg, 1_000_000, F, bb, 1, 1, BENCH, False)


@pytest.mark.parametrize("F,bb,tile", [
    (28, 1, 28 * 288), (28, 2, 28 * 576), (136, 1, 136 * 288),
    (136, 2, 136 * 576), (2000, 1, 2000 * 288), (2000, 2, 2000 * 576)])
def test_tile_bytes_at_256_rows(F, bb, tile):
    """A feature's 256 bins padded by 32 bytes a bin byte: feature f + 1
    starts 8 (uint8) or 16 (uint16) banks after feature f, so the four
    (two) lanes that share a word column at different features hit
    different banks."""
    stride = tile_stride(THREADS, bb)
    assert F * stride == tile
    assert stride % 16 == 0 and (stride // 4) % 32 == 8 * bb
    base = smem_bytes(THREADS, F, bb, 1, False, False)
    assert smem_bytes(THREADS, F, bb, 1, False, True) == base + tile
    # lanes 0-3 (uint8) / 0-1 (uint16) of one word column, features
    # 0..3 / 0..1: four / two different banks
    per = 4 // bb
    banks = {((f * stride + r * bb) // 4) % 32 for f, r in
             zip(range(per), range(per))}
    assert len(banks) == per


@pytest.mark.parametrize("rows", [1, 2, 8, 32, 64, 128, 256])
@pytest.mark.parametrize("bb", [1, 2])
def test_tile_stride_holds_the_rows(rows, bb):
    s = tile_stride(rows, bb)
    assert s >= rows * bb and s % 16 == 0 and s - rows * bb < 16 + 32 * bb


def test_rows_cut_to_the_floor_before_the_tile_goes():
    """F = 136 uint16 tiles at 128 rows; a width whose tile fits only at
    32 rows is cut to 32; one that does not fit there is wide."""
    assert p2_config(1_000_000, 136, 2, 1, 1, SMS, BENCH)[:2] == (128, True)
    fit32 = max(F for F in range(1, 3000)
                if smem_bytes(32, F, 1, 1, False, True) <= SMEM_BYTES)
    assert smem_bytes(64, fit32, 1, 1, False, True) > SMEM_BYTES
    assert p2_config(1_000_000, fit32, 1, 1, 1, SMS, BENCH) == (
        MIN_TILED_ROWS, True, THREADS // MIN_TILED_ROWS, 0)
    assert p2_config(1_000_000, fit32 + 1, 1, 1, 1, SMS, BENCH) == (
        THREADS, False, 1, 0)


@pytest.mark.parametrize("n,T,want_rows", [
    (1_000_000, 1, 256), (1_000_000, 30, 256), (1_000_000, 100, 256),
    (200_000, 1, 256), (200_000, 30, 256), (200_000, 100, 256),
    (1000, 1, 256), (1000, 30, 8), (1000, 100, 2),
    (30_000, 30, 64), (30_000, 100, 64), (1, 100, 2), (1, 300, 1)])
def test_tree_slots(n, T, want_rows):
    """S = 256 / R covers the whole list at few rows (one tree deep a
    thread); at the training and valid rows R = 256 and S = 1, the card
    full of independent rows."""
    for replay in (False, True):
        cfg = p2_config(n, 28, 1, T, 1, SMS, BENCH, replay)
        assert cfg[0] == want_rows and cfg[2] == THREADS // want_rows
        assert cfg[1]
        _ok_for_the_kernel(cfg, n, 28, 1, T, 1, BENCH, replay)
    # the list fits in the slots whenever the grid stays small
    rows = p2_config(n, 28, 1, T, 1, SMS, BENCH)[0]
    assert THREADS // rows >= min(T, THREADS) or \
        -(-n // rows) >= 2 * SMS


def test_staging_needs_a_tree_within_the_stage():
    assert p2_config(1_000_000, 28, 1, 3, 1, SMS, BENCH)[3] == 764
    assert p2_config(1_000_000, 28, 1, 100, 1, SMS, BENCH)[3] == \
        STAGE_RECORDS
    big = STAGE_RECORDS + 1
    assert p2_config(1_000_000, 28, 1, 1, 1, SMS, big) == (
        THREADS, True, 1, 0)
    assert p2_config(1_000_000, 28, 1, 5, 1, SMS, 0)[3] == 0  # stumps
    assert p2_config(1_000_000, 28, 1, 1, 1, SMS, 5)[3] == 8


@pytest.mark.parametrize("K,replay", [(5, False), (5, True), (100, False),
                                      (100, True), (3000, True)])
def test_many_classes_cut_the_rows(K, replay):
    cfg = p2_config(1_000_000, 28, 1, K, K, SMS, BENCH, replay)
    _ok_for_the_kernel(cfg, 1_000_000, 28, 1, K, K, BENCH, replay)
    with pytest.raises(ValueError):
        p2_config(1000, 28, 1, 1, 50_000, SMS, BENCH, replay)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 200_001])
def test_blocks_cover_every_row_once(n):
    for T in (1, 30):
        rows = p2_config(n, 28, 1, T, 1, SMS, BENCH)[0]
        grid = -(-n // rows)
        covered = np.zeros(n, np.int64)
        for blk in range(grid):
            row0 = blk * rows
            nr = min(rows, n - row0)
            assert nr > 0
            covered[row0:row0 + nr] += 1
        assert (covered == 1).all()
