"""The port's level histogram (lightgbm_tpu_torch.ops.cuda_histogram
``histogram_by_leaf_sorted``, kernels 1'' and 2) against the JAX
package's.

On the CPU the port returns its plain version, which sums in the kernels'
order: the stable leaf sort, each leaf's rows in 2048-row blocks, each
block in row order, a leaf's block partials in block order.  The JAX side
runs its Pallas sorted kernel in interpret mode for both variants, as
tests/test_pallas_histogram.py does, at that file's shapes.  The count
channel is exact; g and h agree to rtol 1e-5 / atol 1e-4 (the Pallas
kernel sums each 1024-row chunk as a one-hot matmul; the port row by row;
the JAX file's own tolerance).  Against the JAX segment-sum
``histogram_by_leaf``, which adds every cell in row order, the plain
version is bitwise while each leaf has at most one block of rows.  The
leaf totals of depthwise growth are bitwise ``jnp.sum`` on the CPU.  The
CUDA kernels run only on the card (chip_smoke.py and the ``cuda``-marked
tests below).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lightgbm_tpu.ops.histogram import histogram_by_leaf as jax_by_leaf
from lightgbm_tpu.ops.pallas_histogram import (
    histogram_by_leaf_sorted as jax_sorted)
from lightgbm_tpu_torch.ops import cuda_histogram
from lightgbm_tpu_torch.ops.cuda_histogram import (histogram_by_leaf_sorted,
                                                   histogram_single_leaf)
from lightgbm_tpu_torch.ops.histogram import (
    CHUNK_ROWS, histogram_by_leaf, histogram_by_leaf_sorted_plain,
    histogram_feature_major, leaf_totals, level_layout)

# (name, n, F, B, L, leaf pattern, bin dtype, bin pattern):
# test_pallas_histogram.py's shapes, its empty and skewed leaves, one leaf,
# uint16 x 300 bins; ~90 % of the rows in one bin, with leaves of several
# 2048-row chunks (the kernels' longest per-bin run); uint16 x 5000 bins,
# more than the kernels' 4096-int count table holds (two bin-range passes)
CASES = [
    ("5000x6", 5000, 6, 16, 8, "random", np.uint8, "uniform"),
    ("1000x3", 1000, 3, 32, 4, "random", np.uint8, "uniform"),
    ("300x2", 300, 2, 7, 5, "random", np.uint8, "uniform"),
    ("all-in-0", 2000, 4, 16, 8, "zeros", np.uint8, "uniform"),
    ("tiny+empty", 2000, 4, 16, 8, "skewed", np.uint8, "uniform"),
    ("one-leaf", 2000, 4, 16, 1, "zeros", np.uint8, "uniform"),
    ("uint16", 3000, 3, 300, 6, "random", np.uint16, "uniform"),
    ("dominant-bin", 6000, 3, 32, 2, "random", np.uint8, "dominant"),
    ("many-bins", 3000, 2, 5000, 4, "random", np.uint16, "uniform"),
]
IDS = [c[0] for c in CASES]


def _inputs(n, F, B, L, pattern, dt, bin_pattern="uniform", seed=0):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(F, n)).astype(dt)
    if bin_pattern == "dominant":
        bins[rng.rand(F, n) < 0.9] = B // 3
    leaf = {"random": rng.randint(0, L, size=n),
            "zeros": np.zeros(n),
            "skewed": np.where(np.arange(n) < 5, L - 1, 2)}[pattern]
    return (bins, leaf.astype(np.int32), rng.randn(n).astype(np.float32),
            np.abs(rng.randn(n)).astype(np.float32),
            (rng.rand(n) > 0.3).astype(np.float32))


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("variant", ["v1", "bsub"])
@pytest.mark.parametrize("name,n,F,B,L,pattern,dt,bp", CASES, ids=IDS)
def test_matches_jax_sorted_interpret(name, n, F, B, L, pattern, dt, bp,
                                      variant):
    arrs = _inputs(n, F, B, L, pattern, dt, bp)
    ours = histogram_by_leaf_sorted(*_t(arrs), B, L, variant=variant)
    ref = np.asarray(jax_sorted(*(jnp.asarray(a) for a in arrs),
                                num_bins=B, num_leaves=L, interpret=True,
                                variant=variant))
    assert ours.shape == (L, F, B, 3) and ours.dtype == torch.float32
    ours = ours.numpy()
    np.testing.assert_array_equal(ours[..., 2], ref[..., 2])
    np.testing.assert_allclose(ours[..., :2], ref[..., :2], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("name,n,F,B,L,pattern,dt,bp", CASES, ids=IDS)
def test_matches_jax_segment_sum(name, n, F, B, L, pattern, dt, bp):
    arrs = _inputs(n, F, B, L, pattern, dt, bp, seed=3)
    ref = np.asarray(jax_by_leaf(*(jnp.asarray(a) for a in arrs),
                                 num_bins=B, num_leaves=L))
    # the port's segment-sum counterpart: every cell in row order, bitwise
    np.testing.assert_array_equal(histogram_by_leaf(*_t(arrs), B, L).numpy(),
                                  ref)
    plain = histogram_by_leaf_sorted_plain(*_t(arrs), B, L).numpy()
    np.testing.assert_array_equal(plain[..., 2], ref[..., 2])
    if np.bincount(arrs[1], minlength=L).max() <= CHUNK_ROWS:
        np.testing.assert_array_equal(plain, ref)  # one block per leaf
    else:
        np.testing.assert_allclose(plain, ref, rtol=1e-5, atol=1e-4)


def test_block_order_is_the_kernels():
    """A leaf of several blocks: each 2048-row block of its sorted rows
    summed in row order, the block partials added in block order."""
    n, F, B, L = 3 * CHUNK_ROWS + 500, 3, 11, 3
    bins, _, g, h, m = _inputs(n, F, B, L, "random", np.uint8, seed=5)
    leaf = np.where(np.arange(n) % 5 == 0, 2, 0).astype(np.int32)
    ours = histogram_by_leaf_sorted_plain(*_t((bins, leaf, g, h, m)), B, L)
    for lf in range(L):
        rows = np.flatnonzero(leaf == lf)
        want = torch.zeros(F, B, 3)
        for r0 in range(0, max(len(rows), 1), CHUNK_ROWS):
            sl = rows[r0:r0 + CHUNK_ROWS]
            want = want + histogram_feature_major(
                *_t((bins[:, sl], g[sl], h[sl], m[sl])), B)
        assert torch.equal(ours[lf], want), lf
    assert not ours[1].any()  # the empty leaf


@pytest.mark.parametrize("name,n,F,B,L,pattern,dt,bp", CASES, ids=IDS)
def test_bsub_equals_v1(name, n, F, B, L, pattern, dt, bp):
    """Within the port: the plain K2 is the plain K1'' bitwise."""
    arrs = _t(_inputs(n, F, B, L, pattern, dt, bp, seed=7))
    assert torch.equal(histogram_by_leaf_sorted(*arrs, B, L, variant="bsub"),
                       histogram_by_leaf_sorted(*arrs, B, L, variant="v1"))


@pytest.mark.parametrize("dt,B", [(np.uint8, 37), (np.uint16, 300),
                                  (np.uint16, 5000)])
def test_one_leaf_is_the_single_leaf_histogram(dt, B):
    """With one leaf the level histogram, and the single-leaf histogram
    under either variant, is K1's plain version bitwise."""
    n, F = 2 * CHUNK_ROWS + 77, 5
    bins, _, g, h, m = _t(_inputs(n, F, B, 1, "zeros", dt, seed=9))
    want = histogram_feature_major(bins, g, h, m, B)
    for v in ("v1", "bsub"):
        assert torch.equal(histogram_single_leaf(bins, g, h, m, B,
                                                 variant=v), want)
        lid = torch.zeros(n, dtype=torch.int32)
        assert torch.equal(histogram_by_leaf_sorted(
            bins, lid, g, h, m, B, 1, variant=v)[0], want)


@pytest.mark.parametrize("name,n,F,B,L,pattern,dt,bp", CASES, ids=IDS)
def test_level_layout(name, n, F, B, L, pattern, dt, bp):
    """Each leaf owns max(ceil(rows / 2048), 1) consecutive chunks that
    cover its sorted rows in order; the capacity's tail holds no rows."""
    leaf = torch.from_numpy(_inputs(n, F, B, L, pattern, dt)[1])
    lay = level_layout(leaf, L)
    assert torch.equal(lay.order, torch.argsort(leaf, stable=True))
    counts = np.bincount(leaf.numpy(), minlength=L)
    cs, rs = lay.chunk_start.numpy(), lay.row_start.numpy()
    np.testing.assert_array_equal(np.diff(cs),
                                  np.maximum(-(-counts // CHUNK_ROWS), 1))
    np.testing.assert_array_equal(np.diff(rs), counts)
    cap = lay.chunk_leaf.shape[0]
    assert cap == -(-n // CHUNK_ROWS) + L >= cs[-1]
    r0, nr = lay.chunk_row0.numpy(), lay.chunk_rows.numpy()
    for lf in range(L):
        c = np.arange(cs[lf], cs[lf + 1])
        assert (lay.chunk_leaf.numpy()[c] == lf).all()
        np.testing.assert_array_equal(r0[c], rs[lf] + (c - cs[lf])
                                      * CHUNK_ROWS)
        assert nr[c].sum() == counts[lf] and (nr[c][:-1] == CHUNK_ROWS).all()
    assert (lay.chunk_leaf.numpy()[cs[-1]:] == L).all()
    assert not nr[cs[-1]:].any()


@pytest.mark.parametrize("B", [1, 7, 32, 33, 64, 200, 255, 256, 300])
def test_leaf_totals_are_jnp_sum(B):
    """``jnp.sum(hist[:, 0], axis=1)`` (depthwise.py:108), bitwise."""
    rng = np.random.RandomState(B)
    hist = (rng.randn(9, 2, B, 3) * rng.rand(9, 2, B, 3) * 100).astype(
        np.float32)
    ref = np.asarray(jnp.sum(jnp.asarray(hist)[:, 0, :, :], axis=1))
    np.testing.assert_array_equal(leaf_totals(torch.from_numpy(hist)).numpy(),
                                  ref)


def test_unknown_variant_raises(monkeypatch):
    arrs = _t(_inputs(300, 2, 7, 5, "random", np.uint8))
    with pytest.raises(ValueError, match="variant"):
        histogram_by_leaf_sorted(*arrs, 7, 5, variant="v2")
    monkeypatch.setenv("LGBM_TPU_HIST_KERNEL", "nope")
    with pytest.raises(ValueError, match="variant"):
        histogram_by_leaf_sorted(*arrs, 7, 5)
    with pytest.raises(ValueError, match="variant"):
        histogram_single_leaf(arrs[0], *arrs[2:], 7)


def test_cuda_entries_have_no_cpu_fallback():
    """The kernel entry points never quietly run the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the entries would launch kernels")
    bins, leaf, g, h, m = _t(_inputs(300, 2, 7, 5, "random", np.uint8))
    before = (cuda_histogram.LEVEL_LAUNCHES, cuda_histogram.BSUB_LAUNCHES)
    for v in ("v1", "bsub"):
        with pytest.raises((RuntimeError, ValueError)):
            cuda_histogram.histogram_by_leaf_sorted_cuda(bins, leaf, g, h, m,
                                                         7, 5, v)
    with pytest.raises((RuntimeError, ValueError)):
        cuda_histogram.histogram_single_leaf_bsub_cuda(bins, g, h, m, 7)
    assert (cuda_histogram.LEVEL_LAUNCHES,
            cuda_histogram.BSUB_LAUNCHES) == before


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    for name, n, F, B, L, pattern, dt, bp in CASES:
        arrs = _inputs(n, F, B, L, pattern, dt, bp)
        dev = [a.cuda() for a in _t(arrs)]
        want = histogram_by_leaf_sorted(*_t(arrs), B, L)
        a = histogram_by_leaf_sorted(*dev, B, L, variant="v1")
        b = histogram_by_leaf_sorted(*dev, B, L, variant="v1")
        c = histogram_by_leaf_sorted(*dev, B, L, variant="bsub")
        assert torch.equal(a, b) and torch.equal(a, c), name
        assert torch.equal(a.cpu(), want), name
        single = [dev[0]] + dev[2:]
        assert torch.equal(histogram_single_leaf(*single, B, variant="bsub"),
                           histogram_single_leaf(*single, B, variant="v1"))
