"""The port's single-row-set histogram (lightgbm_tpu_torch.ops.cuda_histogram)
against the JAX package's.

On the CPU the port's ``histogram_single_leaf`` is its plain PyTorch
version; the JAX side runs its Pallas kernel in interpret mode, as
tests/test_pallas_histogram.py does.  The count channel is exact; g and h
sums agree to f32 rounding (rtol/atol 1e-5: the Pallas kernel sums each
512-row chunk as a one-hot matmul, the port row by row in 2048-row
blocks).  The record-window histogram (the plain version of kernel 1') is
held against the JAX package's raw-layout kernel on the unpacked window,
and must equal the port's own single-leaf histogram on the same rows
bitwise.  The CUDA kernels themselves run only on the card (chip_smoke.py
and the ``cuda``-marked tests below).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu.ops.record as JR
from lightgbm_tpu.ops.histogram import histogram_feature_major as jax_hist_fm
from lightgbm_tpu.ops.pallas_histogram import (
    histogram_single_leaf as jax_single_leaf,
    histogram_single_leaf_raw as jax_single_leaf_raw)
from lightgbm_tpu_torch.ops import cuda_histogram
from lightgbm_tpu_torch.ops import record as R
from lightgbm_tpu_torch.ops.cuda_histogram import (histogram_record_window,
                                                   histogram_single_leaf)
from lightgbm_tpu_torch.ops.histogram import (
    CHUNK_ROWS, histogram_feature_major)

SHAPES = [(5, 700, 37, np.uint8), (28, 2048, 255, np.uint8),
          (3, 500, 300, np.uint16)]


# the kernels' edge cases: ~90 % of every feature's rows in one bin, more
# bins than their 4096-int count table (bin-range passes), a row count one
# past a chunk, F not a multiple of the kernels' feature group
# (name, F, cap, B, bin dtype, dominant bin)
EDGE = [("dominant-bin", 28, 3000, 255, np.uint8, True),
        ("u16x5000", 3, 1500, 5000, np.uint16, False),
        ("rows-2049", 6, 2049, 255, np.uint8, False),
        ("F29", 29, 900, 255, np.uint8, False)]
# record windows at an odd begin whose F is not a multiple of k (k = 2 for
# u16 bins, 4 for u8): (name, F, cap, B, bin dtype, begin)
# (k4-F136: the LambdaRank main path's width, a 39-word record)
EDGE_WINDOWS = [("k2-F5", 5, 1200, 300, np.uint16, 101),
                ("k4-F29", 29, 900, 255, np.uint8, 37),
                ("k2-F3-5000", 3, 1500, 5000, np.uint16, 211),
                ("k4-F136", 136, 700, 255, np.uint8, 37)]


def _inputs(F, cap, B, dt, seed=11, dominant=False):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(F, cap)).astype(dt)
    if dominant:
        bins[rng.rand(F, cap) < 0.9] = B // 3
    return (bins,
            rng.randn(cap).astype(np.float32),
            np.abs(rng.randn(cap)).astype(np.float32),
            (rng.rand(cap) < 0.7).astype(np.float32))


def _port(bins, g, h, m, B):
    return histogram_single_leaf(*(torch.from_numpy(a) for a in (bins, g, h, m)),
                                 B).numpy()


@pytest.mark.parametrize("F,cap,B,dt", SHAPES)
def test_matches_jax_pallas_interpret(F, cap, B, dt):
    bins, g, h, m = _inputs(F, cap, B, dt)
    ours = _port(bins, g, h, m, B)
    ref = np.asarray(jax_single_leaf(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(m),
        num_bins=B, interpret=True))
    assert ours.shape == (F, B, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours[..., 2], ref[..., 2])
    np.testing.assert_allclose(ours[..., :2], ref[..., :2], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name,F,cap,B,dt,dominant", EDGE,
                         ids=[e[0] for e in EDGE])
def test_edge_matches_jax_pallas_interpret(name, F, cap, B, dt, dominant):
    """The plain version of K1 against the JAX kernel in interpret mode at
    the kernels' edge cases.  Counts exact; g and h within 1e-5 of each
    cell's sum of |x| (+ 1e-5): a dominant bin sums ~2,700 rows whose
    signs cancel, so its f32 rounding, in two summation orders, scales
    with sum |x| and not with the small result."""
    bins, g, h, m = _inputs(F, cap, B, dt, seed=23, dominant=dominant)
    ours = _port(bins, g, h, m, B)
    ref = np.asarray(jax_single_leaf(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(m),
        num_bins=B, interpret=True))
    assert ours.shape == (F, B, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours[..., 2], ref[..., 2])
    absum = histogram_feature_major(
        torch.from_numpy(bins), *(torch.from_numpy(a).double().abs()
                                  for a in (g, h, m)), B).numpy()
    assert (np.abs(ours[..., :2] - ref[..., :2])
            <= 1e-5 * absum[..., :2] + 1e-5).all()


def test_empty_and_one_row_sets():
    """No rows give zeros; one row equals the JAX segment sum bitwise."""
    bins, g, h, m = _inputs(29, 1, 255, np.uint8, seed=29)
    assert not _port(bins[:, :0], g[:0], h[:0], m[:0], 255).any()
    ref = np.asarray(jax_hist_fm(jnp.asarray(bins), jnp.asarray(g),
                                 jnp.asarray(h), jnp.asarray(m),
                                 num_bins=255))
    np.testing.assert_array_equal(_port(bins, g, h, m, 255), ref)


@pytest.mark.parametrize("F,cap,B,dt", SHAPES)
def test_matches_jax_segment_sum(F, cap, B, dt):
    """Up to CHUNK_ROWS rows both sum each bin in row order: bitwise."""
    bins, g, h, m = _inputs(F, cap, B, dt, seed=3)
    ours = _port(bins, g, h, m, B)
    ref = np.asarray(jax_hist_fm(jnp.asarray(bins), jnp.asarray(g),
                                 jnp.asarray(h), jnp.asarray(m), num_bins=B))
    np.testing.assert_array_equal(ours, ref)


def test_block_order_is_the_kernels():
    """Past CHUNK_ROWS rows the plain version adds per-block partials in
    block order, as the kernel's second pass does."""
    F, B = 4, 19
    cap = 2 * CHUNK_ROWS + 123
    bins, g, h, m = _inputs(F, cap, B, np.uint8, seed=5)
    ours = _port(bins, g, h, m, B)
    want = np.zeros((F, B, 3), np.float32)
    for r0 in range(0, cap, CHUNK_ROWS):
        sl = slice(r0, r0 + CHUNK_ROWS)
        want = want + np.asarray(jax_hist_fm(
            jnp.asarray(bins[:, sl]), jnp.asarray(g[sl]), jnp.asarray(h[sl]),
            jnp.asarray(m[sl]), num_bins=B))
    np.testing.assert_array_equal(ours, want)
    np.testing.assert_array_equal(ours, _port(bins, g, h, m, B))  # repeatable


def test_plain_version_matches_float64():
    bins, g, h, m = _inputs(6, 5000, 40, np.uint8, seed=9)
    ours = histogram_feature_major(
        *(torch.from_numpy(a) for a in (bins, g, h, m)), 40).numpy()
    ref = histogram_feature_major(
        torch.from_numpy(bins), *(torch.from_numpy(a).double()
                                  for a in (g, h, m)), 40).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def _record_window(F, cap, B, dt, begin=211, seed=17):
    """A record of cap + 300 rows and its window [begin, begin+cap)."""
    arrs = _inputs(F, cap + 300, B, dt, seed=seed)
    return arrs, R.build_record(*(torch.from_numpy(a) for a in arrs)), begin


@pytest.mark.parametrize("F,cap,B,dt", SHAPES)
def test_record_window_matches_jax_raw(F, cap, B, dt):
    _check_record_window_against_jax(F, cap, B, dt, 211)


@pytest.mark.parametrize("name,F,cap,B,dt,begin", EDGE_WINDOWS,
                         ids=[e[0] for e in EDGE_WINDOWS])
def test_edge_record_window_matches_jax_raw(name, F, cap, B, dt, begin):
    """The plain version of K1' at odd begins whose F is not a multiple of
    k, against the JAX raw kernel; tolerances as above."""
    _check_record_window_against_jax(F, cap, B, dt, begin)


def _check_record_window_against_jax(F, cap, B, dt, begin):
    (bins, g, h, m), rec, begin = _record_window(F, cap, B, dt, begin)
    k = R.bins_per_word(torch.from_numpy(bins).dtype)
    ours = histogram_record_window(rec, begin, cap, F, k, B).numpy()
    jrec = JR.build_record(*(jnp.asarray(a) for a in (bins, g, h, m)),
                           cap + 300)
    win = jrec[:, begin:begin + cap]
    ref = np.asarray(jax_single_leaf_raw(
        *JR.unpack_window(win, F, k, dt), num_bins=B,
        interpret=True))[:F, :3, :B].transpose(0, 2, 1)
    assert ours.shape == (F, B, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours[..., 2], ref[..., 2])
    np.testing.assert_allclose(ours[..., :2], ref[..., :2], rtol=1e-5,
                               atol=1e-5)
    # the port's single-leaf histogram on the same rows, bitwise
    sl = slice(begin, begin + cap)
    np.testing.assert_array_equal(ours, _port(bins[:, sl], g[sl], h[sl],
                                              m[sl], B))


def test_cuda_entry_has_no_cpu_fallback():
    """The kernel entry point never quietly runs the plain version."""
    bins, g, h, m = _inputs(2, 64, 8, np.uint8)
    before = cuda_histogram.LAUNCHES
    if torch.cuda.is_available():
        pytest.skip("a card is present; the entry would launch the kernel")
    with pytest.raises((RuntimeError, ValueError)):
        cuda_histogram.histogram_single_leaf_cuda(
            *(torch.from_numpy(a) for a in (bins, g, h, m)), 8)
    assert cuda_histogram.LAUNCHES == before
    rec = R.build_record(*(torch.from_numpy(a) for a in (bins, g, h, m)))
    before = cuda_histogram.RECORD_LAUNCHES
    with pytest.raises((RuntimeError, ValueError)):
        cuda_histogram.histogram_record_window_cuda(rec, 0, 64, 2, 4, 8)
    assert cuda_histogram.RECORD_LAUNCHES == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    for F, cap, B, dt in SHAPES + [(28, 60_000, 255, np.uint8)]:
        bins, g, h, m = _inputs(F, cap, B, dt)
        dev = [torch.from_numpy(a).cuda() for a in (bins, g, h, m)]
        a = histogram_single_leaf(*dev, B)
        b = histogram_single_leaf(*dev, B)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_array_equal(a.cpu().numpy(), _port(bins, g, h, m, B))


@pytest.mark.cuda
def test_record_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    for F, cap, B, dt in SHAPES:
        (bins, *_), rec, begin = _record_window(F, cap, B, dt)
        k = R.bins_per_word(torch.from_numpy(bins).dtype)
        a = histogram_record_window(rec.cuda(), begin, cap, F, k, B)
        np.testing.assert_array_equal(
            a.cpu().numpy(),
            histogram_record_window(rec, begin, cap, F, k, B).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name,F,cap,B,dt,dominant", EDGE,
                         ids=[e[0] for e in EDGE])
def test_edge_kernel_matches_plain_on_card(name, F, cap, B, dt, dominant):
    """K1 at the edge cases: bitwise its plain version, and K2 over one
    leaf bitwise K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    bins, g, h, m = _inputs(F, cap, B, dt, seed=23, dominant=dominant)
    dev = [torch.from_numpy(a).cuda() for a in (bins, g, h, m)]
    a = cuda_histogram.histogram_single_leaf_cuda(*dev, B)
    np.testing.assert_array_equal(a.cpu().numpy(), _port(bins, g, h, m, B))
    torch.testing.assert_close(
        cuda_histogram.histogram_single_leaf_bsub_cuda(*dev, B), a, rtol=0,
        atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,F,cap,B,dt,begin", EDGE_WINDOWS,
                         ids=[e[0] for e in EDGE_WINDOWS])
def test_edge_record_kernel_matches_plain_on_card(name, F, cap, B, dt, begin):
    """K1' on windows at an odd begin whose F is not a multiple of k:
    bitwise its plain version and K1 on the unpacked rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    (bins, g, h, m), rec, begin = _record_window(F, cap, B, dt, begin)
    k = R.bins_per_word(torch.from_numpy(bins).dtype)
    a = histogram_record_window(rec.cuda(), begin, cap, F, k, B)
    want = histogram_record_window(rec, begin, cap, F, k, B).numpy()
    np.testing.assert_array_equal(a.cpu().numpy(), want)
    sl = slice(begin, begin + cap)
    k1 = cuda_histogram.histogram_single_leaf_cuda(
        *(torch.from_numpy(np.ascontiguousarray(x)).cuda()
          for x in (bins[:, sl], g[sl], h[sl], m[sl])), B)
    np.testing.assert_array_equal(a.cpu().numpy(), k1.cpu().numpy())
