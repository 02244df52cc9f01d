"""The port's packed record and its partition (lightgbm_tpu_torch.ops.record)
against the JAX package's (lightgbm_tpu.ops.record).

The record helpers must give the JAX record's bytes: rows ``[:Wb+5]``
over the ``n`` real columns (the JAX record pads W to a multiple of 8 and
carries an ``n_pad`` tail; the port has neither).  The partition runs on
the CPU through its plain versions (``compact_tiles`` + ``place_runs``,
the plain versions of kernels 6 and 7) and must leave the record bitwise
as the JAX ``partition_window`` leaves it, run un-jitted in interpret mode
as tests/test_partition_routing.py runs it.  The kernels themselves run
only on the card (chip_smoke.py holds them against these plain versions).
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu.ops.record as JR
from lightgbm_tpu.learners.serial import _go_i32
from lightgbm_tpu_torch.ops import _build, cuda_record, cuda_split_step
from lightgbm_tpu_torch.ops import record as R
from lightgbm_tpu_torch.ops.cuda_search import pack_meta


def _data(n, F, B, dt, seed, bag_frac=0.7):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, n)).astype(dt)
    g = rng.randn(n).astype(np.float32)
    h = (np.abs(rng.randn(n)) + 0.1).astype(np.float32)
    m = (np.ones(n, np.float32) if bag_frac is None
         else (rng.rand(n) < bag_frac).astype(np.float32))
    return bins, g, h, m


def _jax_rec(arrs, n_pad):
    return JR.build_record(*(jnp.asarray(a) for a in arrs), n_pad)


def _port_rec(arrs):
    return R.build_record(*(torch.from_numpy(a) for a in arrs))


def _k(dt):
    return 4 if np.dtype(dt).itemsize == 1 else 2


@pytest.mark.parametrize("F,B,dt", [(6, 16, np.uint8), (7, 255, np.uint8),
                                    (5, 300, np.uint16)])
def test_build_record_matches_jax(F, B, dt):
    n = 1000
    arrs = _data(n, F, B, dt, seed=F)
    rec = _port_rec(arrs)
    k = _k(dt)
    W = JR.num_words(F, k) + 5
    assert rec.shape == (W, n) and rec.dtype == torch.int32
    assert W == R.rec_height(F, k)
    ref = np.asarray(_jax_rec(arrs, n + 100))
    np.testing.assert_array_equal(rec.numpy(), ref[:W, :n])
    # extract_feature and unpack_window, bitwise
    for f in range(F):
        got = R.extract_feature(rec, f, 37, 500, k).numpy()
        want = np.asarray(JR.extract_feature(jnp.asarray(ref), jnp.int32(f),
                                             jnp.int32(37), 500, k))
        np.testing.assert_array_equal(got, want)
    win = rec[:, 100:700]
    got = R.unpack_window(win, F, k, torch.from_numpy(arrs[0]).dtype)
    want = JR.unpack_window(jnp.asarray(ref[:, 100:700]), F, k, dt)
    for a, b in zip(got, want):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got[0].numpy(), arrs[0][:, 100:700])


def _jax_partition(rec, F, k, f, thr, is_cat, begin, pcnt, ll, rl):
    cap = JR.round_up(pcnt, JR.TILE)
    fv = JR.extract_feature(rec, jnp.int32(f), jnp.int32(begin), cap, k)
    go = _go_i32(fv, jnp.int32(thr), jnp.bool_(is_cat))
    out, nleft = JR.partition_window.__wrapped__(
        rec, go, jnp.int32(begin), jnp.int32(pcnt), jnp.bool_(True), cap,
        left_leaf=jnp.int32(ll), right_leaf=jnp.int32(rl),
        leaf_row=JR.num_words(F, k) + 4, interpret=True)
    return out, int(nleft)


# (name, n, F, B, dtype, bag_frac, splits): each split is (f, thr, is_cat,
# begin, pcnt, left_leaf, right_leaf), applied in order to one record
CASES = [
    ("ragged_multi_tile", 3 * 512 - 57, 6, 16, np.uint8, 0.7,
     [(2, 7, False, 0, 3 * 512 - 57, 0, 1)]),
    ("interior_unaligned", 3000, 7, 23, np.uint8, 0.6,
     [(4, 11, False, 517, 1300, 2, 5)]),
    ("all_left", 1200, 6, 16, np.uint8, 0.5,
     [(1, 15, False, 0, 1200, 0, 1)]),
    ("all_right", 1200, 6, 16, np.uint8, 0.5,
     [(3, 16, True, 0, 1200, 0, 1)]),
    ("categorical_no_bagging", 2100, 6, 16, np.uint8, None,
     [(5, 3, True, 0, 2100, 0, 1)]),
    ("u16_two_splits", 1800, 5, 300, np.uint16, 0.8,
     [(4, 150, False, 0, 1800, 0, 1), (0, 99, False, 0, None, 0, 2)]),
    # windows at each 16-byte misalignment of begin, none a multiple of 4
    # columns long (the kernels' scalar heads and tails)
    ("begin_mod4_1", 3000, 6, 16, np.uint8, 0.7,
     [(2, 7, False, 1001, 1297, 0, 1)]),
    ("begin_mod4_2", 3000, 6, 16, np.uint8, 0.7,
     [(3, 9, False, 1002, 1299, 3, 4)]),
    ("begin_mod4_3", 3000, 7, 23, np.uint8, 0.6,
     [(5, 11, True, 1003, 1301, 2, 5)]),
    # windows of 1, 3 and 5 columns and one column past a tile
    ("pcnt_1", 700, 6, 16, np.uint8, 0.7, [(1, 7, False, 333, 1, 0, 1)]),
    ("pcnt_3", 700, 6, 16, np.uint8, 0.7, [(4, 7, False, 5, 3, 0, 1)]),
    ("pcnt_5", 700, 6, 16, np.uint8, 0.7, [(0, 8, False, 6, 5, 1, 2)]),
    ("pcnt_513", 1200, 6, 16, np.uint8, 0.7,
     [(3, 6, False, 37, 513, 0, 1)]),
    # tiles 1-2 of the window all left, tiles 3-4 all right (CRAFT)
    ("middle_tiles_all_left_then_all_right", 6 * 512 + 100, 6, 16, np.uint8,
     0.7, [(2, 7, False, 3, 6 * 512 + 90, 0, 1)]),
    # u16 bins with an odd number of carried rows (R = W - 1 = 9)
    ("u16_odd_rows", 2500, 9, 300, np.uint16, 0.8,
     [(8, 150, False, 7, 2301, 0, 1)]),
    # a wide record: F = 2000 at u8 bins, W = 505 (more rows than one
    # staging buffer of K6 holds)
    ("wide_w505", 3000, 2000, 255, np.uint8, 0.7,
     [(1777, 127, False, 13, 2900, 0, 1)]),
]


def _craft_left_then_right(bins):
    # window [3, 3 + 6*512 + 90) split on feature 2 at bin 7
    bins[2, 3 + 512:3 + 3 * 512] = 0
    bins[2, 3 + 3 * 512:3 + 5 * 512] = 15


# case name -> an edit of its [F, n] bins
CRAFT = {"middle_tiles_all_left_then_all_right": _craft_left_then_right}


def _case_arrays(case):
    name, n, F, B, dt, bag, _ = case
    arrs = _data(n, F, B, dt, seed=n, bag_frac=bag)
    if name in CRAFT:
        CRAFT[name](arrs[0])
    return arrs


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_partition_window_matches_jax(case):
    name, n, F, B, dt, bag, splits = case
    arrs = _case_arrays(case)
    k = _k(dt)
    W = R.rec_height(F, k)
    rec = _port_rec(arrs)
    jrec = _jax_rec(arrs, JR.round_up(n, JR.TILE) + JR.round_up(n, JR.TILE))
    nleft_prev = None
    for f, thr, is_cat, begin, pcnt, ll, rl in splits:
        if pcnt is None:  # the previous split's left child
            pcnt = nleft_prev
        nl = R.partition_window(rec, f, thr, is_cat, begin, pcnt, ll, rl, k)
        jrec, jnl = _jax_partition(jrec, F, k, f, thr, is_cat, begin, pcnt,
                                   ll, rl)
        assert int(nl) == jnl
        np.testing.assert_array_equal(rec.numpy(),
                                      np.asarray(jrec)[:W, :n])
        nleft_prev = jnl
    if name == "all_left":
        assert nleft_prev == n
    if name == "all_right":
        assert nleft_prev == 0
    if name in CRAFT:  # tiles 1-4 of the window are what they claim
        go = arrs[0][2, 3:3 + splits[0][4]] <= 7
        T = R.TILE
        assert [int(go[t * T:(t + 1) * T].sum()) for t in range(1, 5)] == [
            T, T, 0, 0]
    # the record is still a permutation of the rows
    assert sorted(rec[R.row_id_row(W)].tolist()) == list(range(n))


@pytest.mark.parametrize("cnt", [1, 511, 512, 1300])
def test_compact_tiles_matches_numpy(cnt):
    rng = np.random.RandomState(cnt)
    W = 9
    win = rng.randint(-2**31, 2**31 - 1, (W, cnt), dtype=np.int64).astype(
        np.int32)
    go = rng.rand(cnt) < 0.4
    comp, cl, cr = R.compact_tiles(torch.from_numpy(win), torch.from_numpy(go))
    T = R.TILE
    nt = -(-cnt // T)
    assert comp.shape == (nt, W, 2 * T)
    for t in range(nt):
        cols = np.arange(t * T, min(cnt, (t + 1) * T))
        lefts, rights = cols[go[cols]], cols[~go[cols]]
        assert int(cl[t]) == len(lefts) and int(cr[t]) == len(rights)
        np.testing.assert_array_equal(comp[t, :, :len(lefts)].numpy(),
                                      win[:, lefts])
        np.testing.assert_array_equal(
            comp[t, :, T:T + len(rights)].numpy(), win[:, rights])


def test_run_offsets_are_exclusive_prefixes():
    counts = torch.tensor([[3, 0, 5, 2], [1, 4, 0, 7]], dtype=torch.int32)
    offs, nleft = R._run_offsets(counts)
    np.testing.assert_array_equal(offs.numpy(), [[0, 3, 3, 8], [0, 1, 5, 5]])
    assert nleft.dim() == 0 and int(nleft) == 10
    offs, nleft = R._run_offsets(torch.zeros((2, 0), dtype=torch.int32))
    assert offs.shape == (2, 0) and int(nleft) == 0


def test_cuda_entries_have_no_cpu_fallback():
    """The kernel entries never quietly run the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the entries would launch the kernels")
    rec = _port_rec(_data(700, 6, 16, np.uint8, seed=1))
    before = (cuda_record.COMPACT_LAUNCHES, cuda_record.PLACE_LAUNCHES,
              cuda_split_step.LAUNCHES)
    with pytest.raises((RuntimeError, ValueError)):
        cuda_record.compact_cuda(rec, 0, 5, False, 0, 700, 4)
    with pytest.raises((RuntimeError, ValueError)):
        cuda_record.place_cuda(rec, torch.zeros((2, 6, 2 * R.TILE),
                                                dtype=torch.int32),
                               torch.zeros((2, 2), dtype=torch.int32), 0,
                               700, 0, 1)
    meta = pack_meta(torch.ones(6, dtype=torch.bool), torch.full((6,), 16),
                     torch.zeros(6, dtype=torch.bool), "cpu")
    with pytest.raises((RuntimeError, ValueError)):
        cuda_split_step.split_step_cuda(
            rec, torch.zeros((3, 6, 16, 3)), 0, 5, False, 0, 700, 0, 1,
            [1.0] + [0.0] * 11, meta, 4, 16)
    assert (cuda_record.COMPACT_LAUNCHES, cuda_record.PLACE_LAUNCHES,
            cuda_split_step.LAUNCHES) == before


def test_dispatchers_resolve_each_cuda_module_once():
    """ops/record's dispatchers keep the CUDA wrapper modules they import
    (no import statement on every call), and they are the modules the
    wrappers live in, so a patched wrapper is the one that runs."""
    assert R._cuda("cuda_record") is cuda_record
    assert R._cuda("cuda_split_step") is cuda_split_step
    assert R._CUDA_MODULES["cuda_record"] is cuda_record
    assert R._cuda("cuda_record") is R._cuda("cuda_record")


def test_build_treats_a_newer_header_as_stale(tmp_path, monkeypatch):
    """A library is rebuilt when its source or any shared csrc/*.cuh header
    is newer than it, so an edited header never leaves a stale kernel
    loaded."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    src, hdr = csrc / "k.cu", csrc / "shared.cuh"
    so = build / "libk.so"
    for path, t in ((src, 100), (hdr, 100), (so, 200)):
        path.write_text("")
        os.utime(path, (t, t))
    assert not _build._stale("k")
    os.utime(hdr, (300, 300))
    assert _build._stale("k")
    os.utime(so, (400, 400))
    assert not _build._stale("k")
    os.utime(src, (500, 500))
    assert _build._stale("k")
    so.unlink()
    assert _build._stale("k")


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    for case in CASES:
        _, n, F, B, dt, bag, splits = case
        arrs = _case_arrays(case)
        k = _k(dt)
        rec, dev = _port_rec(arrs), _port_rec(arrs).cuda()
        nleft_prev = None
        for f, thr, is_cat, begin, pcnt, ll, rl in splits:
            pcnt = nleft_prev if pcnt is None else pcnt
            a = R.partition_window(rec, f, thr, is_cat, begin, pcnt, ll, rl,
                                   k)
            b = R.partition_window(dev, f, thr, is_cat, begin, pcnt, ll, rl,
                                   k)
            assert int(a) == int(b)
            assert torch.equal(rec, dev.cpu())
            nleft_prev = int(a)
