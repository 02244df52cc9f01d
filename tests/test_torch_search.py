"""The port's two-child split search (lightgbm_tpu_torch.ops.cuda_search)
against the JAX package's.

On the CPU the port's ``search2`` runs its plain PyTorch version; the JAX
side runs ``search2_pallas`` in interpret mode (as
tests/test_pallas_search.py does) and the jnp ``find_best_split_leaves``.
Feature and threshold must match exactly; the float fields to rtol 1e-5 /
atol 1e-6 (the Pallas kernel's suffix sums are a triangular matmul, the
port's a blocked scan).  Against the jnp search, whose suffix sums take
the same blocked order, the port agrees bitwise.  Inputs are the random
and crafted cases of tests/test_pallas_search.py.

``search2_update`` (the plain version of kernel 4) is held against
``search2_update_pallas`` in interpret mode on the JAX package's raw
``[P, Fp, 4, Bp]`` buffer holding the same values: the two updated rows
bitwise (the subtraction is elementwise float32), the search as above.

Beside the F = 9, B = 31 cases, the three searches (``search2_rows``,
``search2_update``, ``search2_pool``; kernels 3, 4 and 5) run at B = 7,
300 and 600, the bin counts that reach the warp scan's other branches on
the card (no block offsets; the level-1 halves; two 512-bin segments),
against ``search2_pallas`` / ``search2_update_pallas`` /
``search2_pallas_raw`` in interpret mode.  The tests marked ``cuda`` hold
each kernel bitwise against its plain version at those shapes, at 5,000
bins and at F = 5,000.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lightgbm_tpu.ops.pallas_search import (search2_pallas,
                                            search2_pallas_raw,
                                            search2_update_pallas)
from lightgbm_tpu.ops.split import find_best_split_leaves as jax_fbsl
from lightgbm_tpu_torch.ops import cuda_search
from lightgbm_tpu_torch.ops.cuda_search import (pack_meta, search2,
                                                search2_pool, search2_rows,
                                                search2_update, unpack)

FLOAT_FIELDS = ("gain", "left_sum_grad", "left_sum_hess", "left_count",
                "right_sum_grad", "right_sum_hess", "right_count",
                "left_output", "right_output")


def _mk(F=9, B=31, seed=0, ints=False, cat_mask=None):
    rng = np.random.RandomState(seed)
    if ints:
        g = rng.randint(-8, 9, (F, B)).astype(np.float32)
        h = rng.randint(1, 5, (F, B)).astype(np.float32)
        c = rng.randint(1, 5, (F, B)).astype(np.float32)
    else:
        g = rng.randn(F, B).astype(np.float32)
        h = np.abs(rng.randn(F, B)).astype(np.float32) + 0.1
        c = rng.randint(1, 50, (F, B)).astype(np.float32)
    hist = np.stack([g, h, c], axis=-1)
    iscat = np.zeros(F, bool) if cat_mask is None else cat_mask
    return (hist, (g.sum(), h.sum(), c.sum()), np.ones(F, bool),
            np.full(F, B, np.int32), iscat)


def _consts(kw):
    return (kw.get("min_data", 1.0), kw.get("min_hess", 0.0),
            kw.get("l1", 0.0), kw.get("l2", 1.0), kw.get("min_gain", 0.0))


def _port(hl, hr, totl, totr, fmask, nbpf, iscat, can=True, **kw):
    t = torch.from_numpy
    return search2(t(hl), t(hr), *[float(v) for v in totl],
                   *[float(v) for v in totr], can, t(fmask), t(nbpf),
                   t(iscat), *_consts(kw))


def _jax_kernel(hl, hr, totl, totr, fmask, nbpf, iscat, can=True, **kw):
    f = jnp.float32
    return search2_pallas(
        jnp.asarray(hl), jnp.asarray(hr), *[f(v) for v in totl],
        *[f(v) for v in totr], jnp.asarray(can), jnp.asarray(fmask),
        jnp.asarray(nbpf), jnp.asarray(iscat),
        *[f(v) for v in _consts(kw)], interpret=True)


def _jax_jnp(hl, hr, totl, totr, fmask, nbpf, iscat, can=True, **kw):
    f = jnp.float32
    res = jax_fbsl(
        jnp.asarray(np.stack([hl, hr])),
        jnp.asarray([totl[0], totr[0]], jnp.float32),
        jnp.asarray([totl[1], totr[1]], jnp.float32),
        jnp.asarray([totl[2], totr[2]], jnp.float32),
        jnp.asarray(fmask), jnp.asarray(nbpf), jnp.asarray(iscat),
        *[f(v) for v in _consts(kw)], jnp.asarray([can, can]))
    return [type(res)(*[a[i] for a in res]) for i in range(2)]


def _check(port, ref, exact, floats=True, rtol=1e-5):
    for a, b in zip(port, ref):
        assert int(a.feature) == int(b.feature)
        assert int(a.threshold) == int(b.threshold)
        if not floats:
            continue
        for k in FLOAT_FIELDS:
            x, y = float(getattr(a, k)), float(np.asarray(getattr(b, k)))
            if exact:
                assert x == y or (np.isnan(x) and np.isnan(y)), k
            else:
                np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-6,
                                           err_msg=k)


def _cases():
    cases = []
    for seed in range(5):
        hl, totl, fmask, nbpf, iscat = _mk(seed=seed)
        hr, totr, *_ = _mk(seed=seed + 100)
        cases.append(((hl, hr, totl, totr, fmask, nbpf, iscat), {}))
    # exact cross-feature tie: feature 2 duplicated at feature 6
    hl, totl, fmask, nbpf, iscat = _mk(ints=True, seed=7)
    hl[2, :, 0] = np.where(np.arange(hl.shape[1]) < 16, 32.0, -32.0)
    hl[2, :, 1] = 1.0
    hl[2, :, 2] = 4.0
    hl[6] = hl[2]
    totl = (hl[2, :, 0].sum(), hl[2, :, 1].sum(), hl[2, :, 2].sum())
    cases.append(((hl, hl, totl, totl, fmask, nbpf, iscat), {}))
    # categorical feature + feature mask + all constraints
    cat = np.zeros(9, bool)
    cat[3] = True
    hl, totl, fmask, nbpf, iscat = _mk(ints=True, seed=11, cat_mask=cat)
    fmask = fmask.copy()
    fmask[0] = False
    cases.append(((hl, hl, totl, totl, fmask, nbpf, iscat),
                  dict(min_data=3.0, min_hess=2.0, l1=0.5, l2=2.0)))
    # exact within-feature tie: empty bins 14 and 15 make thresholds 13,
    # 14 and 15 one split; the largest bin must win
    hl, totl, fmask, nbpf, iscat = _mk(ints=True, seed=13)
    hl[:, :, 0] = 0.0
    hl[1, :, 0] = np.where(np.arange(hl.shape[1]) < 16, 8.0, -8.0)
    hl[1, 14:16] = 0.0
    totl = tuple(hl[1].sum(axis=0))
    cases.append(((hl, hl, totl, totl, fmask, nbpf, iscat), {}))
    return cases


CASES = _cases()
IDS = [f"random{s}" for s in range(5)] + ["tie", "categorical", "bin_tie"]


def test_tie_break_largest_bin_within_feature():
    args, kw = CASES[7]
    res, _ = _port(*args, **kw)
    assert (int(res.feature), int(res.threshold)) == (1, 15)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_matches_jax_pallas_interpret(case):
    args, kw = case
    _check(_port(*args, **kw), _jax_kernel(*args, **kw), exact=False)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_matches_jax_jnp_bitwise(case):
    args, kw = case
    _check(_port(*args, **kw), _jax_jnp(*args, **kw), exact=True)


def test_tie_break_feature_asc_bin_desc():
    args, kw = CASES[5]
    res, _ = _port(*args, **kw)
    assert int(res.feature) == 2  # smallest feature wins the exact tie
    ref, _ = _jax_kernel(*args, **kw)
    assert int(res.threshold) == int(ref.threshold)


def test_no_valid_split():
    hl, totl, fmask, nbpf, iscat = _mk(seed=5)
    args = (hl, hl, totl, totl, fmask, nbpf, iscat)
    port = _port(*args, min_data=1e9)
    _check(port, _jax_kernel(*args, min_data=1e9), exact=False, floats=False)
    _check(port, _jax_jnp(*args, min_data=1e9), exact=True)
    assert int(port[0].feature) == -1 and int(port[0].threshold) == 0
    assert float(port[0].gain) == float("-inf")
    # can_split=False kills both children
    port = _port(*args, can=False)
    _check(port, _jax_kernel(*args, can=False), exact=False, floats=False)
    assert int(port[0].feature) == -1 and int(port[1].feature) == -1


def test_cuda_entry_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the entry would launch the kernel")
    hl, totl, fmask, nbpf, iscat = _mk(seed=1)
    meta = cuda_search.pack_meta(torch.from_numpy(fmask),
                                 torch.from_numpy(nbpf),
                                 torch.from_numpy(iscat), "cpu")
    before = cuda_search.LAUNCHES
    with pytest.raises((RuntimeError, ValueError)):
        cuda_search._search2_rows_cuda(
            torch.from_numpy(hl), torch.from_numpy(hl),
            [1.0, *totl, *totl, 1.0, 0.0, 0.0, 1.0, 0.0], meta)
    assert cuda_search.LAUNCHES == before


# ------------------------------------------------- the scan's branches
# B = 7: one block of 16, no offsets; B = 300: level 1's 16-lane halves;
# B = 600: two 512-bin segments.  A masked feature, a categorical one, a
# short one and all five constraints.  Against the Pallas kernel the floats
# agree to SHAPE_RTOL: over hundreds of bins its triangular-matmul suffix
# sums and the blocked scan round a few ulps apart (1.3e-5 seen at 300
# bins); feature and threshold are exact, and against the jnp search,
# whose suffix sums take the blocked order, the port is bitwise.
SHAPE_BINS = (7, 300, 600)
SHAPE_RTOL = 1e-4


def _shape_case(B, F=9, seed=None):
    seed = B if seed is None else seed
    hl, totl, fmask, nbpf, iscat = _mk(F=F, B=B, seed=seed)
    hr, totr, *_ = _mk(F=F, B=B, seed=seed + 100)
    fmask, nbpf, iscat = fmask.copy(), nbpf.copy(), iscat.copy()
    fmask[0] = False
    iscat[3] = True
    nbpf[7] = max(2, B - 5)
    return ((hl, hr, totl, totr, fmask, nbpf, iscat),
            dict(min_data=3.0, min_hess=0.5, l1=0.25, l2=1.0,
                 min_gain=0.01))


@pytest.mark.parametrize("B", SHAPE_BINS)
def test_shapes_match_jax_pallas_interpret(B):
    args, kw = _shape_case(B)
    _check(_port(*args, **kw), _jax_kernel(*args, **kw), exact=False,
           rtol=SHAPE_RTOL)


@pytest.mark.parametrize("B", SHAPE_BINS)
def test_shapes_match_jax_jnp_bitwise(B):
    args, kw = _shape_case(B)
    _check(_port(*args, **kw), _jax_jnp(*args, **kw), exact=True)


# (F, B) of the tests on the card: the CASES at F = 9, B = 31, the scan's
# branches, a four-level scan over 5,000 bins and F = 5,000 features
CARD_SHAPES = [(9, 31), *[(9, b) for b in SHAPE_BINS], (9, 5000),
               (5000, 255)]
CARD_IDS = [f"F{f}-B{b}" for f, b in CARD_SHAPES]


def _card_cases(F, B):
    return CASES if (F, B) == (9, 31) else [_shape_case(B, F=F)]


def _same(a, b):
    """Bitwise equal rows (NaN where the other has NaN)."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _scal(totl, totr, kw):
    return [1.0, *[float(v) for v in totl], *[float(v) for v in totr],
            *_consts(kw)]


@pytest.mark.cuda
@pytest.mark.parametrize("F,B", CARD_SHAPES, ids=CARD_IDS)
def test_kernel_matches_plain_on_card(F, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    for args, kw in _card_cases(F, B):
        hl, hr, totl, totr, fmask, nbpf, iscat = args
        t = torch.from_numpy
        meta = pack_meta(t(fmask), t(nbpf), t(iscat), "cpu")
        scal = _scal(totl, totr, kw)
        want = search2_rows(t(hl), t(hr), scal, meta)
        got = search2_rows(t(hl).cuda(), t(hr).cuda(), scal, meta.cuda())
        _same(got.cpu(), want)


# --------------------------------------------------------------- kernel 4
_P, _PARENT, _NEW = 4, 1, 3


def _raw(x, Fp, Bp):
    """[F, B, 3] -> the JAX raw layout [Fp, 4, Bp] (zero padded)."""
    F, B, _ = x.shape
    out = np.zeros((Fp, 4, Bp), np.float32)
    out[:F, :3, :B] = x.transpose(0, 2, 1)
    return out


def _update_inputs(h_left, h_right, small_is_left, seed):
    """A buffer whose parent row is left + right, and the smaller child;
    the other rows hold noise that must stay untouched."""
    rng = np.random.RandomState(seed)
    hists = rng.randn(_P, *h_left.shape).astype(np.float32)
    hists[_PARENT] = h_left + h_right
    return hists, (h_left if small_is_left else h_right)


def _update_both(h_left, h_right, totl, totr, small_is_left, fmask, nbpf,
                 iscat, seed, can=True, **kw):
    hists, small = _update_inputs(h_left, h_right, small_is_left, seed)
    F, B, _ = h_left.shape
    t = torch.from_numpy
    ours_h = t(hists.copy())
    meta = pack_meta(t(fmask), t(nbpf), t(iscat), "cpu")
    scal = [float(can), *[float(v) for v in totl],
            *[float(v) for v in totr], *_consts(kw)]
    rows = search2_update(ours_h, t(small), _PARENT, _NEW, small_is_left,
                          scal, meta)
    Fp, Bp = -(-F // 8) * 8, -(-B // 128) * 128
    jh = np.stack([_raw(x, Fp, Bp) for x in hists])
    f = jnp.float32
    jh_new, rl, rr = search2_update_pallas(
        jnp.asarray(jh), jnp.asarray(_raw(small, Fp, Bp)), jnp.int32(_PARENT),
        jnp.int32(_NEW), jnp.bool_(True), jnp.bool_(small_is_left),
        *[f(v) for v in totl], *[f(v) for v in totr], jnp.bool_(can),
        jnp.asarray(fmask), jnp.asarray(nbpf), jnp.asarray(iscat),
        *[f(v) for v in _consts(kw)], interpret=True)
    jh_new = np.asarray(jh_new)[:, :F, :3, :B].transpose(0, 1, 3, 2)
    return hists, ours_h.numpy(), rows, jh_new, (rl, rr), scal, meta


UPDATE_CASES = [(CASES[s][0], sil, s) for s in range(5)
                for sil in (True, False)]
UPDATE_IDS = [f"random{s}-small_{'left' if sil else 'right'}"
              for _, sil, s in UPDATE_CASES]


@pytest.mark.parametrize("case", UPDATE_CASES, ids=UPDATE_IDS)
def test_update_matches_jax_pallas_interpret(case):
    (hl, hr, totl, totr, fmask, nbpf, iscat), small_is_left, seed = case
    before, ours, rows, theirs, ref, _, _ = _update_both(
        hl, hr, totl, totr, small_is_left, fmask, nbpf, iscat, seed)
    np.testing.assert_array_equal(ours[[_PARENT, _NEW]],
                                  theirs[[_PARENT, _NEW]])
    np.testing.assert_array_equal(ours[[0, 2]], before[[0, 2]])
    _check((unpack(rows, 0), unpack(rows, 1)), ref, exact=False)


@pytest.mark.parametrize("case", [CASES[5], CASES[6], CASES[7]],
                         ids=["tie", "categorical", "bin_tie"])
def test_update_crafted_ties(case):
    """Integer-valued histograms: parent - small is exact, so the updated
    rows are the crafted children and the search must resolve the ties
    as kernel 3's search does, bitwise."""
    (hl, hr, totl, totr, fmask, nbpf, iscat), kw = case
    _, ours, rows, theirs, ref, scal, meta = _update_both(
        hl, hr, totl, totr, True, fmask, nbpf, iscat, seed=0, **kw)
    np.testing.assert_array_equal(ours[[_PARENT, _NEW]],
                                  theirs[[_PARENT, _NEW]])
    np.testing.assert_array_equal(ours[_PARENT], hl)
    np.testing.assert_array_equal(ours[_NEW], hr)
    _check((unpack(rows, 0), unpack(rows, 1)), ref, exact=False)
    want = search2_rows(torch.from_numpy(hl), torch.from_numpy(hr), scal,
                        meta)
    assert torch.equal(rows, want)


def test_update_cuda_entry_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the entry would launch the kernel")
    hl, totl, fmask, nbpf, iscat = _mk(seed=1)
    meta = pack_meta(torch.from_numpy(fmask), torch.from_numpy(nbpf),
                     torch.from_numpy(iscat), "cpu")
    before = cuda_search.UPDATE_LAUNCHES
    with pytest.raises((RuntimeError, ValueError)):
        cuda_search._search2_update_cuda(
            torch.zeros((3,) + hl.shape), torch.from_numpy(hl), 0, 1, True,
            [1.0, *totl, *totl, 1.0, 0.0, 0.0, 1.0, 0.0], meta)
    assert cuda_search.UPDATE_LAUNCHES == before


@pytest.mark.parametrize("B", SHAPE_BINS)
@pytest.mark.parametrize("small_is_left", [True, False],
                         ids=["small_left", "small_right"])
def test_update_shapes_match_jax_pallas_interpret(B, small_is_left):
    (hl, hr, totl, totr, fmask, nbpf, iscat), kw = _shape_case(B)
    before, ours, rows, theirs, ref, _, _ = _update_both(
        hl, hr, totl, totr, small_is_left, fmask, nbpf, iscat, B, **kw)
    np.testing.assert_array_equal(ours[[_PARENT, _NEW]],
                                  theirs[[_PARENT, _NEW]])
    np.testing.assert_array_equal(ours[[0, 2]], before[[0, 2]])
    _check((unpack(rows, 0), unpack(rows, 1)), ref, exact=False,
           rtol=SHAPE_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("F,B", CARD_SHAPES, ids=CARD_IDS)
def test_update_kernel_matches_plain_on_card(F, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    cases = (UPDATE_CASES if (F, B) == (9, 31) else
             [(_shape_case(B, F=F)[0], sil, B) for sil in (True, False)])
    for (hl, hr, totl, totr, fmask, nbpf, iscat), sil, seed in cases:
        hists, small = _update_inputs(hl, hr, sil, seed)
        t = torch.from_numpy
        scal = _scal(totl, totr, {})
        cpu_h, dev_h = t(hists.copy()), t(hists.copy()).cuda()
        a = search2_update(cpu_h, t(small), _PARENT, _NEW, sil, scal,
                           pack_meta(t(fmask), t(nbpf), t(iscat), "cpu"))
        b = search2_update(dev_h, t(small).cuda(), _PARENT, _NEW, sil, scal,
                           pack_meta(t(fmask), t(nbpf), t(iscat), "cuda"))
        assert torch.equal(cpu_h, dev_h.cpu())
        _same(b.cpu(), a)


# --------------------------------------------------------------- kernel 5
_SLOTS = 5


def _pool_inputs(hl, hr, resident, seed):
    """A pool of noise with the parent (left + right) in slot 1 when
    resident, else as a tensor of its own; returns the pool, the parent
    argument and the slots (s1, s2) the children take."""
    rng = np.random.RandomState(seed + 50)
    pool = rng.randn(_SLOTS, *hl.shape).astype(np.float32)
    parent = hl + hr
    if resident:
        pool[1] = parent
        return pool, 1, 1, 4
    return pool, torch.from_numpy(parent), 3, 0


@pytest.mark.parametrize("B", SHAPE_BINS)
@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "recomputed"])
def test_pool_shapes_match_jax_raw_search(B, resident):
    """``search2_pool`` (the plain version of kernel 5) against the JAX
    pooled route: the subtraction and routing in XLA, then
    ``search2_pallas_raw`` on the routed children."""
    (hl, hr, totl, totr, fmask, nbpf, iscat), kw = _shape_case(B)
    small_is_left = resident  # both routings over the two parents
    small = hl if small_is_left else hr
    pool, arg, s1, s2 = _pool_inputs(hl, hr, resident, B)
    large = np.asarray(jnp.asarray(hl + hr) - jnp.asarray(small))
    jl, jr = (small, large) if small_is_left else (large, small)
    tot = [float(v) for h in (jl, jr) for v in h[2].sum(axis=0)]
    scal = [1.0, *tot, *_consts(kw)]
    t = torch.from_numpy
    ours = t(pool.copy())
    meta = pack_meta(t(fmask), t(nbpf), t(iscat), "cpu")
    rows = search2_pool(ours, t(small), arg, s1, s2, small_is_left, scal,
                        meta)
    np.testing.assert_array_equal(ours[s1].numpy(), jl)
    np.testing.assert_array_equal(ours[s2].numpy(), jr)
    untouched = [i for i in range(_SLOTS) if i not in (s1, s2)]
    np.testing.assert_array_equal(ours[untouched].numpy(), pool[untouched])
    F = hl.shape[0]
    Fp, Bp = -(-F // 8) * 8, -(-B // 128) * 128
    f = jnp.float32
    ref = search2_pallas_raw(
        jnp.asarray(np.stack([_raw(jl, Fp, Bp), _raw(jr, Fp, Bp)])),
        *[f(v) for v in tot], jnp.bool_(True), jnp.asarray(fmask),
        jnp.asarray(nbpf), jnp.asarray(iscat), *[f(v) for v in _consts(kw)],
        interpret=True)
    _check((unpack(rows, 0), unpack(rows, 1)), ref, exact=False,
           rtol=SHAPE_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("F,B", CARD_SHAPES[1:], ids=CARD_IDS[1:])
def test_pool_kernel_matches_plain_on_card_shapes(F, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    (hl, hr, totl, totr, fmask, nbpf, iscat), kw = _shape_case(B, F=F)
    t = torch.from_numpy
    meta = pack_meta(t(fmask), t(nbpf), t(iscat), "cpu")
    scal = _scal(totl, totr, kw)
    for resident in (True, False):
        for sil in (True, False):
            pool, arg, s1, s2 = _pool_inputs(hl, hr, resident, B)
            small = t(hl if sil else hr)
            cpu, dev = t(pool.copy()), t(pool.copy()).cuda()
            a = search2_pool(cpu, small, arg, s1, s2, sil, scal, meta)
            b = search2_pool(dev, small.cuda(), arg if resident else
                             arg.cuda(), s1, s2, sil, scal, meta.cuda())
            assert torch.equal(cpu, dev.cpu())
            _same(b.cpu(), a)
