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
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lightgbm_tpu.ops.pallas_search import (search2_pallas,
                                            search2_update_pallas)
from lightgbm_tpu.ops.split import find_best_split_leaves as jax_fbsl
from lightgbm_tpu_torch.ops import cuda_search
from lightgbm_tpu_torch.ops.cuda_search import (pack_meta, search2,
                                                search2_rows, search2_update,
                                                unpack)

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


def _check(port, ref, exact, floats=True):
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
                np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6,
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


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    for args, kw in CASES:
        hl, hr, totl, totr, fmask, nbpf, iscat = args
        t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
        got = search2(t(hl), t(hr), *[float(v) for v in totl],
                      *[float(v) for v in totr], True, t(fmask), t(nbpf),
                      t(iscat), *_consts(kw))
        want = _port(*args, **kw)
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                assert float(x) == float(y) or (
                    np.isnan(float(x)) and np.isnan(float(y)))


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


@pytest.mark.cuda
def test_update_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    for (hl, hr, totl, totr, fmask, nbpf, iscat), sil, seed in UPDATE_CASES:
        hists, small = _update_inputs(hl, hr, sil, seed)
        t = torch.from_numpy
        scal = [1.0, *[float(v) for v in totl], *[float(v) for v in totr],
                *_consts({})]
        cpu_h, dev_h = t(hists.copy()), t(hists.copy()).cuda()
        a = search2_update(cpu_h, t(small), _PARENT, _NEW, sil, scal,
                           pack_meta(t(fmask), t(nbpf), t(iscat), "cpu"))
        b = search2_update(dev_h, t(small).cuda(), _PARENT, _NEW, sil, scal,
                           pack_meta(t(fmask), t(nbpf), t(iscat), "cuda"))
        assert torch.equal(cpu_h, dev_h.cpu())
        assert torch.equal(a, b.cpu())
