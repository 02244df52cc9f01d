"""Sparse input and the sparse level histogram (S1's plain version) of the
port against the JAX package's.

* ``SparseBins`` / ``from_csr`` / the LibSVM sparse ingest: storage, bins,
  mappers and metadata bitwise the JAX package's.
* ``sparse_histogram_by_leaf_plain`` (kernel S1's plain version, which
  sums in S1's order: segments of a feature's entries, 2048-row chunks
  of leaf totals) against the JAX package's ``sparse_histogram_by_leaf``
  (one segment sum) and against the port's dense level histogram on the
  densified bins: f32 tolerance rtol 1e-5 / atol 1e-4 (the JAX test's:
  the default bin's cell is a difference of two sums taken in other
  orders), on one and on many segments a feature.
* The default bin's error at 500k rows and 2 leaves against a float64
  oracle: relative 2e-5 (tests/test_sparse.py:293's bound).
* The gate: the sparse histogram is chosen exactly where the JAX
  package's ``_depthwise_hist_fn`` chooses its own.
* Depthwise and hybrid trees trained from CSR against the JAX package's
  sparse trees, held as tests/test_torch_depthwise.py holds depthwise
  trees (structure exact, values rtol 1e-5 / atol 1e-6).
* ``predict`` on a CSR matrix across several densified row chunks equals
  dense ``predict`` bitwise.

Kernel S1 itself runs only on the card: ``test_s1_matches_plain_on_card``
(marked ``cuda``) and ``chip_smoke.py`` phase 20 hold it bitwise against
this plain version.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
import lightgbm_tpu as lgb
import lightgbm_tpu.engine as jax_engine
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JaxDataset
from lightgbm_tpu.io.metadata import Metadata as JaxMetadata
from lightgbm_tpu.models.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.objectives import create_objective as jax_objective
from lightgbm_tpu.ops.sparse_hist import entry_rows as jax_entry_rows
from lightgbm_tpu.ops.sparse_hist import sparse_histogram_by_leaf as jax_s1

import lightgbm_tpu_torch as lt
import lightgbm_tpu_torch.basic as port_basic
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.io.metadata import Metadata
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ops import sparse_hist
from lightgbm_tpu_torch.ops.histogram import histogram_by_leaf_sorted_plain

from test_torch_objectives import assert_same_trees


def _random_csr(n, f, density, seed, values=(0.5, 1.0, 1.5, 2.0, -1.0)):
    rng = np.random.RandomState(seed)
    mask = rng.rand(n, f) < density
    dense = np.zeros((n, f))
    dense[mask] = rng.choice(values, int(mask.sum()))
    return dense, sp.csr_matrix(dense)


def _csr_args(csr):
    return (np.asarray(csr.indptr, np.int64), np.asarray(csr.indices,
                                                         np.int64),
            np.asarray(csr.data, np.float64), csr.shape[1])


def _same_sparse(port, ref):
    assert port.is_sparse and ref.is_sparse
    a, b = port.X_bin, ref.X_bin
    for k in ("indptr", "col", "bin", "default_bins"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(port.dense_bins(), ref.dense_bins())
    assert [m.to_dict() for m in port.bin_mappers] == \
        [m.to_dict() for m in ref.bin_mappers]
    np.testing.assert_array_equal(port.used_feature_map,
                                  ref.used_feature_map)


@pytest.mark.parametrize("max_bin", [15, 300])
def test_from_csr_matches_jax(max_bin):
    dense, csr = _random_csr(800, 50, 0.04, seed=1,
                             values=np.linspace(-3, 3, 400))
    y = (dense.sum(1) > 0).astype(np.float32)
    port = BinnedDataset.from_csr(*_csr_args(csr), Metadata(label=y),
                                  Config(max_bin=max_bin))
    ref = JaxDataset.from_csr(*_csr_args(csr), JaxMetadata(label=y),
                              JaxConfig(max_bin=max_bin))
    _same_sparse(port, ref)
    # the subset and a valid set aligned through CSR
    rows = np.arange(0, 800, 3)
    _same_sparse(port.subset(rows), ref.subset(rows))
    _, csr_v = _random_csr(200, 55, 0.04, seed=2)
    args = _csr_args(csr_v)[:3]
    _same_sparse(port.align_with_csr(*args, Metadata(label=np.zeros(200))),
                 ref.align_with_csr(*args, JaxMetadata(label=np.zeros(200))))
    # the dense path on the same data gives the same bins
    dense_ds = BinnedDataset.from_matrix(dense, Metadata(label=y),
                                         Config(max_bin=max_bin))
    np.testing.assert_array_equal(dense_ds.X_bin, port.dense_bins())


def test_dataset_of_scipy_csr():
    dense, csr = _random_csr(600, 40, 0.05, seed=3)
    y = (dense[:, 0] > 0).astype(np.float32)
    port = lt.Dataset(csr, label=y, device="cpu").construct()
    ref = lgb.Dataset(csr, label=y).construct()
    _same_sparse(port, ref)
    va = lt.Dataset(csr, label=y, device="cpu")
    valid = va.create_valid(csr[:100], label=y[:100]).construct()
    assert valid.is_sparse
    np.testing.assert_array_equal(valid.dense_bins(), port.dense_bins()[:100])


def test_libsvm_sparse_ingest_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    lines = []
    for _ in range(700):
        idx = np.sort(rng.choice(120, rng.randint(0, 5), replace=False))
        lines.append(" ".join(["%d" % rng.randint(0, 2)] + [
            "%d:%.17g" % (j, rng.choice([1.0, 2.0, 0.25])) for j in idx]))
    path = tmp_path / "d.svm"
    path.write_text("\n".join(lines) + "\n")
    port = BinnedDataset.from_file(str(path), Config())
    ref = JaxDataset.from_file(str(path), JaxConfig())
    _same_sparse(port, ref)
    np.testing.assert_array_equal(port.metadata.label, ref.metadata.label)


def _hist_case(n, f, density, L, seed, max_bin=16, distinct=40):
    dense, csr = _random_csr(n, f, density, seed,
                             values=np.linspace(-2, 2, distinct))
    ds = BinnedDataset.from_csr(*_csr_args(csr),
                                Metadata(label=np.zeros(n, np.float32)),
                                Config(max_bin=max_bin))
    assert ds.is_sparse
    rng = np.random.RandomState(seed + 1)
    lid = rng.randint(0, L, n).astype(np.int32)
    g = rng.randn(n).astype(np.float32)
    h = (rng.rand(n) + 0.5).astype(np.float32)
    m = (rng.rand(n) > 0.3).astype(np.float32)
    return ds, lid, g, h, m


@pytest.mark.parametrize("seg", [sparse_hist.SEG_ENTRIES, 16])
def test_plain_s1_matches_jax_and_dense(seg):
    ds, lid, g, h, m = _hist_case(3000, 30, 0.04, 6, seed=5)
    B = max(ds.max_num_bin, 2)
    csc = sparse_hist.csc_from_csr(ds.X_bin.indptr, ds.X_bin.col,
                                   ds.X_bin.bin, ds.X_bin.default_bins,
                                   ds.num_features, "cpu", seg)
    assert (len(csc["fold_feat"]) > 0) == (seg == 16)
    t = [torch.from_numpy(a) for a in (lid, g, h, m)]
    got = sparse_hist.sparse_histogram_by_leaf(csc, *t, 6, B).numpy()
    sb = ds.X_bin
    ref = np.asarray(jax_s1(
        jnp.asarray(jax_entry_rows(sb.indptr)), jnp.asarray(sb.col),
        jnp.asarray(sb.bin), jnp.asarray(sb.default_bins, jnp.int32),
        jnp.asarray(lid), jnp.asarray(g), jnp.asarray(h), jnp.asarray(m),
        num_leaves=6, num_features=ds.num_features, num_bins=B))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    dense = histogram_by_leaf_sorted_plain(ds.bins_T("cpu"), *t, B, 6)
    np.testing.assert_allclose(got, dense.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[..., 2], dense.numpy()[..., 2])


@pytest.mark.parametrize("max_bin", [16, 300])
def test_sparse_routing_bins_from_entries(max_bin):
    """A sparse dataset's ``[F, n]`` routing bins, filled from the stored
    entries on the device, equal its densified bins transposed, bitwise
    (uint8 and uint16 bins)."""
    ds = _hist_case(20_000, 8, 0.1, 4, seed=3, max_bin=max_bin,
                    distinct=400)[0]
    want = np.ascontiguousarray(ds.dense_bins().T)
    assert (want.dtype == np.uint16) == (max_bin > 255)
    got = ds.bins_T("cpu")
    assert got.shape == want.shape
    assert got.dtype == torch.from_numpy(want).dtype
    if want.dtype == np.uint16:
        got, want = got.view(torch.int16), want.view(np.int16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_default_bin_error_at_scale():
    """tests/test_sparse.py:293's case through the port's plain S1."""
    n, f, B, L = 500_000, 4, 16, 2
    rng = np.random.RandomState(11)
    nnz_per_row = rng.binomial(f, 0.01, n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(nnz_per_row, out=indptr[1:])
    nnz = int(indptr[-1])
    cols = rng.randint(0, f, nnz).astype(np.int32)
    bins = rng.randint(1, B, nnz).astype(np.uint8)
    leaf_id = rng.randint(0, L, n).astype(np.int32)
    g = (rng.rand(n) + 0.5).astype(np.float32)
    h = (rng.rand(n) + 0.5).astype(np.float32)
    m = np.ones(n, np.float32)
    csc = sparse_hist.csc_from_csr(indptr, cols, bins, np.zeros(f, np.int32),
                                   f, "cpu")
    got = sparse_hist.sparse_histogram_by_leaf(
        csc, *(torch.from_numpy(a) for a in (leaf_id, g, h, m)), L,
        B).numpy()
    erow = sparse_hist.entry_rows(indptr)
    for lf in range(L):
        tot_g = np.sum(g[leaf_id == lf], dtype=np.float64)
        for ff in range(f):
            e_sel = (leaf_id[erow] == lf) & (cols == ff)
            want = tot_g - np.sum(g[erow][e_sel], dtype=np.float64)
            rel = abs(got[lf, ff, 0, 0] - want) / max(abs(want), 1.0)
            assert rel < 2e-5, (lf, ff, got[lf, ff, 0, 0], want, rel)


@pytest.mark.parametrize("density,growth,hist_dtype", [
    (0.03, "depthwise", "float32"),
    (0.03, "hybrid", "float32"),
    (0.03, "leafwise", "float32"),
    (0.12, "depthwise", "float32"),
    (0.03, "depthwise", "float64"),
])
def test_gate_matches_jax(density, growth, hist_dtype):
    dense, csr = _random_csr(600, 40, density, seed=6)
    y = (dense[:, 0] + dense[:, 1] > 0).astype(np.float32)
    params = dict(objective="binary", num_leaves=7, max_bin=16,
                  tree_growth=growth, hist_dtype=hist_dtype,
                  sparse_hist_density=0.05)
    jcfg = JaxConfig.from_dict(params)
    jds = JaxDataset.from_csr(*_csr_args(csr), JaxMetadata(label=y), jcfg)
    jgb = JaxGBDT(jcfg, jds, jax_objective(jcfg, jds.metadata, len(y)))
    jfn = jgb._depthwise_hist_fn()
    want = jfn is not None and jfn.__qualname__.startswith(
        "make_sparse_hist_fn")
    cfg = Config.from_dict(dict(params, hist_dtype="float32"))
    ds = BinnedDataset.from_csr(*_csr_args(csr), Metadata(label=y), cfg)
    gb = GBDT(cfg, ds, create_objective(cfg, ds.metadata, len(y), "cpu"),
              device="cpu")
    gb.config.hist_dtype = hist_dtype  # the gate reads it per call
    fn = gb._level_hist_fn()
    assert fn.__qualname__.startswith("make_sparse_hist_fn") == want


@pytest.mark.parametrize("growth", ["depthwise", "hybrid"])
def test_sparse_trees_match_jax(growth):
    dense, csr = _random_csr(1500, 60, 0.04, seed=7,
                             values=np.linspace(-2, 2, 30))
    rng = np.random.RandomState(8)
    z = dense[:, :10].sum(1) + 0.5 * rng.randn(1500)
    y = (z > 0).astype(np.float32)
    init = (0.3 * rng.randn(1500)).astype(np.float32)
    params = dict(objective="binary", num_leaves=15, max_bin=31,
                  tree_growth=growth, min_data_in_leaf=10, verbose=-1,
                  hist_impl="matmul", forest_batching="off")
    bj = jax_engine.train(dict(params),
                          lgb.Dataset(csr, label=y, init_score=init), 4)
    ds = lt.Dataset(csr, label=y, init_score=init, device="cpu")
    bt = lt.train(dict(params), ds, 4, device="cpu")
    assert ds.construct().is_sparse
    assert bt._gbdt._level_hist_fn().__qualname__.startswith(
        "make_sparse_hist_fn")
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(dense), bj.predict(dense),
                               rtol=1e-5, atol=1e-6)


def test_sparse_predict_chunked_matches_dense(monkeypatch):
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 8)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
    bst = lt.train({"objective": "binary", "num_leaves": 15, "verbose": -1},
                   lt.Dataset(X, label=y, device="cpu"), 5, device="cpu")
    dense, csr = _random_csr(1000, 8, 0.3, seed=9,
                             values=rng.randn(50))
    monkeypatch.setattr(port_basic, "SPARSE_PREDICT_CHUNK_VALUES", 8 * 300)
    for kw in ({}, {"raw_score": True}, {"pred_leaf": True}):
        np.testing.assert_array_equal(bst.predict(csr, **kw),
                                      bst.predict(dense, **kw))


@pytest.mark.cuda
def test_s1_matches_plain_on_card():
    """Kernel S1 bitwise against its plain version on the CPU, and two
    launches against each other: on one and on many segments a feature,
    16 and 300 (uint16) bins, one leaf tile (9 leaves) and several (200
    leaves x 300 bins, cuda_sparse_hist.leaf_tiles), and a level whose
    leaves are mostly empty (rows in every third of 200 leaves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: S1 has no CPU build")
    from lightgbm_tpu_torch.ops.cuda_sparse_hist import leaf_tiles

    for seg, max_bin, L, every in ((sparse_hist.SEG_ENTRIES, 16, 9, 1),
                                   (64, 300, 9, 1),
                                   (sparse_hist.SEG_ENTRIES, 300, 200, 1),
                                   (64, 300, 200, 3)):
        ds, lid, g, h, m = _hist_case(20_000, 40, 0.05, L, seed=10,
                                      max_bin=max_bin, distinct=400)
        lid = lid - lid % every
        B = max(ds.max_num_bin, 2)
        assert (ds.X_bin.bin.dtype == np.uint16) == (max_bin > 255)
        assert (leaf_tiles(L, B)[1] > 1) == (L == 200)
        sb = ds.X_bin
        args = (sb.indptr, sb.col, sb.bin, sb.default_bins, ds.num_features)
        cpu = sparse_hist.csc_from_csr(*args, "cpu", seg)
        gpu = sparse_hist.csc_from_csr(*args, "cuda", seg)
        t = [torch.from_numpy(a) for a in (lid, g, h, m)]
        want = sparse_hist.sparse_histogram_by_leaf(cpu, *t, L, B)
        got = sparse_hist.sparse_histogram_by_leaf(
            gpu, *(a.cuda() for a in t), L, B)
        again = sparse_hist.sparse_histogram_by_leaf(
            gpu, *(a.cuda() for a in t), L, B)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(got, again)
