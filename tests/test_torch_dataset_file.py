"""File loading of the port's ``BinnedDataset`` against the JAX package's.

The same seeded numpy data is written to ``tmp_path`` in the reference's
formats (``%.17g`` CSV/TSV, LibSVM, side files ``.weight`` / ``.query`` /
``.init``) and loaded by ``lightgbm_tpu.io.dataset.BinnedDataset.from_file``
and the port's.  Bins, bin mappers and metadata are held bitwise:
column roles by index and by ``name:``, two-round streaming against
one-shot loading, a valid set aligned to its training set, binary caches
written by either package and read by the other, and
``is_enable_sparse=false``.
"""

import numpy as np
import pytest

from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JaxDataset

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from torch_jax_reader import jax_reader  # noqa: F401  (a fixture)


pytestmark = pytest.mark.usefixtures("jax_reader")


def _write(path, rows, sep=",", header=None):
    lines = [sep.join(header)] if header else []
    lines += [sep.join("%.17g" % v for v in r) for r in rows]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _table(n=600, seed=0):
    """label, 5 features, a weight column and a sorted group id column."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    X[:, 3] = rng.randint(0, 4, n)  # a small-cardinality feature
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    w = rng.rand(n) + 0.5
    g = np.repeat(np.arange(n // 20), 20)
    return np.column_stack([y, X, w, g])


def _meta_equal(a, b):
    for k in ("label", "weights", "query_boundaries", "init_score"):
        x, y = getattr(a.metadata, k), getattr(b.metadata, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=k)


def assert_same_dataset(port, ref):
    assert port.is_sparse == ref.is_sparse
    np.testing.assert_array_equal(port.dense_bins(), ref.dense_bins())
    assert port.dense_bins().dtype == ref.dense_bins().dtype
    assert [m.to_dict() for m in port.bin_mappers] == \
        [m.to_dict() for m in ref.bin_mappers]
    np.testing.assert_array_equal(port.used_feature_map, ref.used_feature_map)
    assert port.num_total_features == ref.num_total_features
    assert list(port.feature_names) == list(ref.feature_names)
    _meta_equal(port, ref)


def _both(path, **params):
    return (BinnedDataset.from_file(path, Config.from_dict(dict(params))),
            JaxDataset.from_file(path, JaxConfig.from_dict(dict(params))))


ROLES = {
    "by-index": dict(label_column="0", weight_column="5", group_column="6",
                     ignore_column="2"),
    "by-name": dict(has_header=True, label_column="name:y",
                    weight_column="name:w", group_column="name:g",
                    ignore_column="name:f1,f3"),
    "label-last": dict(label_column="7"),
    "categorical": dict(categorical_column="3", max_bin=31),
}


@pytest.mark.parametrize("name", sorted(ROLES))
def test_from_file_roles_match_jax(tmp_path, name):
    params = ROLES[name]
    header = (["y", "f0", "f1", "f2", "f3", "f4", "w", "g"]
              if params.get("has_header") else None)
    path = _write(tmp_path / "d.csv", _table(), header=header)
    port, ref = _both(path, **params)
    assert_same_dataset(port, ref)


def test_side_files_match_jax(tmp_path):
    t = _table(400)
    rng = np.random.RandomState(1)
    path = _write(tmp_path / "rank.tsv", t[:, :6], sep="\t")
    np.savetxt(path + ".weight", rng.rand(400) + 0.5, fmt="%.17g")
    np.savetxt(path + ".query", np.full(20, 20), fmt="%d")
    np.savetxt(path + ".init", rng.randn(400), fmt="%.17g")
    port, ref = _both(path)
    assert port.metadata.weights is not None
    assert port.metadata.init_score is not None
    assert len(port.metadata.query_boundaries) == 21
    assert_same_dataset(port, ref)


def test_two_round_loading_equals_one_shot(tmp_path):
    path = _write(tmp_path / "d.csv", _table(3000, seed=2))
    one, ref = _both(path, bin_construct_sample_cnt=1000, max_bin=63)
    two = BinnedDataset._from_file_streaming(
        path, Config(bin_construct_sample_cnt=1000, max_bin=63), "csv",
        chunk_rows=256)
    assert_same_dataset(one, ref)
    assert_same_dataset(two, ref)
    flag, _ = _both(path, bin_construct_sample_cnt=1000, max_bin=63,
                    use_two_round_loading=True)
    assert_same_dataset(flag, ref)


def test_valid_set_aligns_to_train(tmp_path):
    tr = _write(tmp_path / "tr.csv", _table(800, seed=3))
    va = _write(tmp_path / "va.csv", _table(300, seed=4)[:, :5])  # narrower
    port_tr, ref_tr = _both(tr)
    port_va = BinnedDataset.from_file(va, Config(), reference=port_tr)
    ref_va = JaxDataset.from_file(va, JaxConfig(), reference=ref_tr)
    assert_same_dataset(port_va, ref_va)
    assert port_tr.check_align(port_va)
    for stream in (True, False):
        v = BinnedDataset.from_file(
            va, Config(use_two_round_loading=stream), reference=port_tr)
        np.testing.assert_array_equal(v.dense_bins(), ref_va.dense_bins())


def _libsvm(tmp_path, n=500, f=60, seed=5):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(n):
        idx = np.sort(rng.choice(f, rng.randint(1, 6), replace=False))
        lines.append(" ".join(["%d" % rng.randint(0, 2)] + [
            "%d:%.17g" % (j, rng.randint(1, 4) * 0.5) for j in idx]))
    path = tmp_path / "d.svm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_binary_cache_crosses_packages(tmp_path, writer, kind):
    path = (_write(tmp_path / "d.csv", _table(500)) if kind == "dense"
            else _libsvm(tmp_path))
    port, ref = _both(path)
    assert port.is_sparse == (kind == "sparse")
    cache = str(tmp_path / "cache.bin")
    (ref if writer == "jax" else port).save_binary(cache)
    assert_same_dataset(BinnedDataset.load_binary(cache), ref)
    assert_same_dataset(BinnedDataset.load_binary(cache),
                        JaxDataset.load_binary(cache))
    # the cache next to the data file is read instead of the text
    (ref if writer == "jax" else port).save_binary(path + ".bin")
    again = BinnedDataset.from_file(path, Config())
    assert_same_dataset(again, ref)


def test_save_binary_flag_and_reload(tmp_path):
    path = _write(tmp_path / "d.csv", _table(300))
    BinnedDataset.from_file(path, Config(is_save_binary_file=True))
    cached = BinnedDataset.from_file(path + "", Config())
    _, ref = _both(path)
    assert_same_dataset(cached, ref)
    off = BinnedDataset.from_file(
        path, Config(enable_load_from_binary_file=False))
    assert_same_dataset(off, ref)


def test_enable_sparse_false_densifies(tmp_path):
    path = _libsvm(tmp_path)
    port, ref = _both(path, is_enable_sparse=False)
    assert not port.is_sparse
    assert_same_dataset(port, ref)


def test_distributed_loading_raises(tmp_path):
    """A partitioned load needs a world of ``num_machines`` ranks (the
    CLI forms it first); without one it refuses to load one rank's
    partition alone."""
    path = _write(tmp_path / "d.csv", _table(100))
    with pytest.raises(ValueError, match="world of 2 ranks"):
        BinnedDataset.from_file(path, Config(num_machines=2))


def test_dataset_from_path_and_label_override(tmp_path):
    t = _table(400)
    path = _write(tmp_path / "d.csv", t[:, :6])
    ds = lt.Dataset(path, device="cpu").construct()
    ref = JaxDataset.from_file(path, JaxConfig())
    assert_same_dataset(ds, ref)
    flipped = 1.0 - t[:, 0]
    ds2 = lt.Dataset(path, label=flipped, device="cpu").construct()
    np.testing.assert_array_equal(ds2.metadata.label,
                                  flipped.astype(np.float32))
    out = str(tmp_path / "saved.bin")
    lt.Dataset(path, device="cpu").save_binary(out)
    assert_same_dataset(BinnedDataset.load_binary(out), ref)


def test_from_jax_arrays_carries_a_dataset(tmp_path):
    for path in (_write(tmp_path / "d.csv", _table(300)), _libsvm(tmp_path)):
        ref = JaxDataset.from_file(path, JaxConfig())
        md = ref.metadata
        port = BinnedDataset.from_jax_arrays(
            ref.X_bin, [m.to_dict() for m in ref.bin_mappers],
            ref.used_feature_map, ref.num_total_features, label=md.label,
            weights=md.weights, query_boundaries=md.query_boundaries,
            init_score=md.init_score, feature_names=ref.feature_names)
        assert_same_dataset(port, ref)
