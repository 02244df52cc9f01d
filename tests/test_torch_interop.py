"""State carried between the JAX package and the port: model text in both
directions, JAX trees as numpy through ``convert.trees_from_numpy``, and
the binning (bin matrix and bin boundaries bitwise equal)."""

import numpy as np
import pytest

import jax

import lightgbm_tpu as lgb
import lightgbm_tpu.engine as jax_engine
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JaxBinned
from lightgbm_tpu.io.metadata import Metadata as JaxMetadata

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import trees_from_numpy
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.io.metadata import Metadata

PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
          "verbose": -1}


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(21)
    X = rng.randn(2500, 8)
    y = (X[:, 0] * X[:, 1] + X[:, 2] > 0).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def jax_booster(data):
    X, y = data
    return jax_engine.train(dict(PARAMS), lgb.Dataset(X, label=y),
                            num_boost_round=4, verbose_eval=False)


@pytest.fixture(scope="module")
def port_booster(data):
    X, y = data
    return lt.train(dict(PARAMS), lt.Dataset(X, label=y, device="cpu"),
                    num_boost_round=4, device="cpu")


def test_port_model_loads_in_jax(data, port_booster):
    X, _ = data
    s = port_booster.model_to_string()
    bj = lgb.Booster(model_str=s)
    np.testing.assert_allclose(bj.predict(X), port_booster.predict(X),
                               atol=1e-6)
    assert bj.model_to_string() == s  # byte-compatible both ways


def test_jax_model_loads_in_port(data, jax_booster):
    X, _ = data
    s = jax_booster.model_to_string()
    bt = lt.Booster(model_str=s, device="cpu")
    np.testing.assert_allclose(bt.predict(X), jax_booster.predict(X),
                               atol=1e-6)
    assert bt.model_to_string() == s


def test_trees_from_numpy_predicts_like_jax(data, jax_booster):
    X, _ = data
    dicts = [jax.tree.map(np.asarray, t)._asdict()
             for t in jax_booster._gbdt.models]
    trees, booster = trees_from_numpy(
        dicts, device="cpu", objective="binary", sigmoid=1.0,
        max_feature_idx=X.shape[1] - 1)
    assert [t.num_leaves for t in trees] == [int(d["num_leaves"])
                                             for d in dicts]
    np.testing.assert_allclose(booster.predict(X), jax_booster.predict(X),
                               atol=1e-6)
    np.testing.assert_allclose(booster.predict(X, raw_score=True),
                               jax_booster.predict(X, raw_score=True),
                               atol=1e-6)


@pytest.mark.parametrize("max_bin,cats", [(255, ()), (63, (3,)),
                                          (300, (1,))])
def test_binning_bitwise(max_bin, cats):
    rng = np.random.RandomState(5)
    n = 6000
    X = rng.randn(n, 6)
    X[:, 1] = rng.randint(0, 40, n)  # categorical candidates
    X[:, 3] = rng.randint(0, 12, n)
    X[:, 2] = np.round(X[:, 2], 1)  # few distinct values
    X[::7, 4] = np.nan  # missing -> zero bin
    X[:, 5] = 1.5  # trivial column, dropped
    y = (X[:, 0] > 0).astype(np.float32)
    if max_bin == 300:
        X[:, 0] = rng.randn(n) * 100  # many distinct values -> uint16 bins
    ours = BinnedDataset.from_matrix(X, Metadata(label=y),
                                     Config(max_bin=max_bin),
                                     categorical_features=cats)
    ref = JaxBinned.from_matrix(X, JaxMetadata(label=y),
                                JaxConfig(max_bin=max_bin),
                                categorical_features=cats)
    assert ours.X_bin.dtype == ref.X_bin.dtype
    np.testing.assert_array_equal(ours.X_bin, ref.X_bin)
    np.testing.assert_array_equal(ours.used_feature_map, ref.used_feature_map)
    for a, b in zip(ours.bin_thresholds_real(), ref.bin_thresholds_real()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.bins_T("cpu").numpy(),
                                  np.asarray(ref.dense_bins_T_device()))
    # a valid set aligned to the training mappers
    Xv = rng.randn(500, 6)
    va = ours.align_with(Xv, Metadata(label=np.zeros(500)))
    vr = ref.align_with(Xv, JaxMetadata(label=np.zeros(500)))
    np.testing.assert_array_equal(va.X_bin, vr.X_bin)
