"""Distributed loading (io/distributed.py, ``num_machines > 1``) and the
parallel learners through the training API and the CLI, on a 2-rank gloo
world of CPU processes (tests/torch_parallel_worker.py, started once for
the module, every rank killed past a deadline).

* ``partition_rows`` and ``shard_features`` equal the JAX package's.
* ``distributed_find_bin_mappers`` over the world equals the JAX
  package's mappers and the serial ones.
* ``from_file`` with ``num_machines=2`` keeps each rank's partition
  (query by query for ranked data) with the whole file's mappers: the
  JAX package's ``from_file(..., rank=r)`` bitwise.  Without a world of
  that size it raises (the CLI forms the world first, from a machine
  list or torchrun's env: tests/test_torch_multihost.py).
* ``lt.train`` with ``tree_learner=data`` and ``voting`` (degenerate
  ``top_k``): the model text is the same on both ranks and, with a
  custom objective whose gradients are integers (every sum exact), the
  serial model's; with a world of one rank ``tree_learner=data`` grows
  the serial model bitwise.
* The CLI with ``num_machines=2``: each rank trains data-parallel on its
  partition and both write the same model.
"""

import datetime

import numpy as np
import pytest
import torch.distributed as dist

from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.binner import find_bin_mappers as jax_find_bin_mappers
from lightgbm_tpu.io.dataset import BinnedDataset as JaxDataset
from lightgbm_tpu.io.distributed import (partition_rows as jax_partition,
                                         shard_features as jax_shard)

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.binner import find_bin_mappers
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.io.distributed import (distributed_find_bin_mappers,
                                               partition_rows,
                                               shard_features)

from torch_parallel_worker import World, exact_fobj, free_port

W = 2
N, NF = 1000, 6


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, NF)
    X[:, 5] = rng.randint(0, 4, N)  # categorical
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.randn(N) * 0.5 > 0).astype(
        np.float32)
    return X, y


def _write(path, X, y):
    np.savetxt(path, np.column_stack([y, X]), fmt="%.9g", delimiter=",")


TRAIN_PARAMS = {"objective": "binary", "num_leaves": 15,
                "min_data_in_leaf": 10, "categorical_feature": [5]}
API_CASES = {"data": dict(tree_learner="data"),
             "voting": dict(tree_learner="voting", top_k=NF)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_io")
    X, y = _data()
    _write(d / "train.csv", X, y)
    Xv, yv = _data(1)
    _write(d / "valid.csv", Xv[:300], yv[:300])
    # ranked data: 50 queries of 20 rows, the group sizes beside it
    _write(d / "rank.csv", X, np.clip(np.round(X[:, 0] + 2), 0, 4))
    np.savetxt(d / "rank.csv.query", np.full(50, 20), fmt="%d")
    return d


@pytest.fixture(scope="module")
def world(files, tmp_path_factory):
    X, y = _data()
    sample = X[np.sort(np.random.RandomState(2).choice(N, 400, False))]
    load = {"num_machines": W, "max_bin": 63, "categorical_feature": "5"}
    cases = [("mappers", "find_mappers",
              dict(sample=sample, num_machines=W, max_bin=63,
                   categorical_features=[5])),
             ("load", "load", dict(path=str(files / "train.csv"),
                                   params=load,
                                   valid=str(files / "valid.csv"))),
             ("load_rank", "load", dict(path=str(files / "rank.csv"),
                                        params=load))]
    for name, extra in API_CASES.items():
        cases.append((f"api-{name}", "train",
                      dict(params=dict(TRAIN_PARAMS, **extra), X=X, y=y,
                           rounds=4, exact=True)))
    cases.append(("api-float", "train",
                  dict(params=dict(TRAIN_PARAMS, tree_learner="data"), X=X,
                       y=y, rounds=4)))
    out = tmp_path_factory.mktemp("dist_out")
    cli = [f"data={files / 'train.csv'}", "objective=binary", "num_trees=4",
           "num_leaves=7", "num_machines=2", "tree_learner=data",
           "verbose=-1"]
    cases.append(("cli", "cli_train", dict(argv=cli,
                                           model_path=str(out / "m.txt"))))
    return World(cases, W, str(tmp_path_factory.mktemp("world")),
                 deadline_s=240).results()


def _same_on_ranks(world, name, key):
    for r in range(1, W):
        assert world[r][name][key] == world[0][name][key]
    return world[0][name][key]


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("n,qb", [(1000, None), (1000, "q")])
def test_partition_rows_equals_jax(n, qb):
    bounds = np.arange(0, n + 1, 20) if qb else None
    for m in (1, 2, 3):
        rows = [partition_rows(n, r, m, 7, bounds) for r in range(m)]
        for r in range(m):
            np.testing.assert_array_equal(rows[r],
                                          jax_partition(n, r, m, 7, bounds))
        np.testing.assert_array_equal(np.sort(np.concatenate(rows)),
                                      np.arange(n))


@pytest.mark.parametrize("F,m", [(6, 2), (7, 3), (2, 4)])
def test_shard_features_equals_jax(F, m):
    for a, b in zip(shard_features(F, m), jax_shard(F, m)):
        np.testing.assert_array_equal(a, b)


def test_find_mappers_over_world_equal_jax_and_serial(world):
    X, _ = _data()
    sample = X[np.sort(np.random.RandomState(2).choice(N, 400, False))]
    got = world[0]["mappers"]
    assert world[1]["mappers"] == got
    serial = [m.to_dict() for m in find_bin_mappers(
        sample, max_bin=63, categorical_features=[5])]
    jax = [m.to_dict() for m in jax_find_bin_mappers(
        sample, max_bin=63, categorical_features=[5])]
    assert got == serial == jax
    # one rank alone: its own mappers, no transport
    one = distributed_find_bin_mappers(sample, 0, 1, max_bin=63,
                                       categorical_features=[5])
    assert [m.to_dict() for m in one] == serial


def test_partitioned_load_equals_jax(world, files):
    whole = BinnedDataset.from_file(
        str(files / "train.csv"),
        Config.from_dict({"max_bin": 63, "categorical_feature": "5"}))
    rows = []
    for r in range(W):
        got = world[r]["load"]
        assert got["partition_rank"] == r
        assert got["mappers"] == [m.to_dict() for m in whole.bin_mappers]
        jcfg = JaxConfig.from_dict({"num_machines": W, "max_bin": 63,
                                    "categorical_feature": "5"})
        jds = JaxDataset.from_file(str(files / "train.csv"), jcfg, rank=r)
        np.testing.assert_array_equal(got["bins"], np.asarray(jds.X_bin))
        np.testing.assert_array_equal(got["label"], jds.metadata.label)
        keep = partition_rows(N, r, W, Config().data_random_seed)
        np.testing.assert_array_equal(got["bins"], whole.dense_bins()[keep])
        rows.append(keep)
        # the valid file is partitioned too, with the training mappers
        assert got["valid_bins"].shape[0] < 300
    assert sum(len(k) for k in rows) == N


def test_partitioned_ranked_load_keeps_queries(world, files):
    seed = Config().data_random_seed
    qb = np.arange(0, N + 1, 20)
    for r in range(W):
        keep = partition_rows(N, r, W, seed, qb)
        assert len(keep) % 20 == 0
        assert len(world[r]["load_rank"]["label"]) == len(keep)


def test_num_machines_without_world_names_step_3(files):
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="world of 2 ranks"):
        BinnedDataset.from_file(str(files / "train.csv"),
                                Config(num_machines=2))


@pytest.mark.parametrize("name", sorted(API_CASES))
def test_api_exact_sums_equal_serial(world, name):
    """Model text the same on both ranks and the serial model's."""
    got = _same_on_ranks(world, f"api-{name}", "model")
    X, y = _data()
    serial = lt.train(dict(TRAIN_PARAMS, verbose=-1),
                      lt.Dataset(X, label=y, device="cpu"), 4,
                      fobj=exact_fobj, device="cpu").model_to_string()
    assert got == serial


def test_api_float_data_same_on_ranks(world):
    got = _same_on_ranks(world, "api-float", "model")
    assert got.count("Tree=") == 4


def test_world_of_one_grows_serial(tmp_path):
    """A world of one rank: ``tree_learner=data`` is the serial learner
    (the JAX package's rule on one device), bitwise."""
    X, y = _data()
    params = dict(TRAIN_PARAMS, verbose=-1)
    serial = lt.train(params, lt.Dataset(X, label=y, device="cpu"), 3,
                      device="cpu").model_to_string()
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        bst = lt.train(dict(params, tree_learner="data"),
                       lt.Dataset(X, label=y, device="cpu"), 3,
                       device="cpu")
        assert bst._gbdt._learner is None
        assert bst.model_to_string() == serial
    finally:
        dist.destroy_process_group()


def test_cli_num_machines_trains_on_partitions(world):
    got = world[0]["cli"]
    assert got["rc"] == 0 and world[1]["cli"]["rc"] == 0
    assert world[1]["cli"]["model"] == got["model"]
    assert got["model"].count("Tree=") == 4
