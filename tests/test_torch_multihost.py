"""Forming a world from a machine list (parallel/multihost.py) and the
CLI's cross-rank path, against the JAX package's rules.

* ``resolve_world``: the first line is the coordinator, a rank from
  ``LGBM_TPU_PROCESS_ID`` where several lines share this host, its local
  index among its host's lines, loud failures on a short list or an
  ambiguous host, the env triple, and no world for a gang child (the env
  pair without a coordinator).  ``plan_backend``: gloo on the CPU only
  where asked.
* A failed snapshot gather leaves rank 0 a one-rank manifest with
  ``gather_error`` on record.
* ``sync_config_across_processes`` over a made-up world of two: the
  seeds and fractions take their minimum (fractions through their
  float64 bit patterns), a structural mismatch stops naming both
  fingerprints, and the fingerprint is the JAX package's crc of its 14
  keys.
* ONE 2-rank gloo world of CLI processes on 127.0.0.1, formed from a
  machine list with ``LGBM_TPU_PROCESS_ID``, rank 1 given another
  ``bagging_seed`` and ``LGBM_TPU_FAULT=delay_collective:1:150``, beside
  a world of the same training formed from torchrun's env (every rank
  given the smaller seed): both ranks of both worlds write one model;
  rank 0's merged manifest has both ranks, the sentinel's checks and
  names rank 1 the straggler.
"""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from lightgbm_tpu.config import Config as JaxConfig

from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.basic import LightGBMError
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.obs import dist
from lightgbm_tpu_torch.parallel import multihost

from torch_parallel_worker import ROOT, free_port

_ENV = ("LGBM_TPU_COORDINATOR", "LGBM_TPU_NUM_PROCESSES",
        "LGBM_TPU_PROCESS_ID")


@pytest.fixture
def env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _mlist(tmp_path, *hosts):
    path = tmp_path / "mlist.txt"
    path.write_text("".join(f"{h} {12400 + i}\n" for i, h in enumerate(hosts)))
    return str(path)


def test_machine_list_resolution(tmp_path, env):
    ml = _mlist(tmp_path, "127.0.0.1", "127.0.0.1", "10.9.9.9")
    cfg = Config(num_machines=2, machine_list_file=ml)
    with pytest.raises(LightGBMError, match="LGBM_TPU_PROCESS_ID"):
        multihost.resolve_world(cfg)  # two lines of this host
    env.setenv("LGBM_TPU_PROCESS_ID", "1")
    assert multihost.resolve_world(cfg) == {
        "coordinator": "127.0.0.1:12400", "num_processes": 2,
        "process_id": 1, "local_index": 1, "local_count": 2}
    env.setenv("LGBM_TPU_PROCESS_ID", "2")
    w = multihost.resolve_world(Config(num_machines=3, machine_list_file=ml))
    assert (w["local_index"], w["local_count"]) == (0, 1)
    with pytest.raises(LightGBMError, match="lists 3 machines"):
        multihost.resolve_world(Config(num_machines=4, machine_list_file=ml))
    env.delenv("LGBM_TPU_PROCESS_ID")
    one = _mlist(tmp_path, "10.9.9.8", "127.0.0.1")
    assert multihost.resolve_world(Config(
        num_machines=2, machine_list_file=one))["process_id"] == 1
    # the env triple; a gang child's env pair forms no world
    env.setenv("LGBM_TPU_NUM_PROCESSES", "4")
    env.setenv("LGBM_TPU_PROCESS_ID", "3")
    assert multihost.resolve_world(Config()) is None
    env.setenv("LGBM_TPU_COORDINATOR", "10.9.9.9:5000")
    assert multihost.resolve_world(Config()) == {
        "coordinator": "10.9.9.9:5000", "num_processes": 4,
        "process_id": 3, "local_index": 0, "local_count": 1}
    assert multihost.plan_backend(multihost.resolve_world(Config()),
                                  "cpu")[0] == "gloo"


def test_local_listen_port_is_refused(tmp_path, env):
    cfg = Config(num_machines=2, local_listen_port=12500)
    with pytest.raises(ValueError, match="local_listen_port"):
        with multihost.config_world(cfg, "cpu"):
            pass


def test_num_machines_without_world_fails_loudly(tmp_path, env, capsys):
    """No machine list, env or torchrun world: the load refuses to train
    one rank's partition alone."""
    data = tmp_path / "d.csv"
    np.savetxt(data, np.random.RandomState(0).randn(50, 3), delimiter=",")
    assert cli.main([f"data={data}", "num_machines=2", "objective=regression",
                     f"output_model={tmp_path}/m.txt"], device="cpu") == 1
    assert "world of 2 ranks" in capsys.readouterr().err


def test_failed_gather_degrades_to_one_rank(tmp_path, env):
    """Rank 0 of a world whose peer never publishes its snapshot writes
    its own manifest with the failure on record (the JAX package's
    cli.py:335-344)."""
    import json

    rng = np.random.RandomState(1)
    X = rng.randn(200, 3)
    data = tmp_path / "d.csv"
    np.savetxt(data, np.column_stack([X[:, 0] > 0, X]), delimiter=",")

    def never(*a, **k):
        raise TimeoutError("rank-snapshot exchange: ranks [1] never published")

    env.setattr(cli, "world_size", lambda: 2)
    env.setattr(dist, "gather_rank_snapshots", never)
    out = tmp_path / "m.txt"
    assert cli.main([f"data={data}", "objective=binary", "num_trees=2",
                     f"output_model={out}"], device="cpu") == 0
    man = json.load(open(f"{out}.manifest.json"))
    assert man["ranks"] == []
    assert man["extra"]["distributed"]["gather_error"].startswith(
        "TimeoutError: rank-snapshot exchange: ranks [1]")
    assert os.path.exists(f"{out}.manifest.json.rankobs/rank_0.json")


def _fake_world(env, rows_of):
    """A world of two in this process: the all-gather returns this
    rank's words beside ``rows_of(words)``'s."""
    env.setattr(multihost, "world_size", lambda: 2)
    env.setattr(dist, "world_barrier", lambda site="": None)
    env.setattr(dist, "world_allgather_int32", lambda v, site="": np.stack(
        [np.asarray(v, np.int32), rows_of(np.asarray(v, np.int32))]))


def test_config_sync_takes_the_minimum(env):
    cfg = Config(bagging_seed=9, feature_fraction=0.75, bagging_fraction=0.5)
    other = Config(bagging_seed=4, feature_fraction=0.625,
                   bagging_fraction=0.9, data_random_seed=11)

    def rows_of(v):
        if len(v) == 1:  # the structural fingerprint: the same
            return v
        seeds = [other.data_random_seed, other.feature_fraction_seed,
                 other.bagging_seed]
        fr = np.asarray([other.feature_fraction, other.bagging_fraction])
        return np.concatenate([np.asarray(seeds, np.int32),
                               fr.view(np.int32)])

    _fake_world(env, rows_of)
    multihost.sync_config_across_processes(cfg)
    assert (cfg.bagging_seed, cfg.data_random_seed) == (4, 1)
    assert (cfg.feature_fraction, cfg.bagging_fraction) == (0.625, 0.5)


def test_config_sync_refuses_a_structural_mismatch(env):
    cfg = Config(num_leaves=7)
    theirs = multihost.structural_fingerprint(Config(num_leaves=15))
    _fake_world(env, lambda v: np.asarray([theirs], np.int32)
                if len(v) == 1 else v)
    mine = multihost.structural_fingerprint(cfg)
    with pytest.raises(LightGBMError, match="differs across processes") as e:
        multihost.sync_config_across_processes(cfg)
    assert str(mine) in str(e.value) and str(theirs) in str(e.value)


@pytest.mark.parametrize("params", [
    {}, {"objective": "multiclass", "num_class": "3", "num_leaves": "63",
         "learning_rate": "0.05", "tree_learner": "data",
         "tree_growth": "depthwise", "max_depth": "6", "lambda_l2": "1.5"}])
def test_structural_fingerprint_is_the_jax_packages(params):
    """The JAX package's crc over its 14 keys (multihost.py:266-275)."""
    jcfg = JaxConfig.from_dict(dict(params))
    src = "|".join(f"{k}={getattr(jcfg, k, None)}"
                   for k in multihost.STRUCTURAL_KEYS)
    assert multihost.structural_fingerprint(Config.from_dict(dict(params))) \
        == zlib.crc32(src.encode()) & 0x7FFFFFFF


# ------------------------------------------------- two worlds of the CLI
N, TREES = 800, 4
_RUN = ("import sys; sys.path.insert(0, sys.argv.pop(1)); "
        "from lightgbm_tpu_torch import cli; "
        "sys.exit(cli.main(sys.argv[1:], device='cpu'))")


def _rank(argv, env, log):
    return subprocess.Popen([sys.executable, "-c", _RUN, ROOT, *argv],
                            env=env, stdout=log, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    rng = np.random.RandomState(0)
    X = rng.randn(N, 5)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.randn(N) > 0).astype(int)
    np.savetxt(d / "train.csv", np.column_stack([y, X]), fmt="%.9g",
               delimiter=",")
    (d / "mlist.txt").write_text(f"127.0.0.1 {free_port()}\n"
                                 f"127.0.0.1 {free_port()}\n")
    base = [f"data={d / 'train.csv'}", "objective=binary",
            f"num_trees={TREES}", "num_leaves=7", "tree_learner=data",
            "num_machines=2", "bagging_fraction=0.7", "bagging_freq=1",
            "time_out=20", "verbose=1"]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("LGBM_TPU_", "MASTER_", "RANK", "WORLD_SIZE",
                                "LOCAL_RANK"))}
    env.update(OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    port = str(free_port())
    procs, logs = [], []
    for r in range(2):
        # the machine-list world: rank 1 has another seed and straggles
        e = dict(env, LGBM_TPU_PROCESS_ID=str(r),
                 LGBM_TPU_RANK_OBS_DIR=str(d / "ml_obs"))
        if r == 1:
            e["LGBM_TPU_FAULT"] = "delay_collective:1:150"
        logs.append(open(d / f"ml{r}.log", "w"))
        procs.append(_rank(base + [f"machine_list_file={d / 'mlist.txt'}",
                                   f"bagging_seed={5 - 2 * r}",
                                   f"output_model={d / f'ml{r}.txt'}"],
                           e, logs[-1]))
        # the torchrun-env world, every rank given the smaller seed
        e = dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                 LGBM_TPU_RANK_OBS_DIR=str(d / "tr_obs"))
        logs.append(open(d / f"tr{r}.log", "w"))
        procs.append(_rank(base + ["bagging_seed=3",
                                   f"output_model={d / f'tr{r}.txt'}"],
                           e, logs[-1]))
    try:
        rcs = [p.wait(timeout=150) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    names = ["ml0", "tr0", "ml1", "tr1"]
    for n, rc in zip(names, rcs):
        assert rc == 0, open(d / f"{n}.log").read()[-3000:]
    return d


def test_worlds_write_one_model(worlds):
    d = worlds
    models = {n: (d / f"{n}.txt").read_text()
              for n in ("ml0", "ml1", "tr0", "tr1")}
    assert models["ml0"].count("Tree=") == TREES
    # one model on every rank of both worlds: the machine list's rank 1
    # trained on the smaller bagging_seed the sync gave it
    assert len(set(models.values())) == 1
    log = (d / "ml1.log").read_text()
    assert "backend=gloo on cpu" in log and "process_id=1" in log


def test_merged_manifest_names_the_straggler(worlds):
    import json

    man = json.load(open(worlds / "ml0.txt.manifest.json"))
    assert [r["process_index"] for r in man["ranks"]] == [0, 1]
    assert not (worlds / "ml1.txt.manifest.json").exists()
    ex = man["extra"]["distributed"]
    assert ex["world"] == 2
    c = ex["merged_counters"]
    assert c["desync_checks"] == 2 * TREES
    assert c["collective_site.desync_sentinel.all-gather"] == 2 * TREES
    assert c["collective_site.config_sync.all-gather"] == 2
    strag = {s["site"]: s for s in ex["stragglers"]}
    assert strag["desync_sentinel"]["straggler_rank"] == 1
    assert strag["config_sync"]["straggler_rank"] == 1
    assert strag["desync_sentinel"]["wait_skew_s"] > 0.1
