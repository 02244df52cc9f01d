"""The port's training gang (resilience/gang.py, ``task=train_fleet``)
against the JAX package's, on the same inputs made from a numpy seed.

* Barrier math, the reshard parity gate and the env contract equal the
  JAX package's: ``last_common_barrier``, ``rollback_to_barrier``,
  ``histogram_fingerprint``, ``shard_rows`` (the same shard bytes),
  ``_passthrough_params``, the ``LGBM_TPU_GANG_CHAOS_KILL`` /
  ``LGBM_TPU_GANG_FAULT`` parsing, ``beacon_from_env`` and
  ``describe_topology`` (from the env alone).
* Gang-stamped checkpoints (``CheckpointManager(gang=...)``) carry the
  JAX package's block, and each package reads the other's.
* ``ThreadRank`` gangs with the JAX package's stub job
  (tests/test_gang.py:300-516): a chaos kill recovers bitwise at the same
  world size, a repeat offender is shrunk past, a doomed gang exhausts
  its budget with a flight-recorder dump, and a preemption fans out to
  exit 75 on every rank.
* A ``ThreadRank`` gang whose job trains the port's booster on the CPU
  (checkpoints, beacon and resume as ``task=train`` does them) survives
  a chaos kill with rank 0's model equal to a plain CPU training's.
* The artifact and the CLI: ``write_train_fleet_artifact``'s shape, and
  ``task=train_fleet`` refusing the CPU.
"""

import hashlib
import json
import os
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.parallel import multihost as jmultihost
from lightgbm_tpu.resilience import checkpoint as jck
from lightgbm_tpu.resilience import gang as jgang

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.obs import flightrec, telemetry
from lightgbm_tpu_torch.parallel import multihost
from lightgbm_tpu_torch.resilience import EXIT_PREEMPTED
from lightgbm_tpu_torch.resilience import checkpoint as ck
from lightgbm_tpu_torch.resilience import gang
from lightgbm_tpu_torch.resilience.atomic import atomic_write_json
from lightgbm_tpu_torch.resilience.gang import (GangParityError,
                                                GangSupervisor, ThreadRank,
                                                ThreadRankContext)


@pytest.fixture(autouse=True)
def _no_dump_dir():
    yield
    flightrec.set_dump_dir("")


# ------------------------------------------------- against the JAX package
def _ckpt_dirs(tmp_path, rng, ranks=3):
    dirs = []
    for r in range(ranks):
        d = tmp_path / f"r{r}" / "ckpt"
        d.mkdir(parents=True)
        for it in sorted(set(rng.randint(1, 12, 4).tolist())):
            (d / f"ckpt_{it:08d}.json").write_text("{}")
        dirs.append(str(d))
    return dirs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_barrier_math_equals_jax(tmp_path, seed):
    rng = np.random.RandomState(seed)
    dirs = _ckpt_dirs(tmp_path, rng)
    common = gang.last_common_barrier(dirs)
    assert common == jgang.last_common_barrier(dirs)
    twins = [d.replace(str(tmp_path), str(tmp_path / "j")) for d in dirs]
    for d, t in zip(dirs, twins):
        os.makedirs(t)
        for f in os.listdir(d):
            open(os.path.join(t, f), "w").write("{}")
    assert gang.rollback_to_barrier(dirs, common) == \
        jgang.rollback_to_barrier(twins, common)
    assert [sorted(os.listdir(d)) for d in dirs] == \
        [sorted(os.listdir(t)) for t in twins]
    assert gang.last_common_barrier([str(tmp_path / "none")]) == 0


def _csv(path, rng, n=101):
    X = np.round(rng.randn(n, 4), 3)
    y = (X[:, 0] > 0).astype(int)
    with open(path, "w") as fh:
        for i in range(n):
            fh.write(",".join([str(y[i])] + [f"{v:g}" for v in X[i]]) + "\n")


@pytest.mark.parametrize("slots", [[0, 1], [0, 1, 2], [2, 0, 5]])
def test_shards_and_fingerprint_equal_jax(tmp_path, slots):
    rng = np.random.RandomState(len(slots))
    src = str(tmp_path / "d.csv")
    _csv(src, rng)
    got = gang.shard_rows(src, str(tmp_path / "port"), slots)
    want = jgang.shard_rows(src, str(tmp_path / "jax"), slots)
    assert sorted(got) == sorted(want) == sorted(slots)
    for s in slots:
        assert open(got[s], "rb").read() == open(want[s], "rb").read()
        assert os.path.basename(got[s]) == os.path.basename(want[s])
    fp = gang.histogram_fingerprint([got[s] for s in slots])
    assert fp == jgang.histogram_fingerprint([want[s] for s in reversed(
        slots)]) == gang.histogram_fingerprint([src])
    # a lost row fails the gate
    lines = open(got[slots[0]]).read().splitlines()[1:]
    open(got[slots[0]], "w").write("\n".join(lines) + "\n")
    assert gang.histogram_fingerprint([got[s] for s in slots]) != fp
    with pytest.raises(GangParityError):
        orig = gang.histogram_fingerprint
        try:
            gang.histogram_fingerprint = lambda ps: orig(ps[:1])
            gang.shard_rows(src, str(tmp_path / "bad"), slots)
        finally:
            gang.histogram_fingerprint = orig


@pytest.mark.parametrize("params", [
    {},
    {"objective": "binary", "num_leaves": "15", "learning_rate": "0.05",
     "metric": "auc,binary_logloss", "bagging_fraction": "0.7",
     "bagging_freq": "2", "train_ranks": "3", "gang_barrier_every": "2",
     "gang_shard_data": "true", "serve_replicas": "2",
     "machine_list_file": "ml.txt", "snapshot_freq": "4",
     "is_unbalance": "true", "categorical_feature": "1,3"},
])
def test_passthrough_params_equal_jax(params):
    got = gang._passthrough_params(Config.from_dict(dict(params)))
    want = jgang._passthrough_params(JaxConfig.from_dict(dict(params)))
    assert got == want


def test_env_contract_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("LGBM_TPU_GANG_CHAOS_KILL", "1:3, 2:5:always")
    monkeypatch.setenv("LGBM_TPU_GANG_FAULT", "2:hang_after_tree:4:600")
    assert gang._chaos_kill_from_env() == jgang._chaos_kill_from_env() == {
        1: (3, False), 2: (5, True)}
    assert gang._gang_fault_env() == jgang._gang_fault_env() == {
        2: "hang_after_tree:4:600"}
    assert gang.beacon_from_env() is None
    for k, v in (("LGBM_TPU_GANG_DIR", str(tmp_path)),
                 ("LGBM_TPU_GANG_SLOT", "2"), ("LGBM_TPU_GANG_ID", "g-7"),
                 ("LGBM_TPU_PROCESS_ID", "1"),
                 ("LGBM_TPU_NUM_PROCESSES", "3"),
                 ("LGBM_TPU_GANG_BARRIER_EVERY", "2")):
        monkeypatch.setenv(k, v)
    b, jb = gang.beacon_from_env(), jgang.beacon_from_env()
    assert b.gang_block() == jb.gang_block()
    b.ready()
    b.heartbeat(4)
    hb = json.load(open(gang.heartbeat_file(str(tmp_path), 2)))
    assert hb["iteration"] == 4 and hb["rank"] == 1
    assert gang.ready_file(str(tmp_path), 2) == \
        jgang.ready_file(str(tmp_path), 2)
    # the topology from the env alone (the JAX package's live backend
    # is hidden, as it is in a rank child before its first device call)
    from jax._src import xla_bridge

    monkeypatch.setattr(xla_bridge, "_backends", {})
    assert multihost.describe_topology() == jmultihost.describe_topology()
    assert multihost.describe_topology()["gang_slot"] == 2
    # a gang child has the env pair and no coordinator: no world
    assert multihost.resolve_world(Config()) is None


def _mini(pkg):
    rng = np.random.RandomState(0)
    X = rng.randn(300, 5).astype(np.float32)
    y = (X[:, 0] + 0.2 * rng.randn(300) > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 32,
              "min_data_in_leaf": 5, "snapshot_freq": 2, "verbose": -1}
    if pkg == "jax":
        return lgb.Booster(params, lgb.Dataset(X, label=y))._gbdt
    return lt.Booster(params, lt.Dataset(X, label=y, device="cpu"),
                      device="cpu")._gbdt


def test_gang_checkpoints_read_both_ways(tmp_path):
    block = {"schema": gang.GANG_SCHEMA, "gang_id": "g", "slot": 1,
             "rank": 1, "world_size": 2, "barrier_every": 2}
    assert gang.RankBeacon(str(tmp_path), 1, 1, 2, "g", 2).gang_block() == \
        jgang.RankBeacon(str(tmp_path), 1, 1, 2, "g", 2).gang_block() == block
    blocks = {}
    for pkg, mod in (("jax", jck), ("port", ck)):
        g = _mini(pkg)
        g.config.snapshot_dir = str(tmp_path / pkg)
        mgr = mod.CheckpointManager(g.config, g, {}, {}, gang=block)
        for it in range(3):
            g.train_one_iter()
            mgr.write(it + 1)
        blocks[pkg] = sorted(os.listdir(tmp_path / pkg))
    assert blocks["jax"] == blocks["port"] == ["ckpt_00000002.json",
                                               "ckpt_00000003.json"]
    for pkg, other in (("jax", ck), ("port", jck)):
        for it, barrier in ((2, True), (3, False)):
            payload = other.load_checkpoint(str(
                tmp_path / pkg / f"ckpt_{it:08d}.json"))
            assert payload["gang"] == dict(block, barrier_id=it,
                                           barrier=barrier), (pkg, it)


# ------------------------------------------------ ThreadRank supervisors
def _stub_job(trees, every, die_slot=None, die_at=None):
    """The JAX package's deterministic hash-chain job: state depends only
    on the iteration count, so any world size or resume point converges
    bitwise."""

    def job(ctx):
        ckpt = os.path.join(ctx.slot_dir, "ckpt")
        os.makedirs(ckpt, exist_ok=True)
        start, state = 0, "genesis"
        if ctx.resume:
            its = sorted(int(f[5:13]) for f in os.listdir(ckpt)
                         if f.startswith("ckpt_"))
            if its:
                with open(os.path.join(ckpt,
                                       f"ckpt_{its[-1]:08d}.json")) as fh:
                    rec = json.load(fh)
                start, state = int(rec["iteration"]), rec["state"]
        ctx.ready()
        for it in range(start, trees):
            ctx.check_signals()
            time.sleep(0.005)
            done = it + 1
            state = hashlib.sha256(f"{state}:{done}".encode()).hexdigest()
            if die_slot == ctx.slot and done == die_at:
                raise RuntimeError("injected death")
            if done % every == 0:
                atomic_write_json(os.path.join(ckpt, f"ckpt_{done:08d}.json"),
                                  {"iteration": done, "state": state})
            ctx.heartbeat(done)
        with open(os.path.join(ctx.slot_dir, "model.txt"), "w") as fh:
            fh.write(state + "\n")

    return job


def _mk_supervisor(gdir, slots, job, every=2, **kw):
    os.makedirs(gdir, exist_ok=True)

    def ckpt_dir_for(s):
        return os.path.join(gdir, f"r{s}", "ckpt")

    def factory(slot, rank, world, resume):
        sdir = os.path.join(gdir, f"r{slot}")
        os.makedirs(ckpt_dir_for(slot), exist_ok=True)
        ctx = ThreadRankContext(slot, rank, world, gdir, sdir, every, resume)
        return ThreadRank(slot, rank, job, ctx)

    defaults = dict(restart_budget=4, rank_fail_limit=2, min_ranks=1,
                    backoff_base_s=0.01, backoff_max_s=0.02,
                    heartbeat_timeout_s=10.0, ready_timeout_s=30.0,
                    poll_interval_s=0.003)
    defaults.update(kw)
    return GangSupervisor(factory, slots=list(slots), gang_dir=gdir,
                          ckpt_dir_for=ckpt_dir_for, barrier_every=every,
                          **defaults)


def _model(gdir, slot=0):
    with open(os.path.join(gdir, f"r{slot}", "model.txt")) as fh:
        return fh.read()


def test_gang_chaos_kill_recovers_bitwise(tmp_path):
    base = str(tmp_path / "base")
    sup = _mk_supervisor(base, [0, 1], _stub_job(8, 2))
    assert sup.run() == 0 and sup.recoveries == []
    want = _model(base)
    gdir = str(tmp_path / "chaos")
    flightrec.set_dump_dir(gdir)
    sup = _mk_supervisor(gdir, [0, 1], _stub_job(8, 2), chaos_kill_at={1: 3})
    assert sup.run() == 0
    assert (sup.rank_deaths, sup.restarts, sup.shrinks) == (1, 1, 0)
    rec = sup.recoveries[0]
    assert rec["action"] == "restart" and rec["mttr_s"] > 0
    assert _model(gdir) == want
    d = sup.describe()
    assert d["world_size"] == 2 and d["budget_spent"] == 1


def test_gang_shrinks_past_repeat_offender(tmp_path):
    base = str(tmp_path / "base")
    sup = _mk_supervisor(base, [0, 1, 2], _stub_job(8, 2))
    assert sup.run() == 0
    want = _model(base)
    gdir = str(tmp_path / "shrink")
    flightrec.set_dump_dir(gdir)
    sup = _mk_supervisor(gdir, [0, 1, 2],
                         _stub_job(8, 2, die_slot=2, die_at=4))
    assert sup.run() == 0
    assert sup.shrinks == 1 and sup.active_slot_ids() == [0, 1]
    assert [r["action"] for r in sup.recoveries] == ["restart", "shrink"]
    assert _model(gdir) == want
    assert sup.artifact_section()["world_size_end"] == 2


def test_gang_budget_exhausts_with_postmortem(tmp_path):
    gdir = str(tmp_path / "doomed")
    flightrec.set_dump_dir(gdir)
    flightrec.reset()
    sup = _mk_supervisor(gdir, [0, 1], _stub_job(8, 2, die_slot=1, die_at=1),
                         restart_budget=2, rank_fail_limit=99, min_ranks=2)
    assert sup.run() == 1 and sup.budget_exhausted is True
    dumps = [f for f in os.listdir(gdir)
             if f.startswith("flightrec_") and f.endswith(".json")]
    assert dumps, "budget exhaustion left no post-mortem"
    newest = max(dumps, key=lambda f: os.path.getmtime(os.path.join(gdir, f)))
    with open(os.path.join(gdir, newest)) as fh:
        assert json.load(fh)["reason"] == "gang_budget_exhausted"


def test_gang_preempt_fans_out_to_every_rank(tmp_path):
    gdir = str(tmp_path / "preempt")
    flightrec.set_dump_dir(gdir)

    def job(ctx):
        ctx.ready()
        for it in range(1000):
            ctx.check_signals()
            ctx.heartbeat(it + 1)
            time.sleep(0.005)

    sup = _mk_supervisor(gdir, [0, 1, 2], job)
    handles = []
    real = sup._factory

    def spying(*a):
        h = real(*a)
        handles.append(h)
        return h

    sup._factory = spying
    results: list = []
    t = threading.Thread(target=lambda: results.append(sup.run()))
    t.start()
    deadline = time.monotonic() + 30
    while len(handles) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    sup.request_preempt()
    t.join(30)
    assert results == [EXIT_PREEMPTED] and sup.preempted is True
    assert [h.poll() for h in handles] == [EXIT_PREEMPTED] * 3


# ----------------------------------------- a gang of the port's booster
TREES, EVERY = 6, 2


def _train_job(data, params, kill_log=None):
    """One rank's ``task=train`` on the CPU, as the CLI runs it for a gang
    child: the checkpoint manager stamps the gang block and heartbeats,
    a resumed rank restores the newest checkpoint, and the rank polls its
    simulated signals between iterations."""
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    from lightgbm_tpu_torch.models.dart import create_boosting
    from lightgbm_tpu_torch.objectives import create_objective

    def job(ctx):
        cfg = Config.from_dict(dict(
            params, output_model=os.path.join(ctx.slot_dir, "model.txt"),
            snapshot_dir=os.path.join(ctx.slot_dir, "ckpt"),
            snapshot_freq=str(EVERY)))
        train = BinnedDataset.from_file(data, cfg)
        booster = create_boosting(cfg, train, create_objective(
            cfg, train.metadata, train.num_data, "cpu"), device="cpu")
        start = 0
        if ctx.resume:
            found = ck.load_latest_for(cfg)
            if found is not None:
                start = ck.restore_training_state(booster, found[1])
        block = gang.RankBeacon(ctx.gang_dir, ctx.slot, ctx.rank, ctx.world,
                                "thread-gang", EVERY).gang_block()
        ctx.ready()
        with ck.CheckpointManager(cfg, booster, {}, {}, gang=block,
                                  heartbeat=ctx.heartbeat) as mgr:
            for it in range(start, TREES):
                ctx.check_signals()
                booster.train_one_iter()
                mgr.after_iteration(it)
        with open(cfg.output_model, "w") as fh:
            fh.write(booster.save_model_to_string(-1))

    return job


def test_booster_gang_survives_a_chaos_kill(tmp_path):
    rng = np.random.RandomState(3)
    X = rng.randn(400, 5)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(int)
    data = str(tmp_path / "d.csv")
    np.savetxt(data, np.column_stack([y, X]), fmt="%.9g", delimiter=",")
    params = {"objective": "binary", "num_leaves": "7", "verbose": "-1",
              "bagging_fraction": "0.7", "bagging_freq": "1",
              "num_trees": str(TREES)}
    plain = str(tmp_path / "plain.txt")
    assert cli.main([f"data={data}", f"output_model={plain}",
                     *[f"{k}={v}" for k, v in params.items()]],
                    device="cpu") == 0
    gdir = str(tmp_path / "gang")
    flightrec.set_dump_dir(gdir)
    telemetry.get_telemetry().reset()
    sup = _mk_supervisor(gdir, [0, 1], _train_job(data, params), every=EVERY,
                         chaos_kill_at={1: 3})
    assert sup.run() == 0
    # the kill lands once slot 1's heartbeat reaches 3; a thread rank
    # honours it at its next iteration, so the common barrier is 2 or 4
    barrier = sup.recoveries[0]["barrier"]
    assert sup.restarts == 1 and barrier in (2, 4)
    want = open(plain).read()
    assert _model(gdir, 0) == _model(gdir, 1) == want
    ckpt = ck.load_checkpoint(ck.latest_checkpoint(
        os.path.join(gdir, "r0", "ckpt")))
    assert ckpt["gang"]["barrier_id"] == TREES and ckpt["gang"]["barrier"]
    cfg = Config(num_iterations=TREES, gang_barrier_every=EVERY)
    path = gang.write_train_fleet_artifact(
        os.path.join(gdir, "train_fleet.json"), sup, cfg,
        barrier_every=EVERY, rc=0)
    art = json.load(open(path))
    assert art["schema"] == gang.ARTIFACT_SCHEMA
    tf = art["train_fleet"]
    assert tf["failed_iterations"] == 0 and tf["restarts"] == 1
    assert tf["final_barrier"] == TREES
    assert tf["barriers_committed"] == TREES // EVERY
    assert art["counters"]["lgbm_gang_restarts"] == 1
    assert art["counters"]["lgbm_gang_chaos_kills"] == 1


def test_train_fleet_cli_needs_barriers_and_the_card(tmp_path, capsys):
    args = ["task=train_fleet", "data=x.csv", f"output_model={tmp_path}/m"]
    assert cli.main(args, device="cpu") == 1
    assert "on the card" in capsys.readouterr().err
    with pytest.raises(ValueError, match="gang_barrier_every"):
        gang.train_fleet_from_config(Config.from_dict(
            {"task": "train_fleet", "data": "x.csv",
             "output_model": str(tmp_path / "m")}))
