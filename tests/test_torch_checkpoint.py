"""The port's checkpoints and resume (``resilience/checkpoint.py``, ROADMAP
A9) against the uninterrupted run and against the JAX package's.

* *Round trip, bitwise, on every route*: a booster checkpointed at
  iteration 3 through a file, restored into a fresh booster and trained
  to 6 writes the uninterrupted run's model string, on the mega, record
  and order leaf-wise routes (the record-window routes' plain versions,
  selected as the card selects them), pooled, depthwise, hybrid,
  ``hist_dtype=float64``, DART with bagging and ``feature_fraction``,
  multiclass through the forest lanes and through the class loop,
  ``nonfinite_policy=clip`` under ``nan_grads`` and an ``input_model``
  continuation of another ``num_leaves``.
* *Held against the JAX package*: on the JAX test's mini booster
  (tests/test_resilience.py ``_mini_booster``: bagging 0.8 every 2
  iterations, ``feature_fraction`` 0.8) both packages checkpoint at
  iteration 3 and the files agree in schema, key sets, tree fields'
  dtypes and shapes, the RNG states and packed bag mask bitwise, the
  counters, and the scores within rtol 1e-5; each package's file passes
  the other's checksum.
* *Loud refusals*: corruption, a config mismatch (the resume flag
  alone exempt), a schema mismatch; pruning keeps the newest two.
* *The CLI in process* (``cli.main(..., device="cpu")``, as the JAX
  package's tests/test_resilience.py:195-257 drive its CLI): kill → 75 →
  ``--resume`` bitwise, resume with no checkpoint, a corrupt checkpoint
  refused, early stopping across a kill, the hang fault, the snapshot
  cadence, and ``snapshot_freq=0`` costing no launch and no host sync.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import time

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.resilience import checkpoint as jck
from lightgbm_tpu.resilience import faults as jax_faults

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch import ops
from lightgbm_tpu_torch.learners import serial
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.obs import telemetry
from lightgbm_tpu_torch.ops.cuda_histogram import histogram_record_window
from lightgbm_tpu_torch.resilience import EXIT_PREEMPTED, faults
from lightgbm_tpu_torch.resilience import checkpoint as ck
from lightgbm_tpu_torch.resilience.atomic import verify_sidecar


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    faults.clear_faults()
    yield
    faults.clear_faults()
    jax_faults.clear_faults()


# ------------------------------------------------------- round trip, routes
def _data(seed=0, n=600, f=6, classes=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    z = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(n)
    y = (np.digitize(z, [-0.5, 0.5]) if classes else z > 0)
    return X, y.astype(np.float32)


BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 32,
        "min_data_in_leaf": 5, "learning_rate": 0.2,
        "bagging_fraction": 0.8, "bagging_freq": 2,
        "feature_fraction": 0.8, "verbose": -1}
MULTI = {"objective": "multiclass", "num_class": 3, "num_leaves": 7}

# (route, parameters over BASE, the record-window route's fuse switch
# (None: not selected), fault)
ROUTES = [
    ("mega", {}, "1", ""),
    ("record", {}, "0", ""),
    ("order", {}, None, ""),
    ("pooled", {"histogram_pool_size": 0.01}, None, ""),
    ("depthwise", {"tree_growth": "depthwise"}, None, ""),
    ("hybrid", {"tree_growth": "hybrid"}, None, ""),
    ("float64", {"hist_dtype": "float64"}, None, ""),
    ("dart", {"boosting_type": "dart", "drop_rate": 0.5, "skip_drop": 0.0,
              "bagging_freq": 1}, None, ""),
    ("multiclass-lanes", dict(MULTI, forest_batching="on"), None, ""),
    ("multiclass-loop", dict(MULTI, forest_batching="off"), None, ""),
    ("clip-nan-grads", {"nonfinite_policy": "clip"}, None, "nan_grads:4"),
    ("input-model", {}, None, ""),
]


@pytest.fixture
def route(request, monkeypatch, tmp_path):
    """(parameters, fault) with the route selected: the record-window
    routes through their plain histogram, as the card selects them
    (``LGBM_TPU_FUSE_HIST`` picks mega or record)."""
    name, extra, fuse, fault = request.param
    if fuse is not None:
        monkeypatch.setattr(GBDT, "_leafwise_hist_fn_raw",
                            lambda self: histogram_record_window)
        monkeypatch.setenv("LGBM_TPU_FUSE_HIST", fuse)
    if name == "order":
        monkeypatch.setenv("LGBM_TPU_OPT_HISTS", "0")
    params = dict(BASE, **extra)
    if name == "input-model":
        X, y = _data()
        init = lt.train(dict(BASE, num_leaves=5), lt.Dataset(
            X[:400], label=y[:400], device="cpu"), 3, device="cpu")
        path = str(tmp_path / "init.txt")
        init.save_model(path)
        params["input_model"] = path
    return name, params, fault


def _booster(params):
    X, y = _data(classes="num_class" in params)
    ds = lt.Dataset(X[:400], label=y[:400], params=params, device="cpu")
    bst = lt.Booster(params=params, train_set=ds, device="cpu")
    bst.add_valid(ds.create_valid(X[400:], label=y[400:]), "valid")
    return bst


def _train(bst, rounds, fault=""):
    faults.set_fault(fault)
    for _ in range(rounds):
        bst.update()
    faults.clear_faults()


@pytest.mark.parametrize("route", ROUTES, indirect=True,
                         ids=[r[0] for r in ROUTES])
def test_round_trip_is_bitwise_on_every_route(route, tmp_path):
    name, params, fault = route
    full = _booster(params)
    _train(full, 6, fault)
    half = _booster(params)
    _train(half, 3, fault)
    path = ck.checkpoint_file(str(tmp_path), 3)
    ck.save_checkpoint(path, half._gbdt, half._gbdt.config, iteration=3)
    res = _booster(params)
    payload = ck.load_checkpoint(path)
    ck.validate_against_config(payload, res._gbdt.config, path)
    assert ck.restore_training_state(res._gbdt, payload) == 3
    assert res.current_iteration == half.current_iteration
    if name == "input-model":  # 5-leaf init trees, then 15-leaf trees
        assert [g["count"] for g in payload["models"]] == [3, 3]
    _train(res, 3, fault)
    assert res.model_to_string() == full.model_to_string()
    assert res.eval_valid() == full.eval_valid()
    assert np.array_equal(res._gbdt.predict_at(1), full._gbdt.predict_at(1))


# ----------------------------------------------------- against the JAX package
def _mini(pkg):
    """tests/test_resilience.py ``_mini_booster``'s data and config in
    either package (the GBDT)."""
    rng = np.random.RandomState(0)
    X = rng.randn(300, 5).astype(np.float32)
    y = (X[:, 0] + 0.2 * rng.randn(300) > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 32,
              "min_data_in_leaf": 5, "bagging_fraction": 0.8,
              "bagging_freq": 2, "feature_fraction": 0.8,
              "hist_impl": "matmul", "verbose": -1}
    if pkg == "jax":
        return lgb.Booster(params, lgb.Dataset(X, label=y))._gbdt
    return lt.Booster(params, lt.Dataset(X, label=y, device="cpu"),
                      device="cpu")._gbdt


@pytest.fixture(scope="module")
def both_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_parity")
    out = {}
    for pkg, mod in (("jax", jck), ("port", ck)):
        g = _mini(pkg)
        for _ in range(3):
            g.train_one_iter()
        path = str(tmp / f"{pkg}_ckpt_00000003.json")
        mod.save_checkpoint(path, g, g.config, iteration=3)
        out[pkg] = path
    return out


def test_checkpoint_file_matches_the_jax_package(both_files):
    docs = {k: json.load(open(p)) for k, p in both_files.items()}
    jd, pd = docs["jax"], docs["port"]
    assert jd["schema"] == pd["schema"] == ck.SCHEMA
    jp, pp = jd["payload"], pd["payload"]
    assert set(jp) == set(pp)
    for block in ("booster", "lineage", "bagging", "rng", "early_stop"):
        assert set(jp[block]) == set(pp[block]), block
    for key in ("iteration",):
        assert jp[key] == pp[key] == 3
    for key in ("iter_", "num_init_iteration", "num_class", "name",
                "objective", "pending_stop"):
        assert jp["booster"][key] == pp["booster"][key], key
    assert len(jp["models"]) == len(pp["models"]) == 1
    jf, pf = jp["models"][0]["fields"], pp["models"][0]["fields"]
    assert list(jf) == list(pf)
    for name in jf:
        assert (jf[name]["dtype"], jf[name]["shape"]) == \
            (pf[name]["dtype"], pf[name]["shape"]), name
    # both draw from the same RandomStates, draw for draw
    for which in ("bag", "feat"):
        assert jp["rng"][which] == pp["rng"][which], which
    assert jp["bagging"] == pp["bagging"]
    assert jp["bagging"]["cnt"] == int(300 * 0.8)
    js, ps = jck._dec(jp["scores"]), ck._dec(pp["scores"])
    assert js.dtype == ps.dtype and js.shape == ps.shape
    np.testing.assert_allclose(ps, js, rtol=1e-5, atol=1e-6)


def test_each_package_reads_the_others_file(both_files):
    assert ck.load_checkpoint(both_files["jax"])["iteration"] == 3
    assert jck.load_checkpoint(both_files["port"])["iteration"] == 3


# ------------------------------------------------------------ loud refusals
def _one_iter_checkpoint(tmp_path, it=1):
    g = _mini("port")
    g.train_one_iter()
    path = ck.checkpoint_file(str(tmp_path), it)
    ck.save_checkpoint(path, g, g.config, iteration=it)
    return g, path


def test_corruption_is_loud(tmp_path):
    _, path = _one_iter_checkpoint(tmp_path)
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.seek(size // 2)
        fh.write(b"A" * 16)
    with pytest.raises(ck.CheckpointError,
                       match="checksum|corrupted|unreadable"):
        ck.load_checkpoint(path)


def test_config_mismatch_is_loud_but_not_the_resume_flag(tmp_path):
    g, path = _one_iter_checkpoint(tmp_path)
    payload = ck.load_checkpoint(path)
    other = dataclasses.replace(g.config, num_leaves=31)
    with pytest.raises(ck.CheckpointError, match="fingerprint"):
        ck.validate_against_config(payload, other, path)
    ck.validate_against_config(
        payload, dataclasses.replace(g.config, resume=True), path)


def test_schema_mismatch_is_loud(tmp_path):
    _, path = _one_iter_checkpoint(tmp_path)
    doc = json.load(open(path))
    doc["schema"] = "lightgbm-tpu/checkpoint/v0"
    with open(path, "w") as fh:
        json.dump(doc, fh)
    with pytest.raises(ck.CheckpointError, match="schema"):
        ck.load_checkpoint(path)


def test_prune_keeps_the_newest_two(tmp_path):
    g, _ = _one_iter_checkpoint(tmp_path)
    d = str(tmp_path)
    for it in (2, 3, 4):
        ck.save_checkpoint(ck.checkpoint_file(d, it), g, g.config,
                           iteration=it)
    ck.prune_checkpoints(d)
    names = [os.path.basename(p) for p in ck.list_checkpoints(d)]
    assert names == ["ckpt_00000003.json", "ckpt_00000004.json"]
    assert ck.latest_checkpoint(d).endswith("ckpt_00000004.json")


# ------------------------------------------------------------- the CLI
def _write_csv(tmp_path, rows=300, seed=11, noise=0.0):
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, 5)
    y = (X[:, 0] + noise * rng.randn(rows) > 0).astype(np.float64)
    data = str(tmp_path / f"d{seed}.csv")
    np.savetxt(data, np.column_stack([y, X]), fmt="%.6g", delimiter=",")
    return data


def _cli(args, fault=""):
    """``cli.main(args, device="cpu")`` at verbose=1 under ``fault``:
    (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    faults.set_fault(fault)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = tcli.main(list(args) + ["verbose=1"], device="cpu")
    finally:
        faults.clear_faults()
    return rc, out.getvalue(), err.getvalue()


def _base(data, trees=7):
    return ["task=train", f"data={data}", "objective=binary",
            f"num_trees={trees}", "num_leaves=7", "min_data_in_leaf=5",
            "bagging_fraction=0.7", "bagging_freq=2",
            "feature_fraction=0.8", "is_save_binary_file=false"]


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_cli_kill_resume_bitwise(tmp_path):
    """SIGTERM through the real handler (the ``kill_after_tree`` fault)
    at iteration 3 of 7 -> 75 -> ``--resume`` -> the uninterrupted run's
    model file, byte for byte, with its sidecar."""
    base = _base(_write_csv(tmp_path))
    m_a, m_b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    assert _cli(base + [f"output_model={m_a}"])[0] == 0
    rc, _, err = _cli(base + [f"output_model={m_b}", "snapshot_freq=2"],
                      fault="kill_after_tree:3")
    assert rc == EXIT_PREEMPTED
    assert "resume" in err
    assert not os.path.exists(m_b)
    # the flight recorder dumped beside the model, the preemption last
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("flightrec_")
             and f.endswith(".json")]
    assert len(dumps) == 1
    events = json.load(open(tmp_path / dumps[0]))["events"]
    assert events[-1]["kind"] == "preempted"
    assert events[-1]["iteration"] == 3
    assert [os.path.basename(p) for p in ck.list_checkpoints(
        m_b + ".ckpt")] == ["ckpt_00000002.json", "ckpt_00000003.json"]
    rc, out, _ = _cli(base + [f"output_model={m_b}", "snapshot_freq=2",
                              "--resume"])
    assert rc == 0
    assert "continuing at iteration 4" in out
    assert _read(m_a) == _read(m_b)
    assert verify_sidecar(m_b) is not None


def test_cli_resume_without_checkpoint_starts_fresh(tmp_path):
    base = _base(_write_csv(tmp_path, seed=12), trees=3)
    m, ref = str(tmp_path / "m.txt"), str(tmp_path / "ref.txt")
    rc, out, err = _cli(base + [f"output_model={m}", "resume=true"])
    assert rc == 0 and "starting fresh" in out + err
    assert _cli(base + [f"output_model={ref}"])[0] == 0
    assert _read(m) == _read(ref)


def test_cli_resume_refuses_a_corrupt_checkpoint(tmp_path):
    base = _base(_write_csv(tmp_path, seed=13), trees=6) + [
        f"output_model={tmp_path / 'm.txt'}", "snapshot_freq=1"]
    rc, _, _ = _cli(base, fault="kill_after_tree:2,corrupt_checkpoint")
    assert rc == EXIT_PREEMPTED
    rc, _, err = _cli(base + ["--resume"])
    assert rc == 1
    assert "checksum" in err or "corrupted" in err
    assert not os.path.exists(tmp_path / "m.txt")


def test_cli_early_stopping_survives_a_kill(tmp_path):
    """Killed after the best iteration but before the stop, the resumed
    run stops where the uninterrupted one does, with the same truncated
    model: the checkpoint carries the early-stopping bests."""
    train = _write_csv(tmp_path, rows=300, seed=14, noise=1.5)
    valid = _write_csv(tmp_path, rows=200, seed=15, noise=1.5)
    base = ["task=train", f"data={train}", f"valid_data={valid}",
            "objective=binary", "metric=binary_logloss", "num_trees=60",
            "num_leaves=15", "min_data_in_leaf=2", "learning_rate=0.5",
            "early_stopping_round=3", "is_save_binary_file=false"]
    m_a, m_b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    rc, out, _ = _cli(base + [f"output_model={m_a}"])
    assert rc == 0
    stop = re.search(r"Early stopping at iteration (\d+), the best "
                     r"iteration round is (\d+)", out)
    assert stop, "the reference run must stop early"
    stop_at, best = int(stop.group(1)), int(stop.group(2))
    assert best < stop_at - 1
    rc, _, _ = _cli(base + [f"output_model={m_b}"],
                    fault=f"kill_after_tree:{stop_at - 1}")
    assert rc == EXIT_PREEMPTED
    rc, out, _ = _cli(base + [f"output_model={m_b}", "--resume"])
    assert rc == 0
    assert (f"Early stopping at iteration {stop_at}, the best iteration "
            f"round is {best}") in out
    assert _read(m_a) == _read(m_b)


def test_cli_hang_fault_stalls_and_carries_on(tmp_path):
    base = _base(_write_csv(tmp_path, seed=16), trees=5)
    m_a, m_b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    assert _cli(base + [f"output_model={m_a}"])[0] == 0
    t0 = time.perf_counter()
    rc, _, _ = _cli(base + [f"output_model={m_b}"],
                    fault="hang_after_tree:3:0.05")
    assert rc == 0 and time.perf_counter() - t0 >= 0.05
    assert _read(m_a) == _read(m_b)


def test_cli_snapshot_cadence(tmp_path):
    m = str(tmp_path / "m.txt")
    rc, out, _ = _cli(_base(_write_csv(tmp_path, seed=17), trees=6)
                      + [f"output_model={m}", "snapshot_freq=2"])
    assert rc == 0
    assert out.count("Checkpoint written") == 3
    assert [os.path.basename(p) for p in ck.list_checkpoints(
        m + ".ckpt")] == ["ckpt_00000004.json", "ckpt_00000006.json"]
    snap = str(tmp_path / "snaps")
    rc, _, _ = _cli(_base(_write_csv(tmp_path, seed=17), trees=3)
                    + [f"output_model={m}", "snapshot_freq=3",
                       f"snapshot_dir={snap}"])
    assert rc == 0
    assert os.listdir(snap) == ["ckpt_00000003.json"]


class _NoManager:
    """The train loop without a checkpoint manager (``ckmgr=None``)."""

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


def _counted_run(args):
    tel = telemetry.get_telemetry()
    ops.reset_launch_counts()
    syncs, learner = tel.counter("host_syncs"), serial.HOST_SYNCS
    assert _cli(args)[0] == 0
    return (ops.launch_counts(), tel.counter("host_syncs") - syncs,
            serial.HOST_SYNCS - learner)


def test_snapshot_freq_zero_costs_nothing(tmp_path, monkeypatch):
    """With ``snapshot_freq=0`` and no signal the manager does no device
    work: a run's launches and host syncs are those of the same run
    without it, and so is its model."""
    base = _base(_write_csv(tmp_path, seed=18), trees=4)
    m_a, m_b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    with_manager = _counted_run(base + [f"output_model={m_a}"])
    monkeypatch.setattr(ck, "CheckpointManager", _NoManager)
    without = _counted_run(base + [f"output_model={m_b}"])
    assert with_manager == without
    assert with_manager[2] > 0
    assert _read(m_a) == _read(m_b)
    assert not os.path.exists(m_a + ".ckpt")
