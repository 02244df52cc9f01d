"""The port's CLI (``lightgbm_tpu_torch.cli``) against the JAX package's.

Seeded numpy data is written to ``tmp_path`` in the reference's formats
(``%.17g`` CSV or TSV, ``.init`` / ``.query`` side files) with a
``train.conf`` of the reference's keys.  ``cli.main(argv,
device="cpu")`` and ``lightgbm_tpu.cli.main(argv)`` train binary,
regression, multiclass and LambdaRank models; the two model files hold
the same trees as the engine tests hold ``train``'s
(test_torch_objectives.assert_same_trees: structure exact, values rtol
1e-5 / atol 1e-6).  The data carry a random init score (an ``.init``
file), for the reason tests/test_torch_engine_api.py gives.
``task=predict`` on a JAX-written model file writes the JAX CLI's result
file byte for byte (normal, raw, leaf index, ``num_iteration``), and the
streaming path writes the one-shot path's bytes.  Early stopping,
``input_model`` continuation, ``profile=true``'s trace,
``load_parameters`` precedence, ``task=serve`` over HTTP and the refused
tasks are checked too.
"""

import http.client
import json
import os

import numpy as np
import pytest

from lightgbm_tpu import cli as jcli

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch.config import Config

from test_torch_objectives import assert_same_trees

CONF = """# reference keys (examples/*/train.conf)
task = train
objective = {objective}
metric = {metric}
metric_freq = 1
is_training_metric = true
max_bin = 63
data = {data}
valid_data = {valid}
num_trees = {trees}
learning_rate = 0.1
num_leaves = 15
feature_fraction = {ff}
bagging_freq = {bf}
bagging_fraction = 0.8
min_data_in_leaf = 20
min_sum_hessian_in_leaf = 1e-3
output_model = {model}
hist_impl = matmul
forest_batching = off
verbose = -1
"""


def _write(path, label, X, sep=","):
    with open(path, "w") as fh:
        for yi, row in zip(label, X):
            fh.write(sep.join("%.17g" % v for v in (yi, *row)) + "\n")
    return str(path)


def _problem(tmp_path, objective, n=1500, seed=0, sep=","):
    """(train path, valid path, conf keys) with .init side files."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    z = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] - 0.4 * X[:, 3] ** 2
    extra = {}
    K = 1
    if objective == "binary":
        y = (z + 0.5 * rng.randn(n) > 0).astype(float)
        metric = "binary_logloss,auc"
    elif objective == "regression":
        y = z + 0.3 * rng.randn(n)
        metric = "l2,l1"
    elif objective == "multiclass":
        y = np.digitize(z, [-0.5, 0.5]).astype(float)
        metric, K = "multi_logloss,multi_error", 3
        extra["num_class"] = 3
    else:  # lambdarank: queries of 30 rows
        y = np.clip((z * 1.5 + 2).astype(int), 0, 4).astype(float)
        metric = "ndcg"
        extra["ndcg_eval_at"] = "1,3,5"
    cut = n * 2 // 3
    paths = []
    for name, rows in (("train", slice(0, cut)), ("valid", slice(cut, n))):
        p = _write(tmp_path / f"{name}.txt", y[rows], X[rows], sep=sep)
        m = rows.stop - rows.start
        np.savetxt(p + ".init", (0.3 * rng.randn(m * K)).astype(np.float32),
                   fmt="%.9g")
        if objective == "lambdarank":
            np.savetxt(p + ".query", np.full(m // 30, 30), fmt="%d")
        paths.append(p)
    return paths[0], paths[1], dict(objective=objective, metric=metric,
                                    **extra)


def _conf(tmp_path, train, valid, keys, trees=6, model="m.txt", ff=0.8,
          bf=2):
    text = CONF.format(data=train, valid=valid, trees=trees, ff=ff, bf=bf,
                       model=str(tmp_path / model), **{
                           k: keys[k] for k in ("objective", "metric")})
    text += "".join(f"{k} = {v}\n" for k, v in keys.items()
                    if k not in ("objective", "metric"))
    path = tmp_path / "train.conf"
    path.write_text(text)
    return str(path)


def _models(path):
    return lt.Booster(model_file=path, device="cpu")._gbdt.models


def _train_both(tmp_path, conf, *argv):
    port = str(tmp_path / "port.txt")
    ref = str(tmp_path / "jax.txt")
    assert tcli.main([f"config={conf}", f"output_model={port}", *argv],
                     device="cpu") == 0
    assert jcli.main([f"config={conf}", f"output_model={ref}", *argv]) == 0
    return port, ref


@pytest.mark.parametrize("objective", ["binary", "regression", "multiclass",
                                       "lambdarank"])
def test_train_matches_jax_cli(tmp_path, objective):
    train, valid, keys = _problem(tmp_path, objective,
                                  sep="\t" if objective == "regression"
                                  else ",")
    conf = _conf(tmp_path, train, valid, keys)
    port, ref = _train_both(tmp_path, conf)
    assert_same_trees(_models(ref), _models(port))
    head = [ln for ln in open(port).read().split("Tree=0")[0].splitlines()]
    assert head == open(ref).read().split("Tree=0")[0].splitlines()
    assert os.path.exists(port + ".sha256")
    manifest = json.load(open(port + ".manifest.json"))
    assert manifest["entry"] == "cli.train"
    assert manifest["result"]["num_trees"] == len(_models(port))


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """A JAX-written binary model and its data (train + valid files)."""
    tmp = tmp_path_factory.mktemp("cli_predict")
    train, valid, keys = _problem(tmp, "binary", seed=4)
    conf = _conf(tmp, train, valid, keys, trees=8)
    model = str(tmp / "jax.txt")
    assert jcli.main([f"config={conf}", f"output_model={model}"]) == 0
    return dict(tmp=tmp, model=model, valid=valid)


@pytest.mark.parametrize("extra", [[], ["is_predict_raw_score=true"],
                                   ["is_predict_leaf_index=true"],
                                   ["num_iteration_predict=3"]],
                         ids=["normal", "raw", "leaf", "num_iteration"])
def test_predict_matches_jax_cli(jax_model, extra):
    tmp = jax_model["tmp"]
    name = "-".join(extra) or "normal"
    out = {}
    for pkg, cli, kw in (("port", tcli, {"device": "cpu"}),
                         ("jax", jcli, {})):
        out[pkg] = str(tmp / f"{pkg}-{name}.txt")
        argv = ["task=predict", f"data={jax_model['valid']}",
                f"input_model={jax_model['model']}",
                f"output_result={out[pkg]}", *extra]
        assert cli.main(argv, **kw) == 0
    text = open(out["port"]).read()
    assert text == open(out["jax"]).read()
    assert text.count("\n") == 500


def test_streaming_predict_equals_one_shot(jax_model, monkeypatch):
    tmp = jax_model["tmp"]
    one = str(tmp / "one.txt")
    streamed = str(tmp / "streamed.txt")
    argv = ["task=predict", f"data={jax_model['valid']}",
            f"input_model={jax_model['model']}"]
    assert tcli.main(argv + [f"output_result={one}"], device="cpu") == 0
    monkeypatch.setattr(tcli.Predictor, "stream_threshold", 0)
    monkeypatch.setattr(tcli.Predictor, "chunk_rows", 64)
    for overlap in (True, False):
        monkeypatch.setattr(tcli.Predictor, "overlap", overlap)
        cfg = Config.from_dict(tcli.load_parameters(
            argv + [f"output_result={streamed}"]))
        stats = tcli.run_predict(cfg, device="cpu")
        assert stats["streamed"] and stats["chunks"] == 8
        assert open(streamed).read() == open(one).read()


def test_early_stopping_matches_jax_cli(tmp_path):
    train, valid, keys = _problem(tmp_path, "binary", n=1200, seed=2)
    conf = _conf(tmp_path, train, valid, keys, trees=60)
    port, ref = _train_both(tmp_path, conf, "early_stopping_round=3",
                            "learning_rate=0.4")
    n_port, n_ref = len(_models(port)), len(_models(ref))
    assert n_port == n_ref < 60
    assert_same_trees(_models(ref), _models(port))


def test_input_model_continues_training(tmp_path):
    train, valid, keys = _problem(tmp_path, "binary", seed=3)
    conf = _conf(tmp_path, train, valid, keys, ff=1.0, bf=0)
    first = str(tmp_path / "first.txt")
    whole = str(tmp_path / "whole.txt")
    more = str(tmp_path / "more.txt")
    assert tcli.main([f"config={conf}", "num_trees=3",
                      f"output_model={first}"], device="cpu") == 0
    assert tcli.main([f"config={conf}", f"input_model={first}",
                      "num_trees=3", f"output_model={more}"],
                     device="cpu") == 0
    assert tcli.main([f"config={conf}", f"output_model={whole}"],
                     device="cpu") == 0
    a, b = _models(more), _models(whole)
    assert len(a) == len(b) == 6
    assert open(more).read() == open(whole).read()


def test_profile_writes_a_trace(tmp_path):
    """``profile=true`` (C8): a torch.profiler trace of the training loop
    lands in ``profile_dir``, and the model is bitwise the one trained
    without it."""
    train, valid, keys = _problem(tmp_path, "binary", n=600, seed=6)
    conf = _conf(tmp_path, train, valid, keys, trees=3)
    plain, profiled = str(tmp_path / "plain.txt"), str(tmp_path / "prof.txt")
    trace_dir = tmp_path / "trace"
    assert tcli.main([f"config={conf}", f"output_model={plain}"],
                     device="cpu") == 0
    assert tcli.main([f"config={conf}", f"output_model={profiled}",
                      "profile=true", f"profile_dir={trace_dir}"],
                     device="cpu") == 0
    traces = os.listdir(trace_dir)
    assert len(traces) == 1 and traces[0].endswith(".trace.json")
    events = json.load(open(trace_dir / traces[0]))["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    assert open(profiled).read() == open(plain).read()


def test_load_parameters_matches_jax(tmp_path):
    conf = tmp_path / "p.conf"
    conf.write_text("num_trees = 7\nvalid_data = a.txt\nlearning_rate=0.2\n"
                    "# a comment\nmetric = auc\n")
    argv = [f"config={conf}", "num_iterations=9", "valid=b.txt", "--resume"]
    got = tcli.load_parameters(argv)
    assert got == jcli.load_parameters(argv)
    cfg = Config.from_dict(got)
    assert cfg.num_iterations == 9 and cfg.valid_data == ["b.txt"]
    assert cfg.learning_rate == 0.2 and cfg.resume


def test_serve_task_answers_http(jax_model):
    cfg = Config.from_dict(tcli.load_parameters(
        ["task=serve", f"input_model={jax_model['model']}", "serve_port=0",
         "serve_buckets=8,32"]))
    server = tcli.run_serve(cfg, device="cpu", block=False)
    try:
        rows = np.random.RandomState(5).randn(5, 6)
        want = lt.Booster(model_file=jax_model["model"],
                          device="cpu").predict(rows)
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=30)
        conn.request("POST", "/v1/predict", json.dumps({"rows": rows.tolist()}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200
        assert np.asarray(body["predictions"]).tobytes() == want.tobytes()
    finally:
        server.close()


# the ids the cases had while serve_fleet, train_fleet, resume and
# snapshot_freq were refused naming A9 (A8/A9 for train_fleet)
REFUSED_IDS = ["argv0-A7", "argv1-A9", "argv2-A8/A9", "argv3-A9",
               "argv4-A9", "argv5-A8", "argv6-A3"]


@pytest.mark.parametrize("argv,item", [
    (["task=train_many"], "A7"),
    (["task=serve_fleet"], "A11"),
    (["task=train_fleet"], "A8"),
    (["resume=true"], "A9"),
    (["snapshot_freq=5"], "A9"),
    (["num_machines=2"], "A8"),
    (["boosting_type=dart"], "A3"),
], ids=REFUSED_IDS)
def test_refused_tasks_name_their_item(tmp_path, argv, item, capsys):
    """What the CLI does not run raises naming its ROADMAP item.
    ``boosting_type=dart`` (A3) was refused here until DART was ported:
    it now trains and writes a ``dart`` model.  ``task=train_many`` (A7)
    likewise: it now writes ``num_models`` (2) models, ``m.txt.0`` and
    ``m.txt.1``.  Checkpoints (A9) likewise: ``resume=true`` with no
    checkpoint trains from scratch and ``snapshot_freq=5`` leaves the
    checkpoint of iteration 5 beside the model.  ``task=serve_fleet``
    (A11) reaches the fleet's entry, which needs a model and the card
    (its replicas are ``python -m lightgbm_tpu_torch`` processes).
    ``task=train_fleet`` (A8) reaches the gang's entry, which needs
    checkpoint barriers and the card (its ranks are ``python -m
    lightgbm_tpu_torch`` processes); ``num_machines=2`` (A8) forms no
    world without a machine list, so the load refuses to train one
    rank's partition alone."""
    train, valid, keys = _problem(tmp_path, "binary", n=300)
    conf = _conf(tmp_path, train, valid, keys)
    if item == "A3":
        assert tcli.main([f"config={conf}", *argv], device="cpu") == 0
        with open(tmp_path / "m.txt") as fh:
            assert fh.readline() == "dart\n"
        return
    if item == "A7":
        assert tcli.main([f"config={conf}", *argv], device="cpu") == 0
        for i in range(2):
            with open(tmp_path / f"m.txt.{i}") as fh:
                assert fh.readline() == "gbdt\n"
        assert not os.path.exists(tmp_path / "m.txt")
        return
    if item == "A9":
        assert tcli.main([f"config={conf}", *argv], device="cpu") == 0
        with open(tmp_path / "m.txt") as fh:
            assert fh.readline() == "gbdt\n"
        ckpts = sorted(os.listdir(tmp_path / "m.txt.ckpt")) \
            if argv[0].startswith("snapshot") else []
        assert ckpts == (["ckpt_00000005.json"]
                         if argv[0].startswith("snapshot") else [])
        # train_many reads no checkpoint knob, so it refuses them
        assert tcli.main([f"config={conf}", "task=train_many", *argv],
                         device="cpu") == 1
        assert "task=train_many does not checkpoint" in capsys.readouterr().err
        return
    if item == "A11":
        assert tcli.main([f"config={conf}", *argv], device="cpu") == 1
        assert "input_model should not be empty for serve_fleet" in \
            capsys.readouterr().err
        assert tcli.main([f"config={conf}", *argv,
                          f"input_model={tmp_path / 'x.txt'}"],
                         device="cpu") == 1
        assert "on the card" in capsys.readouterr().err
        assert not os.path.exists(tmp_path / "m.txt")
        return
    assert item == "A8"
    assert tcli.main([f"config={conf}", *argv], device="cpu") == 1
    err = capsys.readouterr().err
    if argv[0] == "task=train_fleet":
        assert "on the card" in err
        with pytest.raises(ValueError, match="gang_barrier_every"):
            from lightgbm_tpu_torch.resilience.gang import \
                train_fleet_from_config

            train_fleet_from_config(tcli.Config.from_dict(
                tcli.load_parameters([f"config={conf}", *argv])))
    else:
        assert "world of 2 ranks" in err
    assert not os.path.exists(tmp_path / "m.txt")


def test_errors_return_one(tmp_path, capsys):
    assert tcli.main(["task=predict", "data=x.csv"], device="cpu") == 1
    assert tcli.main(["task=nonsense"], device="cpu") == 1
    assert "Met Exceptions" in capsys.readouterr().err
