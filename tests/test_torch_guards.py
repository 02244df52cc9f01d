"""The port's non-finite guards (``nonfinite_policy``, ROADMAP A9's first
step) against the JAX package's, under the ``nan_grads:J`` fault.

Mirrors the JAX package's tests/test_resilience.py:278-363 on both
packages side by side, on the same seeded numpy data and config:
``raise`` restores the exact pre-iteration state and training goes on
cleanly; ``skip_tree`` skips the poisoned iteration and escalates after
``MAX_CONSECUTIVE_SKIPS`` skips in a row; ``clip`` keeps the model
finite and its counts drain (through the CLI too); ``off`` has no guard.
Each outcome (tree counts, the error text, the telemetry counters' moves)
is the JAX package's; scores agree within rtol 1e-5, atol 1e-6 (the
float32 histogram order differs on the CPU).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.obs import telemetry as jax_telemetry
from lightgbm_tpu.resilience import faults as jax_faults
from lightgbm_tpu.resilience.guards import NonFiniteError as JaxNonFiniteError

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch.obs import telemetry
from lightgbm_tpu_torch.resilience import faults
from lightgbm_tpu_torch.resilience.guards import (MAX_CONSECUTIVE_SKIPS,
                                                  NonFiniteError,
                                                  NonFiniteGuard)

PKGS = ("jax", "port")


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    faults.clear_faults()
    jax_faults.clear_faults()


def _counter(pkg, name):
    tel = jax_telemetry if pkg == "jax" else telemetry
    return tel.get_telemetry().counter(name)


def _set_fault(spec):
    faults.set_fault(spec)
    jax_faults.set_fault(spec)


def _mini(pkg, policy="off", boosting="gbdt", seed=0):
    """The JAX test's mini booster (300 x 5, 7 leaves, bagging and
    feature fraction) in either package."""
    rng = np.random.RandomState(seed)
    X = rng.randn(300, 5).astype(np.float32)
    y = (X[:, 0] + 0.2 * rng.randn(300) > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 32,
              "min_data_in_leaf": 5, "bagging_fraction": 0.8,
              "bagging_freq": 2, "feature_fraction": 0.8,
              "nonfinite_policy": policy, "boosting_type": boosting,
              "hist_impl": "matmul", "verbose": -1}
    if pkg == "jax":
        return lgb.Booster(params, lgb.Dataset(X, label=y))._gbdt
    return lt.Booster(params, lt.Dataset(X, label=y, device="cpu"),
                      device="cpu")._gbdt


def _scores(g):
    return g._scores.numpy() if isinstance(g._scores, torch.Tensor) \
        else np.asarray(g._scores)


def test_nan_grads_policy_raise_restores_clean_state():
    """policy=raise restores the exact pre-iteration snapshot (a
    subtracting rollback would keep NaN - NaN = NaN in the scores), and
    training continues to a finite model, in both packages alike."""
    messages, after = {}, {}
    for pkg, err in (("jax", JaxNonFiniteError), ("port", NonFiniteError)):
        g = _mini(pkg, policy="raise")
        g.train_one_iter()
        before = _scores(g).copy()
        _set_fault("nan_grads:1")
        with pytest.raises(err, match="non-finite") as ex:
            g.train_one_iter()
        messages[pkg] = str(ex.value)
        assert g.num_trees == 1 and g.iter_ == 1
        np.testing.assert_array_equal(_scores(g), before)
        _set_fault("")
        g.train_one_iter()
        assert g.num_trees == 2
        after[pkg] = _scores(g)
        assert np.isfinite(after[pkg]).all()
    assert messages["port"] == messages["jax"]
    np.testing.assert_allclose(after["port"], after["jax"], rtol=1e-5,
                               atol=1e-6)


def test_skip_tree_escalates_on_persistent_nonfinite():
    """A skip changes nothing, so a deterministic NaN source would burn
    every remaining iteration: the guard raises after
    MAX_CONSECUTIVE_SKIPS skips, and a clean iteration resets the run."""
    g = NonFiniteGuard("skip_tree")
    bad = torch.full((1, 8), float("nan"))
    ok = torch.ones((1, 8))
    with pytest.raises(NonFiniteError, match="consecutive"):
        for _ in range(MAX_CONSECUTIVE_SKIPS + 1):
            g.check_gradients(bad, ok)
    g2 = NonFiniteGuard("skip_tree")
    for _ in range(MAX_CONSECUTIVE_SKIPS - 1):
        g2.check_gradients(bad, ok)
    g2.check_gradients(ok, ok)
    _, _, skip = g2.check_gradients(bad, ok)
    assert skip  # still skipping, not raising


@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
def test_nan_grads_policy_skip_tree(boosting):
    moved, models = {}, {}
    for pkg in PKGS:
        g = _mini(pkg, policy="skip_tree", boosting=boosting)
        before = _counter(pkg, "nonfinite_skipped_trees")
        _set_fault("nan_grads:1")
        for _ in range(3):
            g.train_one_iter()  # the second is poisoned: skipped
        assert g.num_trees == 2 and g.iter_ == 2
        moved[pkg] = _counter(pkg, "nonfinite_skipped_trees") - before
        models[pkg] = g.save_model_to_string()
    assert moved == {"jax": 1, "port": 1}
    assert models["port"].splitlines()[0] == boosting


@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
def test_nan_grads_policy_clip_keeps_model_finite(boosting):
    moved = {}
    for pkg in PKGS:
        g = _mini(pkg, policy="clip", boosting=boosting)
        before = _counter(pkg, "nonfinite_values_clipped")
        _set_fault("nan_grads:1")
        for _ in range(3):
            g.train_one_iter()
        g.finalize_guards()
        assert g.num_trees == 3
        moved[pkg] = _counter(pkg, "nonfinite_values_clipped") - before
        s = g.save_model_to_string()
        vals = [float(t) for line in s.splitlines()
                if line.startswith(("leaf_value=", "internal_value="))
                for t in line.split("=", 1)[1].split()]
        assert vals and all(np.isfinite(vals))
    assert moved["port"] == moved["jax"] > 0


def test_cli_clip_policy_counts_are_drained(tmp_path):
    """A short clip-policy CLI run still reports its clipped values: the
    parked device counts drain before the model is saved."""
    rng = np.random.RandomState(22)
    X = rng.randn(300, 5)
    y = (X[:, 0] > 0).astype(float)
    data = tmp_path / "train.csv"
    np.savetxt(data, np.column_stack([y, X]), delimiter=",", fmt="%.9g")
    before = _counter("port", "nonfinite_values_clipped")
    faults.set_fault("nan_grads:1")
    rc = tcli.main(["task=train", f"data={data}", "objective=binary",
                    "num_trees=3", "num_leaves=7", "min_data_in_leaf=5",
                    "nonfinite_policy=clip",
                    f"output_model={tmp_path / 'm.txt'}"], device="cpu")
    assert rc == 0
    assert _counter("port", "nonfinite_values_clipped") > before


def test_cli_raise_policy_fails_the_run(tmp_path):
    rng = np.random.RandomState(23)
    X = rng.randn(300, 5)
    y = (X[:, 0] > 0).astype(float)
    data = tmp_path / "train.csv"
    np.savetxt(data, np.column_stack([y, X]), delimiter=",", fmt="%.9g")
    faults.set_fault("nan_grads:1")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = tcli.main(["task=train", f"data={data}", "objective=binary",
                        "num_trees=3", "num_leaves=7", "min_data_in_leaf=5",
                        "nonfinite_policy=raise",
                        f"output_model={tmp_path / 'm.txt'}"], device="cpu")
    assert rc == 1 and "nonfinite_policy=raise" in err.getvalue()
    assert not (tmp_path / "m.txt").exists()


def test_nonfinite_policy_off_has_no_guard():
    assert _mini("port", policy="off")._nf_guard is None
    assert _mini("jax", policy="off")._nf_guard is None


def test_nan_grads_fault_is_ported_and_the_rest_still_refused():
    faults.set_fault("nan_grads:2")
    assert faults.fault_active("nan_grads") == "2"
    g = torch.zeros(2, 4)
    h = torch.ones(2, 4)
    assert faults.poison_grads(g, h, 1) == (g, h)  # not iteration 2
    pg, ph = faults.poison_grads(g, h, 2)
    assert torch.isnan(pg[:, 0]).all() and torch.isinf(ph[:, 0]).all()
    assert torch.equal(g, torch.zeros(2, 4))  # copies, not in place
    assert faults.poison_grads(g, h, 2) == (g, h)  # fires once
    # the checkpoint faults are ported with the checkpoints (A9), the
    # collective straggler and desync faults with obs/dist (A8 step 3):
    # every kind of the JAX package parses now
    faults.set_fault("corrupt_checkpoint")
    assert faults.fault_active("corrupt_checkpoint") == ""
    faults.set_fault("delay_collective:0:5,desync_step:0")
    assert faults.fault_active("delay_collective") == "0:5"
    assert faults.fault_active("desync_step") == "0"
