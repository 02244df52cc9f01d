"""The port's ``resilience/retry.py`` against the JAX package's.

The JAX package's retry and deadline tests (tests/test_resilience.py:
369-415) run on the port, and the two modules give equal values: the
transient classifier over a list of messages, the backoff schedule for
attempts 0-10 with and without a seeded ``random.Random``, and the
recovery ladder's decision sequences for a seed (restart / shrink, each
delay, and where the budget runs out).
"""

import random
import time

import pytest

from lightgbm_tpu.resilience import retry as jretry

from lightgbm_tpu_torch.obs import telemetry
from lightgbm_tpu_torch.resilience import faults, retry
from lightgbm_tpu_torch.resilience.retry import (
    CollectiveDeadlineExceeded, CollectiveFailed, RecoveryEscalation,
    RecoveryExhausted, call_with_deadline, guarded_collective,
    retry_transient)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    faults.clear_faults()
    yield
    faults.clear_faults()


def _counter(name):
    return telemetry.get_telemetry().counter(name)


# ------------------------------------------- the JAX package's retry tests
def test_retry_transient_recovers_from_injected_collective():
    before = _counter("transient_retries")
    labelled = _counter("transient_retries.t_pre-dispatch")
    faults.set_fault("fail_collective_once")
    out = guarded_collective(lambda: "ok", deadline_s=30.0, label="t")
    assert out == "ok"
    assert _counter("transient_retries") == before + 1
    assert _counter("transient_retries.t_pre-dispatch") == labelled + 1
    assert faults.fault_active("fail_collective_once") is None  # consumed


def test_retry_transient_does_not_retry_real_errors():
    calls = []

    def boom():
        calls.append(1)
        raise ValueError("shape mismatch: not transient")

    with pytest.raises(ValueError):
        retry_transient(boom, retries=3)
    assert len(calls) == 1


def test_retry_transient_gives_up_after_its_retries(monkeypatch):
    sleeps = []
    monkeypatch.setattr(retry.time, "sleep", sleeps.append)
    calls = []

    def flaky():
        calls.append(1)
        raise RuntimeError("UNAVAILABLE: still down")

    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        retry_transient(flaky, retries=3, base_delay_s=0.5, max_delay_s=8.0)
    assert len(calls) == 4
    assert sleeps == [0.5, 1.0, 2.0]


def test_collective_deadline_fails_loudly_instead_of_hanging():
    t0 = time.perf_counter()
    with pytest.raises(CollectiveDeadlineExceeded, match="checkpoint"):
        call_with_deadline(lambda: time.sleep(10), 0.3, what="test barrier")
    assert time.perf_counter() - t0 < 5.0


def test_collective_deadline_disabled_passes_through():
    assert call_with_deadline(lambda: 7, 0.0) == 7


def test_dispatched_collective_failure_is_not_retried_unilaterally():
    calls = []

    def flaky_collective():
        calls.append(1)
        raise RuntimeError("UNAVAILABLE: peer went away mid-op")

    with pytest.raises(CollectiveFailed, match="desynchronize"):
        guarded_collective(flaky_collective, deadline_s=10.0, label="t")
    assert len(calls) == 1


def test_collective_deadline_resolution(monkeypatch):
    from lightgbm_tpu_torch.config import Config

    monkeypatch.delenv("LGBM_TPU_COLLECTIVE_DEADLINE_S", raising=False)
    assert retry.collective_deadline_s() == 0.0
    assert retry.collective_deadline_s(
        Config(collective_deadline_s=12.5)) == 12.5
    monkeypatch.setenv("LGBM_TPU_COLLECTIVE_DEADLINE_S", "3")
    assert retry.collective_deadline_s(
        Config(collective_deadline_s=12.5)) == 3.0


# ------------------------------------------------ parity with the JAX module
MESSAGES = [
    RuntimeError("UNAVAILABLE: connection to coordinator lost"),
    RuntimeError("DEADLINE_EXCEEDED: barrier"),
    RuntimeError("ABORTED: peer restarted"),
    ConnectionResetError("connection reset by peer"),
    OSError("[Errno 104] Connection reset by peer"),
    OSError("Socket closed"),
    RuntimeError("failed to connect to all addresses"),
    BrokenPipeError("[Errno 32] Broken pipe"),
    ValueError("shape mismatch"),
    MemoryError("RESOURCE_EXHAUSTED: out of memory"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    KeyError("unavailable"),
    RuntimeError(""),
]


def test_markers_and_classifier_equal_the_jax_modules():
    assert tuple(retry.TRANSIENT_MARKERS) == tuple(jretry.TRANSIENT_MARKERS)
    got = [retry.is_transient(e) for e in MESSAGES]
    assert got == [jretry.is_transient(e) for e in MESSAGES]
    assert got[:8] == [True] * 8 and not any(got[8:])


@pytest.mark.parametrize("seed", [None, 0, 7, 12345])
@pytest.mark.parametrize("base,cap", [(0.2, 5.0), (0.5, 8.0), (1.0, 1.0)])
def test_backoff_schedule_equals_the_jax_modules(seed, base, cap):
    r1 = None if seed is None else random.Random(seed)
    r2 = None if seed is None else random.Random(seed)
    ours = [retry.backoff_delay(a, base_s=base, max_s=cap, rng=r1)
            for a in range(11)]
    theirs = [jretry.backoff_delay(a, base_s=base, max_s=cap, rng=r2)
              for a in range(11)]
    assert ours == theirs


def _ladder(mod, seed, failures, **kw):
    """The decisions of ``mod.RecoveryEscalation`` over a sequence of
    (world, consecutive rank failures), ending at the exhaustion."""
    esc = mod.RecoveryEscalation(seed=seed, **kw)
    out = []
    for world, fails in failures:
        try:
            out.append(esc.next_action(world=world, rank_failures=fails))
        except mod.RecoveryExhausted as e:
            out.append(("exhausted", str(e).split(" — ")[0]))
            break
    return out, esc.remaining()


@pytest.mark.parametrize("seed", [0, 3, 99])
@pytest.mark.parametrize("kw,failures", [
    ({}, [(4, 1)] * 10),
    ({"restart_budget": 5, "rank_fail_limit": 2},
     [(4, 1), (4, 2), (3, 1), (3, 2), (2, 2), (1, 1)]),
    ({"min_world": 3, "rank_fail_limit": 1}, [(4, 1), (3, 1)]),
])
def test_recovery_ladder_equals_the_jax_modules(seed, kw, failures):
    ours = _ladder(retry, seed, failures, **kw)
    assert ours == _ladder(jretry, seed, failures, **kw)
    decisions, _ = ours
    assert decisions[-1][0] in ("exhausted", "restart", "shrink")
    assert issubclass(RecoveryExhausted, RuntimeError)
    assert RecoveryEscalation(seed=seed).remaining() == 8
