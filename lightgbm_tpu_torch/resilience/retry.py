"""Bounded retry for transient failures + a deadline that fails loudly
instead of hanging.

A stdlib copy of the JAX package's ``resilience/retry.py``, all of it.
Two production failure shapes this covers:

* **Transient errors** — a dropped connection, a coordinator mid-restart,
  a collective hitting a preempted peer.  These surface as exceptions
  whose messages carry the runtime's status vocabulary (``UNAVAILABLE``,
  ``DEADLINE_EXCEEDED``, ``connection reset`` …).  :func:`retry_transient`
  retries exactly those, with exponential backoff and a telemetry
  counter, and re-raises everything else immediately — an OOM or a
  shape error must never be retried into a loop.
* **Hangs** — a collective whose peer died before joining blocks
  forever by default.  :func:`call_with_deadline` runs the call on a
  worker thread and raises :class:`CollectiveDeadlineExceeded` when the
  clock runs out.  The worker thread cannot be killed, so the process
  should treat the exception as fatal-but-loud: log, checkpoint state if
  any, exit nonzero — the supervisor restarts it.

:func:`backoff_delay` is also the restart schedule of the serving
fleet's supervisor (serving/supervisor.py) and the training gang's
(resilience/gang.py), whose recovery ladder is
:class:`RecoveryEscalation`.  :func:`guarded_collective` carries the
traced collectives of obs/dist.py (the config sync and the desync
sentinel, under ``collective_deadline_s``); the parallel learners' own
collectives run under their process group's deadline (parallel/mesh.py).
The classifier works on message text, so the module imports neither
torch nor numpy.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence, TypeVar

from ..log import Log
from ..obs import telemetry
from . import faults

T = TypeVar("T")

# status vocabulary of transient, retry-safe failures (XLA/gRPC wording)
TRANSIENT_MARKERS: Sequence[str] = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "connection reset",
    "Connection reset",
    "Socket closed",
    "failed to connect",
    "Broken pipe",
)


def _counter_label(label: str) -> str:
    """Human label -> counter-name segment ("config sync allgather
    (pre-dispatch)" -> "config_sync_allgather_pre-dispatch")."""
    return "_".join(label.replace("(", "").replace(")", "").split())


def is_transient(exc: BaseException) -> bool:
    msg = f"{type(exc).__name__}: {exc}"
    return any(marker in msg for marker in TRANSIENT_MARKERS)


def backoff_delay(attempt: int, *, base_s: float, max_s: float,
                  rng=None) -> float:
    """THE exponential-backoff schedule, shared by every retry loop in
    the tree (transient-collective retry here, replica restarts in
    serving/supervisor.py).  ``attempt`` is the
    zero-based failure count: attempt 0 waits ``base_s``.

    With ``rng`` (a ``random.Random``) the delay is jittered into
    ``[0.5x, 1.5x)`` — fleet restarts must not stampede the coordinator
    in lockstep.  Without it the schedule is deterministic, which the
    single-process retry paths prefer (reproducible test timings)."""
    delay = min(max_s, base_s * (2 ** max(0, attempt)))
    if rng is not None:
        delay *= 0.5 + rng.random()  # jitter in [0.5x, 1.5x)
    return delay


def retry_transient(fn: Callable[[], T], *, retries: int = 3,
                    base_delay_s: float = 0.5, max_delay_s: float = 8.0,
                    label: str = "") -> T:
    """Call ``fn``; on a transient failure (see :func:`is_transient`)
    retry up to ``retries`` times with exponential backoff.  Counts
    ``transient_retries`` in telemetry, plus the label-scoped
    ``transient_retries.<label>`` so a retry is attributable to the
    specific collective/site it guarded.  Non-transient exceptions and
    the final transient failure propagate unchanged."""
    attempt = 0
    while True:
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — classified below
            if not is_transient(e) or attempt >= retries:
                raise
            attempt += 1
            delay = backoff_delay(attempt - 1, base_s=base_delay_s,
                                  max_s=max_delay_s)
            # attribute the retry to the specific collective/site: the
            # bare global counter says "something retried somewhere",
            # which on an 8-rank run is no attribution at all
            adds = {"transient_retries": 1}
            if label:
                adds[f"transient_retries.{_counter_label(label)}"] = 1
            telemetry.count_many(adds)
            Log.warning(
                f"transient failure{f' in {label}' if label else ''} "
                f"(attempt {attempt}/{retries}, retrying in {delay:.1f}s): "
                f"{type(e).__name__}: {str(e)[:200]}")
            time.sleep(delay)


class CollectiveDeadlineExceeded(RuntimeError):
    """A guarded collective/device call outlived its deadline.  The call
    is still blocked on its (abandoned, daemon) worker thread — treat
    this as fatal-but-loud: the process must exit rather than issue
    further collectives into a wedged world."""


def call_with_deadline(fn: Callable[[], T], deadline_s: float,
                       what: str = "collective") -> T:
    """Run ``fn`` with a wall-clock deadline.  ``deadline_s <= 0``
    disables the guard (direct call).  On timeout raises
    :class:`CollectiveDeadlineExceeded` with an actionable message."""
    if deadline_s <= 0:
        return fn()
    result: list = []
    error: list = []

    def runner() -> None:
        try:
            result.append(fn())
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            error.append(e)

    t = threading.Thread(target=runner, daemon=True,
                         name=f"deadline:{what}")
    t.start()
    t.join(deadline_s)
    if t.is_alive():
        telemetry.count("collective_deadline_hits")
        raise CollectiveDeadlineExceeded(
            f"{what} did not complete within {deadline_s:.0f}s — a peer "
            "process likely died or was preempted before joining. The "
            "call is abandoned on a daemon thread; exit this process and "
            "re-launch the world (resume from the latest checkpoint). "
            "Raise collective_deadline_s (or set it to 0) if the "
            "deadline is simply too tight for this topology.")
    if error:
        raise error[0]
    return result[0]


class CollectiveFailed(RuntimeError):
    """A dispatched collective failed.  Deliberately NOT retried on this
    rank alone: peers that already completed the op have moved on, and a
    unilaterally re-issued collective would match the WRONG op (silent
    cross-rank desync — worse than the failure).  Recovery is
    world-level: exit, re-launch all ranks, resume from checkpoint."""


def guarded_collective(fn: Callable[[], T], *, deadline_s: float,
                       label: str, retries: int = 2) -> T:
    """The composition the multihost paths use: fault-injection point,
    retry of PRE-DISPATCH failures only, and a deadline on the
    collective itself.

    The retry scope is deliberately narrow: only failures raised before
    the collective dispatches (the chaos injection point; connection
    setup in callers that stage it there) are transient-retried.  A
    failure from the dispatched collective is wrapped in
    :class:`CollectiveFailed` and raised loudly — one rank retrying a
    matched collective while its peers have moved on desynchronizes the
    world."""
    retry_transient(faults.maybe_fail_collective, retries=retries,
                    label=f"{label} (pre-dispatch)")
    try:
        return call_with_deadline(fn, deadline_s, what=label)
    except CollectiveDeadlineExceeded:
        raise
    except BaseException as e:  # noqa: BLE001 — classified below
        if is_transient(e):
            raise CollectiveFailed(
                f"{label} failed after dispatch ({type(e).__name__}: "
                f"{str(e)[:200]}). Not retrying on this rank alone — "
                "re-issuing a matched collective unilaterally would "
                "desynchronize the world. Exit, re-launch all ranks "
                "together, and resume from the latest checkpoint.") from e
        raise


def collective_deadline_s(cfg=None, default: float = 0.0) -> float:
    """Resolve the configured collective deadline: the
    ``LGBM_TPU_COLLECTIVE_DEADLINE_S`` env var wins (operator override
    on a wedged fleet), else ``cfg.collective_deadline_s``, else
    ``default`` (0 = disabled)."""
    import os

    env = os.environ.get("LGBM_TPU_COLLECTIVE_DEADLINE_S", "")
    if env:
        return float(env)
    if cfg is not None:
        return float(getattr(cfg, "collective_deadline_s", default) or 0.0)
    return default


# --------------------------------------------------- escalation ladder
class RecoveryExhausted(RuntimeError):
    """Every recovery stage has been spent: the restart budget is gone
    (or shrinking would go below the minimum world size).  The caller
    must fail LOUDLY — dump the flight recorder and exit nonzero; a
    supervisor that silently keeps respawning a doomed gang burns fleet
    capacity without ever telling an operator."""


class RecoveryEscalation:
    """The three-stage recovery ladder for multihost training.

    Stage 1 — **retry** — lives inside the rank: pre-dispatch transient
    failures are retried in place by :func:`guarded_collective` /
    :func:`retry_transient`.  A failure that escapes a rank (process
    death, a fired collective deadline, a heartbeat stall) reaches this
    object, which decides between the remaining stages:

    Stage 2 — **restart** — abort the iteration, roll every survivor
    back to the last coordinated checkpoint barrier, and reform the gang
    at the SAME world size (bitwise-identical resume).  Each restart
    consumes one unit of ``restart_budget`` and waits a jittered
    exponential backoff (:func:`backoff_delay`).

    Stage 3 — **shrink** — when the same rank has died
    ``rank_fail_limit`` times in a row, stop paying for it: drop the
    rank, reshard the data (gated on global-histogram parity), and
    reform the gang one rank smaller.  Shrinking also consumes budget.

    When the budget is exhausted, or shrinking would drop the world
    below ``min_world``, :meth:`next_action` raises
    :class:`RecoveryExhausted`.

    Decisions are deterministic given ``seed`` (the jitter uses a
    private ``random.Random``), so chaos tests replay exactly."""

    def __init__(self, *, restart_budget: int = 8, rank_fail_limit: int = 2,
                 min_world: int = 1, backoff_base_s: float = 0.2,
                 backoff_max_s: float = 5.0, seed: int = 0) -> None:
        import random

        self.restart_budget = int(restart_budget)
        self.rank_fail_limit = int(rank_fail_limit)
        self.min_world = max(1, int(min_world))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.spent = 0
        self._rng = random.Random(seed)

    def remaining(self) -> int:
        return max(0, self.restart_budget - self.spent)

    def next_action(self, *, world: int, rank_failures: int):
        """Classify the next recovery step after a rank failure.

        ``world`` is the current gang size; ``rank_failures`` is the
        consecutive-failure count of the slot that just died (including
        this failure).  Returns ``("restart", delay_s)`` or
        ``("shrink", delay_s)``; raises :class:`RecoveryExhausted` when
        the ladder has no rung left."""
        if self.spent >= self.restart_budget:
            raise RecoveryExhausted(
                f"restart budget exhausted ({self.spent}/"
                f"{self.restart_budget} recoveries spent) — refusing to "
                "respawn a gang that keeps dying. Inspect the flight "
                "recorder dump and the per-rank logs; raise "
                "gang_restart_budget only once the cause is understood.")
        want_shrink = rank_failures >= self.rank_fail_limit
        if want_shrink and world - 1 < self.min_world:
            raise RecoveryExhausted(
                f"rank died {rank_failures}x (limit {self.rank_fail_limit}) "
                f"but shrinking below gang_min_ranks={self.min_world} is "
                "not allowed — the world cannot hold the workload. "
                "Replace the bad host or lower gang_min_ranks.")
        self.spent += 1
        delay = backoff_delay(self.spent - 1, base_s=self.backoff_base_s,
                              max_s=self.backoff_max_s, rng=self._rng)
        return ("shrink" if want_shrink else "restart"), delay
