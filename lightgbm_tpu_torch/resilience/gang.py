"""Elastic multi-process training: the gang supervisor and its
coordinated checkpoint barriers (``task=train_fleet``).

The port of lightgbm_tpu/resilience/gang.py, the training-side twin of
serving/supervisor.py's ReplicaSupervisor; its schema strings, counter
names (``lgbm_gang_*``), env contract and artifact are the JAX
package's.
A multihost data-parallel run is a GANG: every rank must advance
together, so one dead or hung rank costs the whole iteration — the
reference binary simply dies there (network.h:87-159 has no recovery
path).  This module makes rank loss a bounded, attributable event:

* :class:`GangSupervisor` — launches N rank processes with a readiness
  handshake (atomic ``rank_<slot>.ready.json`` files), watches per-rank
  HEARTBEAT files (one atomic write per boosting iteration), and on a
  rank death / stale heartbeat / fired collective deadline aborts the
  iteration, rolls EVERY survivor back to the last coordinated
  checkpoint barrier, and reforms the gang.
* **Coordinated checkpoint barrier** — ranks checkpoint on a shared
  deterministic cadence (``gang_barrier_every`` boosting iterations),
  so "an iteration every live rank has a checkpoint for" always exists.
  The barrier id IS the completed-iteration count; rollback = prune
  every rank's ``ckpt_%08d.json`` files beyond the last common id and
  relaunch with ``resume=true``.  Same world size -> the resumed final
  model is BITWISE identical to an uninterrupted run (the existing
  single-process resume contract, applied gang-wide).
* **Escalation ladder** (resilience/retry.py RecoveryEscalation) —
  stage 1 (in-rank transient retry) is unchanged; stage 2 restarts the
  gang at the same world size; stage 3 shrinks past a rank that died
  ``gang_rank_fail_limit`` times, under one jittered-backoff restart
  budget.  Budget exhausted -> RecoveryExhausted, flight-recorder dump,
  exit 1 — a crash-looping gang must page, not spin.
* **Shrink + reshard parity gate** — with ``gang_shard_data=true`` the
  supervisor row-shards the data file; a shrink reshards across the
  survivors and REFUSES to proceed unless the union of shards carries
  the same row multiset as the original dataset
  (:func:`histogram_fingerprint`): identical row multiset => every
  global (allreduced) feature histogram is identical, so training on
  the resharded world is statistically the same problem.  Resharded
  ranks restart boosting (their per-row score buffers no longer match
  their shard); without sharding (redundant mode) survivors resume
  from the barrier with zero lost iterations.
* **SIGTERM fan-out** — a SIGTERM to the supervisor is forwarded to
  EVERY rank child; each checkpoints and exits 75, then the supervisor
  itself exits 75 (resilience.EXIT_PREEMPTED).  Relaunching
  ``task=train_fleet`` with ``resume=true`` rolls to the last common
  barrier and continues.

The rank children (:class:`SubprocessRank`) are ``python -m
lightgbm_tpu_torch task=train`` processes, which train on the card;
each is an independent single-process training (it gets
``LGBM_TPU_PROCESS_ID`` / ``LGBM_TPU_NUM_PROCESSES`` and no coordinator,
so it forms no world, parallel/multihost.py).  In process,
:class:`ThreadRank` runs a job function on a thread (the tests' CPU
gangs).  The supervisor itself is host code: it touches no device.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..analysis import lockcheck
from ..log import Log
from ..obs import flightrec, telemetry
from . import EXIT_PREEMPTED
from .atomic import atomic_write, atomic_write_json
from .retry import RecoveryEscalation, RecoveryExhausted

GANG_SCHEMA = "lightgbm-tpu/gang/v1"
ARTIFACT_SCHEMA = "lightgbm-tpu/train-fleet/v1"

_CKPT_RE = re.compile(r"ckpt_(\d{8})\.json$")


class GangParityError(RuntimeError):
    """A reshard lost or duplicated rows: the union of the proposed
    shards does not carry the original dataset's row multiset, so
    global histograms would silently change.  The shrink is refused."""


# --------------------------------------------------------------- rank files
def ready_file(gang_dir: str, slot: int) -> str:
    return os.path.join(gang_dir, f"rank_{slot}.ready.json")


def heartbeat_file(gang_dir: str, slot: int) -> str:
    return os.path.join(gang_dir, f"rank_{slot}.hb.json")


class RankBeacon:
    """The rank-side half of the supervision protocol, driven from the
    cli train path: one atomic ready-file write when the training loop
    is about to start, one atomic heartbeat write per completed
    iteration (CheckpointManager.after_iteration), and the rank-topology
    block every checkpoint carries."""

    def __init__(self, gang_dir: str, slot: int, rank: int, world: int,
                 gang_id: str, barrier_every: int) -> None:
        self.gang_dir = gang_dir
        self.slot = int(slot)
        self.rank = int(rank)
        self.world = int(world)
        self.gang_id = gang_id
        self.barrier_every = int(barrier_every)

    def ready(self) -> None:
        atomic_write_json(ready_file(self.gang_dir, self.slot), {
            "slot": self.slot, "rank": self.rank, "pid": os.getpid(),
            "t_unix": round(time.time(), 3)})

    def heartbeat(self, iteration: int) -> None:
        atomic_write_json(heartbeat_file(self.gang_dir, self.slot), {
            "slot": self.slot, "rank": self.rank,
            "iteration": int(iteration), "pid": os.getpid(),
            "t_unix": round(time.time(), 3)})

    def gang_block(self) -> dict:
        """Static topology stamped into every checkpoint manifest (the
        manager adds the per-write ``barrier_id``/``barrier``)."""
        return {"schema": GANG_SCHEMA, "gang_id": self.gang_id,
                "slot": self.slot, "rank": self.rank,
                "world_size": self.world,
                "barrier_every": self.barrier_every}


def beacon_from_env() -> Optional[RankBeacon]:
    """Build the beacon from the env the supervisor launched us with;
    None when this process is not a gang member."""
    gang_dir = os.environ.get("LGBM_TPU_GANG_DIR", "")
    if not gang_dir:
        return None
    slot = int(os.environ.get("LGBM_TPU_GANG_SLOT", "0") or 0)
    rank = int(os.environ.get("LGBM_TPU_PROCESS_ID", "0") or 0)
    world = int(os.environ.get("LGBM_TPU_NUM_PROCESSES", "1") or 1)
    gang_id = os.environ.get("LGBM_TPU_GANG_ID", "gang")
    every = int(os.environ.get("LGBM_TPU_GANG_BARRIER_EVERY", "1") or 1)
    return RankBeacon(gang_dir, slot, rank, world, gang_id, every)


# ------------------------------------------------------------ barrier math
def _ckpt_iterations(ckpt_dir: str) -> Dict[int, str]:
    """iteration -> path for every checkpoint file in ``ckpt_dir``."""
    out: Dict[int, str] = {}
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return out
    for name in names:
        m = _CKPT_RE.match(name)
        if m:
            out[int(m.group(1))] = os.path.join(ckpt_dir, name)
    return out


def last_common_barrier(ckpt_dirs: Sequence[str]) -> int:
    """The newest iteration EVERY rank has a checkpoint for (0 = none:
    the gang restarts from scratch, which is itself a valid barrier —
    a deterministic run from iteration 0 still hits the bitwise
    contract)."""
    common: Optional[set] = None
    for d in ckpt_dirs:
        its = set(_ckpt_iterations(d))
        common = its if common is None else (common & its)
    return max(common) if common else 0


def rollback_to_barrier(ckpt_dirs: Sequence[str], barrier: int) -> int:
    """Prune every checkpoint NEWER than ``barrier`` (uncoordinated
    progress: some rank advanced past the last common barrier before
    the abort).  Returns the number of files removed."""
    removed = 0
    for d in ckpt_dirs:
        for it, path in _ckpt_iterations(d).items():
            if it > barrier:
                try:
                    os.remove(path)
                    removed += 1
                except OSError:
                    pass
    return removed


# ---------------------------------------------------- reshard parity gate
def histogram_fingerprint(paths: Sequence[str]) -> str:
    """Order-independent fingerprint of the row MULTISET across
    ``paths``: sha256 over the sorted concatenation of data lines.
    Two datasets with equal fingerprints produce identical global
    feature histograms under ANY row partition — this is the parity
    gate a shrink-time reshard must pass."""
    rows: List[bytes] = []
    for p in paths:
        with open(p, "rb") as fh:
            rows.extend(line.rstrip(b"\r\n") for line in fh
                        if line.strip())
    h = hashlib.sha256()
    for line in sorted(rows):
        h.update(line)
        h.update(b"\n")
    return h.hexdigest()


def shard_rows(data_path: str, out_dir: str,
               slots: Sequence[int]) -> Dict[int, str]:
    """Round-robin row shards of ``data_path`` for the active slots
    (``shard_r<slot>.csv`` under ``out_dir``), verified against the
    parity gate before anyone trains on them.  Returns slot -> path."""
    os.makedirs(out_dir, exist_ok=True)
    with open(data_path, "r") as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.strip()]
    shards: Dict[int, List[str]] = {s: [] for s in slots}
    order = list(slots)
    for i, ln in enumerate(lines):
        shards[order[i % len(order)]].append(ln)
    paths: Dict[int, str] = {}
    for s in slots:
        path = os.path.join(out_dir, f"shard_r{s}.csv")
        atomic_write(path, "\n".join(shards[s]) + "\n")
        paths[s] = path
    want = histogram_fingerprint([data_path])
    got = histogram_fingerprint([paths[s] for s in slots])
    if want != got:
        raise GangParityError(
            f"reshard of {data_path} across slots {list(slots)} FAILED "
            f"the global-histogram parity gate (row-multiset sha256 "
            f"{got[:16]}… != source {want[:16]}…) — rows were lost or "
            "duplicated; refusing to train on it.")
    telemetry.count("lgbm_gang_parity_checks")
    return paths


# ------------------------------------------------------------ rank handles
class SubprocessRank:
    """One rank as a real ``python -m lightgbm_tpu_torch task=train``
    subprocess (on the card).  stdout/stderr tee to ``<slot_dir>/log.txt``; kill() is
    SIGKILL (abrupt rank death), terminate() is SIGTERM (the rank
    checkpoints and exits 75)."""

    def __init__(self, slot: int, rank: int, argv: Sequence[str],
                 env: Dict[str, str], gang_dir: str, log_path: str) -> None:
        self.slot = int(slot)
        self.rank = int(rank)
        self.argv = list(argv)
        self.env = dict(env)
        self.gang_dir = gang_dir
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self._log_fh = None

    def start(self) -> None:
        env = dict(os.environ)
        env.update(self.env)
        self._log_fh = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "lightgbm_tpu_torch", *self.argv],
            stdout=self._log_fh, stderr=subprocess.STDOUT, env=env)

    def wait_ready(self, timeout_s: float) -> bool:
        path = ready_file(self.gang_dir, self.slot)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if os.path.exists(path):
                return True
            if self.poll() is not None:
                return False
            time.sleep(0.05)
        return False

    def poll(self) -> Optional[int]:
        if self.proc is None:
            return None
        rc = self.proc.poll()
        if rc is not None and self._log_fh is not None:
            try:
                self._log_fh.close()
            except OSError:
                pass
            self._log_fh = None
        return rc

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()

    def terminate(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()

    def wait(self, timeout_s: float) -> Optional[int]:
        if self.proc is None:
            return None
        try:
            self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            pass
        return self.poll()


class RankKilled(Exception):
    """In-thread stand-in for SIGKILL (thread ranks)."""


class RankPreempted(Exception):
    """In-thread stand-in for the SIGTERM checkpoint-and-exit-75 path."""


class ThreadRankContext:
    """What a thread-rank job sees: identity, the handshake/heartbeat
    beacon, and the cooperative kill/preempt flags the job must poll
    between iterations (a thread cannot be SIGKILLed; polling at the
    iteration boundary is the same granularity the real train loop
    honors signals at)."""

    def __init__(self, slot: int, rank: int, world: int, gang_dir: str,
                 slot_dir: str, barrier_every: int, resume: bool,
                 data_path: str = "") -> None:
        self.slot = slot
        self.rank = rank
        self.world = world
        self.gang_dir = gang_dir
        self.slot_dir = slot_dir
        self.barrier_every = barrier_every
        self.resume = resume
        self.data_path = data_path
        self.killed = threading.Event()
        self.preempt = threading.Event()
        self._beacon = RankBeacon(gang_dir, slot, rank, world,
                                  "thread-gang", barrier_every)

    def ready(self) -> None:
        self._beacon.ready()

    def heartbeat(self, iteration: int) -> None:
        self._beacon.heartbeat(iteration)

    def check_signals(self) -> None:
        """Raise the pending simulated signal, kill winning over
        preempt (a SIGKILL outranks a SIGTERM)."""
        if self.killed.is_set():
            raise RankKilled()
        if self.preempt.is_set():
            raise RankPreempted()


class ThreadRank:
    """One rank as a daemon thread running ``fn(ctx)`` — the in-process
    stand-in for SubprocessRank (a test supplies the job: a stub, or the
    port's booster on the CPU).  Exit codes mirror the process contract:
    0 done, 75 preempted-after-checkpoint, -9 killed, 1 error."""

    def __init__(self, slot: int, rank: int, fn: Callable, ctx:
                 ThreadRankContext) -> None:
        self.slot = int(slot)
        self.rank = int(rank)
        self.fn = fn
        self.ctx = ctx
        self.gang_dir = ctx.gang_dir
        self._rc: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = lockcheck.make_lock(f"gang.threadrank.{slot}")

    def _run(self) -> None:
        try:
            self.fn(self.ctx)
            rc = 0
        except RankKilled:
            rc = -9
        except RankPreempted:
            rc = 75
        except Exception as e:  # noqa: BLE001 — rank error -> exit 1
            Log.warning(f"thread rank {self.slot} error: "
                        f"{type(e).__name__}: {e}")
            rc = 1
        with self._lock:
            self._rc = rc

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"gang-rank-{self.slot}")
        self._thread.start()

    def wait_ready(self, timeout_s: float) -> bool:
        path = ready_file(self.gang_dir, self.slot)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if os.path.exists(path):
                return True
            if self.poll() is not None:
                return False
            time.sleep(0.01)
        return False

    def poll(self) -> Optional[int]:
        with self._lock:
            return self._rc

    def kill(self) -> None:
        self.ctx.killed.set()

    def terminate(self) -> None:
        self.ctx.preempt.set()

    def wait(self, timeout_s: float) -> Optional[int]:
        if self._thread is not None:
            self._thread.join(timeout_s)
        return self.poll()


# ------------------------------------------------------------- supervisor
class _RankSlot:
    """One supervised rank position.  ``slot_id`` is stable for the
    life of the gang (it names the rank's private dir, shard, and
    handshake files); ``rank`` is the dense 0..world-1 index the
    current formation assigns (re-numbered after a shrink so rank-file
    exchanges stay contiguous)."""

    __slots__ = ("slot_id", "rank", "handle", "failures", "done",
                 "last_hb_iter")

    def __init__(self, slot_id: int) -> None:
        self.slot_id = slot_id
        self.rank = slot_id
        self.handle = None
        self.failures = 0
        self.done = False
        self.last_hb_iter = 0


class GangSupervisor:
    """Owns the rank gang: formation (with rollback to the last common
    barrier), heartbeat/death monitoring, the recovery ladder, SIGTERM
    fan-out, and the train-fleet artifact metrics.

    ``factory(slot_id, rank, world, resume)`` builds a rank handle
    (SubprocessRank or ThreadRank).  ``ckpt_dir_for(slot_id)`` names a
    slot's checkpoint dir (for barrier math).  ``reshard(slot_ids)``
    (optional) re-partitions the data across the surviving slots after
    a shrink and returns whether survivors may resume (False = the
    shards changed under them, restart boosting from scratch)."""

    def __init__(self, factory: Callable, *, slots: Sequence[int],
                 gang_dir: str, ckpt_dir_for: Callable[[int], str],
                 barrier_every: int = 1,
                 restart_budget: int = 8, rank_fail_limit: int = 2,
                 min_ranks: int = 1,
                 backoff_base_s: float = 0.2, backoff_max_s: float = 5.0,
                 heartbeat_timeout_s: float = 60.0,
                 ready_timeout_s: float = 180.0,
                 poll_interval_s: float = 0.2,
                 reshard: Optional[Callable] = None,
                 chaos_kill_at: Optional[Dict[int, int]] = None,
                 seed: int = 0, sleep: Callable = time.sleep) -> None:
        self._factory = factory
        self._gang_dir = gang_dir
        self._ckpt_dir_for = ckpt_dir_for
        self._barrier_every = int(barrier_every)
        self._hb_timeout = float(heartbeat_timeout_s)
        self._ready_timeout = float(ready_timeout_s)
        self._poll_interval = float(poll_interval_s)
        self._reshard = reshard
        # slot -> (iteration, persistent): SIGKILL the slot once its
        # heartbeat reaches the iteration; persistent entries re-arm at
        # every gang formation (they model a host that keeps dying,
        # driving the shrink rung of the ladder)
        self._chaos_kill_at: Dict[int, tuple] = {}
        for k, v in (chaos_kill_at or {}).items():
            self._chaos_kill_at[int(k)] = (
                (int(v[0]), bool(v[1])) if isinstance(v, (tuple, list))
                else (int(v), False))
        self._chaos_fired: set = set()
        self._sleep = sleep
        self._esc = RecoveryEscalation(
            restart_budget=restart_budget, rank_fail_limit=rank_fail_limit,
            min_world=min_ranks, backoff_base_s=backoff_base_s,
            backoff_max_s=backoff_max_s, seed=seed)
        self._lock = lockcheck.make_lock("gang.state")
        self._slots: List[_RankSlot] = [_RankSlot(s) for s in slots]
        self._world_start = len(self._slots)
        # set from a signal handler: a single reference assignment is
        # atomic under the GIL and the run loop reads it once per poll
        self._preempt_signum: Optional[int] = None
        self.recoveries: List[dict] = []
        self.lost_iterations = 0
        self.restarts = 0
        self.shrinks = 0
        self.rank_deaths = 0
        self.rank_hangs = 0
        self.preempted = False
        self.budget_exhausted = False
        self.final_barrier = 0

    # -- public surface -------------------------------------------------
    def request_preempt(self, signum: int = signal.SIGTERM) -> None:
        """Signal-handler hook: ask the run loop to fan the preemption
        out to every rank (SIGTERM fan-out satellite — ALL ranks must
        checkpoint and exit 75, not just rank 0)."""
        self._preempt_signum = signum

    def chaos_kill(self, slot_id: int) -> None:
        """Abruptly kill one rank (chaos hook — drives the exact death
        path a preempted host produces)."""
        with self._lock:
            slot = self._slot_by_id(slot_id)
            if slot is not None and slot.handle is not None:
                telemetry.count("lgbm_gang_chaos_kills")
                flightrec.record("gang_chaos_kill", slot=slot_id)
                slot.handle.kill()

    def describe(self) -> dict:
        with self._lock:
            return {
                "world_size_start": self._world_start,
                "world_size": len(self._slots),
                "slots": [{"slot": s.slot_id, "rank": s.rank,
                           "failures": s.failures, "done": s.done,
                           "last_hb_iter": s.last_hb_iter}
                          for s in self._slots],
                "restarts": self.restarts, "shrinks": self.shrinks,
                "rank_deaths": self.rank_deaths,
                "rank_hangs": self.rank_hangs,
                "budget_spent": self._esc.spent,
                "budget_remaining": self._esc.remaining(),
                "recoveries": list(self.recoveries),
                "lost_iterations": self.lost_iterations,
                "preempted": self.preempted,
                "budget_exhausted": self.budget_exhausted,
                "final_barrier": self.final_barrier,
            }

    def run(self, resume: bool = False) -> int:
        """Supervise until every rank finishes (0), the operator
        preempts the fleet (75), or recovery is exhausted (1).  A rank
        that dies DURING formation re-enters the same recovery ladder
        as one that dies mid-iteration."""
        self._t_start = time.monotonic()
        pending: Optional[tuple] = ("__form__", resume)
        try:
            while True:
                if pending is not None:
                    kind = pending[0]
                    try:
                        if kind == "__form__":
                            self._form_gang(resume=pending[1], first=True)
                        else:
                            self._recover(*pending)
                        pending = None
                    except _FormationFailed as ff:
                        pending = (ff.slot_id, "rank_death", ff.rc)
                    continue
                if self._preempt_signum is not None:
                    return self._preempt_all()
                failed = self._poll_once()
                with self._lock:
                    if all(s.done for s in self._slots):
                        break
                if failed is not None:
                    pending = failed
                    continue
                self._sleep(self._poll_interval)
        except RecoveryExhausted as err:
            self.budget_exhausted = True
            telemetry.count("lgbm_gang_budget_exhausted")
            flightrec.record("gang_budget_exhausted", error=str(err)[:400])
            flightrec.dump(reason="gang_budget_exhausted")
            Log.warning(f"gang: {err}")
            self._kill_all()
            return 1
        self.final_barrier = last_common_barrier(
            [self._ckpt_dir_for(s.slot_id) for s in self._slots])
        Log.info(
            f"gang: all {len(self._slots)} ranks finished "
            f"(restarts={self.restarts}, shrinks={self.shrinks}, "
            f"lost_iterations={self.lost_iterations})")
        return 0

    def active_slot_ids(self) -> List[int]:
        with self._lock:
            return [s.slot_id for s in self._slots]

    def artifact_section(self) -> dict:
        """The metrics block of the train-fleet/v1 artifact."""
        wall = time.monotonic() - getattr(self, "_t_start", time.monotonic())
        mttrs = [r["mttr_s"] for r in self.recoveries if "mttr_s" in r]
        return {
            "world_size_start": self._world_start,
            "world_size_end": len(self._slots),
            "restarts": self.restarts,
            "shrinks": self.shrinks,
            "rank_deaths": self.rank_deaths,
            "rank_hangs": self.rank_hangs,
            "recoveries": len(self.recoveries),
            "recovery_timeline": list(self.recoveries),
            "mttr_s": round(sum(mttrs) / len(mttrs), 4) if mttrs else 0.0,
            "lost_iterations": self.lost_iterations,
            "budget_spent": self._esc.spent,
            "budget_exhausted": self.budget_exhausted,
            "preempted": self.preempted,
            "final_barrier": self.final_barrier,
            "wall_s": round(wall, 4),
        }

    # -- internals ------------------------------------------------------
    def _slot_by_id(self, slot_id: int) -> Optional[_RankSlot]:
        for s in self._slots:
            if s.slot_id == slot_id:
                return s
        return None

    def _clear_handshake(self, slot_id: int) -> None:
        for path in (ready_file(self._gang_dir, slot_id),
                     heartbeat_file(self._gang_dir, slot_id)):
            try:
                os.remove(path)
            except OSError:
                pass

    def _form_gang(self, resume: bool, first: bool = False) -> None:
        """(Re)launch every active rank from a COMMON state: roll all
        checkpoint dirs back to the last common barrier (or wipe them on
        a fresh start), clear the handshake files, start the handles,
        and wait for every ready file.  A rank that dies before ready
        re-enters the recovery ladder."""
        with self._lock:
            slots = list(self._slots)
        dirs = [self._ckpt_dir_for(s.slot_id) for s in slots]
        if resume:
            barrier = last_common_barrier(dirs)
            pruned = rollback_to_barrier(dirs, barrier)
            if pruned:
                telemetry.count("lgbm_gang_rollbacks")
                Log.info(f"gang: rolled back {pruned} checkpoint(s) "
                         f"beyond barrier {barrier}")
        else:
            barrier = 0
            rollback_to_barrier(dirs, 0)
        self._barrier = barrier
        # persistent chaos kills re-arm at every formation
        self._chaos_fired -= {s for s, (_, persist)
                              in self._chaos_kill_at.items() if persist}
        for i, slot in enumerate(slots):
            self._clear_handshake(slot.slot_id)
            slot.rank = i
            slot.done = False
            slot.last_hb_iter = barrier  # stale fronts would inflate lost
        telemetry.count("lgbm_gang_launches", len(slots))
        flightrec.record("gang_form", world=len(slots), barrier=barrier,
                         resume=bool(resume), first=bool(first))
        for slot in slots:
            handle = self._factory(slot.slot_id, slot.rank, len(slots),
                                   resume)
            with self._lock:
                slot.handle = handle
            handle.start()
        for slot in slots:
            if not slot.handle.wait_ready(self._ready_timeout):
                rc = slot.handle.poll()
                raise _FormationFailed(slot.slot_id, rc)
        Log.info(f"gang: formed with {len(slots)} rank(s) at barrier "
                 f"{barrier} (resume={resume})")

    def _heartbeat_age(self, slot: _RankSlot) -> Optional[float]:
        hb = heartbeat_file(self._gang_dir, slot.slot_id)
        try:
            with open(hb) as fh:
                slot.last_hb_iter = int(json.load(fh).get("iteration", 0))
        except (OSError, ValueError):
            pass
        for path in (hb, ready_file(self._gang_dir, slot.slot_id)):
            try:
                return time.time() - os.path.getmtime(path)
            except OSError:
                continue
        return None

    def _poll_once(self):
        """One monitor pass.  Returns ``(slot_id, cause, rc)`` on the
        first observed failure, else None.  Marks cleanly finished
        ranks done."""
        with self._lock:
            slots = list(self._slots)
        for slot in slots:
            if slot.done or slot.handle is None:
                continue
            rc = slot.handle.poll()
            if rc == 0:
                slot.done = True
                continue
            if rc is not None:
                # 75 without a supervisor-initiated preemption means an
                # outside actor SIGTERMed one rank: the gang treats any
                # unilateral exit as a death and recovers
                return (slot.slot_id, "rank_death", rc)
            age = self._heartbeat_age(slot)
            if self._hb_timeout > 0 and age is not None and \
                    age > self._hb_timeout:
                Log.warning(
                    f"gang: rank slot {slot.slot_id} heartbeat is "
                    f"{age:.1f}s stale (deadline {self._hb_timeout:.1f}s)"
                    " — declaring it hung and killing it")
                slot.handle.kill()
                slot.handle.wait(10.0)
                return (slot.slot_id, "rank_hang", None)
            target = self._chaos_kill_at.get(slot.slot_id)
            if target is not None and slot.slot_id not in \
                    self._chaos_fired and slot.last_hb_iter >= target[0]:
                self._chaos_fired.add(slot.slot_id)
                self.chaos_kill(slot.slot_id)
        return None

    def _kill_all(self) -> None:
        with self._lock:
            slots = list(self._slots)
        for slot in slots:
            if slot.handle is not None and not slot.done:
                slot.handle.kill()
        for slot in slots:
            if slot.handle is not None and not slot.done:
                slot.handle.wait(10.0)

    def _recover(self, slot_id: int, cause: str, rc) -> None:
        """Stages 2/3 of the ladder: abort the iteration (kill every
        survivor — their post-barrier progress is unjoinable anyway),
        roll back, back off, reform.  Raises RecoveryExhausted when the
        ladder is out of rungs."""
        t_detect = time.monotonic()
        slot = self._slot_by_id(slot_id)
        slot.failures += 1
        if cause == "rank_hang":
            self.rank_hangs += 1
            telemetry.count("lgbm_gang_rank_hangs")
        else:
            self.rank_deaths += 1
            telemetry.count("lgbm_gang_rank_deaths")
        hb_front = max([s.last_hb_iter for s in self._slots] + [0])
        flightrec.record("gang_abort", slot=slot_id, cause=cause,
                         rc=rc if rc is None else int(rc),
                         failures=slot.failures, world=len(self._slots),
                         hb_front=hb_front)
        self._kill_all()
        action, delay = self._esc.next_action(
            world=len(self._slots), rank_failures=slot.failures)
        resume = True
        if action == "shrink":
            with self._lock:
                self._slots = [s for s in self._slots
                               if s.slot_id != slot_id]
            self.shrinks += 1
            telemetry.count("lgbm_gang_shrinks")
            Log.warning(
                f"gang: slot {slot_id} died {slot.failures}x — shrinking "
                f"to {len(self._slots)} rank(s)")
            if self._reshard is not None:
                resume = bool(self._reshard(self.active_slot_ids()))
        else:
            self.restarts += 1
            telemetry.count("lgbm_gang_restarts")
        # the drain-tagged post-mortem: every abort leaves the full
        # event ring (who died, what the heartbeat front was, what the
        # ladder decided) next to the artifacts BEFORE the backoff wait
        flightrec.record("gang_recovery", action=action, slot=slot_id,
                         cause=cause, backoff_s=round(delay, 3),
                         budget_spent=self._esc.spent)
        flightrec.dump(reason=f"gang_abort_{cause}")
        self._sleep(delay)
        self._form_gang(resume=resume)
        barrier = self._barrier
        lost = max(0, hb_front - barrier)
        self.lost_iterations += lost
        telemetry.count_many({"lgbm_gang_lost_iterations": lost})
        mttr = time.monotonic() - t_detect
        self.recoveries.append({
            "t_rel_s": round(t_detect - self._t_start, 4),
            "cause": cause, "slot": slot_id, "action": action,
            "world_after": len(self._slots), "barrier": barrier,
            "lost_iterations": lost, "mttr_s": round(mttr, 4),
        })
        telemetry.record_value("lgbm_gang_mttr_s", mttr)
        Log.info(f"gang: recovered from {cause} of slot {slot_id} via "
                 f"{action} in {mttr:.2f}s (barrier {barrier}, "
                 f"{lost} lost iteration(s))")

    def _preempt_all(self) -> int:
        """SIGTERM fan-out: forward the preemption to EVERY rank child,
        wait for each to checkpoint and exit 75, then report 75
        ourselves.  A rank that ignores the signal is killed (and
        logged) — the fleet must release its hosts."""
        signum = self._preempt_signum or signal.SIGTERM
        self.preempted = True
        telemetry.count("lgbm_gang_preemptions")
        with self._lock:
            live = [s for s in self._slots
                    if not s.done and s.handle is not None]
        Log.warning(
            f"gang: forwarding {signal.Signals(signum).name} to "
            f"{len(live)} rank(s); each checkpoints and exits "
            f"{EXIT_PREEMPTED}")
        for slot in live:
            slot.handle.terminate()
        clean = 0
        for slot in live:
            rc = slot.handle.wait(self._ready_timeout)
            if rc == EXIT_PREEMPTED:
                clean += 1
            else:
                Log.warning(
                    f"gang: rank slot {slot.slot_id} exited {rc} "
                    f"(expected {EXIT_PREEMPTED}) during preemption")
                slot.handle.kill()
                slot.handle.wait(10.0)
        flightrec.record("gang_preempt", ranks=len(live), clean=clean,
                         signal=signal.Signals(signum).name)
        flightrec.dump(reason="gang_preempt")
        Log.info(f"gang: preempted; {clean}/{len(live)} rank(s) "
                 "checkpointed cleanly — relaunch with resume=true")
        return EXIT_PREEMPTED


class _FormationFailed(Exception):
    """A rank died (or never became ready) during gang formation —
    converted into the normal recovery path by the run loop."""

    def __init__(self, slot_id: int, rc) -> None:
        super().__init__(f"rank slot {slot_id} failed during formation "
                         f"(rc={rc})")
        self.slot_id = slot_id
        self.rc = rc


# -------------------------------------------------------- CLI entry point
def _passthrough_params(cfg) -> List[str]:
    """Re-emit the training parameters a rank child needs as
    ``key=value`` argv: every field that differs from the dataclass
    default, minus the ones the supervisor owns (task/data/output/
    checkpoint/gang/serving knobs)."""
    import dataclasses

    from ..config import Config

    skip = {"task", "data", "output_model", "snapshot_dir",
            "snapshot_freq", "resume", "train_ranks", "gang_dir",
            "gang_barrier_every", "gang_restart_budget",
            "gang_backoff_base_s", "gang_backoff_max_s",
            "gang_rank_fail_limit", "gang_min_ranks",
            "gang_heartbeat_timeout_s", "gang_ready_timeout_s",
            "gang_shard_data", "machine_list_file"}
    out: List[str] = []
    for f in dataclasses.fields(Config):
        if f.name in skip or f.name.startswith("serve_"):
            continue
        val = getattr(cfg, f.name)
        if f.default is not dataclasses.MISSING:
            if val == f.default:
                continue
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore
            if val == f.default_factory():  # type: ignore
                continue
        if isinstance(val, bool):
            out.append(f"{f.name}={'true' if val else 'false'}")
        elif isinstance(val, (list, tuple)):
            if val:
                out.append(f"{f.name}={','.join(str(v) for v in val)}")
        else:
            out.append(f"{f.name}={val}")
    return out


def _chaos_kill_from_env() -> Dict[int, tuple]:
    """``LGBM_TPU_GANG_CHAOS_KILL="<slot>:<iteration>[:always][,...]"``
    — the supervisor SIGKILLs the slot once its heartbeat reaches the
    iteration; ``always`` re-arms the kill at every gang formation, the
    crash-looping host that drives the shrink rung."""
    spec = os.environ.get("LGBM_TPU_GANG_CHAOS_KILL", "")
    out: Dict[int, tuple] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        s, _, rest = part.partition(":")
        it, _, mode = rest.partition(":")
        out[int(s)] = (int(it or 1), mode == "always")
    return out


def _gang_fault_env() -> Dict[int, str]:
    """``LGBM_TPU_GANG_FAULT="<slot>:<fault-spec>"`` — inject an
    LGBM_TPU_FAULT into ONE rank child only (e.g. a hang)."""
    spec = os.environ.get("LGBM_TPU_GANG_FAULT", "")
    out: Dict[int, str] = {}
    if spec:
        s, _, fault = spec.partition(":")
        out[int(s)] = fault
    return out


def train_fleet_from_config(cfg) -> int:
    """``task=train_fleet``: supervise ``train_ranks`` rank
    subprocesses through to a finished model at ``cfg.output_model``
    (rank 0's model, copied on success), with the full recovery ladder,
    SIGTERM fan-out, and a committed-shape train-fleet/v1 artifact at
    ``<gang_dir>/train_fleet.json``."""
    gang_dir = cfg.gang_dir or (cfg.output_model + ".gang")
    barrier_every = int(cfg.gang_barrier_every or cfg.snapshot_freq or 0)
    if barrier_every <= 0:
        raise ValueError(
            "task=train_fleet needs gang_barrier_every or snapshot_freq "
            "> 0 — a gang without checkpoint barriers cannot roll back")
    os.makedirs(gang_dir, exist_ok=True)
    flightrec.configure_dir(gang_dir)
    slots = list(range(int(cfg.train_ranks)))
    gang_id = f"gang-{os.getpid()}"
    obs_dir = os.path.join(gang_dir, "obs")
    os.makedirs(obs_dir, exist_ok=True)

    shard_map: Dict[int, str] = {}
    reshard = None
    if cfg.gang_shard_data:
        shard_map.update(shard_rows(cfg.data, gang_dir, slots))

        def reshard(active_ids: Sequence[int]) -> bool:
            shard_map.update(shard_rows(cfg.data, gang_dir, active_ids))
            # resharded rows invalidate the survivors' per-row score
            # buffers: boosting restarts from scratch on the new shards
            # (statistically identical — the parity gate just held)
            return False

    passthrough = _passthrough_params(cfg)

    def slot_dir(slot: int) -> str:
        return os.path.join(gang_dir, f"r{slot}")

    def ckpt_dir_for(slot: int) -> str:
        return os.path.join(slot_dir(slot), "ckpt")

    fault_by_slot = _gang_fault_env()

    def factory(slot: int, rank: int, world: int, resume: bool):
        sdir = slot_dir(slot)
        os.makedirs(ckpt_dir_for(slot), exist_ok=True)
        data = shard_map.get(slot, cfg.data)
        argv = ["task=train", f"data={data}",
                f"output_model={os.path.join(sdir, 'model.txt')}",
                f"snapshot_dir={ckpt_dir_for(slot)}",
                f"snapshot_freq={barrier_every}",
                f"resume={'true' if resume else 'false'}",
                *passthrough]
        env = {
            "LGBM_TPU_GANG_DIR": gang_dir,
            "LGBM_TPU_GANG_SLOT": str(slot),
            "LGBM_TPU_GANG_ID": gang_id,
            "LGBM_TPU_GANG_BARRIER_EVERY": str(barrier_every),
            "LGBM_TPU_PROCESS_ID": str(rank),
            "LGBM_TPU_NUM_PROCESSES": str(world),
            "LGBM_TPU_RANK_OBS_DIR": obs_dir,
            "LGBM_TPU_FLIGHTREC_DIR": gang_dir,
        }
        if slot in fault_by_slot:
            env["LGBM_TPU_FAULT"] = fault_by_slot[slot]
        return SubprocessRank(slot, rank, argv, env, gang_dir,
                              log_path=os.path.join(sdir, "log.txt"))

    sup = GangSupervisor(
        factory, slots=slots, gang_dir=gang_dir,
        ckpt_dir_for=ckpt_dir_for, barrier_every=barrier_every,
        restart_budget=cfg.gang_restart_budget,
        rank_fail_limit=cfg.gang_rank_fail_limit,
        min_ranks=cfg.gang_min_ranks,
        backoff_base_s=cfg.gang_backoff_base_s,
        backoff_max_s=cfg.gang_backoff_max_s,
        heartbeat_timeout_s=cfg.gang_heartbeat_timeout_s,
        ready_timeout_s=cfg.gang_ready_timeout_s,
        poll_interval_s=0.05,  # detection latency IS the MTTR floor
        chaos_kill_at=_chaos_kill_from_env(), reshard=reshard,
        seed=cfg.seed)

    old_handlers = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(
                sig, lambda signum, frame: sup.request_preempt(signum))
    except ValueError:
        old_handlers = {}  # not the main thread (tests)
    try:
        rc = sup.run(resume=bool(cfg.resume))
    finally:
        for sig, old in old_handlers.items():
            signal.signal(sig, old)

    if rc == 0:
        first = sup.active_slot_ids()[0]
        src = os.path.join(slot_dir(first), "model.txt")
        with open(src, "rb") as fh:
            atomic_write(cfg.output_model, fh.read(), mode="wb")
        Log.info(f"gang: saved rank {first}'s model to "
                 f"{cfg.output_model}")
    write_train_fleet_artifact(
        os.path.join(gang_dir, "train_fleet.json"), sup, cfg,
        barrier_every=barrier_every, rc=rc)
    return rc


def write_train_fleet_artifact(path: str, sup: GangSupervisor, cfg,
                               barrier_every: int, rc: int) -> str:
    """The ``lightgbm-tpu/train-fleet/v1`` artifact: the recovery
    metrics (MTTR; failed_iterations > 0 and budget exhaustion are
    failures), the ``lgbm_gang_*`` counters, and a RunManifest sibling
    whose ``ranks[]`` carries every rank child's gang-stamped telemetry
    snapshot."""
    section = sup.artifact_section()
    target = int(getattr(cfg, "num_iterations", 0) or 0)
    section["target_iterations"] = target
    section["failed_iterations"] = (
        0 if rc in (0, EXIT_PREEMPTED)
        else max(0, target - sup.final_barrier))
    section["exit_code"] = int(rc)
    section["barriers_committed"] = (
        sup.final_barrier // max(1, barrier_every))
    tel = telemetry.get_telemetry().snapshot()
    counters = {k: v for k, v in tel.get("counters", {}).items()
                if k.startswith("lgbm_gang_")}
    doc = {
        "schema": ARTIFACT_SCHEMA,
        "created_unix": round(time.time(), 3),
        "shape": {
            "ranks": section["world_size_start"],
            "trees": target,
            "barrier_every": int(barrier_every),
            "shard_data": bool(getattr(cfg, "gang_shard_data", False)),
            "seed": int(getattr(cfg, "seed", 0) or 0),
        },
        "train_fleet": section,
        "counters": counters,
    }
    atomic_write_json(path, doc)
    try:
        # the manifest sibling (obs/manifest.py): rank snapshots carry
        # the gang stamp (obs/dist.py), making every recovery
        # attributable — "slot 2's third incarnation" has a name
        from ..obs import dist
        from ..obs.manifest import RunManifest, manifest_path

        snaps = []
        obs_dir = os.path.join(os.path.dirname(path), "obs")
        for name in sorted(os.listdir(obs_dir)):
            if name.startswith("rank_") and name.endswith(".json"):
                with open(os.path.join(obs_dir, name)) as fh:
                    snaps.append(json.load(fh))
        man = RunManifest.collect(
            "train_fleet", config=cfg, result=dict(section),
            ranks=dist.ranks_section(snaps) if snaps else [])
        man.write(manifest_path(path))
    except Exception as e:  # noqa: BLE001 — manifest is best-effort
        Log.warning(f"train-fleet manifest write failed: "
                    f"{type(e).__name__}: {e}")
    Log.info(f"gang: wrote train-fleet artifact to {path}")
    return path
