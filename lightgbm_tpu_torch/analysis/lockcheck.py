"""Runtime lock sanitizer for the threaded serving/obs/resilience tier.

A copy of the JAX package's ``analysis/lockcheck.py`` (stdlib only).
It checks the actual interleavings, in the spirit of ThreadSanitizer's
lock-order analysis (the JAX package's static half,
``analysis/concurrency.py``, is not ported).  Threaded modules create their primitives through
the factories here:

    _lock = lockcheck.make_lock("memory.census")
    self._cond = lockcheck.make_condition("queue.cond")

With ``LGBM_TPU_LOCKCHECK`` unset (the default) the factories return
the plain ``threading`` primitives — zero wrappers, zero overhead, so
production serving pays nothing.  With ``LGBM_TPU_LOCKCHECK=1`` they
return instrumented proxies that record, per thread, the stack of held
locks and the acquisition call stack for each, and accumulate a
process-wide lock-order graph.  Two finding kinds:

``lock-order-inversion``
    acquiring B while holding A when some thread has already acquired
    A while holding B — the classic deadlock precondition, reported
    with BOTH lock names and BOTH acquisition stacks (this order's and
    the recorded reverse order's), so a post-mortem names the exact
    pair without reproducing the hang.

``sync-under-lock``
    a host sync/materialization executed while holding an instrumented
    lock.  The serving hot path calls ``lockcheck.note_host_sync(...)``
    just before each device wait; if the calling thread holds a lock
    at that point, every other thread is queued behind a device
    round-trip.

Findings are appended to an in-process list (``findings()``) and
mirrored to the flight recorder (``obs/flightrec.py``) as
``kind="lockcheck"`` events, so a deadlock post-mortem dump carries
them alongside the serving timeline.  ``stats()`` exposes per-lock
acquisition counts and max hold times for hold-time regressions.

The checker's own bookkeeping lock is a plain ``threading.Lock`` held
only for dict updates (never while calling user code or the flight
recorder) and is itself excluded from checking.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

_ENV_FLAG = "LGBM_TPU_LOCKCHECK"

_enabled = os.environ.get(_ENV_FLAG, "").strip().lower() in (
    "1", "true", "yes", "on")

# bookkeeping state -- guarded by _state_lock, which is deliberately a
# raw primitive (instrumenting the checker with itself would recurse)
_state_lock = threading.Lock()
_edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
_findings: List[Dict[str, Any]] = []
_stats: Dict[str, Dict[str, float]] = {}
_tls = threading.local()


def enabled() -> bool:
    """Whether the sanitizer is active (env knob or set_enabled)."""
    return _enabled


def set_enabled(flag: bool) -> None:
    """Toggle at runtime (tests).  Only locks created AFTER enabling
    are instrumented — module-level locks made at import keep whatever
    flavour the import-time knob selected."""
    global _enabled
    _enabled = bool(flag)


def reset() -> None:
    """Drop accumulated findings, edges, and stats (tests)."""
    with _state_lock:
        _edges.clear()
        del _findings[:]
        _stats.clear()


def findings() -> List[Dict[str, Any]]:
    with _state_lock:
        return [dict(f) for f in _findings]


def stats() -> Dict[str, Dict[str, float]]:
    with _state_lock:
        return {k: dict(v) for k, v in _stats.items()}


def lock_order_graph() -> Dict[Tuple[str, str], int]:
    """(held, acquired) -> times that edge was observed."""
    with _state_lock:
        return {k: int(v["count"]) for k, v in _edges.items()}


def _held_stack() -> List[Dict[str, Any]]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = []
        _tls.held = stack
    return stack


def _capture_stack(skip: int = 3) -> List[str]:
    """Short formatted stack, trimmed of checker frames."""
    frames = traceback.extract_stack(limit=skip + 12)[:-skip]
    return [f"{os.path.basename(fr.filename)}:{fr.lineno}:{fr.name}"
            for fr in frames[-8:]]


def _emit(finding: Dict[str, Any]) -> None:
    with _state_lock:
        _findings.append(finding)
    # mirror into the flight recorder so a post-mortem dump carries the
    # lock pair + stacks; lazy import keeps analysis/ obs-free
    # at import time, try/except keeps the sanitizer non-fatal
    try:
        from ..obs import flightrec
        flightrec.record("lockcheck", **finding)
    except Exception:
        pass


def _path_exists(src: str, dst: str) -> bool:
    """DFS over the recorded edge graph; caller holds _state_lock."""
    seen = {src}
    frontier = [src]
    while frontier:
        cur = frontier.pop()
        if cur == dst:
            return True
        for (a, b) in _edges:
            if a == cur and b not in seen:
                seen.add(b)
                frontier.append(b)
    return False


def _note_acquired(name: str, stack: List[str]) -> None:
    """Called after a top-level (depth 0 -> 1) acquisition succeeds."""
    held = _held_stack()
    thread = threading.current_thread().name
    inversion: Optional[Dict[str, Any]] = None
    with _state_lock:
        st = _stats.setdefault(name, {"acquisitions": 0, "max_hold_s": 0.0})
        st["acquisitions"] += 1
        if held:
            outer = held[-1]
            key = (outer["name"], name)
            rev = (name, outer["name"])
            # inversion: some thread has (or transitively had) the
            # reverse order on record and this edge would close a cycle
            if rev in _edges or _path_exists(name, outer["name"]):
                prior = _edges.get(rev)
                inversion = {
                    "finding": "lock-order-inversion",
                    "first_lock": outer["name"],
                    "second_lock": name,
                    "thread": thread,
                    "first_lock_stack": list(outer["stack"]),
                    "second_lock_stack": list(stack),
                    "reverse_thread": prior["thread"] if prior else "?",
                    "reverse_first_stack":
                        list(prior["outer_stack"]) if prior else [],
                    "reverse_second_stack":
                        list(prior["inner_stack"]) if prior else [],
                }
            e = _edges.setdefault(key, {
                "count": 0, "thread": thread,
                "outer_stack": list(outer["stack"]),
                "inner_stack": list(stack)})
            e["count"] += 1
    held.append({"name": name, "t0": time.perf_counter(), "stack": stack})
    if inversion is not None:
        _emit(inversion)


def _note_released(name: str) -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i]["name"] == name:
            entry = held.pop(i)
            hold_s = time.perf_counter() - entry["t0"]
            with _state_lock:
                st = _stats.setdefault(
                    name, {"acquisitions": 0, "max_hold_s": 0.0})
                if hold_s > st["max_hold_s"]:
                    st["max_hold_s"] = hold_s
            return


def note_host_sync(label: str) -> None:
    """Hot-path hook: call just before a host sync / device wait.

    No-op (one attribute load) when the sanitizer is off.  When on and
    the calling thread holds an instrumented lock, records a
    ``sync-under-lock`` finding with the held locks' acquisition
    stacks and the sync site."""
    if not _enabled:
        return
    held = _held_stack()
    if not held:
        return
    _emit({
        "finding": "sync-under-lock",
        "sync_site": label,
        "thread": threading.current_thread().name,
        "held_locks": [h["name"] for h in held],
        "held_stacks": {h["name"]: list(h["stack"]) for h in held},
        "sync_stack": _capture_stack(),
    })


class _InstrumentedLock:
    """Proxy over Lock/RLock recording order edges and hold times.

    Implements the full CPython Condition protocol (`_release_save`,
    `_acquire_restore`, `_is_owned`) so ``Condition(make_rlock(...))``
    keeps correct held-stack bookkeeping across ``wait()``."""

    __slots__ = ("_inner", "_name", "_reentrant", "_depth")

    def __init__(self, inner: Any, name: str, reentrant: bool) -> None:
        self._inner = inner
        self._name = name
        self._reentrant = reentrant
        self._depth = threading.local()

    @property
    def name(self) -> str:
        return self._name

    def _d(self) -> int:
        return getattr(self._depth, "v", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        stack = _capture_stack()
        got = self._inner.acquire(blocking, timeout)
        if got:
            d = self._d()
            self._depth.v = d + 1
            if d == 0:
                _note_acquired(self._name, stack)
        return got

    def release(self) -> None:
        d = self._d()
        self._inner.release()
        if d > 0:
            self._depth.v = d - 1
            if d == 1:
                _note_released(self._name)

    def __enter__(self) -> "_InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # --- Condition integration -------------------------------------
    def _release_save(self) -> Any:
        d = self._d()
        self._depth.v = 0
        if d > 0:
            _note_released(self._name)
        if hasattr(self._inner, "_release_save"):
            return (d, self._inner._release_save())
        self._inner.release()
        return (d, None)

    def _acquire_restore(self, saved: Any) -> None:
        d, inner_saved = saved
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_saved)
        else:
            self._inner.acquire()
        self._depth.v = d
        if d > 0:
            _note_acquired(self._name, _capture_stack())

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        return self._d() > 0


def make_lock(name: str) -> Any:
    """A mutex named for diagnostics; plain ``threading.Lock`` when the
    sanitizer is off."""
    if not _enabled:
        return threading.Lock()
    return _InstrumentedLock(threading.Lock(), name, reentrant=False)


def make_rlock(name: str) -> Any:
    """A reentrant mutex; plain ``threading.RLock`` when off."""
    if not _enabled:
        return threading.RLock()
    return _InstrumentedLock(threading.RLock(), name, reentrant=True)


def make_condition(name: str) -> threading.Condition:
    """A condition variable whose underlying (reentrant) lock is
    instrumented; plain ``threading.Condition`` when off."""
    if not _enabled:
        return threading.Condition()
    return threading.Condition(
        _InstrumentedLock(threading.RLock(), name, reentrant=True))
