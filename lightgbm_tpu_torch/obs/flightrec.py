"""Flight recorder: the last N structured events, dumped on the way down.

A copy of the JAX package's ``obs/flightrec.py`` (stdlib only).  A
lock-cheap ring keeps the most recent events — dispatches, hot-swaps,
injected faults, signals — and, when something terminal happens, dumps
it atomically (``resilience.atomic``, with a ``.sha256`` sidecar) to
``<dir>/flightrec_r<rank>_<pid>.json``.  The dump's TAIL is the
triggering event: the writer records the trigger and then dumps, so a
post-mortem reads the file backwards from the cause.

Recording cost: one dict build + one ``deque.append`` — no lock on the
record path.  The ring is a ``collections.deque(maxlen=cap)``: append
and eviction are one atomic operation under the GIL, so concurrent
recorders can interleave (events are re-sorted by ``seq`` on read) but
can never grow the buffer past the cap.  The dump lock only serializes
dumps (and the rare capacity changes) against each other.

Dump triggers in the port: a serving dispatcher-thread crash, a refused
hot-swap, a serving process's SIGTERM/SIGINT, a training preemption or
non-finite abort, a detected desync and the gang supervisor's recoveries.
The rank in the file name is obs/dist.py's ``process_index`` (the
``torch.distributed`` world's, else ``LGBM_TPU_PROCESS_ID``, else 0)
unless :func:`set_rank` says otherwise.

The dump directory: ``LGBM_TPU_FLIGHTREC_DIR`` (read at import) wins;
otherwise an entry point calls :func:`configure_dir` (next to the served
model for ``serve_from_config``).  When neither is set, :func:`dump` is a
no-op returning ``None`` — observability never surprises a library
embedder with stray files.
"""

from __future__ import annotations

import collections
import itertools
import os
import time
from typing import Deque, Dict, List, Optional

from ..analysis import lockcheck

SCHEMA = "lightgbm-tpu/flightrec/v1"

DEFAULT_CAP = 256

# read once at import (repo convention for behavior knobs)
_ENV_DIR = os.environ.get("LGBM_TPU_FLIGHTREC_DIR", "")
try:
    _ENV_CAP = int(os.environ.get("LGBM_TPU_FLIGHTREC_CAP",
                                  str(DEFAULT_CAP)))
except ValueError:
    # a malformed knob must not make the whole package unimportable
    _ENV_CAP = DEFAULT_CAP

# the ring: append + oldest-eviction is ONE atomic deque operation, so
# concurrent recorders cannot grow it past the cap (see module docstring)
_EVENTS: Deque[dict] = collections.deque(maxlen=max(1, _ENV_CAP))
# seq via itertools.count: next() is atomic under the GIL, so ids stay
# unique and contiguous across threads
_SEQ = itertools.count()
_STATE: Dict[str, object] = {"dir": _ENV_DIR, "rank": None}
# RLock, not Lock: dump() runs from signal handlers, and a signal
# delivered while the main thread is mid-dump would re-enter a plain
# Lock and self-deadlock
_DUMP_LOCK = lockcheck.make_rlock("flightrec.dump")


def set_rank(rank: Optional[int]) -> None:
    """Explicit rank override for the dump filename (tests/chaos
    simulate multi-rank worlds in one process).  ``None`` restores
    lazy auto-detection."""
    _STATE["rank"] = rank


def _resolve_rank() -> int:
    """The rank baked into the dump filename: the explicit override,
    else obs/dist.py's (the world's, else the launcher env, else 0).
    Guarded: this can run in a signal handler on the way down, and a
    failed rank lookup must never cost the post-mortem."""
    if _STATE.get("rank") is not None:
        return int(_STATE["rank"])  # type: ignore[arg-type]
    try:
        from .dist import process_index

        return process_index()
    except Exception:  # noqa: BLE001
        return 0


def record(kind: str, **fields) -> None:
    """Append one structured event to the ring.  ``kind`` is a short
    snake_case tag; ``fields`` must be JSON-able scalars/strings."""
    ev = {"seq": next(_SEQ), "t_mono": round(time.perf_counter(), 6),
          "unix": round(time.time(), 3), "kind": kind}
    if fields:
        ev.update(fields)
    _EVENTS.append(ev)


def events() -> List[dict]:
    """Chronological copy of the ring's current contents.  Concurrent
    recorders may append out of seq order (mint-then-append is two
    steps); sorting by seq restores the true timeline.  A concurrent
    append invalidates a live deque iterator (RuntimeError), so the
    copy retries — the record rate is per-batch/per-incident, so a
    clean window is always near (and losing the post-mortem to a torn
    copy would defeat the module)."""
    buf: List[dict] = []
    for _ in range(64):
        try:
            buf = list(_EVENTS)
            break
        except RuntimeError:  # deque mutated during iteration
            continue
    else:
        # pathological write storm: element-index reads tolerate
        # concurrent appends (a best-effort partial copy still beats
        # losing the post-mortem)
        for i in range(len(_EVENTS)):
            try:
                buf.append(_EVENTS[i])
            except IndexError:
                break
    return sorted(buf, key=lambda e: e["seq"])


def dropped() -> int:
    """Events that have aged out of the ring (seqs are contiguous, so
    total-recorded minus retained is exact up to a concurrent append)."""
    buf = events()
    if not buf:
        return 0
    return max(0, buf[-1]["seq"] + 1 - len(buf))


def configure_dir(fallback: str) -> str:
    """Entry-point wiring: the env override wins, else ``fallback``.
    Called per run (cli train / serve), so a long-lived test process
    follows each run's artifact directory."""
    d = _ENV_DIR or fallback
    _STATE["dir"] = d
    return d


def set_dump_dir(d: str) -> None:
    """Explicit override (chaos scenarios, tests)."""
    _STATE["dir"] = d


def dump_dir() -> str:
    return str(_STATE["dir"] or "")


def set_capacity(cap: int) -> None:
    """Resize the ring (tests).  Clears it and restarts the seq."""
    global _EVENTS, _SEQ
    if cap < 1:
        raise ValueError(f"flight recorder cap must be >= 1, got {cap}")
    with _DUMP_LOCK:
        _EVENTS = collections.deque(maxlen=int(cap))
        _SEQ = itertools.count()


def reset() -> None:
    global _SEQ
    with _DUMP_LOCK:
        _EVENTS.clear()
        _SEQ = itertools.count()


def dump_path(directory: Optional[str] = None) -> Optional[str]:
    """Rank-tagged dump location: ``flightrec_r<rank>_<pid>.json``.
    On a multi-rank run every rank dumps into the SAME directory
    (shared filesystem or a gathered scratch dir), so the filename must
    carry the rank — pids alone can collide across hosts, and a
    post-mortem that cannot say which rank's ring it reads is useless
    for desync/straggler attribution."""
    d = directory or dump_dir()
    if not d:
        return None
    return os.path.join(
        d, f"flightrec_r{_resolve_rank()}_{os.getpid()}.json")


def dump(reason: str = "", directory: Optional[str] = None
         ) -> Optional[str]:
    """Write the ring to ``<dir>/flightrec_r<rank>_<pid>.json``
    atomically with
    a checksum sidecar.  Returns the path, or None when no directory is
    configured.  NEVER raises — this runs on the way down (signal
    handlers, terminal excepts), and the dump failing must not mask the
    original failure."""
    path = dump_path(directory)
    if path is None:
        return None
    try:
        with _DUMP_LOCK:
            payload = {
                "schema": SCHEMA,
                "pid": os.getpid(),
                "rank": _resolve_rank(),
                "created_unix": round(time.time(), 3),
                "reason": reason,
                "dropped": dropped(),
                "events": events(),
            }
        from ..resilience.atomic import atomic_write_json

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        atomic_write_json(path, payload, checksum=True)
        from . import telemetry

        telemetry.count("flightrec.dumps")
        return path
    except Exception as e:  # noqa: BLE001 — last-gasp writer, see docstring
        try:
            from ..log import Log

            Log.warning(f"flight-recorder dump to {path} failed: "
                        f"{type(e).__name__}: {e}")
        except Exception:  # noqa: BLE001
            pass
        return None
