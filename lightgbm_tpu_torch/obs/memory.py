"""Device-memory observability: where the bytes live.

Counterpart of the JAX package's ``obs/memory.py`` for the parts the
training and serving tiers call, on PyTorch's caching allocator:

* ``device_memory_stats()`` — ``torch.cuda.memory_allocated`` /
  ``max_memory_allocated`` / ``memory_reserved`` and the card's
  capacity, normalized to ``hbm_*`` keys.  A process that has not
  touched the card (every CPU run) reads none: ``hbm_stats_supported``
  is false and :func:`memory_gauges` is empty.
* ``register_owner`` / ``live_buffer_census()`` — owners (a training
  booster's ``dataset`` and ``scores``, the serving engine's packed
  model) register a getter of their tensors; the
  registry holds only weakrefs, so it never causes the retention it is
  built to detect.  PyTorch has no list of every live tensor (the JAX
  package walks ``jax.live_arrays()``), so the census covers registered
  owners, and the allocator's own totals cover the rest.
* ``phase_boundary(name)`` — allocator watermarks at the boundaries the
  host sees (``binning``, ``train``, ``serve``, ``swap``).
* OOM post-mortems — ``classify_dispatch_error`` turns a
  ``torch.cuda.OutOfMemoryError`` (or a RESOURCE_EXHAUSTED /
  "out of memory" message, which the fault injector raises) escaping a
  training or serving dispatch into a flight-recorder dump (tail kind
  ``oom``) carrying the last census and, where the caller knows its
  shape, the analytic footprint model's prediction (``obs/memmodel``).

The gauge names are the JAX package's (``lgbm_memory_*``).
"""

from __future__ import annotations

import itertools
import weakref
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from ..analysis import lockcheck

GAUGE_PREFIX = "lgbm_memory_"

# substrings that identify an out-of-device-memory failure in an
# exception's text (torch's allocator says "CUDA out of memory")
OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
               "OOM when allocating")

_lock = lockcheck.make_lock("memory.census")

# token -> (tag, weakref-to-owner, getter); getter(owner) returns an
# iterable of tensors
_owners: Dict[int, Tuple[str, "weakref.ref", Callable[[Any], Any]]] = {}
_owner_counter = itertools.count(1)

# phase -> {"last_bytes", "peak_bytes", "samples"}
_watermarks: Dict[str, Dict[str, Any]] = {}
_last_census: Optional[dict] = None


# ---------------------------------------------------------------------------
# allocator stats

def device_memory_stats(device: Any = None) -> dict:
    """The caching allocator's gauges for one CUDA device: ``hbm_*``
    keys, ``hbm_stats_supported`` false (and zeros) when the process
    has not initialized CUDA.  Never raises."""
    empty = {"hbm_bytes_in_use": 0, "hbm_peak_bytes": 0,
             "hbm_reserved_bytes": 0, "hbm_limit_bytes": 0,
             "hbm_stats_supported": False}
    try:
        if not torch.cuda.is_initialized():
            return empty
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device is None else torch.device(device)
        if dev.type != "cuda":
            return empty
        return {
            "hbm_bytes_in_use": int(torch.cuda.memory_allocated(dev)),
            "hbm_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
            "hbm_reserved_bytes": int(torch.cuda.memory_reserved(dev)),
            "hbm_limit_bytes": int(
                torch.cuda.get_device_properties(dev).total_memory),
            "hbm_stats_supported": True,
        }
    except Exception as e:  # noqa: BLE001 — a gauge must never raise
        return dict(empty, hbm_stats_error=f"{type(e).__name__}: "
                                           f"{str(e)[:120]}")


# ---------------------------------------------------------------------------
# owner registry + census

def register_owner(tag: str, owner: Any,
                   getter: Callable[[Any], Iterable[torch.Tensor]]) -> int:
    """Register ``owner`` as holding device tensors under ``tag``;
    ``getter(owner)`` returns them at census time.  Only a weakref to
    ``owner`` is kept; a dead owner drops out at the next census.
    Returns a token for :func:`unregister_owner`."""
    token = next(_owner_counter)
    with _lock:
        _owners[token] = (str(tag), weakref.ref(owner), getter)
    return token


def unregister_owner(token: int) -> None:
    with _lock:
        _owners.pop(token, None)


def _owner_tensors() -> Iterable[Tuple[str, torch.Tensor]]:
    """(tag, tensor) pairs from live registered owners; drops dead
    weakrefs as it goes."""
    with _lock:
        items = list(_owners.items())
    dead = []
    for token, (tag, ref, getter) in items:
        owner = ref()
        if owner is None:
            dead.append(token)
            continue
        try:
            tensors = list(getter(owner))
        except Exception:  # noqa: BLE001 — a census never raises
            continue
        for t in tensors:
            if isinstance(t, torch.Tensor):
                yield tag, t
    if dead:
        with _lock:
            for token in dead:
                _owners.pop(token, None)


def live_buffer_census(top: int = 16) -> dict:
    """Group the registered owners' tensors by (owner tag, dtype, shape,
    device); a tensor two owners share counts once."""
    global _last_census
    groups: Dict[Tuple[str, str, tuple, str], Dict[str, int]] = {}
    by_owner: Dict[str, Dict[str, int]] = {}
    seen = set()
    total = count = 0
    for tag, t in _owner_tensors():
        key_ptr = (t.device, t.data_ptr(), t.numel())
        if key_ptr in seen:
            continue
        seen.add(key_ptr)
        nbytes = t.numel() * t.element_size()
        total += nbytes
        count += 1
        key = (tag, str(t.dtype).replace("torch.", ""), tuple(t.shape),
               str(t.device))
        g = groups.setdefault(key, {"bytes": 0, "count": 0})
        g["bytes"] += nbytes
        g["count"] += 1
        o = by_owner.setdefault(tag, {"bytes": 0, "buffers": 0})
        o["bytes"] += nbytes
        o["buffers"] += 1
    rows = sorted(
        ({"owner": k[0], "dtype": k[1], "shape": list(k[2]),
          "device": k[3], "count": v["count"], "bytes": v["bytes"]}
         for k, v in groups.items()),
        key=lambda r: (-r["bytes"], r["owner"], r["dtype"]))
    census = {"total_bytes": int(total), "buffers": int(count),
              "by_owner": {k: dict(v) for k, v in sorted(by_owner.items())},
              "groups": rows[:max(0, int(top))], "supported": True}
    _last_census = census
    return census


def last_census() -> Optional[dict]:
    return _last_census


# ---------------------------------------------------------------------------
# host-side phase watermarks

def phase_boundary(phase: str) -> None:
    """Sample the allocator at a host-visible boundary; nothing to
    sample (and nothing recorded) before CUDA is initialized."""
    st = device_memory_stats()
    if not st["hbm_stats_supported"]:
        return
    with _lock:
        w = _watermarks.setdefault(
            phase, {"last_bytes": 0, "peak_bytes": 0, "samples": 0})
        w["last_bytes"] = st["hbm_bytes_in_use"]
        w["peak_bytes"] = max(int(w["peak_bytes"]), st["hbm_peak_bytes"])
        w["samples"] += 1


def watermarks() -> dict:
    with _lock:
        return {k: dict(v) for k, v in sorted(_watermarks.items())}


# ---------------------------------------------------------------------------
# gauges

def memory_gauges(census: Optional[dict] = None) -> dict:
    """Flat ``lgbm_memory_*`` gauge dict for
    :func:`obs.export.render_prometheus` ((value, help) entries); empty
    where the allocator has nothing to report (the CPU)."""
    st = device_memory_stats()
    if not st["hbm_stats_supported"]:
        return {}
    c = census if census is not None else live_buffer_census()
    gauges: Dict[str, Any] = {
        GAUGE_PREFIX + "bytes_in_use": (
            st["hbm_bytes_in_use"],
            "Device allocator bytes currently in use"),
        GAUGE_PREFIX + "peak_bytes": (
            st["hbm_peak_bytes"], "Device allocator peak bytes"),
        GAUGE_PREFIX + "reserved_bytes": (
            st["hbm_reserved_bytes"],
            "Bytes the caching allocator holds from the card"),
        GAUGE_PREFIX + "limit_bytes": (
            st["hbm_limit_bytes"], "Device capacity"),
        GAUGE_PREFIX + "stats_supported": (
            1, "1 when the backend exposes allocator stats"),
        GAUGE_PREFIX + "live_buffer_bytes": (
            c.get("total_bytes", 0),
            "Total bytes of the registered owners' tensors"),
        GAUGE_PREFIX + "live_buffers": (
            c.get("buffers", 0), "Number of the registered owners' tensors"),
    }
    for tag, row in (c.get("by_owner") or {}).items():
        gauges[GAUGE_PREFIX + "owner_bytes_" + str(tag)] = (
            row.get("bytes", 0),
            f"Live bytes owned by census tag '{tag}'")
    return gauges


# ---------------------------------------------------------------------------
# OOM classification + post-mortem

def is_oom_error(exc: BaseException) -> bool:
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = f"{type(exc).__name__}: {exc}"
    return any(marker in msg for marker in OOM_MARKERS)


def oom_postmortem(exc: BaseException, where: str,
                   shape: Optional[dict] = None,
                   predict_params: Optional[dict] = None) -> dict:
    """Record and dump the post-mortem of an OOM at a dispatch boundary
    (flight-recorder tail kind ``oom``): the last census and, with
    ``predict_params``, ``obs/memmodel.predict``'s footprint for the
    failing shape, so the dump says both what was resident and what the
    model expected.  Never raises: a post-mortem that throws inside an
    OOM handler would mask the real failure."""
    from . import flightrec, telemetry

    try:
        census = live_buffer_census()
    except Exception:  # noqa: BLE001
        census = last_census() or {"total_bytes": 0, "buffers": 0,
                                   "by_owner": {}, "groups": []}
    predicted = None
    if predict_params:
        try:
            from . import memmodel

            predicted = memmodel.predict(**predict_params)
        except Exception:  # noqa: BLE001 — as the census
            predicted = None
    event = {
        "where": where,
        "error": f"{type(exc).__name__}: {str(exc)[:400]}",
        "shape": dict(shape or {}),
        "hbm": device_memory_stats(),
        "census": {
            "total_bytes": census.get("total_bytes", 0),
            "buffers": census.get("buffers", 0),
            "by_owner": census.get("by_owner", {}),
            "top": (census.get("groups") or [])[:8],
        },
        "predicted_peak_bytes": (
            predicted.get("peak_bytes") if predicted else None),
        "predicted_phases": (
            predicted.get("phases") if predicted else None),
    }
    try:
        telemetry.count("oom." + where.split(".")[0])
        flightrec.record("oom", **event)
        event["dump_path"] = flightrec.dump("oom")
    except Exception:  # noqa: BLE001
        event.setdefault("dump_path", None)
    return event


def classify_dispatch_error(exc: BaseException, where: str,
                            shape: Optional[dict] = None,
                            predict_params: Optional[dict] = None,
                            ) -> Optional[dict]:
    """Dispatch-boundary hook: post-mortem iff ``exc`` is an OOM.
    Returns the post-mortem event (or None); callers re-raise ``exc``
    either way."""
    if not is_oom_error(exc):
        return None
    return oom_postmortem(exc, where, shape=shape,
                          predict_params=predict_params)
