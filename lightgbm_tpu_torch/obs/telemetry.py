"""Always-on runtime telemetry: spans, counters, reservoirs, histograms.

A copy of the JAX package's ``obs/telemetry.py`` (stdlib only): the
serving tier counts and times through it, and ``/v1/stats`` and
``/metrics`` read its snapshot, so its counter and metric names are the
JAX package's.

* **Near-zero overhead on the hot path.**  A span is two
  ``time.perf_counter()`` calls and two dict operations; a counter is
  one uncontended-lock acquisition and one dict add.  Nothing here
  touches a device tensor or forces a sync.
* **Host wall, not device time.**  A CUDA launch returns before the
  card finishes, so a span around one measures the enqueue; device time
  comes from CUDA events or the profiler (``profile_slice``,
  ``chip_smoke.py``), never from these timers.

Counters the library maintains itself: ``host_syncs`` (deliberate
device->host copies), and the serving tier's ``serving.*`` counters.
The JAX package's XLA counters (``backend_compiles``, the collective
counts of compiled programs) have no counterpart: the port compiles no
programs, and its kernel builds are counted by ``ops/_build.BUILDS``.

Env: ``LGBM_TPU_TELEMETRY`` = ``on`` (default) | ``off`` | ``json``
(``json`` additionally emits one structured JSON line to stderr when an
entry point calls :func:`emit`).  Read once at import; :func:`set_enabled`
is the runtime override.
"""

from __future__ import annotations

import bisect
import json
import sys
import time
from os import environ as _environ
from typing import Dict, List, Optional

from ..analysis import lockcheck

# read once at import — see module docstring
TELEMETRY_MODE = _environ.get("LGBM_TPU_TELEMETRY", "on").strip().lower()

_RESERVOIR_CAP = 4096

# fixed latency buckets (seconds) for Prometheus-style histograms: the
# serving stage clocks span ~0.1 ms (pad on a warm bucket) to seconds
# (a cold dispatch); log-ish spacing keeps the tail resolvable without
# per-request allocation.  STABLE — these boundaries are part of the
# /metrics contract (docs/observability.md), change = new metric name.
DEFAULT_LATENCY_BOUNDS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class SpanStat:
    """Accumulated wall time of one named span (host-wall, see module
    docstring for the async-dispatch caveat)."""

    __slots__ = ("total_s", "count", "min_s", "max_s")

    def __init__(self) -> None:
        self.total_s = 0.0
        self.count = 0
        self.min_s = float("inf")
        self.max_s = 0.0

    def add(self, dt: float) -> None:
        self.total_s += dt
        self.count += 1
        if dt < self.min_s:
            self.min_s = dt
        if dt > self.max_s:
            self.max_s = dt

    def as_dict(self) -> dict:
        return {
            "total_s": round(self.total_s, 6),
            "count": self.count,
            "min_s": round(self.min_s, 6) if self.count else 0.0,
            "max_s": round(self.max_s, 6),
        }


class Reservoir:
    """Sliding window of the most recent ``cap`` samples with p50/p99.

    A ring buffer, not a probabilistic reservoir: per-tree times drift
    (lazy Mosaic compiles early, steady state later), and the question
    the manifest answers is "what does a tree cost NOW", so the window
    deliberately reports the most recent ``cap`` trees.  The total
    sample count is kept so a reader can see how much was windowed out.
    """

    __slots__ = ("cap", "_buf", "_n")

    def __init__(self, cap: int = _RESERVOIR_CAP) -> None:
        self.cap = cap
        self._buf: List[float] = []
        self._n = 0

    def add(self, v: float) -> None:
        if len(self._buf) < self.cap:
            self._buf.append(v)
        else:
            self._buf[self._n % self.cap] = v
        self._n += 1

    def __len__(self) -> int:
        return self._n

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the current window (0 if empty)."""
        if not self._buf:
            return 0.0
        s = sorted(self._buf)
        k = max(0, min(len(s) - 1, int(round(p / 100.0 * (len(s) - 1)))))
        return s[k]

    def clone(self) -> "Reservoir":
        """Cheap copy (one list copy) so percentile sorting can happen
        OUTSIDE the telemetry store lock — a /metrics scrape must not
        stall request-path writers for the duration of ~18 sorts."""
        c = Reservoir(self.cap)
        c._buf = list(self._buf)
        c._n = self._n
        return c

    def as_dict(self, include_samples: bool = False) -> dict:
        window = len(self._buf)
        mean = sum(self._buf) / window if window else 0.0
        out = {
            "count": self._n,
            "window": window,
            "mean_s": round(mean, 6),
            "p50_s": round(self.percentile(50), 6),
            "p99_s": round(self.percentile(99), 6),
            "max_s": round(max(self._buf), 6) if window else 0.0,
        }
        if include_samples:
            # the raw window, in insertion order: cross-rank merging
            # (obs/dist.py) concatenates windows and recomputes exact
            # quantiles — averaging per-rank percentiles would be wrong
            # for any skewed distribution
            start = self._n % self.cap if self._n > self.cap else 0
            ordered = self._buf[start:] + self._buf[:start]
            out["samples"] = [round(v, 6) for v in ordered]
        return out


class Histogram:
    """Fixed-bucket histogram (the Prometheus exposition shape).

    Complements :class:`Reservoir`: the reservoir answers "what do the
    most recent requests cost" (sliding window, exact quantiles); the
    histogram is cumulative over the process lifetime and exports as
    ``_bucket{le=...}/_sum/_count`` series a scraper can rate() and
    aggregate across replicas — which windowed quantiles cannot.
    ``observe`` is one bisect + three adds.
    """

    __slots__ = ("bounds", "counts", "total", "sum")

    def __init__(self, bounds=DEFAULT_LATENCY_BOUNDS) -> None:
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds) or not self.bounds:
            raise ValueError(f"histogram bounds must be sorted and "
                             f"non-empty, got {bounds!r}")
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf bucket
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += 1
        self.sum += v

    def as_dict(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.total, "sum": round(self.sum, 9)}


class _Span:
    """Context manager recording one timed region into a Telemetry."""

    __slots__ = ("_tel", "_name", "_t0")

    def __init__(self, tel: "Telemetry", name: str) -> None:
        self._tel = tel
        self._name = name

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._tel._record_span(self._name, time.perf_counter() - self._t0)


class _NullSpan:
    """Telemetry-off span: enter/exit do nothing at all."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Telemetry:
    """Process-wide telemetry store (counters, spans, reservoirs,
    histograms).

    Every mutation takes the one store lock.  This changed with the
    serving observability PR: the training loop is single-threaded (the
    GIL made torn counts harmless), but the serving tier increments
    from many request threads at once, where ``d[k] = d.get(k) + n``
    LOSES increments and a ``/v1/stats`` snapshot could see the rows
    counter ahead of the requests counter it rode in with.  An
    uncontended ``threading.Lock`` is tens of nanoseconds — re-proven
    below the noise floor by the JAX package's ``tools/telemetry_overhead.py`` — and in
    exchange :meth:`snapshot` is one consistent cut: everything it
    returns was simultaneously true.  Related adds that must move
    together go through :meth:`count_many` (one acquisition).
    """

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        # RLock, not Lock: the preemption path runs flightrec.dump()
        # (which counts) from a SIGNAL HANDLER on the main thread — if
        # the signal interrupted a frame that already holds the store
        # lock, a non-reentrant lock would deadlock the "Ctrl-C twice"
        # abort.  Re-entry can at worst lose the interrupted frame's
        # single increment; a hang needs SIGKILL.
        self._lock = lockcheck.make_rlock("telemetry.store")
        self._counters: Dict[str, float] = {}
        self._spans: Dict[str, SpanStat] = {}
        self._reservoirs: Dict[str, Reservoir] = {}
        self._histograms: Dict[str, Histogram] = {}

    # ------------------------------------------------------------- record
    def span(self, name: str):
        """``with tel.span("bench.timed_loop"): ...`` — host-wall timer."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name)

    def _record_span(self, name: str, dt: float) -> None:
        with self._lock:
            st = self._spans.get(name)
            if st is None:
                st = self._spans.setdefault(name, SpanStat())
            st.add(dt)

    def count(self, name: str, n: float = 1) -> None:
        """Monotonic counter add (no-op when disabled)."""
        if self.enabled:
            with self._lock:
                self._counters[name] = self._counters.get(name, 0) + n

    def count_many(self, adds: Dict[str, float]) -> None:
        """Several counter adds under ONE lock acquisition — for pairs
        that must never be observed half-applied (``serving.requests``
        and ``serving.rows``: a snapshot between two separate adds
        would report traffic whose row count belongs to no request
        count)."""
        if not self.enabled:
            return
        with self._lock:
            for name, n in adds.items():
                self._counters[name] = self._counters.get(name, 0) + n

    def record_value(self, name: str, v: float) -> None:
        """Append one sample to the named reservoir (e.g. per-tree s)."""
        if not self.enabled:
            return
        with self._lock:
            r = self._reservoirs.get(name)
            if r is None:
                r = self._reservoirs.setdefault(name, Reservoir())
            r.add(v)

    def observe(self, name: str, v: float, bounds=None) -> None:
        """One sample into the named fixed-bucket histogram (the
        ``/metrics`` exposition shape; see :class:`Histogram` for why
        this exists next to the reservoirs).  ``bounds`` applies only
        on first touch of a name."""
        if not self.enabled:
            return
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms.setdefault(
                    name, Histogram(bounds or DEFAULT_LATENCY_BOUNDS))
            h.observe(v)

    def _sample_sinks(self, name: str):
        """Get-or-create the (reservoir, histogram) pair a latency
        series feeds.  Caller holds the store lock."""
        r = self._reservoirs.get(name)
        if r is None:
            r = self._reservoirs.setdefault(name, Reservoir())
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms.setdefault(name, Histogram())
        return r, h

    def record_samples(self, samples: Dict[str, float]) -> None:
        """Several latency samples under ONE lock acquisition, each
        feeding its reservoir AND its histogram — the serving scatter
        path records five series per request (four stages + the
        end-to-end), and five-times-two separate acquisitions were the
        dominant tracing cost on the 1-core container (measured by
        the JAX package's ``tools/telemetry_overhead.py --serving``)."""
        if not self.enabled:
            return
        with self._lock:
            for name, v in samples.items():
                r, h = self._sample_sinks(name)
                r.add(v)
                h.observe(v)

    def record_sample_lists(self, samples: Dict[str, List[float]]) -> None:
        """Batch form of :meth:`record_samples`: one lock acquisition
        for a whole coalesced batch's worth of per-request samples —
        the serving dispatcher records once per BATCH, keeping the
        tracing cost on its critical path independent of how many
        requests coalesced."""
        if not self.enabled:
            return
        with self._lock:
            for name, vals in samples.items():
                r, h = self._sample_sinks(name)
                for v in vals:
                    r.add(v)
                    h.observe(v)

    def host_sync(self, n: int = 1) -> None:
        """Record a deliberate device->host materialization point."""
        self.count("host_syncs", n)

    # ------------------------------------------------------------ inspect
    def counter(self, name: str) -> float:
        return self._counters.get(name, 0)

    def reservoir(self, name: str) -> Optional[Reservoir]:
        return self._reservoirs.get(name)

    def span_stat(self, name: str) -> Optional[SpanStat]:
        return self._spans.get(name)

    def histogram(self, name: str) -> Optional[Histogram]:
        return self._histograms.get(name)

    def snapshot(self, include_samples: bool = False) -> dict:
        """ONE consistent cut of everything, as plain JSON-able dicts:
        the store lock is held across the whole copy and every writer
        takes the same lock, so no snapshot can observe one counter of
        a related pair updated and the other not (``/v1/stats`` and
        ``/metrics`` both read through here)."""
        with self._lock:
            counters = dict(self._counters)
            spans = {k: v.as_dict() for k, v in self._spans.items()}
            # clone, don't as_dict: percentile sorting over up-to-4096
            # samples per reservoir happens outside the lock, so a
            # scrape can't stall every request-path writer meanwhile
            res_clones = {k: v.clone() for k, v in self._reservoirs.items()}
            histograms = {k: v.as_dict() for k, v in self._histograms.items()}
        reservoirs = {k: v.as_dict(include_samples=include_samples)
                      for k, v in res_clones.items()}
        return {"counters": counters, "spans": spans,
                "reservoirs": reservoirs, "histograms": histograms}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._spans.clear()
            self._reservoirs.clear()
            self._histograms.clear()

    def emit(self, stream=None) -> None:
        """One JSON line of the full snapshot (``LGBM_TPU_TELEMETRY=json``
        consumers; also the ``verbose>=2`` structured tail)."""
        stream = sys.stderr if stream is None else stream
        print(json.dumps({"lgbm_tpu_telemetry": self.snapshot()},
                         sort_keys=True),
              file=stream, flush=True)


_TELEMETRY = Telemetry(enabled=TELEMETRY_MODE != "off")


def get_telemetry() -> Telemetry:
    """The process-wide singleton every entry point snapshots."""
    return _TELEMETRY


def set_enabled(flag: bool) -> None:
    """Runtime enable/disable (the overhead A/B measurement switch)."""
    _TELEMETRY.enabled = bool(flag)


def enabled() -> bool:
    return _TELEMETRY.enabled


# module-level conveniences bound to the singleton
def span(name: str):
    return _TELEMETRY.span(name)


def count(name: str, n: float = 1) -> None:
    _TELEMETRY.count(name, n)


def count_many(adds: Dict[str, float]) -> None:
    _TELEMETRY.count_many(adds)


def record_value(name: str, v: float) -> None:
    _TELEMETRY.record_value(name, v)


def observe(name: str, v: float, bounds=None) -> None:
    _TELEMETRY.observe(name, v, bounds=bounds)


def record_samples(samples: Dict[str, float]) -> None:
    _TELEMETRY.record_samples(samples)


def record_sample_lists(samples: Dict[str, List[float]]) -> None:
    _TELEMETRY.record_sample_lists(samples)


def host_sync(n: int = 1) -> None:
    _TELEMETRY.host_sync(n)


def emit_if_json(stream=None) -> None:
    """Emit the snapshot line iff LGBM_TPU_TELEMETRY=json (entry points
    call this unconditionally at the end of a run)."""
    if TELEMETRY_MODE == "json":
        _TELEMETRY.emit(stream)
