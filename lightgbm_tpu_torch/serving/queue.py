"""Micro-batched request queue: many small ``submit()``s, one dispatch.

A copy of the JAX package's ``serving/queue.py`` (numpy and threads
only).  Online GBDT traffic is many concurrent 1-64-row requests, and a
dispatch has a fixed cost (the launch, two copies and a sync) whatever
rows it carries.  The queue amortizes that floor structurally: concurrent submits
coalesce into one bucketed engine dispatch under a max-latency /
max-batch policy, and the batched result is scattered back to each
caller's future.

Policy (both knobs, whichever fires first):

* **max_batch_rows** — dispatch as soon as the pending rows fill the
  largest bucket (no point waiting: the batch cannot get cheaper).
* **max_delay_s** — dispatch when the OLDEST pending request has waited
  this long (bounds p99 latency under light traffic; a lone request
  never waits more than one delay window).

A single request larger than ``max_batch_rows`` is dispatched alone —
the engine row-chunks it internally — so oversized callers degrade to
the batch path instead of erroring.

Admission control (the JAX package's docs/serving.md):

* **bounded depth** — ``max_queue_rows`` caps the rows waiting in the
  queue; a submit that would exceed it is refused with
  :class:`QueueFull` (HTTP 429) instead of growing the backlog until
  every request times out.  The bound is enforced at admission, so the
  pending-row count can never exceed it.
* **priority classes** — ``priority="interactive"`` (default) is
  dispatched ahead of ``priority="batch"``, and under pressure the
  queue sheds lowest-first: an interactive submit against a full queue
  evicts queued *batch* requests (their futures fail with
  :class:`QueueFull`) to make room.
* **deadlines** — ``deadline_ms`` bounds how long a request may wait
  end-to-end; a request whose deadline passes while still queued is
  shed with :class:`DeadlineExpired` (HTTP 504) *before* dispatch —
  never dispatched dead.
* **drain** — :meth:`begin_drain` stops admission (submits fail with
  :class:`QueueDraining`, HTTP 503) while everything already admitted
  still dispatches and resolves; :meth:`drain` additionally waits for
  the dispatcher to finish.  ``state`` flips ``serving -> draining``
  for the healthz readiness payload.

Every shed lands in the ``serving.shed.*`` counters (``queue_full`` /
``evicted`` / ``deadline`` / ``draining``, plus ``serving.shed.rows``),
in the flight recorder (event kind ``shed``), and in the 60-second
sliding window behind :attr:`shed_last_60s` (the healthz /
autoscaler pressure signal).

Telemetry: per-request latency lands in the ``serving.request_s``
reservoir (p50/p99 in every serving RunManifest) AND its fixed-bucket
histogram (``/metrics``); each trace stage (queue wait / pad / device /
scatter — ``obs/tracing.py``) feeds its own ``serving.stage.*``
reservoir + histogram; batch shape in ``serving.batch_rows`` /
``serving.batch_occupancy``, queue pressure in ``serving.queue_depth``;
counters ``serving.requests`` / ``.rows`` / ``.batches`` /
``.dispatch_errors``.

Tracing: every ``submit()`` mints (or adopts — the HTTP front end
forwards ``X-LGBM-Trace-Id``) a :class:`~lightgbm_tpu_torch.obs.tracing.
TraceContext`; the resolved :class:`PredictionResult` carries the
trace id and the per-stage breakdown, whose stages sum to the
end-to-end latency by construction (``scatter_s`` is the residual of
real timestamps — the tier-1 pin).

Error contract: an engine failure fails exactly the futures of the
batch that hit it (each with the original exception); the dispatcher
thread itself never dies, so one poisoned request cannot take the
service down.  A dispatcher-thread crash outside the guarded dispatch
(the should-never-happen case) dumps the flight recorder on the way
out (``obs/flightrec.py``).
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np

from ..analysis import lockcheck
from ..obs import flightrec, telemetry, tracing

DEFAULT_MAX_DELAY_S = 0.002

PRIORITIES = ("interactive", "batch")
# sliding window for the healthz/autoscaler shed-pressure signal
SHED_WINDOW_S = 60.0
# _take_batch_or_expired sentinel: "no batch yet, but fail these
# expired futures (outside the lock) and call me again"
_RESWEEP = object()


class RequestShed(RuntimeError):
    """Base of every admission-control rejection.  Carries the HTTP
    mapping (status + Retry-After hint) so every transport — HTTP
    front end, in-process client, fleet supervisor — speaks the same
    contract (docs/serving.md retryability table)."""

    http_status = 503
    reason = "shed"
    #: how long a well-behaved client should wait before retrying
    retry_after_s = 0.05

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        if retry_after_s is not None:
            self.retry_after_s = retry_after_s


class QueueFull(RequestShed):
    """The bounded queue refused (or evicted) this request — the
    service is overloaded.  Retryable after backoff (HTTP 429)."""

    http_status = 429
    reason = "queue_full"


class DeadlineExpired(RequestShed):
    """The request's own deadline passed while it was still queued; it
    was shed in-queue, never dispatched (HTTP 504).  Retrying with the
    same deadline against the same backlog will expire again."""

    http_status = 504
    reason = "deadline"


class QueueDraining(RequestShed):
    """The replica is draining (SIGTERM landed): admission is closed,
    everything already admitted still completes.  Retry on another
    replica immediately (HTTP 503)."""

    http_status = 503
    reason = "draining"


class PredictionResult:
    """What a submitted future resolves to: the values, which model
    answered (hot-swap provenance), the submit->result latency, and the
    trace identity + per-stage breakdown (empty when
    ``LGBM_TPU_TRACING=off``)."""

    __slots__ = ("values", "model_id", "latency_s", "trace_id", "stages")

    def __init__(self, values: np.ndarray, model_id: str,
                 latency_s: float, trace_id: str = "",
                 stages: Optional[Dict[str, float]] = None) -> None:
        self.values = values
        self.model_id = model_id
        self.latency_s = latency_s
        self.trace_id = trace_id
        self.stages = stages if stages is not None else {}

    def __repr__(self) -> str:
        return (f"PredictionResult(n={len(self.values)}, "
                f"model_id={self.model_id[:12]}…, "
                f"latency_s={self.latency_s:.6f}, "
                f"trace_id={self.trace_id[:12]})")


class _Request:
    __slots__ = ("X", "n", "future", "t_submit", "trace", "t_deadline")

    def __init__(self, X: np.ndarray, future: Future,
                 t_submit: float, trace=None,
                 t_deadline: Optional[float] = None) -> None:
        self.X = X
        self.n = X.shape[0]
        self.future = future
        self.t_submit = t_submit
        self.trace = trace
        # perf_counter instant after which dispatching is pointless
        self.t_deadline = t_deadline


class MicroBatchQueue:
    """Coalescing dispatcher in front of a :class:`ServingEngine`."""

    def __init__(self, engine, max_delay_s: float = DEFAULT_MAX_DELAY_S,
                 max_batch_rows: Optional[int] = None,
                 raw_score: bool = False,
                 max_queue_rows: int = 0) -> None:
        if max_delay_s < 0:
            raise ValueError("max_delay_s must be >= 0")
        self._engine = engine
        self._max_delay = float(max_delay_s)
        self._max_rows = int(max_batch_rows or engine.max_batch_rows)
        if self._max_rows < 1:
            raise ValueError("max_batch_rows must be >= 1")
        if max_queue_rows < 0:
            raise ValueError("max_queue_rows must be >= 0 (0 = unbounded)")
        self._max_queue_rows = int(max_queue_rows)
        self._raw_score = bool(raw_score)
        self._cond = lockcheck.make_condition("queue.cond")
        # two admission classes: interactive dispatches first, batch is
        # shed first (docs/serving.md priority semantics)
        self._pending_hi: collections.deque = collections.deque()
        self._pending_lo: collections.deque = collections.deque()
        self._pending_rows = 0
        self._closed = False
        self._draining = False
        # monotonic instants of recent sheds; bounded ring — only the
        # last SHED_WINDOW_S matter, and 4096 sheds/minute is already
        # "the fleet is on fire" territory the counters still cover
        self._shed_times: collections.deque = collections.deque(maxlen=4096)
        self._thread = threading.Thread(
            target=self._loop, name="lgbm-serve-dispatch", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ submit
    def submit(self, X, trace_id: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               priority: str = "interactive") -> Future:
        """Enqueue one request; returns a Future resolving to a
        :class:`PredictionResult`.  The rows are copied to f32 at
        submit time, so the caller may reuse its buffer immediately.
        ``trace_id`` adopts a caller-supplied id (the HTTP header
        path); otherwise one is minted here — submit() IS the trace
        origin, so ``queue_wait_s`` starts now.  ``deadline_ms`` bounds
        the wait: expire in-queue -> :class:`DeadlineExpired`, never
        dispatched.  ``priority`` picks the admission class; admission
        refusals raise :class:`RequestShed` subclasses."""
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, "
                             f"got {priority!r}")
        X = np.ascontiguousarray(np.asarray(X, dtype=np.float32))
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2 or X.shape[0] == 0:
            raise ValueError(
                f"expected a non-empty [n, F] request, got shape {X.shape}")
        nf = self._engine.num_features
        if X.shape[1] != nf:
            raise ValueError(
                f"request has {X.shape[1]} features, serving model "
                f"expects {nf}")
        fut: Future = Future()
        now = time.perf_counter()
        t_deadline = (now + float(deadline_ms) / 1e3
                      if deadline_ms else None)
        req = _Request(X, fut, now, trace=tracing.mint(trace_id),
                       t_deadline=t_deadline)
        evicted: List[_Request] = []
        with self._cond:
            if self._closed or self._draining:
                self._note_shed_locked("draining", 1, req.n)
                raise QueueDraining(
                    "queue is draining; admission closed"
                    if self._draining and not self._closed
                    else "MicroBatchQueue is closed")
            if self._max_queue_rows and \
                    self._pending_rows + req.n > self._max_queue_rows:
                # shed-lowest-first: an interactive arrival may evict
                # queued batch work (newest first — it has waited least)
                if priority == "interactive":
                    while self._pending_lo and \
                            self._pending_rows + req.n > self._max_queue_rows:
                        victim = self._pending_lo.pop()
                        self._pending_rows -= victim.n
                        evicted.append(victim)
                if self._pending_rows + req.n > self._max_queue_rows:
                    # no (or not enough) batch work to shed: refuse the
                    # arrival itself; put any evictions back unharmed
                    for v in reversed(evicted):
                        self._pending_lo.append(v)
                        self._pending_rows += v.n
                    self._note_shed_locked("queue_full",
                                           1, req.n)
                    raise QueueFull(
                        f"queue full: {self._pending_rows} rows pending "
                        f"of {self._max_queue_rows} allowed",
                        retry_after_s=max(0.05, self._max_delay * 2))
                self._note_shed_locked("evicted", len(evicted),
                                       sum(v.n for v in evicted))
            (self._pending_hi if priority == "interactive"
             else self._pending_lo).append(req)
            self._pending_rows += req.n
            self._cond.notify_all()
        for v in evicted:
            exc = QueueFull(
                "evicted by an interactive request under queue pressure",
                retry_after_s=max(0.05, self._max_delay * 4))
            # the victim's wire reason distinguishes "you were refused"
            # from "you were admitted, then displaced" (both 429)
            exc.reason = "evicted"
            self._resolve(v.future, exc=exc)
        # one lock acquisition: a stats/metrics snapshot must never see
        # the request counted but its rows not (or vice versa)
        telemetry.count_many({"serving.requests": 1,
                              "serving.rows": req.n})
        return fut

    def predict(self, X, timeout: float = 60.0,
                trace_id: Optional[str] = None,
                deadline_ms: Optional[float] = None,
                priority: str = "interactive") -> PredictionResult:
        """Blocking convenience: ``submit(X).result(timeout)``."""
        return self.submit(X, trace_id=trace_id, deadline_ms=deadline_ms,
                           priority=priority).result(timeout)

    def _note_shed_locked(self, reason: str, requests: int,
                          rows: int) -> None:
        """Shed bookkeeping (caller holds ``_cond``): the sliding
        window feeding ``shed_last_60s``, the ``serving.shed.*``
        counters, and a flight-recorder event.  telemetry/flightrec
        take only their own internal locks — never this queue's — so
        nesting under ``_cond`` cannot invert an order."""
        if requests <= 0:
            return
        now = time.monotonic()
        for _ in range(requests):
            self._shed_times.append(now)
        telemetry.count_many({"serving.shed." + reason: requests,
                              "serving.shed.rows": rows})
        flightrec.record("shed", reason=reason, requests=requests,
                         rows=rows, pending_rows=self._pending_rows)

    # --------------------------------------------------------- dispatcher
    def _sweep_expired_locked(self) -> List[_Request]:
        """Drop every pending request whose deadline already passed
        (caller holds ``_cond``); returns them for off-lock failure.
        This runs right before batch assembly, so an expired request is
        never dispatched dead — the device slot goes to work someone
        still wants."""
        now = time.perf_counter()
        expired: List[_Request] = []
        for dq in (self._pending_hi, self._pending_lo):
            if not any(r.t_deadline is not None and r.t_deadline <= now
                       for r in dq):
                continue
            keep = [r for r in dq
                    if r.t_deadline is None or r.t_deadline > now]
            dead = [r for r in dq
                    if r.t_deadline is not None and r.t_deadline <= now]
            dq.clear()
            dq.extend(keep)
            expired.extend(dead)
        if expired:
            # invariant: callers hold self._cond (the ``_locked`` suffix
            # contract) — every write to _pending_rows is under that lock
            self._pending_rows -= sum(r.n for r in expired)  # jaxlint: disable=shared-state-unlocked
            self._note_shed_locked("deadline", len(expired),
                                   sum(r.n for r in expired))
        return expired

    def _take_batch(self) -> Optional[List[_Request]]:
        """Block until a batch is due under the policy; pop and return
        it (None = queue closed and drained).  Expired requests are
        shed here, before assembly, and their futures are failed
        PROMPTLY — a caller holding a dead deadline must not also wait
        for the next batch to form before hearing about it."""
        while True:
            batch, expired = self._take_batch_or_expired()
            for r in expired:
                self._resolve(r.future, exc=DeadlineExpired(
                    "deadline expired while queued; request was never "
                    "dispatched"))
            if batch is not _RESWEEP:
                return batch

    def _take_batch_or_expired(self):
        """One blocking pass under ``_cond``: returns ``(batch, [])``
        when a batch is due, ``(None, [])`` when closed and drained, or
        ``(_RESWEEP, expired)`` so the caller can fail expired futures
        outside the lock and come back."""
        with self._cond:
            while True:
                expired = self._sweep_expired_locked()
                if expired:
                    return _RESWEEP, expired
                if not (self._pending_hi or self._pending_lo):
                    if self._closed:
                        return None, []
                    self._cond.wait()
                    continue
                if self._closed or self._draining \
                        or self._pending_rows >= self._max_rows:
                    return self._assemble_locked(), []
                oldest = min(
                    ([self._pending_hi[0].t_submit]
                     if self._pending_hi else []) +
                    ([self._pending_lo[0].t_submit]
                     if self._pending_lo else []))
                remaining = oldest + self._max_delay - time.perf_counter()
                if remaining <= 0:
                    return self._assemble_locked(), []
                # wake for whichever comes first: the batch window
                # closing or the earliest pending deadline expiring
                deadlines = [r.t_deadline
                             for dq in (self._pending_hi, self._pending_lo)
                             for r in dq if r.t_deadline is not None]
                if deadlines:
                    remaining = min(remaining,
                                    min(deadlines) - time.perf_counter())
                self._cond.wait(max(remaining, 0.0005))

    def _assemble_locked(self) -> List[_Request]:
        """Pop the next batch (caller holds ``_cond``): interactive
        first, then batch-priority riders while they still fit."""
        telemetry.record_value(
            "serving.queue_depth",
            len(self._pending_hi) + len(self._pending_lo))
        batch: List[_Request] = []
        rows = 0
        full = False
        for dq in (self._pending_hi, self._pending_lo):
            while dq:
                nxt = dq[0]
                if batch and rows + nxt.n > self._max_rows:
                    # the batch is full: stop entirely — a smaller
                    # batch-priority rider must not leapfrog the
                    # interactive request that did not fit
                    full = True
                    break
                batch.append(dq.popleft())
                rows += nxt.n
            if full:
                break
        self._pending_rows -= rows
        return batch

    def _loop(self) -> None:
        try:
            while True:
                batch = self._take_batch()
                if batch is None:
                    return
                self._dispatch(batch)
        except BaseException as e:  # noqa: BLE001 — the should-never-happen path
            # _dispatch already contains every per-batch failure; an
            # exception HERE means the dispatcher itself is dying and
            # the service is down — leave the post-mortem on the way out
            flightrec.record("dispatcher_crash",
                             error=f"{type(e).__name__}: {e}")
            flightrec.dump(reason="dispatcher_crash")
            raise

    @staticmethod
    def _resolve(fut: Future, result=None, exc=None) -> None:
        """Resolve a future that a client may have cancel()ed while it
        was pending — set_result/set_exception raise InvalidStateError
        on a cancelled future, and that must fail the one request, not
        the dispatcher thread."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except Exception:  # noqa: BLE001 — cancelled mid-flight
            telemetry.count("serving.cancelled")

    def _dispatch(self, batch: List[_Request]) -> None:
        rows = sum(r.n for r in batch)
        # t0 closes every rider's queue_wait_s and opens the batch's
        # dispatch window; pad_s/device_s are measured inside it by the
        # engine, and scatter_s is the window's residual at each
        # request's resolution — so the four stages sum EXACTLY to the
        # end-to-end latency (the tier-1 pin; docs/observability.md)
        t0 = time.perf_counter()
        clock = tracing.StageClock() if any(r.trace for r in batch) else None
        try:
            X = (batch[0].X if len(batch) == 1
                 else np.concatenate([r.X for r in batch], axis=0))
            vals, model_id = self._engine.predict_with_meta(
                X, raw_score=self._raw_score, clock=clock)
        except BaseException as e:  # noqa: BLE001 — fail the batch, not the service
            telemetry.count("serving.dispatch_errors")
            flightrec.record("dispatch_error", rows=rows,
                             requests=len(batch),
                             error=f"{type(e).__name__}: {e}")
            for r in batch:
                self._resolve(r.future, exc=e)
            return
        t1 = time.perf_counter()
        pad_s = clock.get("pad_s") if clock is not None else 0.0
        device_s = clock.get("device_s") if clock is not None else 0.0
        flightrec.record("dispatch", rows=rows, requests=len(batch),
                         model_id=model_id[:16],
                         device_ms=round(device_s * 1e3, 3))
        lo = 0
        # per-request samples accumulate host-side and commit in ONE
        # store-lock acquisition after the scatter: the dispatcher's
        # critical path pays a fixed tracing cost per batch, not per
        # coalesced request (the JAX package's tools/telemetry_overhead.py --serving
        # A/B is the proof this stays below run-to-run noise)
        samples: Dict[str, List[float]] = {"serving.request_s": []}
        for r in batch:
            out = vals[lo:lo + r.n]
            lo += r.n
            tr = r.trace
            t_res = time.perf_counter()
            lat = t_res - r.t_submit
            samples["serving.request_s"].append(lat)
            if tr is not None:
                tr.add("queue_wait_s", max(0.0, t0 - r.t_submit))
                tr.add("pad_s", pad_s)
                tr.add("device_s", device_s)
                tr.add("scatter_s",
                       max(0.0, (t_res - t0) - pad_s - device_s))
                for k, v in tr.stages.items():
                    samples.setdefault(
                        tracing.STAGE_METRIC_PREFIX + k, []).append(v)
                result = PredictionResult(out, model_id, lat,
                                          trace_id=tr.trace_id,
                                          stages=dict(tr.stages))
            else:
                result = PredictionResult(out, model_id, lat)
            self._resolve(r.future, result)
        telemetry.record_sample_lists(samples)
        telemetry.count("serving.batches")
        telemetry.record_value("serving.batch_rows", rows)
        telemetry.record_value("serving.dispatch_s", t1 - t0)

    # ------------------------------------------------------------- close
    def begin_drain(self) -> None:
        """Stop admission (new submits fail with
        :class:`QueueDraining`) while everything already admitted still
        dispatches; ``state`` flips to ``draining`` so healthz and the
        supervisor see it.  Idempotent; does not block."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def drain(self, timeout: float = 30.0) -> None:
        """Graceful drain: :meth:`begin_drain`, then finish every
        admitted request and join the dispatcher (the SIGTERM path —
        docs/serving.md drain contract)."""
        self.begin_drain()
        self.close(timeout)

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, drain what is pending, join the
        dispatcher.  Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)

    def __enter__(self) -> "MicroBatchQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._pending_hi) + len(self._pending_lo)

    @property
    def pending_rows(self) -> int:
        """Rows currently admitted and waiting (the bounded quantity)."""
        with self._cond:
            return self._pending_rows

    @property
    def max_queue_rows(self) -> int:
        return self._max_queue_rows

    @property
    def state(self) -> str:
        """``serving`` or ``draining`` — the healthz readiness field."""
        with self._cond:
            return ("draining" if self._draining or self._closed
                    else "serving")

    @property
    def shed_last_60s(self) -> int:
        """Requests shed in the last 60 s (any reason) — the queue-
        pressure signal healthz exports for supervisors/autoscalers."""
        cutoff = time.monotonic() - SHED_WINDOW_S
        with self._cond:
            return sum(1 for t in self._shed_times if t > cutoff)

    @property
    def dispatcher_alive(self) -> bool:
        """False once the dispatcher thread has exited (after close/
        drain, or the should-never-happen crash path)."""
        return self._thread.is_alive()
