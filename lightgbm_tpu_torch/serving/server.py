"""Stdlib HTTP/JSON serving front end + in-process client.

A copy of the JAX package's ``serving/server.py`` over the port's
serving stack: a dependency-free transport over the engine, the
micro-batch queue and the hot-swap.  One shared set of API
handlers backs both the HTTP server and :class:`InProcessClient`, so
tier-1 tests exercise exactly the request/response contract the wire
speaks without paying socket overhead, and one HTTP smoke test covers
the transport itself.

Endpoints (JSON in/out unless noted):

=======================  ====================================================
``POST /v1/predict``     ``{"rows": [[...], ...], "raw_score": false,
                         "deadline_ms": 50, "priority": "interactive"}`` ->
                         ``{"predictions": [...], "model_id": ..., "n": N,
                         "trace_id": ..., "stages": {queue_wait_s, pad_s,
                         device_s, scatter_s}}``.  An inbound
                         ``X-LGBM-Trace-Id`` header is honored (adopted as
                         the trace id) and echoed on the response; without
                         one, a fresh id is minted and still echoed.  An
                         ``X-LGBM-Deadline-Ms`` header sets the request
                         deadline (body ``deadline_ms`` wins when both are
                         present).  Admission-control sheds map to
                         429 (queue full/evicted), 503 (draining) and 504
                         (deadline expired in-queue), each carrying
                         ``{"error", "reason", "retry_after_s"}`` plus a
                         ``Retry-After`` header when retrying can help
                         (docs/serving.md retryability table).
``POST /v1/swap``        ``{"model": "/path/to/model.txt"}`` -> swap summary;
                         409 + error on a corrupt/unverifiable candidate
                         (the old model keeps serving)
``GET  /v1/healthz``     readiness payload: engine identity (model_id),
                         seconds since the last model (s)wap, bucket
                         ladder, plus the queue-pressure fields the
                         supervisor and autoscalers share (``state:
                         serving|draining``, ``queue_depth``,
                         ``queue_rows``, ``shed_last_60s``).  200 while
                         serving; 503 once draining (SIGTERM landed) so
                         load balancers stop routing here while in-flight
                         work finishes.
``GET  /v1/stats``       full telemetry snapshot (serving reservoirs incl.
                         request p50/p99, stage breakdowns, batch
                         occupancy, queue depth)
``GET  /metrics``        Prometheus text exposition of the same snapshot
                         (``obs/export.py``) + live gauges (queue depth,
                         swap age) — the scrape endpoint
=======================  ====================================================
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from ..log import Log
from ..obs import RunManifest, telemetry, tracing
from ..obs import export as metrics_export
from ..obs import memory as obs_memory
from ..resilience.atomic import ArtifactCorrupt
from .engine import ServingEngine
from .queue import MicroBatchQueue, RequestShed

_PREDICT_TIMEOUT_S = 120.0


def _shed_payload(e: RequestShed) -> Tuple[int, dict]:
    """One mapping from a typed shed to its wire shape — every
    transport (HTTP, in-process, supervisor) sees the same contract."""
    out = {"error": str(e), "reason": e.reason}
    if e.http_status in (429, 503):  # retrying elsewhere/later helps
        out["retry_after_s"] = round(float(e.retry_after_s), 3)
    return e.http_status, out


# ------------------------------------------------------------- handlers
def _result_payload(values, model_id: str, trace_id: str = "",
                    stages: Optional[dict] = None) -> dict:
    """The one place the predict response shape is built (queue and
    engine-direct paths both) — a new field added here reaches every
    transport."""
    out = {"predictions": np.asarray(values).tolist(),
           "model_id": model_id,
           "n": int(np.asarray(values).shape[0])}
    if trace_id:
        out["trace_id"] = trace_id
        out["stages"] = {k: round(v, 6) for k, v in (stages or {}).items()}
    return out


def api_predict(engine: ServingEngine, queue: MicroBatchQueue,
                payload: dict,
                trace_id: Optional[str] = None,
                deadline_ms: Optional[float] = None) -> Tuple[int, dict]:
    rows = payload.get("rows")
    if rows is None:
        return 400, {"error": "missing 'rows'"}
    try:
        X = np.asarray(rows, dtype=np.float64)
    except (TypeError, ValueError) as e:
        return 400, {"error": f"rows not numeric: {e}"}
    if payload.get("deadline_ms") is not None:
        try:
            deadline_ms = float(payload["deadline_ms"])
        except (TypeError, ValueError) as e:
            return 400, {"error": f"bad deadline_ms: {e}"}
    priority = str(payload.get("priority") or "interactive")
    if queue.state == "draining":
        # one refusal for BOTH paths: the engine-direct branch below
        # bypasses the queue, but a draining replica admits nothing
        from .queue import QueueDraining

        telemetry.count("serving.shed.draining")
        return _shed_payload(QueueDraining(
            "replica is draining; retry on another replica"))
    raw = bool(payload.get("raw_score", False))
    if raw != queue._raw_score:
        # the queue batches homogeneous work; per-request raw_score
        # would force per-request dispatch — serve it engine-direct,
        # but feed the SAME traffic counters/reservoirs the queue path
        # feeds, or /v1/stats and the serving manifest undercount load.
        # The trace rides too: no queue, so queue_wait_s is honestly 0
        # and scatter_s is the transform+serialize residual.
        trace = tracing.mint(trace_id)
        t0 = time.perf_counter()
        try:
            vals, model_id = engine.predict_with_meta(X, raw_score=raw,
                                                      clock=trace)
        except ValueError as e:
            return 400, {"error": str(e)}
        lat = time.perf_counter() - t0
        n = int(np.asarray(vals).shape[0])
        telemetry.count_many({"serving.requests": 1, "serving.rows": n})
        if trace is not None:
            trace.add("queue_wait_s", 0.0)
            trace.add("scatter_s",
                      max(0.0, lat - trace.get("pad_s")
                          - trace.get("device_s")))
            tracing.record_stages(trace,
                                  extra={"serving.request_s": lat})
        else:
            telemetry.record_samples({"serving.request_s": lat})
        return 200, _result_payload(
            vals, model_id,
            trace_id=trace.trace_id if trace is not None else "",
            stages=trace.stages if trace is not None else None)
    try:
        res = queue.predict(X, timeout=_PREDICT_TIMEOUT_S,
                            trace_id=trace_id, deadline_ms=deadline_ms,
                            priority=priority)
    except RequestShed as e:
        return _shed_payload(e)
    except ValueError as e:
        return 400, {"error": str(e)}
    return 200, _result_payload(res.values, res.model_id,
                                trace_id=res.trace_id, stages=res.stages)


def api_swap(engine: ServingEngine, payload: dict,
             require_checksum: bool = True) -> Tuple[int, dict]:
    path = payload.get("model")
    if not path:
        return 400, {"error": "missing 'model' (path to the candidate)"}
    from .hotswap import adopt_model

    try:
        summary = adopt_model(engine, str(path),
                              require_checksum=require_checksum)
    except (ArtifactCorrupt, ValueError) as e:
        # refused: the old model keeps serving — 409 Conflict carries
        # the actionable reason
        return 409, {"error": str(e), "model_id": engine.model_id}
    return 200, summary


def api_health(engine: ServingEngine,
               queue: MicroBatchQueue) -> Tuple[int, dict]:
    """Readiness payload: which model is serving, how long since it was
    (s)wapped in, the bucket ladder, and the queue-pressure fields the
    supervisor and autoscalers share (``state``, ``queue_depth``,
    ``queue_rows``, ``shed_last_60s``).  200 while serving; 503 once
    the replica is draining (the readiness flip load balancers key on —
    in-flight work still finishes behind it)."""
    state = queue.state
    return (200 if state == "serving" else 503), {
        "status": "ok" if state == "serving" else "draining",
        "state": state,
        "queue_depth": queue.depth,
        "queue_rows": queue.pending_rows,
        "max_queue_rows": queue.max_queue_rows,
        "shed_last_60s": queue.shed_last_60s,
        "last_swap_age_s": round(engine.last_swap_age_s, 3),
        **engine.describe()}


def api_stats() -> Tuple[int, dict]:
    return 200, {"telemetry": telemetry.get_telemetry().snapshot()}


def api_metrics(engine: ServingEngine,
                queue: MicroBatchQueue) -> Tuple[int, str]:
    """``GET /metrics``: the whole telemetry snapshot in Prometheus
    text format plus the live gauges a snapshot cannot carry.  Returns
    ``(status, text_body)`` — the one non-JSON endpoint."""
    gauges = {
        "lgbm_serving_queue_depth": (
            queue.depth, "requests waiting in the micro-batch queue"),
        "lgbm_serving_last_swap_age_seconds": (
            round(engine.last_swap_age_s, 3),
            "seconds since the active model was adopted"),
        "lgbm_serving_max_batch_rows": (
            engine.max_batch_rows, "largest serving bucket (rows)"),
        "lgbm_serving_bucket_count": (
            len(engine.buckets), "size of the padded-shape bucket ladder"),
        # fleet/overload pressure gauges (the JAX package's docs/serving.md):
        # STABLE names — the supervisor and dashboards key on them
        "lgbm_serving_state": (
            1 if queue.state == "serving" else 0,
            "1 = serving (admitting), 0 = draining"),
        "lgbm_serving_queue_rows_pending": (
            queue.pending_rows,
            "rows admitted and waiting (bounded by max_queue_rows)"),
        "lgbm_serving_max_queue_rows": (
            queue.max_queue_rows,
            "admission bound in rows (0 = unbounded)"),
        "lgbm_serving_shed_last_60s": (
            queue.shed_last_60s,
            "requests shed in the last 60 seconds (any reason)"),
    }
    # device-memory gauges (obs/memory.py): allocator stats + the
    # owner-tagged live-buffer census, fresh per scrape
    try:
        gauges.update(obs_memory.memory_gauges())
    except Exception:  # never let a census failure take down /metrics
        pass
    body = metrics_export.render_prometheus(
        telemetry.get_telemetry().snapshot(), gauges=gauges)
    return 200, body


class InProcessClient:
    """The tier-1 client: same handlers, no sockets.  Every method
    returns ``(status_code, payload)`` exactly as the HTTP transport
    would (``metrics()`` returns the exposition text, the rest dicts)."""

    def __init__(self, engine: ServingEngine, queue: MicroBatchQueue,
                 require_checksum: bool = True) -> None:
        self.engine = engine
        self.queue = queue
        self.require_checksum = require_checksum

    def predict(self, rows, raw_score: bool = False,
                trace_id: Optional[str] = None,
                deadline_ms: Optional[float] = None,
                priority: str = "interactive") -> Tuple[int, dict]:
        return api_predict(self.engine, self.queue,
                           {"rows": rows, "raw_score": raw_score,
                            "priority": priority},
                           trace_id=trace_id, deadline_ms=deadline_ms)

    def swap(self, model_path: str) -> Tuple[int, dict]:
        return api_swap(self.engine, {"model": model_path},
                        require_checksum=self.require_checksum)

    def health(self) -> Tuple[int, dict]:
        return api_health(self.engine, self.queue)

    def stats(self) -> Tuple[int, dict]:
        return api_stats()

    def metrics(self) -> Tuple[int, str]:
        return api_metrics(self.engine, self.queue)


# -------------------------------------------------------------- server
class _ServingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # the handler reaches these through self.server
    engine: ServingEngine
    queue: MicroBatchQueue
    require_checksum: bool


class _Handler(BaseHTTPRequestHandler):
    server_version = "lightgbm-tpu-serve/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt: str, *args) -> None:
        Log.debug("serve: " + fmt % args)

    def _send(self, code: int, obj: dict,
              extra_headers: Optional[dict] = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str,
                   content_type: str = metrics_export.CONTENT_TYPE) -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        try:
            if self.path == "/v1/healthz":
                self._send(*api_health(self.server.engine,
                                       self.server.queue))
            elif self.path == "/v1/stats":
                self._send(*api_stats())
            elif self.path == "/metrics":
                self._send_text(*api_metrics(self.server.engine,
                                             self.server.queue))
            else:
                self._send(404, {"error": f"unknown path {self.path}"})
        except BrokenPipeError:  # client went away mid-response
            pass
        except Exception as e:  # noqa: BLE001 — a probe must see 500, not a reset
            telemetry.count("serving.http_errors")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def do_POST(self) -> None:  # noqa: N802 — http.server API
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": f"bad JSON body: {e}"})
            return
        try:
            if self.path == "/v1/predict":
                # honor a caller-supplied trace id (invalid/absent ->
                # minted downstream) and echo whatever id the request
                # ended up carrying, so the caller can correlate
                header_tid = self.headers.get("X-LGBM-Trace-Id")
                deadline_ms = None
                hdr_deadline = self.headers.get("X-LGBM-Deadline-Ms")
                if hdr_deadline:
                    try:
                        deadline_ms = float(hdr_deadline)
                    except ValueError:
                        self._send(400, {"error": "bad X-LGBM-Deadline-Ms "
                                                  f"header: {hdr_deadline!r}"})
                        return
                code, out = api_predict(self.server.engine,
                                        self.server.queue, payload,
                                        trace_id=header_tid,
                                        deadline_ms=deadline_ms)
                extra = {}
                echo = out.get("trace_id")
                if echo:
                    extra["X-LGBM-Trace-Id"] = echo
                if out.get("retry_after_s") is not None:
                    # HTTP Retry-After is integer delay-seconds; never
                    # round a positive hint down to "retry immediately"
                    extra["Retry-After"] = str(
                        max(1, math.ceil(float(out["retry_after_s"]))))
                self._send(code, out, extra_headers=extra or None)
            elif self.path == "/v1/swap":
                self._send(*api_swap(
                    self.server.engine, payload,
                    require_checksum=self.server.require_checksum))
            else:
                self._send(404, {"error": f"unknown path {self.path}"})
        except BrokenPipeError:  # client went away mid-response
            pass
        except Exception as e:  # noqa: BLE001 — a request must never kill the server
            telemetry.count("serving.http_errors")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})


class ServingServer:
    """The HTTP front end bound to an engine + queue.  ``port=0`` binds
    an ephemeral port (tests); ``.url`` reports the bound address."""

    def __init__(self, engine: ServingEngine, queue: MicroBatchQueue,
                 host: str = "127.0.0.1", port: int = 0,
                 require_checksum: bool = True) -> None:
        self.engine = engine
        self.queue = queue
        self.httpd = _ServingHTTPServer((host, port), _Handler)
        self.httpd.engine = engine
        self.httpd.queue = queue
        self.httpd.require_checksum = require_checksum
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServingServer":
        """Serve on a background thread (tests / embedding)."""
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="lgbm-serve-http",
            daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Blocking serve (the CLI path)."""
        self.httpd.serve_forever()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(10)
        self.queue.close()


def write_serving_manifest(engine: ServingEngine, path: str,
                           result: Optional[dict] = None) -> str:
    """A serving RunManifest: engine identity + the serving telemetry
    snapshot, with per-request p50/p99 from ``serving.request_s``."""
    manifest = RunManifest.collect(
        "serving", config=None,
        result={**engine.describe(), **(result or {})},
        per_tree_reservoir="serving.request_s",
    )
    return manifest.write(path)


def serve_from_config(cfg, block: bool = True, device=None):
    """Build the serving stack from a ``Config`` (its ``serve_*`` keys)
    and run it on ``device`` (CUDA unless ``"cpu"``); the JAX package's
    ``task=serve`` entry (its CLI is ROADMAP A6).  ``block=False``
    returns the started server (the tier-1 path); ``block=True`` serves
    until SIGINT/SIGTERM, then
    DRAINS — healthz flips to ``draining`` (503), admission closes,
    every admitted request finishes, the flight recorder dumps
    (``reason="drain"``) and the serving manifest is written — and
    returns :data:`~lightgbm_tpu_torch.resilience.EXIT_PREEMPTED` (75), the
    same contract a preempted training run exits with, so one
    supervisor relaunch policy covers both tiers."""
    if not cfg.input_model:
        raise ValueError("input_model should not be empty for serve task")
    import os

    from ..obs import flightrec
    from .hotswap import load_packed_model

    # post-mortems land next to the served model (env override wins)
    flightrec.configure_dir(
        os.path.dirname(os.path.abspath(cfg.input_model)))
    pm = load_packed_model(cfg.input_model,
                           require_checksum=cfg.serve_require_checksum,
                           device=device)
    buckets = None
    if cfg.serve_buckets:
        buckets = [int(x) for x in
                   str(cfg.serve_buckets).replace(",", " ").split()]
    engine = ServingEngine(pm, buckets=buckets,
                           max_batch_rows=cfg.serve_max_batch_rows)
    queue = MicroBatchQueue(engine,
                            max_delay_s=cfg.serve_max_delay_ms / 1000.0,
                            max_queue_rows=cfg.serve_max_queue_rows)
    server = ServingServer(engine, queue, host=cfg.serve_host,
                           port=cfg.serve_port)
    Log.info(
        f"serving model {engine.model_id[:12]} ({pm.num_trees} trees) "
        f"at {server.url} — buckets {list(engine.buckets)}, "
        f"max_delay {cfg.serve_max_delay_ms}ms, "
        f"max_queue_rows {cfg.serve_max_queue_rows}")
    if not block:
        return server.start()

    import signal

    from ..resilience import EXIT_PREEMPTED
    from ..resilience.atomic import atomic_write_json

    stop = threading.Event()

    def _stop(signum, frame):  # noqa: ARG001
        Log.info("serving: shutdown signal received, draining")
        stop.set()

    old_term = signal.signal(signal.SIGTERM, _stop)
    old_int = signal.signal(signal.SIGINT, _stop)
    server.start()
    if cfg.serve_ready_file:
        # a supervisor's readiness signal: atomic, so a reader never
        # sees half a JSON
        atomic_write_json(cfg.serve_ready_file,
                          {"url": server.url, "pid": os.getpid(),
                           "model_id": engine.model_id})
    try:
        stop.wait()
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
        # drain order matters: admission closes FIRST (healthz answers
        # 503/draining from here on), every admitted request finishes,
        # and only then does the HTTP listener go down — a kill window
        # where accepted work is silently dropped must not exist
        depth_at_signal = queue.depth
        queue.begin_drain()
        queue.drain()
        flightrec.record("drain", state=queue.state,
                         queue_depth_at_signal=depth_at_signal,
                         shed_last_60s=queue.shed_last_60s)
        flightrec.dump(reason="drain")
        server.close()
        try:
            mpath = cfg.input_model + ".serving.manifest.json"
            write_serving_manifest(engine, mpath)
            Log.info(f"Wrote serving manifest to {mpath}")
        except Exception as e:  # noqa: BLE001 — best-effort evidence
            Log.warning(f"serving manifest write failed: {e}")
        Log.info("serving: drained; exiting 75 (EX_TEMPFAIL) for the "
                 "supervisor")
    return EXIT_PREEMPTED
