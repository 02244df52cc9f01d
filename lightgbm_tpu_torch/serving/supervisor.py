"""Replica supervisor: the serving fleet's resilience layer.

A copy of the JAX package's ``serving/supervisor.py`` over the port's
serving stack (whose dispatches are kernel P1, ``ops/cuda_predict.py``
→ ``csrc/predict.cu``).  ``task=serve`` gives one replica that drains
gracefully and exits 75 when preempted; this module is the other half,
the thing that *notices* and relaunches:

* :class:`SubprocessReplica` — one ``python -m lightgbm_tpu_torch
  task=serve`` subprocess on an ephemeral port, on the card as every
  entry point of the port; readiness via the atomic
  ``serve_ready_file`` JSON ({url, pid, model_id}) plus a 200 healthz.
* :class:`ThreadReplica`  — the in-process analog (engine + queue +
  HTTP server on threads) on any ``device`` (the tests run it with
  ``"cpu"``); ``kill()`` tears the listener down abruptly, the closest
  in-process stand-in for SIGKILL.
* :class:`ReplicaSupervisor` — owns N replicas: health-checks
  readiness, restarts crashed/preempted replicas with jittered
  exponential backoff (``resilience/retry.backoff_delay``; fails the
  whole fleet loudly once the restart budget is spent — a crash loop
  must page, not spin), round-robins requests with ONE bounded retry on
  a different replica for 503 / connection-reset (a replica kill under
  load loses zero requests), and scales between min/max replicas off
  the healthz queue-depth gauge.
* :class:`FleetFrontEnd` — the fleet's own HTTP door
  (``task=serve_fleet``): ``POST /v1/predict`` proxies through the
  supervisor's routing, ``GET /v1/healthz`` reports per-replica state.

Retryability contract: transport errors and 503 (draining replica) are
retried once on a *different* replica — the prediction is pure, so the
retry is idempotent by construction; 429 (overload) and 504 (deadline)
are returned to the caller untouched, because a second replica of the
same overloaded fleet is not relief and a dead deadline stays dead.

Every lock here comes from ``analysis/lockcheck.py`` factories, so the
whole layer can run under the runtime lock sanitizer.
"""

from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis import lockcheck
from ..log import Log
from ..obs import flightrec, telemetry
from ..resilience import retry

#: consecutive failed health checks before a live process is declared
#: wedged and restarted anyway
HEALTH_FAIL_LIMIT = 3
#: consecutive idle monitor rounds (zero depth, zero shed) before one
#: replica above the floor is drained away
SCALE_DOWN_ROUNDS = 20


class FleetRequestFailed(RuntimeError):
    """The primary attempt AND the one bounded retry both failed."""


class FleetBudgetExhausted(RuntimeError):
    """The supervisor spent its restart budget — the fleet is failed
    loudly instead of masking a crash loop."""


def _http_json(method: str, url: str, payload: Optional[dict] = None,
               headers: Optional[dict] = None,
               timeout: float = 30.0) -> Tuple[int, dict]:
    """Minimal stdlib JSON client.  Returns ``(status, payload)`` for
    any HTTP response (including 4xx/5xx); raises ``OSError`` /
    ``http.client.HTTPException`` only for transport failures
    (connection refused/reset, timeout) — the retryable class."""
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:  # a real response, not transport
        try:
            body = json.loads(e.read() or b"{}")
        except (ValueError, OSError):
            body = {"error": str(e)}
        return e.code, body


class SubprocessReplica:
    """One ``task=serve`` subprocess on an ephemeral port."""

    def __init__(self, model_path: str, replica_id: int, workdir: str,
                 host: str = "127.0.0.1",
                 extra_args: Tuple[str, ...] = (),
                 env: Optional[dict] = None) -> None:
        self.model_path = model_path
        self.replica_id = replica_id
        self.workdir = workdir
        self.host = host
        self.extra_args = tuple(extra_args)
        self.env = dict(env or {})
        self.ready_file = os.path.join(
            workdir, f"replica_{replica_id}.ready.json")
        self.url: str = ""
        self.pid: Optional[int] = None
        self._proc: Optional[subprocess.Popen] = None
        self._log_fh = None

    def start(self) -> "SubprocessReplica":
        for leftover in (self.ready_file, self.ready_file + ".sha256"):
            if os.path.exists(leftover):
                os.unlink(leftover)
        self._log_fh = open(os.path.join(
            self.workdir, f"replica_{self.replica_id}.log"), "ab")
        args = [sys.executable, "-u", "-m", "lightgbm_tpu_torch",
                "task=serve", f"input_model={self.model_path}",
                f"serve_host={self.host}", "serve_port=0",
                f"serve_ready_file={self.ready_file}",
                *self.extra_args]
        # the replica runs on the card, as every entry point of the port
        self._proc = subprocess.Popen(
            args, stdout=self._log_fh, stderr=subprocess.STDOUT,
            env={**os.environ, **self.env})
        self.pid = self._proc.pid
        return self

    def wait_ready(self, timeout: float = 90.0) -> None:
        """Block until the ready file lands AND healthz answers 200."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.exit_code() is not None:
                raise RuntimeError(
                    f"replica {self.replica_id} exited rc="
                    f"{self.exit_code()} before becoming ready (log: "
                    f"replica_{self.replica_id}.log)")
            if os.path.exists(self.ready_file):
                try:
                    with open(self.ready_file) as fh:
                        info = json.load(fh)
                    self.url = info["url"]
                    code, _ = _http_json("GET", self.url + "/v1/healthz",
                                         timeout=5.0)
                    if code == 200:
                        return
                except (ValueError, KeyError, OSError,
                        http.client.HTTPException):
                    pass
            time.sleep(0.05)
        raise TimeoutError(
            f"replica {self.replica_id} not ready after {timeout}s")

    def exit_code(self) -> Optional[int]:
        return self._proc.poll() if self._proc is not None else None

    def kill(self) -> None:
        """SIGKILL — the chaos path; no drain, no goodbye."""
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()

    def terminate(self, timeout: float = 30.0) -> Optional[int]:
        """SIGTERM -> graceful drain -> (expected) exit 75."""
        if self._proc is None:
            return None
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait(10)
        if self._log_fh is not None:
            self._log_fh.close()
            self._log_fh = None
        return self._proc.returncode


class ThreadReplica:
    """In-process replica (engine + queue + real HTTP server on
    threads) on ``device`` (the card unless ``"cpu"``): what the tests
    supervise.  ``kill()`` closes the HTTP listener without draining —
    in-flight work dies with it, new connections get refused — the
    in-process analog of SIGKILL."""

    def __init__(self, model_path: str, replica_id: int,
                 max_batch_rows: int = 64,
                 max_queue_rows: int = 0,
                 max_delay_s: float = 0.001,
                 require_checksum: bool = False, device=None) -> None:
        self.model_path = model_path
        self.replica_id = replica_id
        self.device = device
        self._kwargs = dict(max_batch_rows=max_batch_rows,
                            max_queue_rows=max_queue_rows,
                            max_delay_s=max_delay_s,
                            require_checksum=require_checksum)
        self.url: str = ""
        self.pid: Optional[int] = os.getpid()
        self._server = None
        self._exit: Optional[int] = None

    def start(self) -> "ThreadReplica":
        from .engine import ServingEngine
        from .queue import MicroBatchQueue
        from .server import ServingServer

        engine = ServingEngine(
            self.model_path,
            max_batch_rows=self._kwargs["max_batch_rows"],
            require_checksum=self._kwargs["require_checksum"],
            device=self.device)
        queue = MicroBatchQueue(
            engine, max_delay_s=self._kwargs["max_delay_s"],
            max_queue_rows=self._kwargs["max_queue_rows"])
        self._server = ServingServer(engine, queue, port=0).start()
        self.url = self._server.url
        return self

    def wait_ready(self, timeout: float = 30.0) -> None:
        code, _ = _http_json("GET", self.url + "/v1/healthz",
                             timeout=timeout)
        if code != 200:
            raise RuntimeError(f"replica {self.replica_id} healthz {code}")

    def exit_code(self) -> Optional[int]:
        return self._exit

    def kill(self) -> None:
        if self._server is not None and self._exit is None:
            self._exit = 1
            # abrupt: listener down, queue NOT drained — a crash
            self._server.httpd.shutdown()
            self._server.httpd.server_close()

    def terminate(self, timeout: float = 30.0) -> Optional[int]:
        if self._server is not None and self._exit is None:
            self._exit = 75
            self._server.queue.drain(timeout)
            self._server.close()
        return self._exit


class _Slot:
    """One supervised replica position (the handle changes across
    restarts, the slot identity does not)."""

    __slots__ = ("slot_id", "handle", "restart_count", "health_fails",
                 "suspect", "last_depth", "backoff_history")

    def __init__(self, slot_id: int, handle) -> None:
        self.slot_id = slot_id
        self.handle = handle
        self.restart_count = 0
        self.health_fails = 0
        self.suspect = False
        self.last_depth = 0
        self.backoff_history: List[float] = []


class ReplicaSupervisor:
    """Owns N replicas: readiness, restarts, routing, scaling."""

    def __init__(self, factory: Callable[[int], object],
                 replicas: int = 2, max_replicas: int = 0,
                 restart_budget: int = 8,
                 backoff_base_s: float = 0.2,
                 backoff_max_s: float = 5.0,
                 health_interval_s: float = 0.5,
                 ready_timeout_s: float = 90.0,
                 request_timeout_s: float = 30.0,
                 scale_up_depth: int = 64,
                 seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if max_replicas and max_replicas < replicas:
            raise ValueError("max_replicas must be 0 or >= replicas")
        self._factory = factory
        self._min = int(replicas)
        self._max = int(max_replicas or replicas)
        self._budget = int(restart_budget)
        self._backoff_base = float(backoff_base_s)
        self._backoff_max = float(backoff_max_s)
        self._interval = float(health_interval_s)
        self._ready_timeout = float(ready_timeout_s)
        self._req_timeout = float(request_timeout_s)
        self._scale_up_depth = int(scale_up_depth)
        self._sleep = sleep
        # deterministic jitter (a seed reproduces the schedule)
        import random

        self._rng = random.Random(seed)
        self._lock = lockcheck.make_lock("supervisor.state")
        self._slots: List[_Slot] = []
        self._next_slot_id = 0
        self._rr = 0
        self._restarts_total = 0
        self._idle_rounds = 0
        self._failed: Optional[BaseException] = None
        self._stop = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ReplicaSupervisor":
        handles = []
        for _ in range(self._min):
            handles.append(self._spawn())
        for slot in handles:
            slot.handle.wait_ready(self._ready_timeout)
        self._monitor_thread = threading.Thread(
            target=self._monitor, name="lgbm-fleet-monitor", daemon=True)
        self._monitor_thread.start()
        Log.info(f"fleet: {len(handles)} replica(s) ready — "
                 + ", ".join(s.handle.url for s in handles))
        return self

    def _spawn(self) -> _Slot:
        with self._lock:
            slot_id = self._next_slot_id
            self._next_slot_id += 1
        handle = self._factory(slot_id)
        handle.start()
        slot = _Slot(slot_id, handle)
        with self._lock:
            self._slots.append(slot)
        return slot

    def stop(self) -> None:
        """Graceful fleet shutdown: SIGTERM every replica (each drains
        and exits 75), join the monitor."""
        self._stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(30)
        with self._lock:
            slots = list(self._slots)
            self._slots = []
        for slot in slots:
            try:
                slot.handle.terminate()
            except Exception as e:  # noqa: BLE001 — keep tearing down
                Log.warning(f"fleet: replica {slot.slot_id} terminate "
                            f"failed: {e}")

    # ------------------------------------------------------------- routing
    def predict(self, payload: dict,
                headers: Optional[dict] = None) -> Tuple[int, dict]:
        """Route one predict through the fleet: round-robin a healthy
        replica; on 503 or a transport error, retry ONCE on a
        *different* replica (pure inference — idempotent by
        construction).  Returns the replica's ``(status, payload)``;
        raises :class:`FleetRequestFailed` when both attempts die on
        transport."""
        if self._failed is not None:
            raise FleetBudgetExhausted(str(self._failed))
        telemetry.count("serving.fleet.requests")
        first = self._pick(exclude=None)
        if first is None:
            raise FleetRequestFailed("no live replica to route to")
        status, body, transport_err = self._attempt(first, payload,
                                                    headers)
        if status is not None and status != 503:
            return status, body
        # retryable: 503 (draining) or transport failure
        telemetry.count("serving.fleet.retries")
        second = self._pick(exclude=first)
        if second is None:
            if status is not None:
                return status, body
            raise FleetRequestFailed(
                f"replica unreachable ({transport_err}) and no peer to "
                "retry on")
        status2, body2, transport_err2 = self._attempt(second, payload,
                                                       headers)
        if status2 is not None:
            return status2, body2
        raise FleetRequestFailed(
            "both attempts failed on transport: "
            f"{transport_err} / {transport_err2}")

    def _attempt(self, slot: _Slot, payload: dict,
                 headers: Optional[dict]):
        """One HTTP attempt -> ``(status, body, None)`` or
        ``(None, None, error)`` on transport failure (the replica is
        marked suspect so the router skips it until health-checked)."""
        try:
            status, body = _http_json(
                "POST", slot.handle.url + "/v1/predict", payload,
                headers=headers, timeout=self._req_timeout)
            return status, body, None
        except (OSError, http.client.HTTPException) as e:
            with self._lock:
                slot.suspect = True
            flightrec.record("fleet_attempt_failed",
                             slot=slot.slot_id,
                             error=f"{type(e).__name__}: {e}")
            return None, None, f"{type(e).__name__}: {e}"

    def _pick(self, exclude: Optional[_Slot]) -> Optional[_Slot]:
        """Round-robin over live, non-suspect slots; suspects (and the
        excluded first-attempt slot) are skipped while any healthy peer
        exists."""
        with self._lock:
            candidates = [s for s in self._slots
                          if s is not exclude
                          and s.handle.exit_code() is None]
            healthy = [s for s in candidates if not s.suspect]
            pool = healthy or candidates
            if not pool:
                return None
            self._rr += 1
            return pool[self._rr % len(pool)]

    # ------------------------------------------------------------ monitoring
    def _monitor(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self._monitor_round()
            except FleetBudgetExhausted:
                return  # failed loudly; predict() now raises
            except Exception as e:  # noqa: BLE001 — monitor must survive
                Log.warning(f"fleet monitor: {type(e).__name__}: {e}")

    def _monitor_round(self) -> None:
        with self._lock:
            slots = list(self._slots)
        depths: List[int] = []
        shed = 0
        for slot in slots:
            if self._stop.is_set():
                return
            code = None
            try:
                code, health = _http_json(
                    "GET", slot.handle.url + "/v1/healthz", timeout=5.0)
            except (OSError, http.client.HTTPException):
                health = {}
            dead = slot.handle.exit_code() is not None
            if code == 200:
                slot.health_fails = 0
                with self._lock:
                    slot.suspect = False
                slot.last_depth = int(health.get("queue_depth") or 0)
                depths.append(slot.last_depth)
                shed += int(health.get("shed_last_60s") or 0)
            elif not dead:
                slot.health_fails += 1
                dead = slot.health_fails >= HEALTH_FAIL_LIMIT
                if dead:
                    Log.warning(
                        f"fleet: replica {slot.slot_id} failed "
                        f"{slot.health_fails} health checks — declaring "
                        "it wedged")
                    slot.handle.kill()
            if dead:
                self._restart(slot)
        self._maybe_scale(depths, shed)

    def _restart(self, slot: _Slot) -> None:
        """Replace a dead replica, with jittered exponential backoff;
        past the budget, fail the FLEET loudly (flight-recorder dump +
        monitor exit) instead of masking a crash loop."""
        with self._lock:
            self._restarts_total += 1
            total = self._restarts_total
        rc = slot.handle.exit_code()
        if total > self._budget:
            err = FleetBudgetExhausted(
                f"restart budget exhausted ({self._budget}): replica "
                f"{slot.slot_id} died rc={rc} and the fleet will not "
                "mask a crash loop")
            with self._lock:
                self._failed = err
            flightrec.record("fleet_budget_exhausted",
                             budget=self._budget, slot=slot.slot_id,
                             last_rc=rc)
            flightrec.dump(reason="fleet_budget_exhausted")
            Log.warning(str(err))
            raise err
        delay = retry.backoff_delay(slot.restart_count,
                                    base_s=self._backoff_base,
                                    max_s=self._backoff_max, rng=self._rng)
        slot.restart_count += 1
        slot.backoff_history.append(delay)
        kind = "preempted" if rc == 75 else "crashed"
        Log.warning(f"fleet: replica {slot.slot_id} {kind} (rc={rc}); "
                    f"restart {total}/{self._budget} in {delay:.2f}s")
        telemetry.count("serving.fleet.restarts")
        flightrec.record("replica_restart", slot=slot.slot_id,
                         rc=rc, attempt=total, backoff_s=round(delay, 3))
        self._sleep(delay)
        handle = self._factory(slot.slot_id)
        handle.start()
        handle.wait_ready(self._ready_timeout)
        with self._lock:
            slot.handle = handle
            slot.suspect = False
            slot.health_fails = 0

    # -------------------------------------------------------------- scaling
    @staticmethod
    def scale_decision(depths: List[int], shed_last_60s: int,
                       current: int, minimum: int, maximum: int,
                       up_depth: int, idle_rounds: int) -> str:
        """Pure policy (unit-testable): ``"up"`` when the fleet-mean
        queue depth crosses ``up_depth`` or anything was shed in the
        last minute and there is headroom; ``"down"`` after
        ``SCALE_DOWN_ROUNDS`` consecutive idle rounds above the floor;
        else ``"hold"``."""
        if current < minimum:
            return "up"
        mean_depth = (sum(depths) / len(depths)) if depths else 0.0
        if current < maximum and (mean_depth >= up_depth
                                  or shed_last_60s > 0):
            return "up"
        if current > minimum and idle_rounds >= SCALE_DOWN_ROUNDS:
            return "down"
        return "hold"

    def _maybe_scale(self, depths: List[int], shed: int) -> None:
        with self._lock:
            current = len(self._slots)
        idle = bool(depths) and max(depths) == 0 and shed == 0
        self._idle_rounds = self._idle_rounds + 1 if idle else 0
        decision = self.scale_decision(
            depths, shed, current, self._min, self._max,
            self._scale_up_depth, self._idle_rounds)
        if decision == "up" and current < self._max:
            Log.info(f"fleet: scaling up {current} -> {current + 1} "
                     f"(mean depth {sum(depths) / max(len(depths), 1):.0f}, "
                     f"shed_60s {shed})")
            telemetry.count("serving.fleet.scale_up")
            slot = self._spawn()
            slot.handle.wait_ready(self._ready_timeout)
            self._idle_rounds = 0
        elif decision == "down" and current > self._min:
            with self._lock:
                slot = self._slots.pop()
            Log.info(f"fleet: scaling down {current} -> {current - 1} "
                     f"(idle {self._idle_rounds} rounds)")
            telemetry.count("serving.fleet.scale_down")
            slot.handle.terminate()
            self._idle_rounds = 0

    # --------------------------------------------------------------- chaos
    def chaos_kill(self, index: int = 0) -> int:
        """Kill one replica ungracefully (SIGKILL / abrupt listener
        teardown) — the fault-injection hook the fleet tests and
        ``chip_smoke.py`` drive; returns the killed slot id."""
        with self._lock:
            slot = self._slots[index]
        Log.warning(f"fleet: CHAOS killing replica {slot.slot_id}")
        slot.handle.kill()
        return slot.slot_id

    # ------------------------------------------------------------- status
    @property
    def restarts_total(self) -> int:
        with self._lock:
            return self._restarts_total

    @property
    def failed(self) -> Optional[BaseException]:
        with self._lock:
            return self._failed

    @property
    def num_replicas(self) -> int:
        with self._lock:
            return len(self._slots)

    def describe(self) -> dict:
        with self._lock:
            slots = list(self._slots)
            restarts = self._restarts_total
            failed = self._failed
        replicas = []
        for slot in slots:
            replicas.append({
                "slot": slot.slot_id,
                "url": slot.handle.url,
                "pid": slot.handle.pid,
                "suspect": slot.suspect,
                "queue_depth": slot.last_depth,
                "restarts": slot.restart_count,
            })
        return {"replicas": replicas, "restarts_total": restarts,
                "restart_budget": self._budget,
                "failed": str(failed) if failed else None,
                "min_replicas": self._min, "max_replicas": self._max}


# ---------------------------------------------------------------- front end
class FleetFrontEnd:
    """The fleet's HTTP door: predicts proxy through the supervisor's
    routing (so external clients get the retry-on-other-replica
    guarantee too), healthz reports the whole fleet."""

    def __init__(self, supervisor: ReplicaSupervisor,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        sup = supervisor

        class _FleetHandler(BaseHTTPRequestHandler):
            server_version = "lightgbm-tpu-fleet/1"
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt: str, *args) -> None:
                Log.debug("fleet: " + fmt % args)

            def _send(self, code: int, obj: dict) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 — http.server API
                if self.path == "/v1/healthz":
                    d = sup.describe()
                    self._send(503 if d["failed"] else 200, d)
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})

            def do_POST(self) -> None:  # noqa: N802 — http.server API
                if self.path != "/v1/predict":
                    self._send(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    fwd = {k: v for k, v in self.headers.items()
                           if k.lower().startswith("x-lgbm-")}
                    code, out = sup.predict(payload, headers=fwd)
                    self._send(code, out)
                except FleetBudgetExhausted as e:
                    self._send(503, {"error": str(e),
                                     "reason": "fleet_failed"})
                except FleetRequestFailed as e:
                    self._send(503, {"error": str(e),
                                     "reason": "no_replica",
                                     "retry_after_s": 1.0})
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001 — door stays up
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = ThreadingHTTPServer((host, port), _FleetHandler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="lgbm-fleet-http",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(10)


# -------------------------------------------------------------------- entry
def subprocess_factory(cfg, workdir: str) -> Callable[[int], SubprocessReplica]:
    """Bind a Config's serving knobs into a SubprocessReplica factory:
    every replica serves the same model with the same admission/batch
    policy, each on its own ephemeral port."""
    extra = (f"serve_max_batch_rows={cfg.serve_max_batch_rows}",
             f"serve_max_delay_ms={cfg.serve_max_delay_ms}",
             f"serve_max_queue_rows={cfg.serve_max_queue_rows}",
             f"serve_require_checksum={cfg.serve_require_checksum}",
             f"serve_buckets={cfg.serve_buckets}",
             f"verbose={cfg.verbose}")

    def factory(replica_id: int) -> SubprocessReplica:
        return SubprocessReplica(cfg.input_model, replica_id, workdir,
                                 host=cfg.serve_host, extra_args=extra)

    return factory


def serve_fleet_from_config(cfg) -> int:
    """``task=serve_fleet`` entry (cli.py): supervise
    ``serve_replicas`` subprocess replicas behind one front end until
    SIGTERM/SIGINT, then drain the fleet.  Returns 0 on a clean stop,
    1 if the restart budget was exhausted."""
    import signal

    workdir = os.path.dirname(os.path.abspath(cfg.input_model))
    flightrec.configure_dir(workdir)
    sup = ReplicaSupervisor(
        subprocess_factory(cfg, workdir),
        replicas=cfg.serve_replicas,
        max_replicas=cfg.serve_max_replicas,
        restart_budget=cfg.serve_restart_budget,
        seed=cfg.seed)
    sup.start()
    front = FleetFrontEnd(sup, host=cfg.serve_host, port=cfg.serve_port)
    Log.info(f"fleet front end at {front.url} over "
             f"{sup.num_replicas} replica(s)")
    stop = threading.Event()

    def _stop(signum, frame):  # noqa: ARG001
        Log.info("fleet: shutdown signal received")
        stop.set()

    old_term = signal.signal(signal.SIGTERM, _stop)
    old_int = signal.signal(signal.SIGINT, _stop)
    try:
        while not stop.wait(0.5):
            if sup.failed is not None:
                Log.warning(f"fleet failed: {sup.failed}")
                return 1
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
        front.close()
        sup.stop()
    return 0
