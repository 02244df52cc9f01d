"""The port's serving fleet (``serving/supervisor.py``, ROADMAP A11).

* The JAX package's supervisor tests (tests/test_serving_fleet.py:
  257-411) with the same fakes — a replica handle double and an
  in-process transport in place of ``_http_json``: one retry on another
  replica for a transport error, 503 retried and returned when no peer is
  left, jittered exponential backoff and the restart budget failing the
  fleet loudly (with a flight-recorder dump), the front end's healthz
  and predict.
* ``scale_decision`` equals the JAX package's over a grid of queue
  depths, shed counts and fleet sizes.
* Two ``ThreadReplica``s on the CPU over a port model behind a
  ``FleetFrontEnd``, under 4 client threads: ``chaos_kill(0)`` mid-load
  fails no request, every answer is bitwise ``Booster.predict`` of its
  rows, and the supervisor restarted the replica once.
"""

import http.client
import itertools
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

from lightgbm_tpu.serving.supervisor import \
    ReplicaSupervisor as JaxReplicaSupervisor

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.obs import flightrec, telemetry
from lightgbm_tpu_torch.serving import (FleetBudgetExhausted, FleetFrontEnd,
                                        ReplicaSupervisor, ThreadReplica)
from lightgbm_tpu_torch.serving import supervisor as supervisor_mod


def _counters():
    return dict(telemetry.get_telemetry().snapshot()["counters"])


# ------------------------------------------------------- fake replica fleet
class FakeHandle:
    """Replica handle double: the supervisor only touches url / start /
    wait_ready / exit_code / kill / terminate."""

    def __init__(self, url):
        self.url = url
        self.pid = 0
        self.rc = None
        self.terminated = False

    def start(self):
        return self

    def wait_ready(self, timeout=0.0):
        return None

    def exit_code(self):
        return self.rc

    def kill(self):
        self.rc = -9

    def terminate(self, timeout=0.0):
        self.terminated = True
        self.rc = 75
        return self.rc


class FakeTransport:
    """In-process stand-in for supervisor._http_json: routes by URL
    prefix, records every attempt, raises OSError for urls marked
    down."""

    def __init__(self):
        self.responses = {}  # url prefix -> (status, body) or OSError
        self.calls = []      # (method, url, payload)

    def __call__(self, method, url, payload=None, headers=None,
                 timeout=30.0):
        self.calls.append((method, url, payload))
        for prefix, resp in self.responses.items():
            if url.startswith(prefix):
                if isinstance(resp, Exception):
                    raise resp
                return resp
        raise OSError(f"no fake route for {url}")

    def predicts_to(self, prefix):
        return [c for c in self.calls
                if c[0] == "POST" and c[1].startswith(prefix)]


@pytest.fixture()
def fake_fleet(monkeypatch):
    transport = FakeTransport()
    monkeypatch.setattr(supervisor_mod, "_http_json", transport)
    made = []

    def factory(slot_id):
        h = FakeHandle(f"http://replica-{slot_id}-gen{len(made)}")
        made.append(h)
        return h

    return transport, factory, made


def test_supervisor_retries_once_on_other_replica(fake_fleet):
    transport, factory, made = fake_fleet
    sup = ReplicaSupervisor(factory, replicas=2, health_interval_s=60.0,
                            sleep=lambda s: None).start()
    try:
        ok = (200, {"values": [1.0]})
        transport.responses[made[0].url] = OSError("connection reset")
        transport.responses[made[1].url] = ok
        before = _counters()
        payload = {"rows": [[1, 2, 3, 4]]}
        for _ in range(2):  # round-robin guarantees one lands on the
            status, body = sup.predict(payload)  # broken replica
            assert (status, body) == ok
        assert transport.predicts_to(made[0].url), \
            "test never exercised the broken replica"
        # the retry re-sent the SAME payload (idempotent replay)
        assert all(c[2] == payload
                   for c in transport.predicts_to(made[0].url)
                   + transport.predicts_to(made[1].url))
        after = _counters()
        assert after.get("serving.fleet.retries", 0) \
            >= before.get("serving.fleet.retries", 0) + 1
        # the transport failure marked replica 0 suspect: until a
        # health check clears it, routing skips it entirely
        n_before = len(transport.predicts_to(made[0].url))
        for _ in range(4):
            assert sup.predict(payload) == ok
        assert len(transport.predicts_to(made[0].url)) == n_before
    finally:
        sup.stop()
    assert all(h.terminated for h in made[:2])


def test_supervisor_retries_503_and_returns_it_without_peer(fake_fleet):
    transport, factory, made = fake_fleet
    sup = ReplicaSupervisor(factory, replicas=2, health_interval_s=60.0,
                            sleep=lambda s: None).start()
    try:
        draining = (503, {"error": "draining", "reason": "draining"})
        ok = (200, {"values": [2.0]})
        transport.responses[made[0].url] = draining
        transport.responses[made[1].url] = ok
        for _ in range(2):
            assert sup.predict({"rows": [[0, 0, 0, 0]]}) == ok
        # with NO peer left, the 503 comes back to the caller
        transport.responses[made[1].url] = draining
        made[1].rc = 1  # dead: routing can only offer replica 0
        status, _body = sup.predict({"rows": [[0, 0, 0, 0]]})
        assert status == 503
    finally:
        sup.stop()


def test_supervisor_backoff_and_budget_exhaustion(fake_fleet, tmp_path):
    transport, factory, made = fake_fleet
    sleeps = []
    sup = ReplicaSupervisor(factory, replicas=1, restart_budget=3,
                            backoff_base_s=0.1, backoff_max_s=10.0,
                            health_interval_s=60.0, seed=7,
                            sleep=sleeps.append).start()
    old_dir = flightrec.dump_dir()
    flightrec.set_dump_dir(str(tmp_path))
    try:
        transport.responses["http://replica-"] = (200, {})
        slot = sup._slots[0]
        for _ in range(3):
            slot.handle.rc = 1  # crash the current incumbent
            sup._restart(slot)
        assert sup.restarts_total == 3
        assert len(sleeps) == 3
        # jittered exponential: each delay in [0.5, 1.5) x base*2^k
        for k, delay in enumerate(sleeps):
            assert 0.5 * 0.1 * 2 ** k <= delay < 1.5 * 0.1 * 2 ** k
        assert slot.backoff_history == sleeps
        # the JAX package's schedule for the same seed, delay for delay
        jsup = JaxReplicaSupervisor(lambda i: FakeHandle(""), replicas=1,
                                    backoff_base_s=0.1, backoff_max_s=10.0,
                                    seed=7)
        from lightgbm_tpu.resilience.retry import backoff_delay
        assert sleeps == [backoff_delay(k, base_s=0.1, max_s=10.0,
                                        rng=jsup._rng) for k in range(3)]
        # budget exhausted: the fleet fails LOUDLY, not silently
        slot.handle.rc = 1
        with pytest.raises(FleetBudgetExhausted):
            sup._restart(slot)
        with pytest.raises(FleetBudgetExhausted):
            sup.predict({"rows": [[0, 0, 0, 0]]})
        assert sup.describe()["failed"]
        dumps = [f for f in os.listdir(tmp_path)
                 if f.startswith("flightrec_") and f.endswith(".json")]
        assert dumps, "budget exhaustion must dump the flight recorder"
        events = json.load(open(tmp_path / dumps[0]))["events"]
        assert any(e["kind"] == "fleet_budget_exhausted" for e in events)
    finally:
        flightrec.set_dump_dir(old_dir)
        sup.stop()


def test_scale_decision_policy():
    dec = ReplicaSupervisor.scale_decision
    assert dec([100, 80], 0, 2, 2, 4, 64, 0) == "up"
    assert dec([0, 0], 5, 2, 2, 4, 64, 0) == "up"
    assert dec([100, 100], 9, 4, 2, 4, 64, 0) == "hold"
    idle = supervisor_mod.SCALE_DOWN_ROUNDS
    assert dec([0, 0, 0], 0, 3, 2, 4, 64, idle) == "down"
    assert dec([0, 0], 0, 2, 2, 4, 64, idle) == "hold"
    assert dec([], 0, 1, 2, 4, 64, 0) == "up"


def test_scale_decision_equals_the_jax_packages():
    ours, theirs = ReplicaSupervisor.scale_decision, \
        JaxReplicaSupervisor.scale_decision
    depth_sets = [[], [0], [0, 0], [63, 64], [64, 64], [200, 0, 0],
                  [10, 20, 30]]
    seen = set()
    for depths, shed, current, lo, hi, up, idle in itertools.product(
            depth_sets, (0, 1, 7), (1, 2, 3, 4), (1, 2), (2, 4), (32, 64),
            (0, 19, 20, 40)):
        got = ours(depths, shed, current, lo, hi, up, idle)
        assert got == theirs(depths, shed, current, lo, hi, up, idle)
        seen.add(got)
    assert seen == {"up", "down", "hold"}
    assert supervisor_mod.SCALE_DOWN_ROUNDS == 20
    assert supervisor_mod.HEALTH_FAIL_LIMIT == 3


def test_fleet_front_end_healthz_and_predict(fake_fleet):
    transport, factory, made = fake_fleet
    sup = ReplicaSupervisor(factory, replicas=1, health_interval_s=60.0,
                            sleep=lambda s: None).start()
    front = FleetFrontEnd(sup, host="127.0.0.1", port=0)
    try:
        transport.responses[made[0].url] = (200, {"values": [4.5]})
        with urllib.request.urlopen(front.url + "/v1/healthz",
                                    timeout=10) as r:
            health = json.loads(r.read())
        assert health["replicas"]
        assert health["restarts_total"] == 0
        assert health["restart_budget"] >= 1
        req = urllib.request.Request(
            front.url + "/v1/predict",
            data=json.dumps({"rows": [[0, 0, 0, 0]]}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read())["values"] == [4.5]
    finally:
        front.close()
        sup.stop()


# ------------------------------------------------ a real fleet on the CPU
N_FEAT = 6


@pytest.fixture(scope="module")
def fleet_model(tmp_path_factory):
    rng = np.random.RandomState(0)
    X = rng.randn(1200, N_FEAT)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.randn(1200) > 0)
    bst = lt.train({"objective": "binary", "num_leaves": 15,
                    "verbose": -1}, lt.Dataset(X, label=y.astype(np.float32),
                                               device="cpu"), 20,
                   device="cpu")
    path = str(tmp_path_factory.mktemp("fleet") / "model.txt")
    bst.save_model(path)
    return path, lt.Booster(model_file=path, device="cpu"), X


def _post(conn, rows):
    conn.request("POST", "/v1/predict", json.dumps({"rows": rows.tolist()}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def test_thread_fleet_survives_a_replica_kill(fleet_model):
    """4 clients through the front end; replica 0 is killed after a
    quarter of the requests: none fails, each answer is the offline
    ``Booster.predict`` of its rows bitwise, one restart."""
    path, offline, X = fleet_model
    made = []

    def factory(slot_id):
        h = ThreadReplica(path, slot_id, device="cpu")
        made.append(h)
        return h

    sup = ReplicaSupervisor(factory, replicas=2, health_interval_s=0.05,
                            backoff_base_s=0.01, seed=3).start()
    front = FleetFrontEnd(sup)
    clients, per_client = 4, 40
    done = []
    errors = []
    lock = threading.Lock()
    killed = threading.Event()

    def client(c):
        rng = np.random.RandomState(100 + c)
        conn = http.client.HTTPConnection(front.host, front.port, timeout=30)
        for _ in range(per_client):
            lo = rng.randint(0, len(X) - 64)
            rows = X[lo:lo + rng.randint(1, 65)]
            try:
                status, body = _post(conn, rows)
            except (OSError, http.client.HTTPException) as e:
                errors.append(f"transport {e}")
                conn = http.client.HTTPConnection(front.host, front.port,
                                                  timeout=30)
                continue
            with lock:
                done.append((status, rows, body))
                if len(done) == clients * per_client // 4:
                    sup.chaos_kill(0)
                    killed.set()
        conn.close()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        deadline = time.monotonic() + 30
        while sup.restarts_total < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert killed.is_set()
        assert not errors
        assert len(done) == clients * per_client
        assert [s for s, _, _ in done if s != 200] == []
        for status, rows, body in done:
            want = offline.predict(rows)
            assert np.asarray(body["predictions"]).tobytes() == want.tobytes()
        assert sup.restarts_total == 1
        assert sup.num_replicas == 2
        assert sup.failed is None
    finally:
        front.close()
        sup.stop()
        for h in made:  # the killed replica's queue was never drained
            if h.exit_code() == 1:
                h._server.queue.close()
    assert sum(h.exit_code() == 75 for h in made) == 2
