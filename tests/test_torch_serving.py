"""The port's serving core on the CPU: the engine, the micro-batch queue,
the hot-swap and the HTTP / in-process front end, mirroring the JAX
package's tests/test_serving.py, and held against the JAX package's own
ServingEngine on the same model file.

Every engine here is built with ``device="cpu"``, where kernel P1's plain
version serves; the card's run is ``chip_smoke.py`` phase 18.
"""

import http.client
import json
import shutil
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu.serving as jax_serving
from lightgbm_tpu.obs import telemetry as jax_telemetry

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import serving
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.obs import memory as obs_memory
from lightgbm_tpu_torch.obs import telemetry
from lightgbm_tpu_torch.ops import _build
from lightgbm_tpu_torch.resilience import faults
from lightgbm_tpu_torch.resilience.atomic import ArtifactCorrupt
from lightgbm_tpu_torch.serving import (InProcessClient, MicroBatchQueue,
                                        ServingEngine, ServingServer,
                                        adopt_model, load_packed_model,
                                        power_of_two_buckets,
                                        serve_from_config)

N_FEAT = 6
CPU = dict(device="cpu")
BUCKETS = (8, 32, 128)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Two models (B = A + 4 continued-training rounds) saved with their
    ``.sha256`` sidecars, and the boosters that wrote them."""
    tmp = tmp_path_factory.mktemp("serving")
    rng = np.random.RandomState(0)
    X = rng.randn(400, N_FEAT)
    y = (X[:, 0] + 0.3 * rng.randn(400) > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
              "verbose": -1}
    ds = lt.Dataset(X, label=y, **CPU)
    a = lt.train(params, ds, 6, **CPU)
    b = lt.train(params, ds, 4, init_model=a, **CPU)
    m_a, m_b = str(tmp / "a.txt"), str(tmp / "b.txt")
    a.save_model(m_a)
    b.save_model(m_b)
    return {"tmp": tmp, "X": X, "y": y, "params": params,
            "model_a": m_a, "model_b": m_b,
            "booster_a": lt.Booster(model_file=m_a, **CPU),
            "booster_b": lt.Booster(model_file=m_b, **CPU)}


@pytest.fixture()
def engine_a(served):
    """A fresh engine on model A per test (swap tests mutate it)."""
    return ServingEngine(served["model_a"], buckets=BUCKETS,
                         max_batch_rows=128, **CPU)


# ------------------------------------------------------------ engine
def test_bucket_ladder():
    assert power_of_two_buckets(1024) == [8, 16, 32, 64, 128, 256, 512,
                                          1024]
    assert power_of_two_buckets(100) == [8, 16, 32, 64, 128]
    with pytest.raises(ValueError):
        power_of_two_buckets(0)


def test_engine_bitwise_parity_with_offline_predictor(served, engine_a):
    """A served response IS the offline answer, bitwise, at request sizes
    that pad into different buckets and one above the largest."""
    rng = np.random.RandomState(1)
    for n in (1, 7, 8, 20, 100, 200):  # 200 > max bucket: row-chunked
        Xq = rng.randn(n, N_FEAT)
        exp = served["booster_a"].predict(Xq)
        got, mid = engine_a.predict_with_meta(Xq)
        assert got.tobytes() == exp.tobytes(), f"mismatch at n={n}"
        assert mid == engine_a.model_id
    Xq = rng.randn(16, N_FEAT)
    exp = served["booster_a"].predict(Xq, raw_score=True)
    assert engine_a.predict(Xq, raw_score=True).tobytes() == exp.tobytes()


def test_engine_output_does_not_depend_on_padding(served, engine_a):
    """The same rows alone, padded into every bucket, and beside other
    rows give the same bits."""
    rng = np.random.RandomState(11)
    Xq = rng.randn(5, N_FEAT)
    alone = engine_a.predict(Xq, raw_score=True)
    for n in (8, 30, 120):
        big = np.concatenate([Xq, rng.randn(n - 5, N_FEAT)])
        got = engine_a.predict(big, raw_score=True)[:5]
        assert got.tobytes() == alone.tobytes(), n


def test_engine_serves_boosters_and_models_on_its_device(served):
    """A Booster, a GBDT and a file all pack onto the engine's device; an
    engine without a device runs on the card, and refuses without one."""
    bst = served["booster_a"]
    for model in (bst, bst._gbdt, served["model_a"]):
        eng = ServingEngine(model, buckets=(8,), **CPU)
        assert eng.device == torch.device("cpu")
        assert eng.predict(served["X"][:3]).tobytes() == \
            bst.predict(served["X"][:3]).tobytes()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(bst, buckets=(8,))


def test_engine_rejects_bad_requests(engine_a):
    with pytest.raises(ValueError):
        engine_a.predict(np.zeros((0, N_FEAT)))
    with pytest.raises(ValueError):
        engine_a.predict(np.zeros((4, N_FEAT + 2)))


def test_engine_requires_checksum_by_default(served, tmp_path):
    bare = str(tmp_path / "bare.txt")
    shutil.copy(served["model_a"], bare)  # no sidecar
    with pytest.raises(ArtifactCorrupt, match="sidecar"):
        load_packed_model(bare, **CPU)
    pm = load_packed_model(bare, require_checksum=False, **CPU)
    assert pm.num_trees == 6


def test_oom_dispatch_is_classified_and_raised(engine_a, tmp_path):
    """An out-of-memory dispatch fails its request, is counted and dumps
    the flight recorder; the engine serves the next request."""
    from lightgbm_tpu_torch.obs import flightrec

    flightrec.configure_dir(str(tmp_path))
    before = telemetry.get_telemetry().counter("oom.serve")
    faults.set_fault("oom_dispatch")
    try:
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            engine_a.predict(np.zeros((3, N_FEAT)))
    finally:
        faults.clear_faults()
        flightrec.configure_dir("")
    assert telemetry.get_telemetry().counter("oom.serve") == before + 1
    assert list(tmp_path.glob("flightrec_r0_*.json"))
    assert engine_a.predict(np.zeros((3, N_FEAT))).shape == (3,)
    assert obs_memory.is_oom_error(torch.cuda.OutOfMemoryError("x"))


# ------------------------------------------------------------- queue
def test_queue_scatters_coalesced_batches(served, engine_a):
    rng = np.random.RandomState(2)
    Xq = rng.randn(60, N_FEAT)
    exp = served["booster_a"].predict(Xq)
    with MicroBatchQueue(engine_a, max_delay_s=0.005) as q:
        futs = [q.submit(Xq[lo:lo + 5]) for lo in range(0, 60, 5)]
        out = [f.result(30) for f in futs]
    cat = np.concatenate([r.values for r in out])
    assert cat.tobytes() == exp.tobytes()
    tel = telemetry.get_telemetry()
    assert tel.counter("serving.requests") >= 12
    assert tel.reservoir("serving.request_s") is not None


def test_queue_single_request_latency_bounded(engine_a):
    with MicroBatchQueue(engine_a, max_delay_s=0.01) as q:
        t0 = time.perf_counter()
        res = q.predict(np.zeros((1, N_FEAT)), timeout=10)
        wall = time.perf_counter() - t0
    assert res.values.shape == (1,)
    assert wall < 2.0


def test_queue_failed_batch_fails_only_its_futures(served, engine_a):
    """A dispatch that raises fails the futures of its batch; the
    dispatcher survives and serves later requests."""
    with MicroBatchQueue(engine_a, max_delay_s=0.001) as q:
        with pytest.raises(ValueError):
            q.submit(np.zeros((2, N_FEAT + 1)))
        faults.set_fault("oom_dispatch")
        try:
            doomed = q.submit(np.zeros((2, N_FEAT)))
            with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
                doomed.result(30)
        finally:
            faults.clear_faults()
        ok = q.predict(np.zeros((2, N_FEAT)), timeout=30)
        assert ok.values.shape == (2,)


def test_queue_closed_rejects_submits(engine_a):
    q = MicroBatchQueue(engine_a, max_delay_s=0.001)
    q.close()
    with pytest.raises(RuntimeError):
        q.submit(np.zeros((1, N_FEAT)))


def test_queue_cancelled_future_does_not_kill_dispatcher(engine_a):
    with MicroBatchQueue(engine_a, max_delay_s=0.2) as q:
        doomed = q.submit(np.zeros((1, N_FEAT)))
        live = q.submit(np.ones((2, N_FEAT)))
        assert doomed.cancel(), "future dispatched before cancel()"
        assert live.result(30).values.shape == (2,)
        assert q.predict(np.zeros((3, N_FEAT)),
                         timeout=30).values.shape == (3,)


def test_queue_sheds_and_drains(engine_a):
    """A full queue refuses with QueueFull, a draining one with
    QueueDraining; drain finishes what was admitted."""
    q = MicroBatchQueue(engine_a, max_delay_s=0.2, max_queue_rows=4)
    try:
        first = q.submit(np.zeros((3, N_FEAT)))
        with pytest.raises(serving.QueueFull):
            q.submit(np.zeros((3, N_FEAT)))
        q.begin_drain()
        assert q.state == "draining"
        with pytest.raises(serving.QueueDraining):
            q.submit(np.zeros((1, N_FEAT)))
        q.drain()
        assert first.result(30).values.shape == (3,)
    finally:
        q.close()


def test_steady_state_builds_no_kernel_1000_mixed_requests(served, engine_a):
    """After the buckets' prewarm, >= 1000 requests across 4 sizes build
    no kernel (the port's counterpart of the JAX engine's
    recompile-free steady state), and the answers stay bitwise."""
    rng = np.random.RandomState(3)
    pool = rng.randn(512, N_FEAT)
    sizes = [1, 5, 17, 64]
    builds = _build.BUILDS
    with MicroBatchQueue(engine_a, max_delay_s=0.0005) as q:
        futs = [q.submit(pool[(i * 7) % 400:(i * 7) % 400 + sizes[i % 4]])
                for i in range(1000)]
        results = [f.result(60) for f in futs]
    assert len(results) == 1000
    assert _build.BUILDS == builds
    for i in (0, 1, 2, 3, 999):
        lo = (i * 7) % 400
        exp = served["booster_a"].predict(pool[lo:lo + sizes[i % 4]])
        assert results[i].values.tobytes() == exp.tobytes()


# ------------------------------------------------------ hot-swap safety
def test_hotswap_under_load_bitwise_and_safe(served, engine_a):
    """Before the flip every response is the old model's, after it the new
    model's, bitwise; no request fails; no client sees the old model
    again once the new one answered it."""
    rng = np.random.RandomState(4)
    Xq = rng.randn(8, N_FEAT)
    exp_a = served["booster_a"].predict(Xq)
    exp_b = served["booster_b"].predict(Xq)
    assert exp_a.tobytes() != exp_b.tobytes()
    id_a = engine_a.model_id
    stop = threading.Event()
    n_clients = 4
    per_client = [[] for _ in range(n_clients)]
    errors = []
    total = [0]
    lock = threading.Lock()

    def client(idx):
        with MicroBatchQueue(engine_a, max_delay_s=0.0005) as q:
            while not stop.is_set():
                try:
                    r = q.predict(Xq, timeout=30)
                except Exception as e:  # noqa: BLE001 — asserted empty
                    errors.append(e)
                    return
                per_client[idx].append((r.model_id, r.values.tobytes()))
                with lock:
                    total[0] += 1

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while total[0] < 50 and time.monotonic() < deadline:
        time.sleep(0.002)
    summary = adopt_model(engine_a, served["model_b"])
    n_at_swap = total[0]
    while total[0] < n_at_swap + 100 and time.monotonic() < deadline:
        time.sleep(0.002)
    stop.set()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert not errors, f"request errors during swap: {errors[:3]}"
    assert summary["old_model_id"] == id_a and summary["warm"]["compiles"] == 0
    id_b = summary["new_model_id"]
    records = [rec for mine in per_client for rec in mine]
    assert {mid for mid, _ in records} == {id_a, id_b}
    for mid, blob in records:
        assert blob == (exp_a if mid == id_a else exp_b).tobytes()
    for idx, mine in enumerate(per_client):
        flipped = False
        for mid, _ in mine:
            flipped |= mid == id_b
            assert not (flipped and mid == id_a), f"client {idx}: A after B"


def test_hotswap_corrupt_candidate_refused_old_keeps_serving(
        served, engine_a, tmp_path):
    rng = np.random.RandomState(5)
    Xq = rng.randn(12, N_FEAT)
    exp_a = served["booster_a"].predict(Xq)
    cand = str(tmp_path / "cand.txt")
    shutil.copy(served["model_b"], cand)
    shutil.copy(served["model_b"] + ".sha256", cand + ".sha256")
    id_before = engine_a.model_id
    faults.set_fault("corrupt_model")
    try:
        with pytest.raises(ArtifactCorrupt, match="sha256|checksum"):
            adopt_model(engine_a, cand)
    finally:
        faults.clear_faults()
    assert engine_a.model_id == id_before
    assert engine_a.predict(Xq).tobytes() == exp_a.tobytes()
    assert telemetry.get_telemetry().counter("serving.swap_refused") >= 1


def test_swap_incompatible_shape_refused(served, engine_a, tmp_path):
    rng = np.random.RandomState(6)
    X = rng.randn(300, N_FEAT + 3)
    y = (X[:, 0] > 0).astype(np.float32)
    wide = str(tmp_path / "wide.txt")
    lt.train(dict(served["params"], num_leaves=5),
             lt.Dataset(X, label=y, **CPU), 2, **CPU).save_model(wide)
    with pytest.raises(ValueError, match="features"):
        adopt_model(engine_a, wide)
    three = str(tmp_path / "three.txt")
    y3 = (np.abs(X[:, 0]) * 2).astype(int) % 3
    lt.train({"objective": "multiclass", "num_class": 3, "verbose": -1},
             lt.Dataset(X[:, :N_FEAT], label=y3.astype(np.float32), **CPU),
             1, **CPU).save_model(three)
    with pytest.raises(ValueError, match="num_class"):
        adopt_model(engine_a, three)


def test_deferred_serving_names_raise():
    """The fleet names (A11) were refused here, naming A9, until the
    supervisor was ported: they now import from ``serving`` and
    ``serving.supervisor``.  The batch tier (A6) is ported and
    importable, and the training loop's ``kill_after_tree`` fault is
    accepted (A9)."""
    from lightgbm_tpu_torch.serving import supervisor
    for name in ("ReplicaSupervisor", "FleetFrontEnd",
                 "serve_fleet_from_config"):
        assert getattr(serving, name) is getattr(supervisor, name)
    assert not hasattr(serving, "DEFERRED")
    from lightgbm_tpu_torch.serving import batch
    assert serving.pipelined_predict_file is batch.pipelined_predict_file
    assert serving.format_block is batch.format_block
    faults.set_fault("kill_after_tree:3")
    try:
        assert faults.kill_after_tree() == 3
    finally:
        faults.clear_faults()


# ---------------------------------------------------- server transport
def test_http_server_and_inprocess_client(served, engine_a, tmp_path):
    rng = np.random.RandomState(7)
    Xq = rng.randn(5, N_FEAT)
    exp = served["booster_a"].predict(Xq)
    with MicroBatchQueue(engine_a, max_delay_s=0.001) as q:
        client = InProcessClient(engine_a, q)
        code, out = client.predict(Xq.tolist())
        assert code == 200
        assert np.asarray(out["predictions"]).tobytes() == exp.tobytes()
        assert out["model_id"] == engine_a.model_id
        code, out = client.predict([[1, 2]])  # wrong width
        assert code == 400 and "error" in out
        code, out = client.health()
        assert code == 200 and out["status"] == "ok"
        assert out["buckets"] == list(BUCKETS)
        code, out = client.stats()
        assert code == 200 and "telemetry" in out
        server = ServingServer(engine_a, q, port=0).start()
        try:
            conn = http.client.HTTPConnection(server.host, server.port,
                                              timeout=30)
            conn.request("POST", "/v1/predict",
                         json.dumps({"rows": Xq.tolist()}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            wire = json.loads(resp.read())
            assert resp.status == 200
            assert np.asarray(wire["predictions"]).tobytes() == exp.tobytes()
            cand = str(tmp_path / "wire_cand.txt")
            shutil.copy(served["model_b"], cand)
            shutil.copy(served["model_b"] + ".sha256", cand + ".sha256")
            faults.set_fault("corrupt_model")
            try:
                conn.request("POST", "/v1/swap", json.dumps({"model": cand}),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                assert resp.status == 409
                assert "error" in json.loads(resp.read())
            finally:
                faults.clear_faults()
            conn.request("GET", "/v1/healthz", None, {})
            resp = conn.getresponse()
            assert json.loads(resp.read())["model_id"] == engine_a.model_id
            conn.request("GET", "/metrics", None, {})
            resp = conn.getresponse()
            assert resp.status == 200
            assert b"lgbm_serving_requests_total" in resp.read()
            conn.close()
        finally:
            server.httpd.shutdown()
            server.httpd.server_close()


def test_serve_from_config_nonblocking(served):
    cfg = Config(task="serve", input_model=served["model_a"],
                 serve_port=0, serve_buckets="8 32",
                 serve_max_batch_rows=32)
    server = serve_from_config(cfg, block=False, **CPU)
    try:
        with urllib.request.urlopen(server.url + "/v1/healthz",
                                    timeout=30) as resp:
            out = json.loads(resp.read())
        assert resp.status == 200
        assert out["num_trees"] == 6 and out["buckets"] == [8, 32]
        assert out["device"] == "cpu"
    finally:
        server.close()


# --------------------------------------------- against the JAX package
def _metric_families(text: str) -> set:
    """(name, kind) of every ``# TYPE`` line of a /metrics body."""
    return {tuple(line.split()[2:4]) for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_engine_matches_jax_serving_engine(served):
    """The JAX package's ServingEngine on the same model file gives the
    same bits, the same model_id, and, after the same requests, the same
    /metrics counter, summary and histogram names.  Rows here have no
    categorical NaN (where the JAX package's serving and offline paths
    disagree with each other, ROADMAP C)."""
    rng = np.random.RandomState(8)
    reqs = [rng.randn(n, N_FEAT) for n in (1, 7, 33, 128, 200)]
    reqs[2][0, 1], reqs[3][5, 2], reqs[4][9, 0] = np.nan, np.inf, -3e9
    telemetry.get_telemetry().reset()
    jax_telemetry.get_telemetry().reset()
    pe = ServingEngine(served["model_a"], buckets=BUCKETS, **CPU)
    je = jax_serving.ServingEngine(served["model_a"], buckets=BUCKETS)
    assert pe.model_id == je.model_id
    texts = []
    for eng, mod in ((pe, serving), (je, jax_serving)):
        with mod.MicroBatchQueue(eng, max_delay_s=0.001) as q:
            client = mod.InProcessClient(eng, q)
            outs = []
            for X in reqs:
                for raw in (False, True):
                    code, out = client.predict(X.tolist(), raw_score=raw)
                    assert code == 200, out
                    outs.append(np.asarray(out["predictions"]))
            texts.append(client.metrics()[1])
        eng.outs = outs
    for got, want in zip(pe.outs, je.outs):
        assert got.tobytes() == want.tobytes()
    port_fam, jax_fam = map(_metric_families, texts)
    # XLA's compile counter and the JAX package's CPU memory gauges have
    # no counterpart in the port
    jax_fam = {f for f in jax_fam if f[0] != "lgbm_backend_compiles_total"
               and not f[0].startswith("lgbm_memory_")}
    assert port_fam == jax_fam


@pytest.mark.cuda
def test_engine_on_card_is_offline_and_reserves_nothing_new(served):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    bst = lt.Booster(model_file=served["model_a"])
    eng = ServingEngine(served["model_a"], buckets=BUCKETS)
    rng = np.random.RandomState(9)
    reserved = torch.cuda.memory_reserved()
    builds = _build.BUILDS
    for i in range(300):
        X = rng.randn((1, 7, 64, 128, 300)[i % 5], N_FEAT)
        assert eng.predict(X).tobytes() == bst.predict(X).tobytes()
    assert torch.cuda.memory_reserved() == reserved
    assert _build.BUILDS == builds
