"""The port's cross-rank observability (obs/dist.py) and its two faults
(resilience/faults.py ``delay_collective``, ``desync_step``) against the
JAX package's, on the same inputs made from a numpy seed.

* ``merge_snapshots``, ``attribute_stragglers``, ``ranks_section``,
  ``merged_manifest_extra``, ``multichip_artifact`` and
  ``render_rank_table`` give the JAX package's output exactly, on seeded
  snapshots with counters, spans, sample windows, agreeing and
  conflicting histograms, gang stamps and memory peaks.
* ``state_fingerprint`` and ``config_crc`` equal the JAX package's.
* The sentinel names the diverging rank through an injected gather (the
  JAX package's tests/test_dist_obs.py:221-270), checks on its cadence,
  and the ``desync_step`` fault perturbs one row once.
* ``traced_collective`` splits wait from transfer, counts per op,
  attributes a transient retry to its site, and the ``delay_collective``
  fault delays only the rank it names; the merged wait series then
  names it the straggler.
* The exchange: files in rank order, a timeout naming missing ranks.
* Rank identity comes from the env where no world is up (flight-recorder
  dumps too).
"""

import json
import os
import time

import numpy as np
import pytest

from lightgbm_tpu.obs import dist as jdist
from lightgbm_tpu.obs import telemetry as jtelemetry

from lightgbm_tpu_torch.obs import dist, flightrec, telemetry
from lightgbm_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def _clean():
    faults.clear_faults()
    yield
    faults.clear_faults()
    flightrec.set_rank(None)


def _snapshot(rng, rank, world, bounds_conflict=False):
    """A rank snapshot in :func:`rank_snapshot`'s shape from ``rng``."""
    counters = {"host_syncs": int(rng.randint(1, 50)),
                "collective_ops": int(rng.randint(1, 9)),
                "desync_checks": 3, f"only_r{rank}": 1}
    spans = {}
    for name in ("dist.grow.dispatch", "dist.grow.fetch", "load"):
        c = int(rng.randint(1, 6))
        xs = rng.rand(c)
        spans[name] = {"total_s": round(float(xs.sum()), 6), "count": c,
                       "min_s": round(float(xs.min()), 6),
                       "max_s": round(float(xs.max()), 6)}
    reservoirs = {}
    for name in ("collective.desync_sentinel.wait_s",
                 "collective.desync_sentinel.transfer_s", "tree_s"):
        xs = [round(float(v), 6) for v in rng.rand(int(rng.randint(1, 8)))
              * (0.05 if rank == 1 and "wait" in name else 0.5)]
        reservoirs[name] = {"count": len(xs) + int(rng.randint(0, 3)),
                            "window": len(xs),
                            "mean_s": round(sum(xs) / len(xs), 6),
                            "p50_s": 0.0, "p99_s": 0.0,
                            "max_s": max(xs), "samples": xs}
    bounds = [0.1, 1.0] if not bounds_conflict else [0.2, 1.0]
    hists = {"tree_s": {"bounds": bounds,
                        "counts": [int(v) for v in rng.randint(0, 5, 3)],
                        "count": 4, "sum": round(float(rng.rand()), 9)}}
    snap = {"schema": dist.RANK_SCHEMA, "process_index": rank,
            "process_count": world, "pid": 100 + rank, "host": "h",
            "device": {"backend": "cpu", "kind": "cpu", "local_count": 1},
            "created_unix": 1.0,
            "telemetry": {"counters": counters, "spans": spans,
                          "reservoirs": reservoirs, "histograms": hists},
            "extra": {}, "hbm_peak_bytes": int(rng.randint(1, 2**30))}
    if rank == 2:
        snap["gang"] = {"gang_id": "g", "slot": 2, "barrier_every": 2}
    return snap


@pytest.mark.parametrize("seed,world", [(0, 2), (1, 3), (2, 4)])
def test_merge_and_attribution_equal_jax(seed, world):
    rng = np.random.RandomState(seed)
    snaps = [_snapshot(rng, r, world, bounds_conflict=(r == 3))
             for r in range(world)][::-1]  # merge sorts by rank
    merged = dist.merge_snapshots(snaps)
    assert merged == jdist.merge_snapshots(snaps)
    assert merged["counters"]["host_syncs"] == sum(
        s["telemetry"]["counters"]["host_syncs"] for s in snaps)
    got = dist.attribute_stragglers(merged)
    assert got == jdist.attribute_stragglers(merged)
    assert got and got[0]["straggler_rank"] == 1  # the rank that waited least
    assert dist.ranks_section(snaps) == jdist.ranks_section(snaps)
    assert dist.merged_manifest_extra(merged) == \
        jdist.merged_manifest_extra(merged)
    a = dist.multichip_artifact(merged, snaps, {"auc": 0.8}, {"k": 1})
    b = jdist.multichip_artifact(merged, snaps, {"auc": 0.8}, {"k": 1})
    a.pop("created_unix"), b.pop("created_unix")
    assert a == b
    rows = dist.ranks_section(snaps)
    assert dist.render_rank_table(merged, rows) == \
        jdist.render_rank_table(merged, rows)
    with pytest.raises(ValueError, match="duplicate"):
        dist.merge_snapshots([snaps[0], snaps[0]])


def test_fingerprints_equal_jax():
    rng = np.random.RandomState(5)
    for _ in range(20):
        step, cfp = int(rng.randint(0, 10**6)), int(rng.randint(0, 2**31))
        payload = rng.bytes(int(rng.randint(0, 300)))
        assert dist.state_fingerprint(step, cfp, payload, None, [1, 2]) == \
            jdist.state_fingerprint(step, cfp, payload, None, [1, 2])
    from lightgbm_tpu.config import Config as JaxConfig
    from lightgbm_tpu_torch.config import Config

    for obj in ({"a": 1}, (1, 2.5), "x", JaxConfig(num_leaves=7)):
        assert dist.config_crc(obj) == jdist.config_crc(obj)
    assert dist.config_crc(Config(num_leaves=7)) == \
        dist.config_crc(Config(num_leaves=7))


def test_sentinel_names_the_diverging_rank(tmp_path):
    flightrec.set_dump_dir(str(tmp_path))
    flightrec.reset()
    rows = np.asarray([[5, 111, 0], [5, 999, 1], [5, 111, 2]], np.int32)
    s = dist.DesyncSentinel(world=3, rank=0, gather_fn=lambda row: rows)
    with pytest.raises(dist.DesyncError) as ei:
        s.verify(5, 111)
    msg = str(ei.value)
    assert "rank(s) [1]" in msg and "iteration 5" in msg
    assert "fingerprint=111" in msg
    dumps = [f for f in os.listdir(tmp_path)
             if f.startswith("flightrec_") and f.endswith(".json")]
    rec = json.loads((tmp_path / dumps[0]).read_text())
    assert rec["reason"] == "desync"
    assert rec["events"][-1]["kind"] == "desync_detected"
    assert rec["events"][-1]["divergent_ranks"] == [1]
    # the JAX package names the same rank from the same rows
    with pytest.raises(jdist.DesyncError, match=r"rank\(s\) \[1\]"):
        jdist.DesyncSentinel(world=3, rank=0,
                             gather_fn=lambda row: rows).verify(5, 111)
    flightrec.set_dump_dir("")


def test_sentinel_cadence_and_agreement():
    rows = np.asarray([[2, 7, 0], [2, 7, 1]], np.int32)
    calls = []

    def gather(row):
        calls.append(row.tolist())
        return rows

    s = dist.DesyncSentinel(world=2, rank=0, gather_fn=gather,
                            check_every=2)
    s.verify(1, 7)  # off the cadence: no exchange
    s.verify(2, 7)
    assert calls == [[2, 7, 0]]
    assert not dist.DesyncSentinel(world=1, rank=0).should_check(1)
    assert not dist.DesyncSentinel(world=2, rank=0,
                                   check_every=0).should_check(1)


def test_desync_step_fault_perturbs_once():
    s = dist.DesyncSentinel(world=2, rank=1)
    faults.set_fault("desync_step:1")
    r1, r2 = s.local_row(4, 50), s.local_row(5, 50)
    assert int(r1[1]) == 51 and int(r2[1]) == 50
    faults.set_fault("desync_step:1")
    assert int(dist.DesyncSentinel(world=2, rank=0).local_row(4, 50)[1]) == 50
    with pytest.raises(ValueError, match="desync_step"):
        faults.set_fault("desync_step:x")
        faults.maybe_desync_step(rank=0)


def test_delay_fault_names_the_rank():
    faults.set_fault("delay_collective:1:80")
    t0 = time.perf_counter()
    faults.maybe_delay_collective(rank=0)
    fast = time.perf_counter() - t0
    t0 = time.perf_counter()
    faults.maybe_delay_collective(rank=1)
    slow = time.perf_counter() - t0
    assert fast < 0.05 and slow >= 0.07
    with pytest.raises(ValueError, match="delay_collective"):
        faults.set_fault("delay_collective:bogus")
        faults.maybe_delay_collective(rank=0)


def test_traced_collective_splits_wait_and_transfer():
    """Two simulated ranks of one barrier: rank 1 is delayed by the
    fault, so rank 0 waits at the barrier and rank 1 does not; their
    merged wait series name rank 1 the straggler."""
    import threading

    barrier = threading.Barrier(2)
    stores = [telemetry.Telemetry(), telemetry.Telemetry()]
    faults.set_fault("delay_collective:1:120")

    def rank(r):
        out = dist.traced_collective(
            lambda: r * 10, op="all-gather", label="site_x",
            payload_bytes=12, barrier_fn=barrier.wait, rank=r,
            tel=stores[r])
        assert out == r * 10

    ts = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    snaps = [dist.rank_snapshot(stores[r], rank=r, world=2) for r in range(2)]
    c = snaps[0]["telemetry"]["counters"]
    assert c["collective_ops"] == 1 and c["collective_bytes.op.all-gather"] == 12
    merged = dist.merge_snapshots(snaps)
    strag = dist.attribute_stragglers(merged)
    assert strag[0]["site"] == "site_x" and strag[0]["straggler_rank"] == 1
    assert strag == jdist.attribute_stragglers(merged)


def test_traced_collective_retries_under_its_label():
    telemetry.get_telemetry().reset()
    faults.set_fault("fail_collective_once")
    assert dist.traced_collective(lambda: 7, op="all-reduce",
                                  label="config sync") == 7
    c = telemetry.get_telemetry().snapshot()["counters"]
    assert c["transient_retries.config_sync_pre-dispatch"] == 1
    assert c["collective_ops.op.all-reduce"] == 1


def test_rank_snapshot_and_exchange(tmp_path, monkeypatch):
    monkeypatch.setenv("LGBM_TPU_PROCESS_ID", "1")
    monkeypatch.setenv("LGBM_TPU_NUM_PROCESSES", "3")
    monkeypatch.setenv("LGBM_TPU_GANG_DIR", str(tmp_path))
    monkeypatch.setenv("LGBM_TPU_GANG_SLOT", "4")
    monkeypatch.setenv("LGBM_TPU_GANG_BARRIER_EVERY", "2")
    # the env's rank where no world is up (the JAX package reads its
    # runtime once jax is imported, as here)
    assert (dist.process_index(), dist.process_count()) == (1, 3)
    snap = dist.rank_snapshot()
    jsnap = jdist.rank_snapshot(jtelemetry.get_telemetry())
    assert set(snap) == set(jsnap)
    assert snap["process_index"] == 1 and snap["process_count"] == 3
    assert snap["gang"] == jsnap["gang"] == {
        "gang_id": "gang", "slot": 4, "barrier_every": 2}
    assert snap["device"]["backend"] == "cpu"
    xdir = dist.exchange_dir_for(str(tmp_path / "m.txt.manifest.json"))
    assert xdir == jdist.exchange_dir_for(str(tmp_path /
                                               "m.txt.manifest.json"))
    for r in (2, 0):
        dist.write_rank_snapshot(xdir, dist.rank_snapshot(rank=r, world=3))
    with pytest.raises(TimeoutError, match=r"ranks \[1\]"):
        dist.gather_rank_snapshots(xdir, 3, timeout_s=0.2, poll_s=0.05)
    dist.write_rank_snapshot(xdir, snap)
    got = dist.gather_rank_snapshots(xdir, 3, timeout_s=1)
    assert [s["process_index"] for s in got] == [0, 1, 2]
    # the flight recorder's dump carries the env's rank
    flightrec.set_dump_dir(str(tmp_path))
    path = flightrec.dump(reason="t")
    assert os.path.basename(path).startswith("flightrec_r1_")
    flightrec.set_dump_dir("")


def test_exchange_of_one_merges_locally(tmp_path, monkeypatch):
    monkeypatch.delenv("LGBM_TPU_NUM_PROCESSES", raising=False)
    merged = dist.exchange_snapshots(str(tmp_path / "x"))
    assert merged["world"] == 1 and not os.path.exists(tmp_path / "x")
