"""Distributed-run observability: the collective census, rank-scoped
telemetry, cross-rank merging with skew attribution, per-collective
tracing and the desync sentinel.

The port of lightgbm_tpu/obs/dist.py over a ``torch.distributed`` world
(one process a rank) instead of a JAX multi-process runtime:

* **Census** — :func:`record_collective_site` counts every collective
  call of the parallel learners (parallel/mesh.py):
  ``collective_site.<site>.<op>`` counts the calls and
  ``collective_site_bytes.<site>`` sums their result bytes.  The JAX
  package records a site once per trace of the program that holds it;
  the port runs eagerly, so every call records.
* **Rank snapshots** — :func:`rank_snapshot` stamps a full telemetry
  snapshot (reservoirs carrying their raw sample windows, so quantiles
  stay recomputable after a merge) with the rank's identity (rank,
  device, pid, host, peak device memory).
* **Merging + skew** — :func:`merge_snapshots` sums counters, merges
  spans / reservoirs / histograms and computes per-name cross-rank skew
  (max-min, max/mean, which rank); :func:`attribute_stragglers` reads
  the barrier-wait series: the straggler is the rank that waited LEAST
  (it arrived last; every other rank's wait is time spent waiting for
  it).
* **Exchange** — :func:`exchange_snapshots`: every rank atomically
  writes ``rank_<i>.json`` into a shared directory and rank 0 polls for
  them under a deadline: host files, not a collective, so a dead peer
  costs a timeout naming it, not a wedged world.
* **Per-collective tracing** — :func:`traced_collective` runs a
  host-blocking collective through resilience/retry.py's
  ``guarded_collective`` (the chaos injection point, pre-dispatch
  retry, a deadline), with an optional barrier before it timed apart
  (``collective.<label>.wait_s``, straggler time) from the payload
  (``.transfer_s``); op kind and bytes feed ``collective_ops`` /
  ``collective_bytes``.
* **Desync sentinel** — :class:`DesyncSentinel`: one ``int32[3]``
  all-gather of ``(step, fingerprint, rank)`` a checked tree; a
  mismatch raises :class:`DesyncError` NAMING the diverging rank and
  the iteration, after a flight-recorder dump (tail
  ``desync_detected``).

Rank identity (:func:`process_index`, :func:`process_count`) is the
``torch.distributed`` world where one is up, else the launcher env
(``LGBM_TPU_PROCESS_ID`` / ``LGBM_TPU_NUM_PROCESSES``, which a gang
supervisor gives its rank children), else 0 of 1.

Env knobs (read once at import, as the JAX package reads them):

* ``LGBM_TPU_DESYNC_CHECK`` — ``1`` (default): verify every tree;
  ``N``: every N trees; ``0``: off.
* ``LGBM_TPU_COLLECTIVE_TRACE`` — ``on`` (default) | ``off``: off skips
  traced_collective's barrier (one collective a site instead of two)
  and records the transfer only.

The module imports no torch at import; the world is read lazily.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import sys
import time
import zlib
from os import environ as _environ
from typing import Callable, Dict, List, Optional, Sequence

from . import flightrec, telemetry

RANK_SCHEMA = "lightgbm-tpu/rank-snapshot/v1"
MERGED_SCHEMA = "lightgbm-tpu/merged-telemetry/v1"
MULTICHIP_SCHEMA = "lightgbm-tpu/multichip-bench/v1"

# read once at import — see module docstring
try:
    DESYNC_CHECK_EVERY = int(_environ.get("LGBM_TPU_DESYNC_CHECK", "1"))
except ValueError:
    DESYNC_CHECK_EVERY = 1
COLLECTIVE_TRACE = _environ.get(
    "LGBM_TPU_COLLECTIVE_TRACE", "on").strip().lower() != "off"


# ------------------------------------------------------------ rank identity
def _world() -> Optional[tuple]:
    """(rank, size) of the ``torch.distributed`` world where one is up
    (never imports torch: a process that has not imported it has no
    world)."""
    tdist = sys.modules.get("torch.distributed")
    try:
        if tdist is not None and tdist.is_available() \
                and tdist.is_initialized():
            return tdist.get_rank(), tdist.get_world_size()
    except Exception:  # noqa: BLE001 — a torn-down world reads as none
        pass
    return None


def process_index() -> int:
    """This process's rank: the world's, else the launcher env, else 0."""
    w = _world()
    if w is not None:
        return int(w[0])
    try:
        return int(_environ.get("LGBM_TPU_PROCESS_ID", "0") or 0)
    except ValueError:
        return 0


def process_count() -> int:
    """World size, resolved like :func:`process_index`."""
    w = _world()
    if w is not None:
        return int(w[1])
    try:
        return max(1, int(_environ.get("LGBM_TPU_NUM_PROCESSES", "1") or 1))
    except ValueError:
        return 1


def _device_info() -> dict:
    """This process's device identity: the card where the process has
    initialized CUDA, else the CPU (never initializes CUDA itself)."""
    torch = sys.modules.get("torch")
    try:
        if torch is not None and torch.cuda.is_initialized():
            idx = torch.cuda.current_device()
            return {"backend": "cuda",
                    "kind": torch.cuda.get_device_name(idx),
                    "local_count": int(torch.cuda.device_count())}
    except Exception as e:  # noqa: BLE001
        return {"error": f"{type(e).__name__}: {str(e)[:80]}"}
    return {"backend": "cpu", "kind": "cpu", "local_count": 1}


# ------------------------------------------------------------ rank snapshot
def rank_snapshot(tel: Optional[telemetry.Telemetry] = None,
                  rank: Optional[int] = None,
                  world: Optional[int] = None,
                  extra: Optional[dict] = None) -> dict:
    """One rank's full telemetry snapshot, stamped with its identity.
    Reservoirs carry their raw sample windows (``include_samples``) so a
    merge recomputes exact window quantiles instead of averaging
    percentiles (wrong for any skewed distribution)."""
    tel = tel or telemetry.get_telemetry()
    snap = {
        "schema": RANK_SCHEMA,
        "process_index": process_index() if rank is None else int(rank),
        "process_count": process_count() if world is None else int(world),
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "device": _device_info(),
        "created_unix": round(time.time(), 3),
        "telemetry": tel.snapshot(include_samples=True),
        "extra": dict(extra or {}),
    }
    # gang membership (resilience/gang.py): a supervised rank stamps its
    # slot and gang id, so a recovery timeline is attributable
    gang_dir = os.environ.get("LGBM_TPU_GANG_DIR", "")
    if gang_dir:
        snap["gang"] = {
            "gang_id": os.environ.get("LGBM_TPU_GANG_ID", "gang"),
            "slot": int(os.environ.get("LGBM_TPU_GANG_SLOT", "0") or 0),
            "barrier_every": int(
                os.environ.get("LGBM_TPU_GANG_BARRIER_EVERY", "0") or 0),
        }
    # the rank's device-memory high-water mark, so the merged artifact
    # shows memory skew beside time skew (0 on the CPU); an
    # extra-provided value wins (tests)
    if "hbm_peak_bytes" not in snap["extra"]:
        try:
            from . import memory as obs_memory

            snap["hbm_peak_bytes"] = int(
                obs_memory.device_memory_stats().get("hbm_peak_bytes") or 0)
        except Exception:  # noqa: BLE001 - memory evidence is best-effort
            snap["hbm_peak_bytes"] = 0
    else:
        snap["hbm_peak_bytes"] = int(snap["extra"]["hbm_peak_bytes"])
    return snap


def _skew(per_rank: Dict[int, float]) -> dict:
    """Cross-rank skew of one named series: max-min and max/mean plus
    WHICH rank sits at each extreme."""
    ranks = sorted(per_rank)
    vals = [per_rank[r] for r in ranks]
    vmax, vmin = max(vals), min(vals)
    mean = sum(vals) / len(vals)
    return {
        "per_rank": {str(r): round(per_rank[r], 6) for r in ranks},
        "mean_s": round(mean, 6),
        "max_s": round(vmax, 6),
        "min_s": round(vmin, 6),
        "max_minus_min_s": round(vmax - vmin, 6),
        "max_over_mean": round(vmax / mean, 4) if mean > 0 else 0.0,
        "max_rank": ranks[vals.index(vmax)],
        "min_rank": ranks[vals.index(vmin)],
        "reported": len(ranks),
    }


def merge_snapshots(snaps: Sequence[dict]) -> dict:
    """Merge per-rank snapshots (:func:`rank_snapshot` shape) into ONE
    cross-rank view: counters summed in rank order; spans' total and
    count summed, min / max over ranks, ``span_skew`` over per-rank
    totals; reservoirs' windows concatenated in rank order with their
    quantiles recomputed, ``reservoir_skew`` over per-rank window means;
    histograms' buckets summed where the bounds agree, a bounds mismatch
    RECORDED in ``histogram_merge_conflicts``."""
    if not snaps:
        raise ValueError("merge_snapshots: no snapshots to merge")
    by_rank = sorted(snaps, key=lambda s: int(s.get("process_index", 0)))
    ranks = [int(s.get("process_index", 0)) for s in by_rank]
    if len(set(ranks)) != len(ranks):
        raise ValueError(f"merge_snapshots: duplicate ranks {ranks}")

    counters: Dict[str, float] = {}
    span_tot: Dict[str, dict] = {}
    span_per_rank: Dict[str, Dict[int, float]] = {}
    res_samples: Dict[str, List[float]] = {}
    res_count: Dict[str, int] = {}
    res_per_rank_mean: Dict[str, Dict[int, float]] = {}
    hists: Dict[str, dict] = {}
    hist_conflicts: List[str] = []

    for s in by_rank:
        r = int(s.get("process_index", 0))
        t = s.get("telemetry") or {}
        for k, v in (t.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, st in (t.get("spans") or {}).items():
            tot = span_tot.setdefault(
                k, {"total_s": 0.0, "count": 0,
                    "min_s": float("inf"), "max_s": 0.0})
            tot["total_s"] += float(st.get("total_s", 0.0))
            tot["count"] += int(st.get("count", 0))
            tot["min_s"] = min(tot["min_s"], float(st.get("min_s", 0.0)))
            tot["max_s"] = max(tot["max_s"], float(st.get("max_s", 0.0)))
            span_per_rank.setdefault(k, {})[r] = float(st.get("total_s", 0.0))
        for k, rd in (t.get("reservoirs") or {}).items():
            samples = [float(x) for x in (rd.get("samples") or [])]
            res_samples.setdefault(k, []).extend(samples)
            res_count[k] = res_count.get(k, 0) + int(rd.get("count", 0))
            res_per_rank_mean.setdefault(k, {})[r] = float(
                rd.get("mean_s", 0.0))
        for k, hd in (t.get("histograms") or {}).items():
            cur = hists.get(k)
            if cur is None:
                hists[k] = {"bounds": list(hd.get("bounds") or []),
                            "counts": [int(c) for c in
                                       (hd.get("counts") or [])],
                            "count": int(hd.get("count", 0)),
                            "sum": float(hd.get("sum", 0.0))}
            elif cur["bounds"] != list(hd.get("bounds") or []):
                if k not in hist_conflicts:
                    hist_conflicts.append(k)
            else:
                cur["counts"] = [a + int(b) for a, b in
                                 zip(cur["counts"], hd.get("counts") or [])]
                cur["count"] += int(hd.get("count", 0))
                cur["sum"] += float(hd.get("sum", 0.0))

    spans = {}
    for k, tot in span_tot.items():
        spans[k] = {
            "total_s": round(tot["total_s"], 6),
            "count": tot["count"],
            "min_s": round(tot["min_s"], 6)
            if tot["min_s"] != float("inf") else 0.0,
            "max_s": round(tot["max_s"], 6),
        }
    reservoirs = {}
    for k, samples in res_samples.items():
        window = len(samples)
        srt = sorted(samples)

        def _pct(p: float) -> float:
            if not srt:
                return 0.0
            i = max(0, min(len(srt) - 1,
                           int(round(p / 100.0 * (len(srt) - 1)))))
            return srt[i]

        reservoirs[k] = {
            "count": res_count.get(k, 0),
            "window": window,
            "mean_s": round(sum(samples) / window, 6) if window else 0.0,
            "p50_s": round(_pct(50), 6),
            "p99_s": round(_pct(99), 6),
            "max_s": round(srt[-1], 6) if srt else 0.0,
        }

    return {
        "schema": MERGED_SCHEMA,
        "world": len(by_rank),
        "ranks": ranks,
        "counters": counters,
        "spans": spans,
        "span_skew": {k: _skew(v) for k, v in span_per_rank.items()
                      if len(v) > 1},
        "reservoirs": reservoirs,
        "reservoir_skew": {k: _skew(v)
                           for k, v in res_per_rank_mean.items()
                           if len(v) > 1},
        "histograms": hists,
        "histogram_merge_conflicts": hist_conflicts,
    }


# straggler attribution reads the barrier-wait series per rank: the rank
# that waited LEAST arrived LAST
_WAIT_SUFFIX = ".wait_s"
# a skew below this floor is scheduling noise, not a straggler
STRAGGLER_FLOOR_S = 0.005


def attribute_stragglers(merged: dict,
                         floor_s: float = STRAGGLER_FLOOR_S) -> List[dict]:
    """Name the straggling rank per collective site from a merged
    snapshot's barrier-wait skews: ``[{site, straggler_rank,
    wait_skew_s, max_over_mean}]``, worst first; empty when no wait
    series shows skew above ``floor_s``."""
    out = []
    for name, sk in (merged.get("reservoir_skew") or {}).items():
        if not name.endswith(_WAIT_SUFFIX):
            continue
        if sk["max_minus_min_s"] < floor_s:
            continue
        site = name[len("collective."):-len(_WAIT_SUFFIX)] \
            if name.startswith("collective.") else name
        out.append({
            "site": site,
            "straggler_rank": sk["min_rank"],
            "wait_skew_s": sk["max_minus_min_s"],
            "max_over_mean": sk["max_over_mean"],
        })
    out.sort(key=lambda d: -d["wait_skew_s"])
    return out


# ---------------------------------------------------------------- exchange
def exchange_dir_for(artifact_path: str) -> str:
    """The rank-snapshot exchange directory of a run artifact: the env
    override (``LGBM_TPU_RANK_OBS_DIR``) wins, else a ``<artifact>
    .rankobs`` sibling."""
    env = _environ.get("LGBM_TPU_RANK_OBS_DIR", "")
    if env:
        return env
    return os.path.abspath(artifact_path) + ".rankobs"


def _rank_file(directory: str, rank: int) -> str:
    return os.path.join(directory, f"rank_{rank}.json")


def write_rank_snapshot(directory: str,
                        snap: Optional[dict] = None) -> str:
    """Atomically publish this rank's snapshot into the exchange dir."""
    from ..resilience.atomic import atomic_write_json

    snap = snap or rank_snapshot()
    os.makedirs(directory, exist_ok=True)
    path = _rank_file(directory, int(snap["process_index"]))
    atomic_write_json(path, snap)
    return path


def gather_rank_snapshots(directory: str, world: int,
                          timeout_s: float = 120.0,
                          poll_s: float = 0.1) -> List[dict]:
    """Rank 0's half of the exchange: poll until all ``world`` files are
    present (an atomic write makes a present file a complete one), then
    load them in rank order.  Raises ``TimeoutError`` naming the MISSING
    ranks."""
    deadline = time.monotonic() + timeout_s
    want = {r: _rank_file(directory, r) for r in range(world)}
    while True:
        missing = [r for r, p in want.items() if not os.path.exists(p)]
        if not missing:
            break
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"rank-snapshot exchange: ranks {missing} never published "
                f"into {directory} within {timeout_s:.0f}s — those "
                "processes likely died; check their logs/flight recorders")
        time.sleep(poll_s)
    snaps = []
    for r in range(world):
        with open(want[r]) as fh:
            snaps.append(json.load(fh))
    return snaps


def exchange_snapshots(directory: str, timeout_s: float = 120.0,
                       extra: Optional[dict] = None) -> Optional[dict]:
    """End-of-run exchange: every rank publishes, rank 0 gathers and
    merges.  The merged snapshot on rank 0, None on the others; a world
    of one merges its own snapshot (same shape, no files)."""
    world = process_count()
    rank = process_index()
    snap = rank_snapshot(extra=extra)
    if world <= 1:
        return merge_snapshots([snap])
    write_rank_snapshot(directory, snap)
    if rank != 0:
        return None
    return merge_snapshots(
        gather_rank_snapshots(directory, world, timeout_s=timeout_s))


def ranks_section(snaps: Sequence[dict]) -> List[dict]:
    """The manifest's ``ranks[]``: each rank's identity and counters,
    spans and reservoir summaries WITHOUT the raw sample windows (those
    stay in the exchange dir)."""
    out = []
    for s in sorted(snaps, key=lambda s: int(s.get("process_index", 0))):
        t = s.get("telemetry") or {}
        res = {k: {kk: v[kk] for kk in ("count", "mean_s", "p50_s", "p99_s")
                   if kk in v}
               for k, v in (t.get("reservoirs") or {}).items()}
        row = {
            "process_index": int(s.get("process_index", 0)),
            "pid": s.get("pid"),
            "host": s.get("host"),
            "device": s.get("device") or {},
            "counters": dict(t.get("counters") or {}),
            "spans": dict(t.get("spans") or {}),
            "reservoirs": res,
        }
        hbm = s.get("hbm_peak_bytes",
                    (s.get("extra") or {}).get("hbm_peak_bytes"))
        if hbm is not None:
            row["hbm_peak_bytes"] = int(hbm)
        if s.get("gang"):
            row["gang"] = dict(s["gang"])
        out.append(row)
    return out


# ------------------------------------------------------ collective tracing
def record_collective_site(site: str, op: str, nbytes: int) -> None:
    """One collective call at ``site`` (``op`` one of ``all-reduce``,
    ``reduce-scatter``, ``all-gather``, ``barrier``) with a result of
    ``nbytes``."""
    telemetry.count_many({
        f"collective_site.{site}.{op}": 1,
        f"collective_site_bytes.{site}": int(nbytes),
    })


def collective_census() -> dict:
    """The census counters since the telemetry was last reset."""
    counters = telemetry.get_telemetry().snapshot()["counters"]
    return {k: v for k, v in counters.items()
            if k.startswith("collective_site")}


def traced_collective(fn: Callable, *, op: str, label: str,
                      payload_bytes: int = 0,
                      barrier_fn: Optional[Callable] = None,
                      deadline_s: float = 0.0,
                      retries: int = 2,
                      rank: Optional[int] = None,
                      tel: Optional[telemetry.Telemetry] = None):
    """Run a host-blocking collective with per-site tracing.

    With ``barrier_fn`` (and ``LGBM_TPU_COLLECTIVE_TRACE`` on) the
    barrier's wall time is the straggler wait (every rank must arrive
    before any passes) and the rest the payload transfer; both feed the
    labeled reservoirs ``collective.<label>.wait_s`` / ``.transfer_s``
    that :func:`merge_snapshots` skews and :func:`attribute_stragglers`
    reads.  The call rides :func:`resilience.retry.guarded_collective`
    (chaos injection point, pre-dispatch transient retry attributed to
    ``label``, the deadline); the barrier runs under the same deadline.
    ``rank`` overrides the ``delay_collective`` fault's rank match
    (simulated worlds in tests)."""
    from ..resilience import faults
    from ..resilience.retry import call_with_deadline, guarded_collective

    tel = tel or telemetry.get_telemetry()
    faults.maybe_delay_collective(rank=rank)
    wait_s = 0.0
    t0 = time.perf_counter()
    if barrier_fn is not None and COLLECTIVE_TRACE:
        call_with_deadline(barrier_fn, deadline_s,
                           what=f"{label} barrier")
        wait_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    out = guarded_collective(fn, deadline_s=deadline_s, label=label,
                             retries=retries)
    transfer_s = time.perf_counter() - t1
    tel.count_many({
        "collective_ops": 1,
        f"collective_ops.op.{op}": 1,
        "collective_bytes": int(payload_bytes),
        f"collective_bytes.op.{op}": int(payload_bytes),
    })
    tel.record_samples({
        f"collective.{label}.wait_s": wait_s,
        f"collective.{label}.transfer_s": transfer_s,
    })
    return out


def world_barrier(site: str = "") -> None:
    """A barrier over the default process group: ``monitored_barrier``
    on gloo (it names a rank that never arrives), ``barrier`` on the
    card's device under NCCL.  Counted in the census as ``<site>
    .barrier`` where ``site`` is given."""
    import torch
    import torch.distributed as tdist

    if str(tdist.get_backend()) == "gloo":
        tdist.monitored_barrier()
    else:
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    if site:
        record_collective_site(site, "barrier", 0)


def world_allgather_int32(values, site: str = ""):
    """``[world, len(values)]`` int32 numpy: every rank's ``values`` in
    rank order, over the default process group (a CPU tensor on gloo,
    the card's under NCCL).  Counted in the census where ``site`` is
    given."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    row = torch.as_tensor(np.asarray(values, np.int32).reshape(-1))
    if str(tdist.get_backend()) != "gloo":
        row = row.to(torch.device("cuda", torch.cuda.current_device()))
    world = tdist.get_world_size()
    out = row.new_empty((world * row.numel(),))
    tdist.all_gather_into_tensor(out, row)
    if site:
        record_collective_site(site, "all-gather", out.numel() * 4)
    return out.cpu().numpy().reshape(world, -1)


# --------------------------------------------------------- desync sentinel
class DesyncError(RuntimeError):
    """Two ranks disagree on what iteration or model they are training.
    Raised the iteration the divergence is observed, NAMING the rank."""


def state_fingerprint(step: int, config_fp: int, *payloads) -> int:
    """int31 fingerprint of one iteration's state: the step, the
    structural-config crc and any host bytes the caller covers (the
    grown tree's fields — crc32 of a few KB a tree).  Masked to int31 so
    the int32 transport is lossless."""
    h = zlib.crc32(f"{step}|{config_fp}".encode())
    for p in payloads:
        if p is None:
            continue
        if isinstance(p, (bytes, bytearray)):
            h = zlib.crc32(p, h)
        else:
            h = zlib.crc32(repr(p).encode(), h)
    return h & 0x7FFFFFFF


def config_crc(obj) -> int:
    """Structural-config half of the fingerprint (stable across ranks
    by construction: the config sync verified it)."""
    try:
        blob = repr(sorted(vars(obj).items())) if hasattr(obj, "__dict__") \
            else repr(obj)
    except Exception:  # noqa: BLE001 — any stable repr will do
        blob = repr(obj)
    return zlib.crc32(blob.encode()) & 0x7FFFFFFF


class DesyncSentinel:
    """Cross-rank agreement check on a per-tree sync point.

    Each rank contributes ``[step, fingerprint, rank]`` (int32) to one
    all-gather; every rank then checks that all rows agree on (step,
    fingerprint).  A mismatch names the diverging rank(s) by majority
    (the minority rows; on a tie the highest-rank minority) and raises
    :class:`DesyncError` within the iteration, after recording a
    flight-recorder event and dumping the ring (tail
    ``desync_detected``).

    ``gather_fn(row) -> [world, 3]`` defaults to the world's all-gather
    (:func:`world_allgather_int32`, census site ``desync_sentinel``)
    through :func:`traced_collective` with a :func:`world_barrier`
    before it; tests inject a fake gather to make up peer worlds in one
    process.
    """

    def __init__(self, world: Optional[int] = None,
                 rank: Optional[int] = None,
                 gather_fn: Optional[Callable] = None,
                 check_every: int = DESYNC_CHECK_EVERY,
                 deadline_s: float = 0.0) -> None:
        self.world = process_count() if world is None else int(world)
        self.rank = process_index() if rank is None else int(rank)
        self.check_every = int(check_every)
        self.deadline_s = deadline_s
        self._gather = gather_fn

    def local_row(self, step: int, fp: int):
        """This rank's sentinel row, with the ``desync_step`` fault
        applied (a matching rank perturbs its fingerprint ONCE)."""
        import numpy as np

        from ..resilience import faults

        if faults.maybe_desync_step(rank=self.rank):
            fp = (fp + 1) & 0x7FFFFFFF
        return np.asarray([int(step) & 0x7FFFFFFF, int(fp), self.rank],
                          np.int32)

    def _default_gather(self, row):
        return traced_collective(
            lambda: world_allgather_int32(row, site="desync_sentinel"),
            op="all-gather", label="desync_sentinel",
            payload_bytes=int(row.size) * 4 * self.world,
            barrier_fn=lambda: world_barrier("desync_sentinel"),
            deadline_s=self.deadline_s, rank=self.rank)

    def should_check(self, step: int) -> bool:
        return (self.world > 1 and self.check_every > 0
                and step % self.check_every == 0)

    def verify(self, step: int, fp: int) -> None:
        """Exchange and compare; a no-op in a world of one or off the
        cadence."""
        if not self.should_check(step):
            return
        import numpy as np

        row = self.local_row(step, fp)
        gather = self._gather or self._default_gather
        g = np.asarray(gather(row)).reshape(-1, 3)
        telemetry.count("desync_checks")
        pairs = [(int(r[0]), int(r[1])) for r in g]
        if len(set(pairs)) <= 1:
            return
        # the modal (step, fp) is the world's consensus; every minority
        # row is a divergent rank
        from collections import Counter

        consensus, _ = Counter(pairs).most_common(1)[0]
        divergent = sorted(int(g[i][2]) for i, p in enumerate(pairs)
                           if p != consensus)
        detail = {int(r[2]): {"step": int(r[0]), "fingerprint": int(r[1])}
                  for r in g}
        telemetry.count("desync_detected")
        flightrec.record("desync_detected", iteration=int(step),
                         divergent_ranks=divergent,
                         consensus_step=consensus[0],
                         consensus_fingerprint=consensus[1])
        flightrec.dump(reason="desync")
        raise DesyncError(
            f"cross-rank desync at iteration {int(step)}: rank(s) "
            f"{divergent} disagree with the {len(pairs) - len(divergent)}"
            f"-rank consensus (step={consensus[0]}, "
            f"fingerprint={consensus[1]}); per-rank view: {detail}. "
            "This world is no longer training one model — stop all "
            "ranks and resume from the last checkpoint.")


# ----------------------------------------------------- multichip artifact
def multichip_artifact(merged: dict, snaps: Sequence[dict],
                       result: Optional[dict] = None,
                       extra: Optional[dict] = None) -> dict:
    """The multi-rank evidence blob (``lightgbm-tpu/multichip-bench/v1``):
    merged telemetry, the per-rank breakdown, skew and straggler
    attribution."""
    devices = {}
    for s in snaps:
        d = s.get("device") or {}
        if d.get("backend"):
            devices[d["backend"]] = devices.get(d["backend"], 0) \
                + int(d.get("local_count") or 1)
    return {
        "schema": MULTICHIP_SCHEMA,
        "world": merged.get("world"),
        "devices": devices,
        "result": dict(result or {}),
        "ranks": ranks_section(snaps),
        "merged": {k: merged[k] for k in
                   ("counters", "spans", "reservoirs", "histograms")
                   if k in merged},
        "skew": {"spans": merged.get("span_skew") or {},
                 "reservoirs": merged.get("reservoir_skew") or {}},
        "stragglers": attribute_stragglers(merged),
        "extra": dict(extra or {}),
        "created_unix": round(time.time(), 3),
    }


def _fmt_cell(v) -> str:
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


def render_rank_table(merged: dict, ranks: Sequence[dict],
                      counters: Sequence[str] = (
                          "backend_compiles", "dp_grow_traces",
                          "collective_ops", "desync_checks"),
                      span_prefixes: Sequence[str] = ("dist.grow",),
                      ) -> List[str]:
    """A per-rank table and its skew tail, as lines of text."""
    span_names = sorted(
        n for n in (merged.get("spans") or {})
        if any(n.startswith(p) for p in span_prefixes))
    wait_names = sorted(
        n for n in (merged.get("reservoirs") or {})
        if n.startswith("collective.") and n.endswith(".wait_s"))
    have_hbm = any((r.get("hbm_peak_bytes") or 0) > 0 for r in ranks)
    head = (["rank", "device"] + list(counters)
            + [f"{n} s" for n in span_names]
            + [f"{n[len('collective.'):-len('.wait_s')]} wait-mean s"
               for n in wait_names]
            + (["hbm_peak MiB"] if have_hbm else []))
    rows = [head]
    for r in ranks:
        dev = r.get("device") or {}
        cells = [str(r.get("process_index")),
                 f"{dev.get('backend', '?')}x{dev.get('local_count', '?')}"]
        cnt = r.get("counters") or {}
        cells += [_fmt_cell(cnt.get(c, 0)) for c in counters]
        sp = r.get("spans") or {}
        cells += [_fmt_cell((sp.get(n) or {}).get("total_s", 0.0))
                  for n in span_names]
        res = r.get("reservoirs") or {}
        cells += [_fmt_cell((res.get(n) or {}).get("mean_s", 0.0))
                  for n in wait_names]
        if have_hbm:
            cells.append(f"{(r.get('hbm_peak_bytes') or 0) / 2**20:.2f}")
        rows.append(cells)
    widths = [max(len(row[i]) for row in rows) for i in range(len(head))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
             for row in rows]
    for sk_name, sk in sorted((merged.get("span_skew") or {}).items()):
        if any(sk_name.startswith(p) for p in span_prefixes):
            lines.append(
                f"skew {sk_name}: max-min {sk['max_minus_min_s']:.4f}s "
                f"(max r{sk['max_rank']} / min r{sk['min_rank']}, "
                f"max/mean {sk['max_over_mean']:.2f})")
    for s in attribute_stragglers(merged):
        lines.append(
            f"straggler {s['site']}: rank {s['straggler_rank']} "
            f"(wait skew {s['wait_skew_s']:.4f}s, max/mean "
            f"{s['max_over_mean']:.2f})")
    hbm = {int(r.get("process_index", 0)): int(r.get("hbm_peak_bytes") or 0)
           for r in ranks if (r.get("hbm_peak_bytes") or 0) > 0}
    if len(hbm) >= 2:
        ordered = sorted(hbm)
        vals = [hbm[r] for r in ordered]
        vmax, vmin = max(vals), min(vals)
        pct = 100.0 * (vmax - vmin) / vmin if vmin > 0 else 0.0
        lines.append(
            f"memory skew hbm_peak_bytes: max-min "
            f"{(vmax - vmin) / 2**20:.2f} MiB (+{pct:.1f}%, "
            f"max r{ordered[vals.index(vmax)]} / "
            f"min r{ordered[vals.index(vmin)]})")
    return lines


def merged_manifest_extra(merged: dict) -> dict:
    """The slim merged block a RunManifest carries under
    ``extra.distributed`` (skew, stragglers, merged counters; per-rank
    detail lives in ``ranks[]``)."""
    return {
        "merged_counters": dict(merged.get("counters") or {}),
        "span_skew": merged.get("span_skew") or {},
        "reservoir_skew": merged.get("reservoir_skew") or {},
        "stragglers": attribute_stragglers(merged),
        "world": merged.get("world"),
    }


def artifact_sha(path: str) -> Optional[str]:
    """sha256 of an artifact file, its first 16 hex digits."""
    try:
        with open(path, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()[:16]
    except OSError:
        return None
