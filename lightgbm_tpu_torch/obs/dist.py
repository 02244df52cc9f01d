"""The cross-rank collective census.

Counterpart of the one counter of lightgbm_tpu/obs/dist.py that the
parallel learners feed (``record_collective_site``, :444-454); the rest
of that module (rank snapshots, straggler attribution, the desync
sentinel) is ROADMAP A8 step 3.  The JAX package records a site once
per trace of the program that holds it; the port runs eagerly, so every
call records: ``collective_site.<site>.<op>`` counts the calls and
``collective_site_bytes.<site>`` sums their result bytes.
"""

from __future__ import annotations

from . import telemetry


def record_collective_site(site: str, op: str, nbytes: int) -> None:
    """One collective call at ``site`` (``op`` one of ``all-reduce``,
    ``reduce-scatter``, ``all-gather``) with a result of ``nbytes``."""
    telemetry.count_many({
        f"collective_site.{site}.{op}": 1,
        f"collective_site_bytes.{site}": int(nbytes),
    })


def collective_census() -> dict:
    """The census counters since the telemetry was last reset."""
    counters = telemetry.get_telemetry().snapshot()["counters"]
    return {k: v for k, v in counters.items()
            if k.startswith("collective_site")}
