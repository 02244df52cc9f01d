"""Runtime observability for the serving tier.

Copies of the JAX package's stdlib-only ``obs/`` modules, and its device
memory layer on PyTorch's allocator:

* :mod:`~lightgbm_tpu_torch.obs.telemetry` — always-on spans /
  counters / reservoirs / histograms (near-zero overhead).
* :mod:`~lightgbm_tpu_torch.obs.tracing` — per-request ``TraceContext``
  (trace id + stage clock) threaded through the serving tier; every
  served response carries a per-stage latency breakdown.
* :mod:`~lightgbm_tpu_torch.obs.export` — Prometheus text exposition of
  the telemetry snapshot (``GET /metrics`` on the serving server).
* :mod:`~lightgbm_tpu_torch.obs.flightrec` — lock-cheap last-N event
  ring, dumped atomically on serving failures and signals.
* :mod:`~lightgbm_tpu_torch.obs.memory` — allocator gauges, an
  owner-tagged census, watermarks and OOM post-mortems.
* :mod:`~lightgbm_tpu_torch.obs.manifest` — ``RunManifest``.

* :mod:`~lightgbm_tpu_torch.obs.dist` — the collective census of the
  parallel learners (``record_collective_site``).

Not ported yet: the rest of ``dist`` (the cross-rank layer, ROADMAP A8
step 3), ``device_time`` (profiler phases) and ``memmodel`` (the
footprint model), ROADMAP A10.
"""

from __future__ import annotations

from . import export, flightrec, memory, telemetry, tracing  # noqa: F401
from .manifest import (  # noqa: F401
    RunManifest,
    config_fingerprint,
    manifest_path,
    validate,
)
from .telemetry import (  # noqa: F401
    Histogram,
    Reservoir,
    SpanStat,
    Telemetry,
    count,
    count_many,
    emit_if_json,
    enabled,
    get_telemetry,
    host_sync,
    observe,
    record_value,
    set_enabled,
    span,
)
from .tracing import TraceContext  # noqa: F401
