"""Runtime observability for training and serving.

Copies of the JAX package's stdlib-only ``obs/`` modules, its device
memory layer on PyTorch's allocator and its trace phases on
``torch.profiler``:

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

* :mod:`~lightgbm_tpu_torch.obs.dist` — the cross-rank layer: the
  collective census of the parallel learners, rank snapshots, their
  merge with skew and straggler attribution, traced collectives and the
  desync sentinel.
* :mod:`~lightgbm_tpu_torch.obs.device_time` — device seconds a grow-loop
  phase from a ``torch.profiler`` trace (``phase_scope``,
  ``trace_phases``, the CLI's ``profile=true``).
* :mod:`~lightgbm_tpu_torch.obs.memmodel` — the analytic device-memory
  model of each training phase (``predict``, ``max_rows``), the OOM
  post-mortem's prediction.
"""

from __future__ import annotations

from . import (device_time, export, flightrec, memmodel,  # noqa: F401
               memory, telemetry, tracing)
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
