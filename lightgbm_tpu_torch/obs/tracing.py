"""Request tracing: trace ids + per-stage monotonic clocks for serving.

A copy of the JAX package's ``obs/tracing.py`` (stdlib only).  Beside
the end-to-end ``serving.request_s`` reservoir, it says whether a
request's time went to queue wait, pad/copy, device dispatch or
scatter: a :class:`TraceContext` is minted at the edge
(``MicroBatchQueue.submit`` or HTTP ingress — the ``X-LGBM-Trace-Id``
header is honored and echoed), rides the request through coalescing and
dispatch, and accumulates one duration per stage:

==============  =======================================================
stage           what it covers
==============  =======================================================
``queue_wait_s``  submit() → the dispatcher takes the batch
``pad_s``         host-side bucket pad/copy + device transfer handoff
``device_s``      kernel launch + device wait + result fetch
``scatter_s``     everything after the fetch: f64 transform, per-row
                  slicing, future resolution (measured as the residual
                  of real timestamps, so the four stages sum EXACTLY to
                  the end-to-end latency — the tier-1 pin)
==============  =======================================================

``pad_s``/``device_s`` are per-*batch* measurements shared by every
request the batch coalesced — that is the honest attribution: a
coalesced request really did pay the whole batch's pad and dispatch
wall, that being the price of riding along.  Each finished request
feeds every stage into its own labeled telemetry reservoir
(``serving.stage.<stage>``, p50/p99 in manifests and bench artifacts)
AND fixed-bucket histogram (the ``/metrics`` exposition).

Env: ``LGBM_TPU_TRACING`` = ``on`` (default) | ``off``, read once at
import; :func:`set_enabled` is the runtime switch.  Off means: no ids
minted, no stage clocks read — the ``PredictionResult`` then carries an
empty trace id and no stages.  Nothing here touches a device tensor.
"""

from __future__ import annotations

import itertools
import re
import time
import uuid
from os import environ as _environ
from typing import Dict, Optional

from . import telemetry

# read once at import — see module docstring
TRACING_MODE = _environ.get("LGBM_TPU_TRACING", "on").strip().lower()

_ENABLED = TRACING_MODE != "off"

# trace ids are a random per-process prefix + a monotonic counter (GIL
# makes next() atomic): globally unique in practice, and ~10x cheaper
# than a uuid4 per request — minting is on the submit hot path and the
# difference was visible in the tracing-overhead A/B on one core
_ID_PREFIX = uuid.uuid4().hex[:16]
_ID_SEQ = itertools.count()

# the stage names, in pipeline order (the bench artifact + docs contract)
STAGES = ("queue_wait_s", "pad_s", "device_s", "scatter_s")

# reservoir/histogram prefix: serving.stage.queue_wait_s etc.
STAGE_METRIC_PREFIX = "serving.stage."

# inbound X-LGBM-Trace-Id values are caller-controlled: accept a sane
# charset/length, mint a fresh id otherwise (never 400 a predict over
# a decorative header).  fullmatch, not match-with-$: '$' would accept
# a trailing newline
_TRACE_ID_RE = re.compile(r"[A-Za-z0-9._\-]{1,128}")


def valid_trace_id(tid) -> bool:
    return isinstance(tid, str) and bool(_TRACE_ID_RE.fullmatch(tid))


def set_enabled(flag: bool) -> None:
    """Runtime tracing switch (the overhead A/B measurement hook)."""
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


def new_trace_id() -> str:
    return f"{_ID_PREFIX}{next(_ID_SEQ) & 0xFFFFFFFFFFFFFFFF:016x}"


class StageClock:
    """Mutable per-stage duration accumulator.  The engine receives one
    per dispatch (``clock=``) and adds its pad/device measurements;
    stage keys accumulate, so a row-chunked oversize request sums its
    chunks' stages."""

    __slots__ = ("stages",)

    def __init__(self) -> None:
        self.stages: Dict[str, float] = {}

    def add(self, stage: str, seconds: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + seconds

    def get(self, stage: str) -> float:
        return self.stages.get(stage, 0.0)


class TraceContext(StageClock):
    """One request's identity + stage clock (see module docstring)."""

    __slots__ = ("trace_id", "t_origin")

    def __init__(self, trace_id: Optional[str] = None) -> None:
        super().__init__()
        self.trace_id = (trace_id if trace_id and valid_trace_id(trace_id)
                         else new_trace_id())
        self.t_origin = time.perf_counter()


def mint(trace_id: Optional[str] = None) -> Optional[TraceContext]:
    """A fresh TraceContext, or None when tracing is off (callers
    guard stage work on the context's existence, so off really costs
    nothing)."""
    if not _ENABLED:
        return None
    return TraceContext(trace_id)


def record_stages(trace: StageClock,
                  extra: Optional[Dict[str, float]] = None) -> None:
    """Feed one finished request's stages into the labeled telemetry
    reservoirs (manifest/bench p50-p99) and histograms (/metrics), in
    ONE store-lock acquisition.  ``extra`` rides along (the scatter
    path adds the end-to-end ``serving.request_s`` sample)."""
    samples = {STAGE_METRIC_PREFIX + k: v
               for k, v in trace.stages.items()}
    if extra:
        samples.update(extra)
    telemetry.record_samples(samples)
