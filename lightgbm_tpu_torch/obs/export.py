"""Prometheus text exposition of the telemetry snapshot.

``GET /metrics`` on the serving server renders through here; the same
function serves any embedder that wants to scrape a training process.
Pure string work over one consistent :meth:`Telemetry.snapshot` — no
device touch, no extra locking (the snapshot is already one cut).  A
copy of the JAX package's ``obs/export.py``.

Name scheme — STABLE: these names are the scrape-dashboard contract and
the JAX package's; renaming one is a breaking change.

===============  =====================================================
telemetry kind   exported as
===============  =====================================================
counter ``x.y``  ``lgbm_x_y_total`` (TYPE counter)
span ``x``       ``lgbm_x_seconds_total`` + ``lgbm_x_calls_total``
reservoir ``x``  TYPE summary ``lgbm_x_window{quantile="0.5"|"0.99"}``
                 + ``lgbm_x_window_count`` — quantiles over the
                 SLIDING window (recent behavior), total count for
                 scale; suffixed ``_window`` so it can never collide
                 with the histogram series of the same telemetry name
histogram ``x``  TYPE histogram ``lgbm_x_bucket{le="..."}`` cumulative,
                 ``lgbm_x_sum``, ``lgbm_x_count`` — lifetime-cumulative
                 fixed buckets, the series a scraper can rate() and
                 aggregate across replicas
gauge            caller-provided (live values like queue depth that a
                 snapshot cannot know), TYPE gauge, name passed as-is
===============  =====================================================

Non-alphanumeric characters in telemetry names map to ``_``
(``serving.request_s`` -> ``lgbm_serving_request_s``).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple, Union

_SAN_RE = re.compile(r"[^a-zA-Z0-9_]")

GaugeValue = Union[float, int, Tuple[Union[float, int], str]]


def sanitize(name: str) -> str:
    """Telemetry name -> Prometheus metric-name stem (``lgbm_`` prefix,
    non-alphanumerics to underscores)."""
    san = _SAN_RE.sub("_", name.strip())
    if not san or not (san[0].isalpha() or san[0] == "_"):
        san = "_" + san
    return "lgbm_" + san


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Canonical sample value: integers without a trailing ``.0`` (the
    common case for counters), repr-round-trip floats otherwise."""
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _header(out: List[str], name: str, mtype: str, help_text: str) -> None:
    out.append(f"# HELP {name} {_escape_help(help_text)}")
    out.append(f"# TYPE {name} {mtype}")


def render_prometheus(snapshot: dict,
                      gauges: Optional[Dict[str, GaugeValue]] = None
                      ) -> str:
    """Render one telemetry snapshot (``Telemetry.snapshot()`` shape)
    as Prometheus text exposition format (version 0.0.4).  ``gauges``
    maps full metric names to ``value`` or ``(value, help)`` for live
    values the snapshot cannot carry (queue depth, swap age)."""
    out: List[str] = []

    for name, (value, help_text) in sorted(
            (k, v if isinstance(v, tuple) else (v, k))
            for k, v in (gauges or {}).items()):
        _header(out, name, "gauge", help_text)
        out.append(f"{name} {_fmt(value)}")

    for name, v in sorted((snapshot.get("counters") or {}).items()):
        metric = sanitize(name) + "_total"
        _header(out, metric, "counter", f"telemetry counter {name}")
        out.append(f"{metric} {_fmt(v)}")

    for name, st in sorted((snapshot.get("spans") or {}).items()):
        stem = sanitize(name)
        _header(out, stem + "_seconds_total", "counter",
                f"accumulated host-wall seconds of span {name}")
        out.append(f"{stem}_seconds_total {_fmt(st.get('total_s', 0.0))}")
        _header(out, stem + "_calls_total", "counter",
                f"completions of span {name}")
        out.append(f"{stem}_calls_total {_fmt(st.get('count', 0))}")

    for name, r in sorted((snapshot.get("reservoirs") or {}).items()):
        metric = sanitize(name) + "_window"
        _header(out, metric, "summary",
                f"sliding-window quantiles of reservoir {name} "
                f"(window={r.get('window', 0)})")
        out.append(f'{metric}{{quantile="0.5"}} '
                   f"{_fmt(r.get('p50_s', 0.0))}")
        out.append(f'{metric}{{quantile="0.99"}} '
                   f"{_fmt(r.get('p99_s', 0.0))}")
        out.append(f"{metric}_count {_fmt(r.get('count', 0))}")

    for name, h in sorted((snapshot.get("histograms") or {}).items()):
        metric = sanitize(name)
        _header(out, metric, "histogram",
                f"fixed-bucket histogram of {name} (seconds)")
        bounds = h.get("bounds") or []
        counts = h.get("counts") or []
        cum = 0
        for le, c in zip(bounds, counts):
            cum += int(c)
            out.append(f'{metric}_bucket{{le="{_fmt(le)}"}} {cum}')
        total = int(h.get("count", 0))
        out.append(f'{metric}_bucket{{le="+Inf"}} {total}')
        out.append(f"{metric}_sum {_fmt(h.get('sum', 0.0))}")
        out.append(f"{metric}_count {total}")

    return "\n".join(out) + "\n"


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
