"""Phase-attributed device time of the grow loop, from a ``torch.profiler``
trace.

Counterpart of the JAX package's ``obs/device_time.py``.  Host timers
cannot see where the card spends a tree: the learners enqueue launches
and the card runs them later.  Attribution comes from two halves:

1. **Scopes at run time** (:func:`phase_scope`): the learners wrap the
   PyTorch ops between the kernels (the order route's partition and
   gathers, the score update, the level search, prediction) in
   ``torch.profiler.record_function("lgbm.<phase>")`` while a trace is
   being captured; the profiler turns each into a ``gpu_user_annotation``
   range on the device track over the kernels launched inside it.  With
   no trace running the scope is one shared no-op, so the untraced hot
   path pays one flag read.
2. **Bucketing at read time** (:func:`bucket_events`,
   :func:`phase_breakdown_from_trace`): the Chrome trace's device events
   (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``) go to the phase of
   the innermost ``lgbm.*`` range around them, else to the phase of the
   kernel's name (``KERNEL_PHASES``: every ``__global__`` kernel of
   ``csrc/``), else to the JAX package's name patterns, else to
   ``unattributed``; host events are dropped.

Capture is opt-in (``with trace_phases(dir) as result: ...``, or the
CLI's ``profile=true``): a profiler is not free, so the always-on layer
keeps counters and spans, and a trace is taken when someone asks where
the device time went.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from contextlib import nullcontext
from typing import Dict, Iterable, List, Optional, Sequence

import torch

# the grow loop's phases (and predict); the manifest's keys
PHASES = ("histogram", "split-search", "partition", "leaf-update",
          "predict")

# scope name -> phase.  The split step (kernel 8) does the partition and
# the left child's histogram in one launch; it is partition, as in the
# JAX package.
SCOPE_TO_PHASE: Dict[str, str] = {
    "lgbm.histogram": "histogram",
    "lgbm.split_search": "split-search",
    "lgbm.partition": "partition",
    "lgbm.split_step": "partition",
    "lgbm.leaf_update": "leaf-update",
    "lgbm.predict": "predict",
}

# every __global__ kernel of lightgbm_tpu_torch/csrc -> its phase
# (tests/test_torch_device_time.py fails on a kernel missing here)
KERNEL_PHASES: Dict[str, str] = {
    # K8, K6/K7/K9, F1's partition of the leaf map, K1''/K2's chunk table
    "split_step_kernel": "partition",
    "compact_kernel": "partition",
    "place_kernel": "partition",
    "write_kernel": "partition",
    "scatter_kernel": "partition",
    "count_kernel": "partition",
    "layout_kernel": "partition",
    # K1/K1'/K1-f64, K1''/K2/K1''-f64, S1, F1's histogram
    "sorted_partial_kernel": "histogram",
    "walk_partial_kernel": "histogram",
    "hist_reduce_kernel": "histogram",
    "chunk_groups_reduce_kernel": "histogram",
    "level_reduce_kernel": "histogram",
    "group_reduce_kernel": "histogram",
    "sorted_products_kernel": "histogram",
    "s1_rows_kernel": "histogram",
    "s1_leaf_total_kernel": "histogram",
    "s1_stored_kernel": "histogram",
    "s1_fold_kernel": "histogram",
    "lane_hist_kernel": "histogram",
    # K3/K4/K5/K3-f64, F3
    "search2_kernel": "split-search",
    "search2_step_kernel": "split-search",
    "search2_cluster_kernel": "split-search",
    "lane_search_kernel": "split-search",
    "lane_step_kernel": "split-search",
    # P1, P2
    "p1_kernel": "predict",
    "p2_rows_kernel": "predict",
    "p2_slots_kernel": "predict",
}

# the JAX package's name patterns, first match wins, for events no scope
# and no kernel name places
_KERNEL_PATTERNS = (
    (re.compile(r"hist", re.I), "histogram"),
    (re.compile(r"split_step|place|compact|partition|route|write_window"
                r"|compress_half|lane_cumsum", re.I), "partition"),
    (re.compile(r"best_split|search|gain", re.I), "split-search"),
    (re.compile(r"post_grow|leaf_value|shrink", re.I), "leaf-update"),
    (re.compile(r"predict|ensemble|path_table|tree_hit", re.I), "predict"),
)

# the trace's device work; everything else is the host's
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_SCOPE_CAT = "gpu_user_annotation"
_IDENT = re.compile(r"[A-Za-z_]\w*")
_NOOP = nullcontext()


def phase_scope(phase: str):
    """``with phase_scope("histogram"): ...`` — a
    ``torch.profiler.record_function("lgbm.<phase>")`` while a profiler
    is recording (dashes become underscores, the keys of
    :data:`SCOPE_TO_PHASE`), else one shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _NOOP
    return torch.profiler.record_function("lgbm." + phase.replace("-", "_"))


def classify_event(name: str, long_name: str = "") -> Optional[str]:
    """Phase of one trace event by its names, or None: a scope path in
    either name, then a kernel name of ``KERNEL_PHASES`` (the first
    identifier of a demangled signature that is one), then the JAX
    package's patterns."""
    hay = f"{name} {long_name}"
    for scope, phase in SCOPE_TO_PHASE.items():
        if scope in hay:
            return phase
    for ident in _IDENT.findall(hay):
        if ident in KERNEL_PHASES:
            return KERNEL_PHASES[ident]
    for pat, phase in _KERNEL_PATTERNS:
        if pat.search(hay):
            return phase
    return None


def _scope_ranges(events: Sequence[dict]) -> Dict[object, List[tuple]]:
    """pid -> [(start, end, phase)] of the ``lgbm.*`` device ranges."""
    ranges: Dict[object, List[tuple]] = {}
    for ev in events:
        if ev.get("cat") != _SCOPE_CAT or ev.get("ph") != "X":
            continue
        phase = SCOPE_TO_PHASE.get(str(ev.get("name", "")))
        if phase is None or "dur" not in ev:
            continue
        t0 = float(ev["ts"])
        ranges.setdefault(ev.get("pid"), []).append(
            (t0, t0 + float(ev["dur"]), phase))
    return ranges


def bucket_events(events: Iterable[dict],
                  cats: Sequence[str] = DEVICE_CATS) -> Dict[str, float]:
    """Bucket a trace's device events into phase -> seconds.

    Only complete (``ph == "X"``) events whose ``cat`` is in ``cats``
    count; each goes to the innermost ``lgbm.*`` device range on its
    device that contains its start, else to :func:`classify_event` of its
    name, else to ``"unattributed"``, so the buckets always sum to the
    trace's device time.  Host events (``cpu_op``, ``user_annotation``,
    ``cuda_runtime`` ...) are dropped: a CPU trace has no device
    seconds."""
    events = [ev for ev in events if isinstance(ev, dict)]
    ranges = _scope_ranges(events)
    work = sorted((ev for ev in events
                   if ev.get("ph") == "X" and ev.get("cat") in cats
                   and "dur" in ev),
                  key=lambda ev: float(ev.get("ts", 0.0)))
    out: Dict[str, float] = {}
    # one sweep a device: the ranges open at each event's start
    pending = {pid: sorted(rs, reverse=True) for pid, rs in ranges.items()}
    active: Dict[object, List[tuple]] = {}
    for ev in work:
        ts, pid = float(ev.get("ts", 0.0)), ev.get("pid")
        todo, live = pending.get(pid, []), active.setdefault(pid, [])
        while todo and todo[-1][0] <= ts:
            live.append(todo.pop())
        live[:] = [r for r in live if r[1] >= ts]
        if live:
            phase = min(live, key=lambda r: r[1] - r[0])[2]
        else:
            phase = classify_event(str(ev.get("name", ""))) \
                or "unattributed"
        out[phase] = out.get(phase, 0.0) + float(ev["dur"]) / 1e6
    return {k: round(v, 6) for k, v in out.items()}


def device_seconds(events: Iterable[dict],
                   cats: Sequence[str] = DEVICE_CATS) -> float:
    """The trace's device time: every complete event of ``cats``."""
    return sum(float(ev["dur"]) for ev in events
               if isinstance(ev, dict) and ev.get("ph") == "X"
               and ev.get("cat") in cats and "dur" in ev) / 1e6


def _trace_files(path: str) -> List[str]:
    if os.path.isfile(path):
        return [path]
    found = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(path, "**", pat),
                                recursive=True)]
    return sorted(found, key=lambda p: (os.path.getmtime(p), p))[-1:]


def load_trace_events(path: str) -> List[dict]:
    """The events of one Chrome trace: ``path`` itself, or the NEWEST
    trace file under the directory ``path`` (a reused profile dir holds
    earlier runs' traces; summing them would count phases twice)."""
    events: List[dict] = []
    for p in _trace_files(path):
        opener = gzip.open if p.endswith(".gz") else open
        try:
            with opener(p, "rt", encoding="utf-8") as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            continue
        evs = data.get("traceEvents") if isinstance(data, dict) else data
        if isinstance(evs, list):
            events.extend(e for e in evs if isinstance(e, dict))
    return events


def phase_breakdown_from_trace(path: str) -> Dict[str, float]:
    """Phase -> device seconds of a trace file (or the newest under a
    directory)."""
    return bucket_events(load_trace_events(path))


class trace_phases:
    """Capture a ``torch.profiler`` trace around a block and bucket it:

        with trace_phases("/tmp/lgbm_trace") as result:
            run_timed_loop()
        print(result.phases)   # {"histogram": ..., "partition": ...}

    The trace (the card's kernels where CUDA is up) is written to
    ``<trace_dir>/phases.<pid>.trace.json`` (``result.path``).  A profiler
    that fails to start or stop degrades to an empty breakdown rather
    than failing the run."""

    def __init__(self, trace_dir: str) -> None:
        self.trace_dir = trace_dir
        self.path: Optional[str] = None
        self.phases: Dict[str, float] = {}
        self._prof = None

    def __enter__(self) -> "trace_phases":
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        except RuntimeError:
            self._prof = None
        return self

    def __exit__(self, *exc) -> None:
        if self._prof is None:
            return
        try:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            self.path = os.path.join(self.trace_dir,
                                     f"phases.{os.getpid()}.trace.json")
            self._prof.export_chrome_trace(self.path)
            self.phases = phase_breakdown_from_trace(self.path)
        except (RuntimeError, OSError):
            self.phases = {}
