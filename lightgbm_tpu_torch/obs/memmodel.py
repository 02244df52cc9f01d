"""Analytic device-memory model of the port: the expected live set of each
phase of training (and serving), from first principles.

Counterpart of the JAX package's ``obs/memmodel.py``, with its schema
(``components``, ``phases``, ``peak_bytes``, ``peak_phase``), its
functions and its tolerance.  The components the two packages share use
its formulas, so their bytes are the JAX model's bitwise (``n`` is
rows / world, ``B`` the forest batch, ``K`` the classes):

* raw_input   ``F * n * 4``            (float32 source during binning)
* dataset     ``F * n * bin_bytes``    (uint8, uint16 above 256 bins)
* scores      ``B * K * n * 4``
* bag_mask    ``B * n * 4``
* grad_hess   ``B * 2 * K * n * gb``   (gb = 8 under float64 histograms)
* serving     ``sum_b (b * F * 4 + b * K * 8)`` over the bucket rows

The rest model the port's own buffers where the JAX model has the TPU's
record tile (``cells = F * bins * 3``, ``hb`` the histogram item: 4, or
8 under ``hist_prec=float64``; ``CH`` = ``ops/histogram.CHUNK_ROWS``):

* histograms   the leaf buffer ``[L, F, bins, 3]`` (learners/serial.py);
               pooled ``[max(2, P), F, bins, 3]`` slots; depthwise the
               last level pass's output (every leaf grown so far, at most
               ``L - 1``); the forest's ``[lanes, L, F, bins, 3]`` float32
               buffer (learners/forest.py)
* routing      the tree-long row structure: the order route's int64
               permutation ``n * 8``; the record and mega routes' ``[W,
               n]`` int32 record (ops/record.py, ``W = ceil(F / k) + 5``);
               the forest's ``[lanes, n]`` int32 leaf map; depthwise the
               int32 leaf ids
* hist_scratch a histogram's transient buffers: the root's chunk
               partials ``ops/cuda_histogram.scratch_shape`` (float64: a
               partial a group of ``GROUP_CHUNKS`` chunks from 64 chunks)
               and output; the smaller child's on the order route with
               its gathered rows; the record's build; depthwise the level
               kernel's sort, tables and partials
* search_scratch the level search's transients (ops/split.py
               ``find_best_split_leaves``: about 7 times the level's
               histogram), on depthwise levels and hybrid's
* partition    a split's transient buffers at the root window: the order
               route's int64 partition temporaries (``45 * n``); the
               record route's K6 run buffer ``[ceil(n / 512), W - 1,
               1024]`` int32; the mega route's K8 run buffer and its chunk
               partials ``ceil(n / CH) * cells * 4``; depthwise the
               routing's temporaries
* forest_step  ``ForestStep``'s scratch (ops/cuda_forest.py: every lane at
               ``max_rows // 2``, ``max(lanes * cap_s, cap_r)`` chunk
               slots of rows, stats and partials) and the lanes' stacked
               gradients, hessians and masks
* labels       the objective's labels on the device, ``B * n * 4``
* leaf_map     the grown trees' row -> leaf ids, ``lanes * n * 4``

The phases compose them (``_LIVE``): ``binning`` is the JAX model's;
``histogram``, ``split-search`` and ``partition`` hold the tree-long
buffers (grad/hess, histograms, routing, the forest's scratch) and their
own transients; ``leaf-update`` the leaf ids; ``predict`` the resident
set.  ``peak_bytes`` is the largest phase.  ``chip_smoke.py`` holds the
largest training phase against the card's measured peaks and the
``dataset`` / ``scores`` components against the census
(``obs/memory.live_buffer_census``).  Pure python: imports nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

SCHEMA = "lightgbm-tpu/memmodel/v1"

# the documented census-vs-model tolerance (relative %, with an absolute
# floor for the small per-feature side arrays the model folds into its
# components): max(20 %, 8 KiB), the JAX package's
TOLERANCE_PCT = 20.0
TOLERANCE_ABS_BYTES = 8192

PHASES = ("binning", "histogram", "split-search", "partition",
          "leaf-update", "predict")

# constants of the port's buffers (each must mirror its source)
_CHUNK_ROWS = 2048       # ops/histogram.CHUNK_ROWS
_GROUP_CHUNKS = 8        # ops/histogram.GROUP_CHUNKS
_F64_WALK_CHUNKS = 64    # csrc/histogram.cu kWalkMinChunks
_TILE = 512              # ops/record.TILE
_REC_STAT_ROWS = 5       # grad, hess, mask, row id, leaf id
_ORDER_PARTITION = 45    # bytes a row of learners/serial._partition's temps
_LEVEL_ROUTE = 48        # bytes a row of learners/depthwise._route's temps
_LEVEL_SEARCH = 7        # level histograms of ops/split.py's search temps
_FOREST_TILE_THREADS = 256  # csrc/forest.cu kTileThreads
_FOREST_INFO, _FOREST_STEP, _FOREST_BEST = 8, 20, 8  # ops/cuda_forest.py

# route names; the JAX package's record routings are the port's record
_ROUTES = {"order": "order", "record": "record", "mega": "mega",
           "forest": "forest", "prefix": "record", "onehot": "record"}

_RESIDENT = ("dataset", "scores", "bag_mask", "serving")
_TREE = _RESIDENT + ("labels", "grad_hess", "histograms", "routing",
                     "forest_step")
_LIVE: Dict[str, Tuple[str, ...]] = {
    "binning": ("raw_input", "dataset", "scores", "bag_mask"),
    "histogram": _TREE + ("hist_scratch",),
    "split-search": _TREE + ("search_scratch",),
    "partition": _TREE + ("partition",),
    "leaf-update": _RESIDENT + ("labels", "grad_hess", "leaf_map"),
    "predict": _RESIDENT,
}


def _cdiv(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def _rec_height(features: int, bin_bytes: int) -> int:
    return _cdiv(features, 4 if bin_bytes == 1 else 2) + _REC_STAT_ROWS


def _single_hist(cnt: int, cells: int, hb: int, f64: bool) -> int:
    """A single-leaf histogram's output and chunk partials over ``cnt``
    rows (ops/cuda_histogram._launch)."""
    chunks = _cdiv(cnt, _CHUNK_ROWS)
    group = _GROUP_CHUNKS if f64 and chunks >= _F64_WALK_CHUNKS else 1
    return (_cdiv(cnt, _CHUNK_ROWS * group) + 1) * cells * hb


def _forest_step(lanes: int, n: int, features: int, cells: int) -> int:
    """ForestStep's scratch for ``lanes`` lanes over ``n`` rows, and the
    lanes' stacked [lanes, n] gradients, hessians and masks."""
    cap_r = _cdiv(n, _CHUNK_ROWS)
    cap_s = _cdiv(n // 2, _CHUNK_ROWS)
    slots = max(lanes * cap_s, cap_r)
    rows = slots * _CHUNK_ROWS
    work = (lanes * (_FOREST_INFO + 3 + features) + 1
            + lanes * cap_r * (3 + _FOREST_TILE_THREADS // 2))
    scratch = (4 * rows                                # order
               + 12 * rows                             # g, h, mask
               + (slots * cells * 4 if cap_r > 1 else 4)  # partials
               + lanes * cells * 4                     # h
               + lanes * 2 * 16 * 4                    # rows
               + lanes * 2 * features * _FOREST_BEST * 4
               + lanes * _FOREST_STEP * 4 + 4 * work)
    return scratch + 3 * lanes * n * 4


def predict(rows: int, features: int, bins: int = 255, leaves: int = 31,
            num_class: int = 1, world: int = 1, routing: str = "prefix",
            hist_prec: str = "float32",
            bucket_rows: Iterable[int] = (),
            forest_batch: int = 1, *, growth: str = "leafwise",
            pool_slots: int = 0) -> dict:
    """Expected per-device live set, per phase, in bytes.

    ``routing`` is the leaf-wise route: ``order``, ``record`` (the JAX
    package's ``prefix`` and ``onehot`` name it too), ``mega`` or
    ``forest`` (one booster's class trees as lanes).  ``forest_batch``
    > 1 is that many independent models grown as the lanes of one forest
    on one binned matrix (``train_many``, cv's folds): per-model buffers
    scale by it, the forest's by all ``forest_batch * num_class`` lanes.
    ``growth`` (``leafwise``, ``depthwise``, ``hybrid``) and
    ``pool_slots`` (``histogram_pool_size``'s slots, 0 for none) are the
    port's keywords.  ``bucket_rows`` lists the serving buckets' rows.
    Every size is a data-parallel shard's (``rows / world``)."""
    rows = int(rows)
    features = int(features)
    bins = int(bins)
    leaves = int(leaves)
    num_class = max(1, int(num_class))
    world = max(1, int(world))
    forest_batch = max(1, int(forest_batch))
    pool_slots = max(0, int(pool_slots))
    if routing not in _ROUTES:
        raise ValueError(f"routing={routing!r}: one of {sorted(_ROUTES)}")
    if growth not in ("leafwise", "depthwise", "hybrid"):
        raise ValueError(f"growth={growth!r}: leafwise, depthwise or "
                         "hybrid")
    route = _ROUTES[routing]
    n = -(-rows // world)

    bin_bytes = 1 if bins <= 256 else 2
    f64 = str(hist_prec) in ("float64", "f64", "fp64", "double")
    hist_bytes = 8 if f64 else 4
    grad_bytes = hist_bytes  # the JAX model's grad/hess item

    # the components both packages model, by the JAX package's formulas
    dataset = features * n * bin_bytes
    scores = forest_batch * num_class * n * 4
    bag_mask = forest_batch * n * 4
    grad_hess = forest_batch * 2 * num_class * n * grad_bytes
    buckets = [int(b) for b in bucket_rows]
    serving = sum(b * features * 4 + b * num_class * 8 for b in buckets)
    raw_input = features * n * 4

    # the port's own buffers
    cells = features * bins * 3
    labels = forest_batch * n * 4
    forest = forest_batch > 1 or route == "forest"
    lanes = forest_batch * num_class if forest else 1
    forest_step = search_scratch = 0
    pooled = 0 < pool_slots < leaves
    if forest:
        histograms = lanes * leaves * cells * 4
        routing_bytes = lanes * n * 4
        forest_step = _forest_step(lanes, n, features, cells)
        hist_scratch = 12 * n  # a lane's root sums
        partition = 0
    elif growth == "depthwise":
        # a level pass covers every leaf grown so far: the last, at most
        # L - 1 (learners/depthwise.py)
        level = max(leaves - 1, 1)
        parts = (_cdiv(n, _CHUNK_ROWS * (_GROUP_CHUNKS if f64 else 1))
                 + level)
        histograms = level * cells * hist_bytes
        routing_bytes = n * 4
        hist_scratch = (12 * n + parts * cells * hist_bytes
                        + 8 * (2 * level + 5 * parts)
                        + (3 * n * 8 if f64 else 0))
        partition = _LEVEL_ROUTE * n
        search_scratch = _LEVEL_SEARCH * level * cells * hist_bytes
    else:
        # leaf-wise: order (pooled, float64 and hybrid's best-first
        # splits too) / record / mega
        slots = max(2, pool_slots) if pooled else leaves
        histograms = slots * cells * hist_bytes
        rec_words = _rec_height(features, bin_bytes)
        half = n // 2
        if (route in ("record", "mega") and not pooled and not f64
                and growth == "leafwise"):
            routing_bytes = rec_words * n * 4
            build = (rec_words - _REC_STAT_ROWS + 2) * n * 4
            hist_scratch = max(_single_hist(n, cells, 4, False), build,
                               12 * n)
            run_buffer = _cdiv(n, _TILE) * (rec_words - 1) * 2 * _TILE * 4
            partition = run_buffer + (
                _cdiv(n, _CHUNK_ROWS) * cells * 4 if route == "mega"
                else 0)
        else:
            routing_bytes = n * 8
            # the root's, or the smaller child's (pooled: a rebuilt
            # parent's) over its gathered rows
            hist_scratch = max(
                _single_hist(n, cells, hist_bytes, f64), 12 * n,
                half * (features * bin_bytes + 12)
                + _single_hist(half, cells, hist_bytes, f64))
            partition = _ORDER_PARTITION * n
        if growth == "hybrid":
            # its levels to L / 4 leaves, then the resume's level pass over
            # the live leaves
            level = max(leaves // 4, 1)
            parts = _cdiv(n, _CHUNK_ROWS) + level
            hist_scratch = max(hist_scratch, 12 * n + parts * cells
                               * hist_bytes + 8 * (2 * level + 5 * parts))
            search_scratch = _LEVEL_SEARCH * level * cells * hist_bytes
    leaf_map = lanes * n * 4

    components: Dict[str, int] = {
        "raw_input": raw_input,
        "dataset": dataset,
        "scores": scores,
        "bag_mask": bag_mask,
        "grad_hess": grad_hess,
        "histograms": histograms,
        "routing": routing_bytes,
        "serving": serving,
        "labels": labels,
        "hist_scratch": hist_scratch,
        "search_scratch": search_scratch,
        "partition": partition,
        "forest_step": forest_step,
        "leaf_map": leaf_map,
    }
    resident = sum(components[c] for c in _RESIDENT)
    phases: Dict[str, int] = {
        p: int(sum(components[c] for c in live)) for p, live in _LIVE.items()}
    peak_phase = max(phases, key=lambda p: phases[p])
    return {
        "schema": SCHEMA,
        "params": {
            "rows": rows, "features": features, "bins": bins,
            "leaves": leaves, "num_class": num_class, "world": world,
            "routing": routing, "hist_prec": str(hist_prec),
            "bucket_rows": buckets, "rows_per_shard": n,
            "forest_batch": forest_batch, "growth": growth,
            "pool_slots": pool_slots,
        },
        "components": {k: int(v) for k, v in components.items()},
        "resident_bytes": int(resident),
        "phases": phases,
        "peak_bytes": int(phases[peak_phase]),
        "peak_phase": peak_phase,
    }


def training_peak(pred: dict) -> Tuple[str, int]:
    """The largest phase of a tree's growth (histogram, split-search,
    partition, leaf-update): what a peak measured over boosting
    iterations, after the booster is built, is held against."""
    grow = ("histogram", "split-search", "partition", "leaf-update")
    phase = max(grow, key=lambda p: pred["phases"][p])
    return phase, int(pred["phases"][phase])


def limiting_component(pred: dict) -> Tuple[str, int]:
    """The largest single allocation live in the peak phase: the first
    thing out-of-core work must shard or stream."""
    comps = dict(pred["components"])
    name = max(_LIVE[pred["peak_phase"]], key=lambda c: comps.get(c, 0))
    return name, int(comps.get(name, 0))


def max_rows(capacity_bytes: int, **params: Any) -> int:
    """Largest row count whose predicted peak fits ``capacity_bytes``
    (binary search; 0 when even 1 row does not fit).  ``params`` are
    the non-``rows`` arguments of :func:`predict`."""
    capacity = int(capacity_bytes)
    if predict(rows=1, **params)["peak_bytes"] > capacity:
        return 0
    lo, hi = 1, 2
    while predict(rows=hi, **params)["peak_bytes"] <= capacity:
        lo, hi = hi, hi * 2
        if hi > 1 << 44:
            return lo
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if predict(rows=mid, **params)["peak_bytes"] <= capacity:
            lo = mid
        else:
            hi = mid
    return lo


def max_forest_batch(capacity_bytes: int, **params: Any) -> int:
    """Largest forest batch B whose predicted peak fits ``capacity_bytes``
    at the given shape; ``params`` are the non-``forest_batch``
    arguments of :func:`predict` (``rows`` included).  0 when even B=1
    does not fit."""
    capacity = int(capacity_bytes)
    if predict(forest_batch=1, **params)["peak_bytes"] > capacity:
        return 0
    lo, hi = 1, 2
    while predict(forest_batch=hi, **params)["peak_bytes"] <= capacity:
        lo, hi = hi, hi * 2
        if hi > 1 << 30:
            return lo
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if predict(forest_batch=mid, **params)["peak_bytes"] <= capacity:
            lo = mid
        else:
            hi = mid
    return lo


def rows_curve(capacity_bytes: int, row_points: Iterable[int],
               **params: Any) -> dict:
    """Predicted peak at each row count, the capacity ceiling, and the
    allocation that hits the wall first."""
    points = []
    for r in row_points:
        pred = predict(rows=int(r), **params)
        points.append({
            "rows": int(r),
            "peak_bytes": pred["peak_bytes"],
            "peak_phase": pred["peak_phase"],
            "fits": pred["peak_bytes"] <= int(capacity_bytes),
        })
    cap_rows = max_rows(capacity_bytes, **params)
    at_wall = predict(rows=max(cap_rows, 1), **params)
    limiter, limiter_bytes = limiting_component(at_wall)
    return {
        "schema": SCHEMA,
        "capacity_bytes": int(capacity_bytes),
        "params": at_wall["params"],
        "points": points,
        "max_rows": cap_rows,
        "wall": {
            "peak_phase": at_wall["peak_phase"],
            "limiting_component": limiter,
            "limiting_bytes": limiter_bytes,
            "components": at_wall["components"],
        },
    }


def within_tolerance(model_bytes: int, measured_bytes: int,
                     pct: float = TOLERANCE_PCT,
                     abs_floor: int = TOLERANCE_ABS_BYTES) -> bool:
    """The documented agreement predicate: |model - measured| <=
    max(pct % of measured, abs_floor)."""
    slack = max(abs(measured_bytes) * pct / 100.0, float(abs_floor))
    return abs(int(model_bytes) - int(measured_bytes)) <= slack
