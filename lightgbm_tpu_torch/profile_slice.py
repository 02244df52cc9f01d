"""Where the time of one tree goes on the card, at the bench shape.

    python -m lightgbm_tpu_torch.profile_slice [--rows N] [--trees T]
        [--growth leafwise|depthwise|hybrid] [--histogram-pool-size MB]
        [--objective binary|regression|multiclass|lambdarank]
        [--hist-dtype float32|float64]

Trains the bench model (bench.py's config: binary, HIGGS-like rows from
seed 7, 28 features, 255 bins, 255 leaves) through the port's entry
points, warms one iteration, then runs ``--trees`` iterations under
``torch.profiler`` with CPU and CUDA activities (after the same number
timed without it).  ``--objective`` trains chip_smoke.py's main path for
that objective instead (``synthetic``'s data): regression or five-class
multiclass (one tree per class an iteration) on the same rows, or
LambdaRank on 10,000 MSLR-WEB10K-shaped queries (136 features, 31
leaves); the report also gives the gradients' device ms an iteration
(kernel by kernel, ``device_ms_by_kernel``).  ``--growth`` sets
``tree_growth`` (leaf-wise by default).  Leaf-wise, it traces whatever
route ``train`` takes: the mega route by default (K8 ``split_step_kernel`` + K7 per split), the record
route under ``LGBM_TPU_FUSE_HIST=0``, the order route under
``LGBM_TPU_OPT_HISTS=0``; with ``--histogram-pool-size`` (MB, 4 keeps 48
of the 255 leaves' histograms) the pooled order route (K1 for children and
rebuilt parents, K5 per split).  Depthwise runs the level histogram (K1'', or
K2 under ``LGBM_TPU_HIST_KERNEL=bsub``) once per level; hybrid adds the
resume's level pass and the order route's K1 + K3 per split.
``--hist-dtype float64`` sums the histograms in float64: leaf-wise on the
order route with K1-f64 and K3-f64 (its root form at the root, its step
form at every split), depthwise with K1''-f64.
Prints one JSON object (times "per tree" are per iteration): host wall
per tree with and without the profiler,
device busy time per tree (the union of kernel and copy intervals on the
card), the idle share (1 - busy / wall), the device time per kernel name
summed over the profiled trees, largest first, the device events
(kernels and copies) per tree, each ported kernel's launches per
profiled tree (from the wrappers' counts), the host syncs per profiled
tree and, for K1, K1' and K1-f64, the median and quartiles of the row
counts they were launched on (for K8, K6 and K7, of their windows'
columns);
the columns the partition kernels moved a tree, the bytes K6 and K7 must
move for them (K6 2(W-1)·4, K7 (2W-1)·4 a column) and the byte bound a
tree at 3.35 TB/s.
Needs a CUDA card; exits non-zero without one.

``device_ms_by_kernel`` (used by chip_smoke.py and tools/) times a call's
kernels one by one under the profiler.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def _busy_us(events) -> float:
    """Length of the union of device intervals (microseconds)."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def device_ms_by_kernel(torch, fn, reps: int = 20, warm: int = 3):
    """Device ms per call of ``fn`` for each kernel name it launches (the
    name's first 80 characters), over ``reps`` profiled calls after
    ``warm`` unprofiled ones."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = e.name[:80]
            out[key] = out.get(key, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def _quartiles(xs):
    """Median and quartiles of ``xs`` (the nearest-rank ones), its count
    and total."""
    xs = sorted(xs)
    if not xs:
        return {"launches": 0}
    at = lambda q: xs[min(len(xs) - 1, int(q * len(xs)))]  # noqa: E731
    return {"launches": len(xs), "q1": at(0.25), "median": at(0.5),
            "q3": at(0.75), "min": xs[0], "max": xs[-1], "rows": sum(xs)}


@contextlib.contextmanager
def _record_rows(rows):
    """Inside, every K1 / K1' / K1-f64 launch appends its row count to
    ``rows["K1"]`` / ``rows["K1'"]`` / ``rows["K1-f64"]``, and every K8,
    K6 and K7 launch its
    window's column count to ``rows["K8"]``, ``rows["K6"]``,
    ``rows["K7"]`` (and the record's height to ``rows["K6 W"]``,
    ``rows["K7 W"]``)."""
    from lightgbm_tpu_torch.ops import cuda_histogram as ch
    from lightgbm_tpu_torch.ops import cuda_record as cr
    from lightgbm_tpu_torch.ops import cuda_split_step as k8

    k1, k1r = ch.histogram_single_leaf_cuda, ch.histogram_record_window_cuda
    k1d = ch.histogram_single_leaf_f64_cuda
    step = k8.split_step_cuda
    compact, place = cr.compact_cuda, cr.place_cuda

    def single(bins_T, *a, **kw):
        rows["K1"].append(int(bins_T.shape[1]))
        return k1(bins_T, *a, **kw)

    def single64(bins_T, *a, **kw):
        rows["K1-f64"].append(int(bins_T.shape[1]))
        return k1d(bins_T, *a, **kw)

    def window(rec, begin, cnt, *a, **kw):
        rows["K1'"].append(int(cnt))
        return k1r(rec, begin, cnt, *a, **kw)

    def split_step(rec, hists, f, thr, is_cat, begin, pcnt, *a, **kw):
        rows["K8"].append(int(pcnt))
        return step(rec, hists, f, thr, is_cat, begin, pcnt, *a, **kw)

    def compact_cuda(rec, f, thr, is_cat, begin, pcnt, *a, **kw):
        rows["K6"].append(int(pcnt))
        rows["K6 W"].append(int(rec.shape[0]))
        return compact(rec, f, thr, is_cat, begin, pcnt, *a, **kw)

    def place_cuda(rec, comp, counts, begin, pcnt, *a, **kw):
        rows["K7"].append(int(pcnt))
        rows["K7 W"].append(int(rec.shape[0]))
        return place(rec, comp, counts, begin, pcnt, *a, **kw)

    ch.histogram_single_leaf_cuda = single
    ch.histogram_single_leaf_f64_cuda = single64
    ch.histogram_record_window_cuda = window
    k8.split_step_cuda = split_step
    cr.compact_cuda, cr.place_cuda = compact_cuda, place_cuda
    try:
        yield
    finally:
        ch.histogram_single_leaf_cuda = k1
        ch.histogram_single_leaf_f64_cuda = k1d
        ch.histogram_record_window_cuda = k1r
        k8.split_step_cuda = step
        cr.compact_cuda, cr.place_cuda = compact, place


def _partition_bytes(rows, trees):
    """Columns K6 and K7 were launched on a tree, the bytes each must move
    for them and the byte bound a tree (ms at 3.35 TB/s)."""
    k6 = sum(2 * (w - 1) * 4 * c for c, w in zip(rows["K6"], rows["K6 W"]))
    k7 = sum((2 * w - 1) * 4 * c for c, w in zip(rows["K7"], rows["K7 W"]))
    return {"columns_per_tree": {"K6": sum(rows["K6"]) / trees,
                                 "K7": sum(rows["K7"]) / trees},
            "bytes_per_tree": {"K6": k6 / trees, "K7": k7 / trees},
            "bound_ms_per_tree": {"K6": k6 / trees / HBM_BYTES_PER_S * 1e3,
                                  "K7": k7 / trees / HBM_BYTES_PER_S * 1e3}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--trees", type=int, default=3)
    ap.add_argument("--growth", default="leafwise",
                    choices=("leafwise", "depthwise", "hybrid"))
    ap.add_argument("--histogram-pool-size", type=float, default=0.0)
    ap.add_argument("--objective", default="binary",
                    choices=("binary", "regression", "multiclass",
                             "lambdarank"))
    ap.add_argument("--hist-dtype", default="float32",
                    choices=("float32", "float64"))
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_slice: needs a CUDA card", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.learners import serial
    from lightgbm_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightgbm_tpu_torch.synthetic import workload

    params, (X, y, group), _ = workload(args.objective, args.rows,
                                        growth=args.growth,
                                        pool_mb=args.histogram_pool_size,
                                        hist_dtype=args.hist_dtype)
    ds = lt.Dataset(X, label=y, group=group, max_bin=255, params=params)
    booster = lt.Booster(params=params, train_set=ds)
    booster.update()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.trees):
        booster.update()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    reset_launch_counts()
    serial.HOST_SYNCS = serial.POOL_RECOMPUTES = 0
    rows = {"K1": [], "K1'": [], "K1-f64": [], "K8": [], "K6": [], "K7": [],
            "K6 W": [], "K7 W": []}
    with _record_rows(rows), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.trees):
            booster.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = _busy_us(dev_events) * 1e-6
    per_kernel = {}  # by the name's first 80 characters
    for e in dev_events:
        per_kernel[e.name[:80]] = per_kernel.get(e.name[:80], 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    gb = booster._gbdt
    scores = gb._scores if gb.num_class > 1 else gb._scores[0]
    grad_ms = device_ms_by_kernel(
        torch, lambda: gb.objective.get_gradients(scores), reps=3, warm=1)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "objective": args.objective, "rows": gb.num_data,
        "trees": args.trees, "growth": args.growth,
        "hist_dtype": args.hist_dtype,
        "gradients_device_ms_per_iter": sum(grad_ms.values()),
        "gradients_kernel_ms_per_iter": dict(sorted(
            grad_ms.items(), key=lambda kv: -kv[1])[:8]),
        "wall_s_per_tree_unprofiled": plain_wall / args.trees,
        "wall_s_per_tree_profiled": wall / args.trees,
        "device_busy_s_per_tree": busy_s / args.trees,
        "idle_share": 1.0 - busy_s / wall,
        "device_events": len(dev_events),
        "device_events_per_tree": len(dev_events) / args.trees,
        "kernel_ms_per_tree": {k: v / 1e3 / args.trees for k, v in top},
        "launches_per_tree": {name: n / args.trees
                              for name, n in launch_counts().items()},
        "host_syncs_per_tree": serial.HOST_SYNCS / args.trees,
        "pool_slots": booster._gbdt._hist_pool_slots(),
        "parents_rebuilt_per_tree": serial.POOL_RECOMPUTES / args.trees,
        "rows_per_launch": {k: _quartiles(v) for k, v in rows.items()
                            if " W" not in k},
        "partition": _partition_bytes(rows, args.trees),
        "leaves": [t.num_leaves
                   for t in gb.models[-args.trees * gb.num_class:]],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
