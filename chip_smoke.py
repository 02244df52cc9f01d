#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``lightgbm_tpu_torch/csrc`` (one nvcc per source, started together), then:

1. prints the card (nvidia-smi name and power limit), the build times and
   each kernel's registers / shared memory (nvcc -Xptxas -v);
2. holds the histogram kernel against its plain PyTorch version (float64)
   at the main path's shapes, checks two launches are bitwise equal, and
   times kernel, plain version and one PyTorch ``index_add_`` call;
3. holds the split-search kernel against its plain version on 100 random
   cases and the crafted ties, and times both;
4. trains the bench model (bench.py's config: binary, 1M x 28 HIGGS-like
   rows from seed 7 plus 200k valid rows, 255 bins, 255 leaves) through
   ``lightgbm_tpu_torch``'s entry points: one warm tree, then 10 timed
   trees; checks both kernels launched once per tree plus once per split,
   and that train/valid AUC land in the band the JAX package recorded for
   the same data and config;
5. grows 2 trees at 100k rows on the card (kernels) and on the CPU
   (plain versions) and requires them to be structurally identical.

Every phase must pass or the script exits non-zero without a result.  The
line before the last is the kernels' JSON record, the last line the
device record.  Without a CUDA card, or without the package beside it, it
exits non-zero.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# bench.py:57-64 — the driver workload
N_FEAT, NUM_BINS, NUM_LEAVES = 28, 255, 255
LEARNING_RATE, MIN_DATA = 0.1, 100
ROWS, VALID_ROWS, TREES = 1_000_000, 200_000, 10
# train/valid AUC of the JAX package on the same data and config (BENCH_r05)
AUC_TRAIN, AUC_VALID, AUC_TOL = 0.8571, 0.8477, 0.005
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
STRUCT = ("split_feature", "threshold_bin", "decision_type", "left_child",
          "right_child", "leaf_count", "leaf_parent", "leaf_depth")


def make_data(n: int, seed: int = 7, n_valid: int = 0):
    """bench.py make_data (copied): HIGGS-like, 28 correlated features,
    nonlinear boundary; the valid rows come from the same boundary."""
    rng = np.random.RandomState(seed)

    def draw(m):
        return rng.randn(m, N_FEAT).astype(np.float32)

    def label(X, w1, w2):
        z = X @ w1 + 0.5 * (X**2 - 1.0) @ w2 + 0.8 * X[:, 0] * X[:, 1]
        z = (z - z.mean()) / z.std()
        return (z + 0.5 * rng.randn(len(X)) > 0).astype(np.float32)

    X = draw(n)
    w1, w2 = rng.randn(N_FEAT), rng.randn(N_FEAT)
    y = label(X, w1, w2)
    if not n_valid:
        return X, y
    Xv = draw(n_valid)
    yv = label(Xv, w1, w2)
    return X, y, Xv, yv


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def time_ms(torch, fn, reps: int = 20, warm: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warm``
    calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# --------------------------------------------------------------- phase 1
def phase_build(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, "nvidia-smi")
    card = smi.stdout.strip().splitlines()[0]
    say(f"[device] {card}")
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from lightgbm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build_all(force=True)
    say(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f}s")
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                say(f"[ptxas {name}] {line.strip()}")
    return card


# --------------------------------------------------------------- phase 2
def phase_histogram(torch):
    from lightgbm_tpu_torch.ops import cuda_histogram
    from lightgbm_tpu_torch.ops.histogram import histogram_feature_major

    rng = np.random.RandomState(0)
    shapes = [("root", 28, ROWS, 255, np.uint8),
              ("mid-split", 28, 60_000, 255, np.uint8),
              ("odd", 5, 700, 37, np.uint8),
              ("uint16", 28, 100_000, 300, np.uint16)]
    record = None
    for name, F, cap, B, dt in shapes:
        bins = torch.from_numpy(rng.randint(0, B, (F, cap)).astype(dt)).cuda()
        g = torch.from_numpy(rng.randn(cap).astype(np.float32)).cuda()
        h = torch.from_numpy(np.abs(rng.randn(cap)).astype(np.float32)).cuda()
        m = torch.from_numpy((rng.rand(cap) < 0.8).astype(np.float32)).cuda()
        k1 = cuda_histogram.histogram_single_leaf_cuda(bins, g, h, m, B)
        k2 = cuda_histogram.histogram_single_leaf_cuda(bins, g, h, m, B)
        torch.cuda.synchronize()
        check(torch.equal(k1, k2), f"histogram {name}: launches not bitwise "
              "equal")
        ref = histogram_feature_major(bins, g.double(), h.double(),
                                      m.double(), B)
        absg = histogram_feature_major(bins, g.double().abs(),
                                       h.double().abs(), m.double(), B)
        err = (k1.double() - ref).abs()
        check(torch.equal(k1[..., 2].double(), ref[..., 2]),
              f"histogram {name}: counts differ")
        tol = 1e-5 * absg[..., :2] + 1e-6
        check(bool((err[..., :2] <= tol).all()),
              f"histogram {name}: g/h beyond 1e-5*sum|x| + 1e-6")
        cpu = histogram_feature_major(bins.cpu(), g.cpu(), h.cpu(), m.cpu(), B)
        bitwise_cpu = bool(torch.equal(k1.cpu(), cpu))
        max_err = float(err.max())

        keys = (bins.to(torch.int64) + torch.arange(F, device="cuda")[:, None]
                * B).reshape(-1)
        src = torch.stack([g * m, h * m, m], -1).repeat(F, 1)

        def library():
            return torch.zeros(F * B, 3, device="cuda").index_add_(0, keys, src)

        ms = time_ms(torch, lambda: cuda_histogram.histogram_single_leaf_cuda(
            bins, g, h, m, B))
        plain_ms = time_ms(torch, lambda: histogram_feature_major(
            bins, g, h, m, B))
        lib_ms = time_ms(torch, library)
        nbytes = F * cap * bins.element_size() + 12 * cap + F * B * 12
        bound = max(nbytes / HBM_BYTES_PER_S, 3 * F * cap / F32_FLOPS) * 1e3
        say(f"[hist {name}] F={F} cap={cap} B={B} {np.dtype(dt).name} "
            f"max_abs_err={max_err:.3g} bitwise_vs_cpu_plain={bitwise_cpu} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bound:.5f}")
        if name == "root":
            record = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, library_ms=lib_ms)
        del bins, g, h, m, keys, src, ref, absg, err
    return record


# --------------------------------------------------------------- phase 3
def _search_cases(rng, F, B):
    cases = []
    for _ in range(100):
        hs = []
        for _c in range(2):
            g = rng.randn(F, B).astype(np.float32)
            h = (np.abs(rng.randn(F, B)) + 0.1).astype(np.float32)
            c = rng.randint(1, 50, (F, B)).astype(np.float32)
            hs.append(np.stack([g, h, c], -1))
        iscat = rng.rand(F) < 0.1
        fmask = rng.rand(F) < 0.9
        nbpf = rng.randint(2, B + 1, F).astype(np.int32)
        consts = [float(rng.choice([1.0, 20.0])), float(rng.choice([0.0, 5.0])),
                  float(rng.choice([0.0, 0.5])), float(rng.choice([0.0, 1.0])),
                  0.0]
        cases.append((hs, fmask, nbpf, iscat, consts))
    # exact ties: a feature duplicated (feature asc) and empty bins
    # (bin desc), integer stats so both sides compute identical floats
    g = rng.randint(-8, 9, (F, B)).astype(np.float32)
    hh = rng.randint(1, 5, (F, B)).astype(np.float32)
    c = rng.randint(1, 5, (F, B)).astype(np.float32)
    tie = np.stack([g, hh, c], -1)
    tie[2, :, 0] = np.where(np.arange(B) < B // 2, 32.0, -32.0)
    tie[2, :, 1:] = [1.0, 4.0]
    tie[2, B // 2 - 2:B // 2] = 0.0
    tie[9] = tie[2]
    cases.append(([tie, tie], np.ones(F, bool), np.full(F, B, np.int32),
                  np.zeros(F, bool), [1.0, 0.0, 0.0, 1.0, 0.0]))
    return cases


def phase_search(torch):
    from lightgbm_tpu_torch.ops import cuda_search

    rng = np.random.RandomState(1)
    F, B = N_FEAT, NUM_BINS
    worst, bitwise, n = 0.0, 0, 0
    for hs, fmask, nbpf, iscat, consts in _search_cases(rng, F, B):
        hl, hr = (torch.from_numpy(a).cuda() for a in hs)
        meta = cuda_search.pack_meta(torch.from_numpy(fmask),
                                     torch.from_numpy(nbpf),
                                     torch.from_numpy(iscat), "cuda")
        scal = [1.0]
        for hcur in hs:  # leaf totals: feature 2's sums
            scal += [float(v) for v in hcur[2].sum(axis=0)]
        scal += consts
        k = cuda_search._search2_rows_cuda(hl, hr, scal, meta)
        p = cuda_search._search2_rows_plain(hl, hr, scal, meta)
        kk, pp = k.cpu().numpy(), p.cpu().numpy()
        check((kk[:, 1:3] == pp[:, 1:3]).all(),
              f"search: feature/threshold differ {kk[:, 1:3]} vs {pp[:, 1:3]}")
        fin = np.isfinite(pp[:, :11]) & (pp[:, 1:2] >= 0)
        np.testing.assert_allclose(kk[:, :11][fin], pp[:, :11][fin],
                                   rtol=1e-5, atol=1e-6)
        worst = max(worst, float(np.abs(kk[:, :11][fin] - pp[:, :11][fin])
                                 .max(initial=0.0)))
        bitwise += int(np.array_equal(kk, pp, equal_nan=True))
        n += 1
    tie = kk  # the last case is the crafted tie
    check(int(tie[0, 1]) == 2 and int(tie[0, 2]) == B // 2 - 1,
          f"search: tie resolved to {tie[0, 1:3]}")
    ms = time_ms(torch, lambda: cuda_search._search2_rows_cuda(
        hl, hr, scal, meta))
    plain_ms = time_ms(torch, lambda: cuda_search._search2_rows_plain(
        hl, hr, scal, meta))
    nbytes = 2 * F * B * 12 + F * 16 + 2 * 16 * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    say(f"[search] cases={n} bitwise_equal={bitwise} max_abs_err={worst:.3g} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.6f}")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                library_ms=None)


# --------------------------------------------------------------- phase 4
def phase_main_path(torch, lt):
    from lightgbm_tpu_torch.learners import serial
    from lightgbm_tpu_torch.ops import cuda_histogram, cuda_search

    t0 = time.perf_counter()
    X, y, Xv, yv = make_data(ROWS, seed=7, n_valid=VALID_ROWS)
    params = {"objective": "binary", "num_leaves": NUM_LEAVES,
              "max_bin": NUM_BINS, "learning_rate": LEARNING_RATE,
              "min_data_in_leaf": MIN_DATA, "metric": "auc", "verbose": -1}
    train_set = lt.Dataset(X, label=y, max_bin=NUM_BINS, params=params)
    train_set.construct()
    say(f"[main] data + binning {time.perf_counter() - t0:.1f}s")

    warm = lt.train(params, train_set, num_boost_round=1)  # warm-up tree
    torch.cuda.synchronize()
    del warm
    booster = lt.Booster(params=params, train_set=train_set)
    torch.cuda.reset_peak_memory_stats()
    cuda_histogram.LAUNCHES = cuda_search.LAUNCHES = serial.HOST_SYNCS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TREES):
        booster.update()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = (cuda_histogram.LAUNCHES, cuda_search.LAUNCHES)
    syncs = serial.HOST_SYNCS
    peak = torch.cuda.max_memory_allocated()
    trees = booster._gbdt.models
    expect = sum(1 + (t.num_leaves - 1) for t in trees)
    leaves = [t.num_leaves for t in trees]

    train_auc = booster.eval_train()[0][2]
    booster.add_valid(train_set.create_valid(Xv, label=yv), "valid")
    valid_auc = booster.eval_valid()[0][2]
    pv = booster.predict(Xv[:1000])
    say(f"[main] {TREES} trees {elapsed:.3f}s s/tree={elapsed / TREES:.4f} "
        f"leaves={leaves} train_auc={train_auc:.6f} valid_auc={valid_auc:.6f} "
        f"hist_launches={launches[0]} search_launches={launches[1]} "
        f"expected={expect} host_syncs_per_tree={syncs / TREES:.1f} "
        f"peak_mem_bytes={peak}")
    check(len(trees) == TREES, "main: tree count")
    check(launches[0] > 0 and launches[1] > 0, "main: a kernel never launched")
    check(launches[0] == expect and launches[1] == expect,
          f"main: launches {launches} != 1 + splits per tree ({expect})")
    check(abs(train_auc - AUC_TRAIN) <= AUC_TOL,
          f"main: train AUC {train_auc} outside {AUC_TRAIN}+-{AUC_TOL}")
    check(abs(valid_auc - AUC_VALID) <= AUC_TOL,
          f"main: valid AUC {valid_auc} outside {AUC_VALID}+-{AUC_TOL}")
    check(pv.shape == (1000,) and bool(np.isfinite(pv).all())
          and bool(((pv > 0) & (pv < 1)).all()), "main: predictions")
    return launches


# --------------------------------------------------------------- phase 5
def phase_kernel_vs_plain_trees(torch, lt):
    X, y = make_data(100_000, seed=11)
    params = {"objective": "binary", "num_leaves": NUM_LEAVES,
              "max_bin": NUM_BINS, "learning_rate": LEARNING_RATE,
              "min_data_in_leaf": MIN_DATA, "verbose": -1}
    models = {}
    for dev in ("cuda", "cpu"):
        ds = lt.Dataset(X, label=y, max_bin=NUM_BINS, device=dev)
        b = lt.train(params, ds, num_boost_round=2, device=dev)
        models[dev] = b._gbdt.models
    same = True
    for a, b in zip(models["cuda"], models["cpu"]):
        same &= a.num_leaves == b.num_leaves
        for k in STRUCT:
            same &= bool(torch.equal(getattr(a, k).cpu(), getattr(b, k)))
    leaves = [t.num_leaves for t in models["cuda"]]
    say(f"[trees] 2 trees at 100k rows, leaves={leaves}: kernel-grown == "
        f"plain-grown: {same}")
    check(same, "kernel-grown and plain-grown trees differ")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "lightgbm_tpu_torch")):
        print("chip_smoke: run from a checkout: lightgbm_tpu_torch/ is not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import lightgbm_tpu_torch as lt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_build(torch)
    hist = phase_histogram(torch)
    search = phase_search(torch)
    launches = phase_main_path(torch, lt)
    phase_kernel_vs_plain_trees(torch, lt)
    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s "
        f"on {card}")
    kernels = [
        dict(name="histogram_single_leaf", route="cuda",
             source="lightgbm_tpu_torch/csrc/histogram.cu",
             replaces="lightgbm_tpu/ops/pallas_histogram.py:193",
             launches=launches[0], bound_by="bytes", **hist),
        dict(name="search2", route="cuda",
             source="lightgbm_tpu_torch/csrc/search.cu",
             replaces="lightgbm_tpu/ops/pallas_search.py:264",
             launches=launches[1], bound_by="bytes", **search),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
