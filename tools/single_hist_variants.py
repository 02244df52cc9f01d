#!/usr/bin/env python3
"""Configurations of the single-leaf histograms (K1, K1') side by side on one
card, across row counts.

    python3 tools/single_hist_variants.py [--parent-csrc DIR] [NAME ...]

Each configuration is a copy of ``lightgbm_tpu_torch/csrc`` with a few
constants replaced (features and threads a block, how K1 stages its bins,
how many partials a pass-2 thread loads at once), built by
``ops/_build.py`` into its own directory and run through the wrappers
``ops/cuda_histogram.histogram_single_leaf_cuda`` and
``histogram_record_window_cuda``, one configuration per process, as
``chip_smoke.py`` loads the kernels.  On inputs made from seed 0 each
configuration's K1 and K1' must equal their plain versions on the CPU
bitwise: the bench shape's 1M-row root (28 u8 features, 255 bins) and
60,000 rows, ~90 % of every feature's rows in one bin, u16 x 5000 bins,
1, 2,049 and 130,001 rows, F = 5 and F = 29, record windows with k = 2
and k = 4 whose F is not a multiple of k at an odd begin.  It then times
K1 and K1' at 2,048, 16,384, 131,072 and 1M rows (F = 28, 255 bins, u8;
K1' on a window at an odd begin): CUDA-event medians of 20 calls after
3 (the whole call, as the learner sees it) and, under the profiler, the
device ms of pass 1 and pass 2 per call; ``shipped`` adds one
``index_add_`` of the same sums.  ``--parent-csrc DIR`` adds a
configuration ``parent`` built from another checkout's ``csrc`` (same C
entries), e.g. the per-bin walk that K1 and K1' ran before.  The plain
versions' outputs are kept under ``build/single_hist_variants``.  Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "lightgbm_tpu_torch", "csrc")
WORK = os.path.join(ROOT, "build", "single_hist_variants")
SIZES = (2048, 16_384, 131_072, 1_000_000)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


# csrc/histogram.cu's shipped features and threads a block
SHIPPED = {"kSingleGroup": 1, "kSingleThreads": 512, "kWindowGroup": 1,
           "kWindowThreads": 512}


def _group(g, t, record=True):
    """K1 (and K1', whose group must be whole record words or a part of
    one) at g features and t threads a block."""
    new = {"kSingleGroup": g, "kSingleThreads": t}
    if record:
        new.update(kWindowGroup=g, kWindowThreads=t)
    return [("histogram.cu", f"{k} = {SHIPPED[k]};", f"{k} = {v};")
            for k, v in new.items()]


# name -> (file, text, replacement) edits of a copy of csrc/
CONFIGS = {
    "shipped": [],
    "g1x256": _group(1, 256),
    "g2x512": _group(2, 512),
    "g4x256": _group(4, 256),
    "g4x512": _group(4, 512),
    "g8x512": _group(8, 512),
    # K1 stages one bin a load, through the gathered path's identity order
    "byte_stage": [("hist_chunk.cuh",
                    "    stage_contiguous<BinT, G, kThreads>(bins, grad, "
                    "hess, mask, n, row0,",
                    "    stage_gathered<BinT, G, kThreads>(SortedRows<BinT>"
                    "{bins, grad, hess, mask, nullptr, n}, row0,")],
    # pass 2 adds each partial as it loads it
    "reduce_b1": [("histogram.cu", "kReduceBatch = 16;",
                   "kReduceBatch = 1;")],
}


def _stats(rng, n):
    return (rng.randn(n).astype(np.float32),
            np.abs(rng.randn(n)).astype(np.float32),
            (rng.rand(n) < 0.8).astype(np.float32))


def cases():
    """name -> ("K1", bins, g, h, m, B) or ("K1'", bins, g, h, m, B, begin,
    cnt): the record is built from all the rows, the window is [begin,
    begin + cnt)."""
    rng = np.random.RandomState(0)
    out = {}

    def k1(name, F, n, B, dt, dominant=False):
        bins = rng.randint(0, B, (F, n)).astype(dt)
        if dominant:
            bins[rng.rand(F, n) < 0.9] = B // 3
        out[name] = ("K1", bins, *_stats(rng, n), B)

    def k1r(name, F, n, B, dt, begin, cnt):
        out[name] = ("K1'", rng.randint(0, B, (F, n)).astype(dt),
                     *_stats(rng, n), B, begin, cnt)

    for n in SIZES:
        k1(f"k1-{n}", 28, n, 255, np.uint8)
        k1r(f"k1r-{n}", 28, n + 1001, 255, np.uint8, 1001, n)
    k1("k1-60000", 28, 60_000, 255, np.uint8)
    k1("dominant", 28, 300_000, 255, np.uint8, dominant=True)
    k1("u16x5000", 4, 100_000, 5000, np.uint16)
    k1("rows-1", 28, 1, 255, np.uint8)
    k1("rows-2049", 28, 2049, 255, np.uint8)
    k1("rows-130001", 28, 130_001, 255, np.uint8)
    k1("F5", 5, 70_001, 37, np.uint8)
    k1("F29", 29, 70_001, 255, np.uint8)
    k1r("k1r-60000", 28, 1_000_000, 255, np.uint8, 333_333, 60_000)
    k1r("k4-F29", 29, 50_000, 255, np.uint8, 777, 40_001)
    k1r("k2-F5", 5, 50_000, 300, np.uint16, 1001, 30_003)
    k1r("k2-F29-5000", 29, 20_000, 5000, np.uint16, 3, 12_345)
    k1r("k4-dominant", 28, 300_000, 255, np.uint8, 5, 250_001)
    return out


def _to_torch(torch, case, dev):
    from lightgbm_tpu_torch.ops.record import build_record

    kind, bins, g, h, m, B = case[:6]
    t = [torch.from_numpy(a).to(dev) for a in (bins, g, h, m)]
    if kind == "K1":
        return t, B
    return build_record(*t), B


def _plain(torch, name, case):
    from lightgbm_tpu_torch.ops import histogram as plain

    x, B = _to_torch(torch, case, "cpu")
    if case[0] == "K1":
        return plain.histogram_feature_major(*x, B)
    F = case[1].shape[0]
    k = 4 if case[1].dtype == np.uint8 else 2
    return plain.histogram_record_window(x, case[6], case[7], F, k, B)


def _kernel(torch, ch, case, x, B):
    if case[0] == "K1":
        return lambda: ch.histogram_single_leaf_cuda(*x, B)
    F = case[1].shape[0]
    k = 4 if case[1].dtype == np.uint8 else 2
    return lambda: ch.histogram_record_window_cuda(x, case[6], case[7], F,
                                                   k, B)


def time_ms(torch, fn, reps=20, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def make_reference():
    import torch
    os.makedirs(WORK, exist_ok=True)
    for name, case in cases().items():
        torch.save(_plain(torch, name, case),
                   os.path.join(WORK, f"ref_{name}.pt"))


def run_config(name, src=CSRC):
    import torch
    d = os.path.join(WORK, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, os.path.join(d, "csrc"))
    for f, a, b in CONFIGS.get(name, []):
        p = os.path.join(d, "csrc", f)
        with open(p) as fh:
            s = fh.read()
        if a not in s:
            raise SystemExit(f"{name}: {a!r} not in {f}")
        with open(p, "w") as fh:
            fh.write(s.replace(a, b))
    from lightgbm_tpu_torch.ops import _build
    from lightgbm_tpu_torch.ops import cuda_histogram as ch
    from lightgbm_tpu_torch.profile_slice import device_ms_by_kernel
    _build.CSRC = os.path.join(d, "csrc")
    _build.BUILD_DIR = os.path.join(d, "kernels")
    _build.SOURCES = ("histogram",)
    _build.build_all(force=True)
    for line in _build.ptxas_report("histogram").splitlines():
        if "Used" in line or "spill" in line:
            print(f"[{name}] ptxas {line.strip()}", flush=True)
    for cname, case in cases().items():
        x, B = _to_torch(torch, case, "cuda")
        fn = _kernel(torch, ch, case, x, B)
        want = torch.load(os.path.join(WORK, f"ref_{cname}.pt"))
        a, b = fn(), fn()
        torch.cuda.synchronize()
        ok = torch.equal(a, b) and torch.equal(a.cpu(), want)
        if not ok:
            print(f"[{name}] {cname}: {case[0]} differs from its plain "
                  "version", flush=True)
            raise SystemExit(1)
        if not cname.startswith(("k1-", "k1r-")) or cname.endswith("60000"):
            continue
        n = int(cname.split("-")[1])
        ms = time_ms(torch, fn)
        dev = device_ms_by_kernel(torch, fn)
        p1 = sum(v for k, v in dev.items() if "partial" in k)
        p2 = sum(v for k, v in dev.items() if "reduce" in k)
        line = (f"[{name}] {case[0]} rows={n}: call {ms:.4f} ms | device "
                f"pass 1 {p1:.4f} pass 2 {p2:.4f} ms")
        if name == "shipped":
            bins, g, h, m = (x if case[0] == "K1" else
                             [torch.from_numpy(v).cuda()[..., case[6]:
                                                         case[6] + n]
                              .contiguous() for v in case[1:5]])
            F = bins.shape[0]
            keys = (bins.to(torch.int64) + torch.arange(F, device="cuda")
                    [:, None] * B).reshape(-1)
            src = torch.stack([g * m, h * m, m], -1).repeat(F, 1)
            lib = time_ms(torch, lambda: torch.zeros(
                F * B, 3, device="cuda").index_add_(0, keys, src))
            nbytes = F * n + 12 * n + F * B * 12
            line += (f" | index_add_ {lib:.4f} ms | bound "
                     f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms")
        print(line, flush=True)
    print(f"[{name}] every case bitwise == plain (two launches each)",
          flush=True)


def main(argv) -> int:
    if argv[:1] == ["--reference"]:
        make_reference()
        return 0
    if argv[:1] == ["--config"]:
        run_config(*argv[1:])
        return 0
    parent = None
    if argv[:1] == ["--parent-csrc"]:
        parent, argv = os.path.abspath(argv[1]), argv[2:]
    names = argv or list(CONFIGS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"[device] {smi.stdout.strip()}", flush=True)
    t0 = time.perf_counter()
    rc = subprocess.run([sys.executable, __file__, "--reference"]).returncode
    if rc:
        return rc
    print(f"[reference] plain versions on the CPU in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    runs = [[name] for name in names]
    if parent:
        runs.insert(0, ["parent", parent])
    for run in runs:
        rc = subprocess.run([sys.executable, __file__, "--config", *run]
                            ).returncode or rc
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
