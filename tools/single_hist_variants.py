#!/usr/bin/env python3
"""Configurations of the single-leaf histograms (K1, K1') side by side on one
card, across row counts.

    python3 tools/single_hist_variants.py [--f64] [--parent-csrc DIR]
        [NAME ...]

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

``--f64`` selects K1-f64 (``hist_dtype=float64``) instead: the
configurations of ``F64_CONFIGS`` (the shipped kernel, which sorts a
small set and walks a large one; the walk at every size; the sort at
every size; more batches loaded ahead) and, with
``--parent-csrc``, another checkout's K1-f64 (e.g. the earlier sorted
design, one partial a chunk, whose scratch the tool sizes from the
library: a partial a group of ``lgbm_hist_group_chunks()`` chunks from
``lgbm_hist_walk_min_chunks()`` chunks up, else a partial a chunk, as
where the library has no such entries).  Each is held against the plain
float64 version on the CPU (``histogram_feature_major`` with
``acc_dtype=float64``) at the K1 cases above, 18,433 rows and the timed
sizes: bitwise, two launches equal, where the library sums in the plain
version's order (a build of this checkout's ``csrc``; another
checkout's where a set holds at most 9 chunks, the two orders' common
ground), else counts bitwise and sums within rtol 1e-12.  It then times
the C entry (its scratch allocated once) at 2,048-1M rows (F64_SIZES)
and at 17,825,792 rows (drawn on the card; the counts held exact, the
sums within rtol 1e-12 of the first configuration's): CUDA-event medians
of 20 calls after 3, pass 1 and pass 2 device ms from the profiler, and
the scratch bytes; ``f64`` adds the wrapper's whole call and one float64
``index_add_`` of the same sums.
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
ENVELOPE_ROWS = (1 << 24) + (1 << 20)  # chip_smoke.py phase 22's root
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
CHUNK = 2048


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
                    "    stage_contiguous<BinT, G, kThreads, kRaw>(bins, "
                    "grad, hess, mask, n,",
                    "    stage_gathered<BinT, G, kThreads, kRaw>("
                    "SortedRows<BinT>{bins, grad, hess, mask, nullptr, n},")],
    # pass 2 adds each partial as it loads it
    "reduce_b1": [("histogram.cu", "kReduceBatch = 16;",
                   "kReduceBatch = 1;")],
}

# K1-f64's configurations (--f64): edits of hist_chunk.cuh's walk
WALK = "hist_chunk.cuh"
MIN = "constexpr int kWalkMinChunks = 64;"
F64_CONFIGS = {
    "f64": [],
    "f64_walk_all": [("histogram.cu", MIN,
                      "constexpr int kWalkMinChunks = 0;")],
    "f64_sort_all": [("histogram.cu", MIN,
                      "constexpr int kWalkMinChunks = 1 << 30;")],
    "f64_ahead8": [(WALK, "kWalkAhead = 4;", "kWalkAhead = 8;")],
}
F64_SIZES = (2048, 16_384, 32_768, 65_536, 98_304, 131_072, 1_000_000)


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


def f64_cases():
    """name -> (bins, g, h, m, B): K1's cases, just over nine chunks'
    rows and F64_SIZES' (k1-N timed)."""
    out = {k: v[1:6] for k, v in cases().items() if v[0] == "K1"}
    rng = np.random.RandomState(1)
    for n in (18_433,) + F64_SIZES:
        if f"k1-{n}" not in out:
            out[f"k1-{n}"] = (rng.randint(0, 255, (28, n)).astype(np.uint8),
                              *_stats(rng, n), 255)
    return out


def _f64_lib(torch):
    """The loaded histogram library, typed for lgbm_hist_single_leaf_f64,
    its chunks a group and the chunks from which it walks (1 and never
    for a library without groups)."""
    import ctypes
    from lightgbm_tpu_torch.ops import _build

    lib = _build.load("histogram")
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.lgbm_hist_single_leaf_f64.restype = i
    lib.lgbm_hist_single_leaf_f64.argtypes = [vp, i, vp, vp, vp, i, i64, i,
                                              vp, vp, vp]
    group, walk_min = 1, 1 << 30
    if hasattr(lib, "lgbm_hist_group_chunks"):
        lib.lgbm_hist_group_chunks.restype = i
        lib.lgbm_hist_walk_min_chunks.restype = i
        group = lib.lgbm_hist_group_chunks()
        walk_min = lib.lgbm_hist_walk_min_chunks()
    return lib, (group, walk_min)


def _f64_entry(torch, lib, group, bins, g, h, m, B):
    """(a function calling the C entry into buffers allocated once, its
    output, its scratch bytes); ``group`` is _f64_lib's (chunks a group,
    chunks from which the library walks)."""
    from lightgbm_tpu_torch.ops import _build

    F, n = bins.shape
    group, walk_min = group
    parts = -(-n // (CHUNK * (group if -(-n // CHUNK) >= walk_min else 1)))
    out = torch.empty((F, B, 3), dtype=torch.float64, device="cuda")
    part = torch.empty((parts, F, B, 3), dtype=torch.float64, device="cuda")

    def call():
        code = lib.lgbm_hist_single_leaf_f64(
            bins.data_ptr(), bins.element_size(), g.data_ptr(), h.data_ptr(),
            m.data_ptr(), F, n, B, part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        _build.check(code, "float64 histogram")
        return out

    return call, out, part.numel() * 8


def _holds(torch, a, want, exact):
    """a == want bitwise, or counts bitwise and sums within rtol 1e-12."""
    a = a.cpu()
    if exact:
        return torch.equal(a, want)
    return (torch.equal(a[..., 2], want[..., 2])
            and bool(((a - want).abs() <= 1e-12 * want.abs()).all()))


def run_f64(name, src=CSRC):
    import torch
    from lightgbm_tpu_torch.ops.histogram import GROUP_CHUNKS
    from lightgbm_tpu_torch.profile_slice import device_ms_by_kernel
    _configure(name, src, F64_CONFIGS)
    lib, group = _f64_lib(torch)
    for cname, (bins, g, h, m, B) in f64_cases().items():
        x = [torch.from_numpy(v).cuda() for v in (bins, g, h, m)]
        call, out, _ = _f64_entry(torch, lib, group, *x, B)
        a = call().clone()
        b = call()
        torch.cuda.synchronize()
        want = torch.load(os.path.join(WORK, f"ref64_{cname}.pt"))
        exact = group[0] == GROUP_CHUNKS or bins.shape[1] <= 9 * CHUNK
        if not (torch.equal(a, b) and _holds(torch, a, want, exact)):
            print(f"[{name}] {cname}: K1-f64 differs from its plain version",
                  flush=True)
            raise SystemExit(1)
        if cname in [f"k1-{k}" for k in F64_SIZES]:
            _time_f64(torch, name, lib, group, x, B, device_ms_by_kernel)
    gen = torch.Generator(device="cuda").manual_seed(22)
    n, F, B = ENVELOPE_ROWS, 28, 255
    bins = torch.randint(0, B, (F, n), dtype=torch.uint8, device="cuda",
                         generator=gen)
    g = torch.randn(n, device="cuda", generator=gen)
    h = torch.rand(n, device="cuda", generator=gen)
    m = (torch.rand(n, device="cuda", generator=gen) < 0.8).float()
    out = _time_f64(torch, name, lib, group, [bins, g, h, m], B,
                    device_ms_by_kernel)
    cnt = torch.stack([torch.bincount(bins[f].long(), weights=m.double(),
                                      minlength=B) for f in range(F)])
    ok = torch.equal(out[..., 2], cnt)
    first = os.path.join(WORK, "envelope64.pt")
    if os.path.exists(first):
        want = torch.load(first)
        ok = ok and bool(((out.cpu() - want).abs()
                          <= 1e-12 * want.abs()).all())
    else:
        torch.save(out.cpu(), first)
    print(f"[{name}] rows={n}: counts exact and sums within rtol 1e-12 of "
          f"the first configuration's: {ok}", flush=True)
    if not ok:
        raise SystemExit(1)
    print(f"[{name}] every case == plain (two launches each)", flush=True)


def _time_f64(torch, name, lib, group, x, B, device_ms_by_kernel):
    """Times the C entry on ``x`` and prints its line; returns its
    output."""
    bins, g, h, m = x
    F, n = bins.shape
    call, out, scratch = _f64_entry(torch, lib, group, *x, B)
    ms = time_ms(torch, call)
    dev = device_ms_by_kernel(torch, call)
    p1 = sum(v for k, v in dev.items() if "partial" in k)
    p2 = sum(v for k, v in dev.items() if "reduce" in k)
    line = (f"[{name}] K1-f64 rows={n}: entry {ms:.4f} ms | device pass 1 "
            f"{p1:.4f} pass 2 {p2:.4f} ms | scratch {scratch} B")
    if name == "f64" and n < ENVELOPE_ROWS:
        from lightgbm_tpu_torch.ops import cuda_histogram as ch
        whole = time_ms(torch, lambda: ch.histogram_single_leaf_f64_cuda(
            bins, g, h, m, B))
        keys = (bins.to(torch.int64) + torch.arange(F, device="cuda")
                [:, None] * B).reshape(-1)
        md = m.double()
        src = torch.stack([g.double() * md, h.double() * md, md],
                          -1).repeat(F, 1)
        lib_ms = time_ms(torch, lambda: torch.zeros(
            F * B, 3, dtype=torch.float64, device="cuda").index_add_(
                0, keys, src))
        nbytes = F * n + 12 * n + F * B * 24
        line += (f" | call {whole:.4f} ms | index_add_ {lib_ms:.4f} ms | "
                 f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms")
    print(line, flush=True)
    return call().clone()


def make_reference(f64=False):
    import torch
    os.makedirs(WORK, exist_ok=True)
    if f64:
        from lightgbm_tpu_torch.ops.histogram import histogram_feature_major
        for name, (bins, g, h, m, B) in f64_cases().items():
            x = [torch.from_numpy(v) for v in (bins, g, h, m)]
            torch.save(histogram_feature_major(*x, B, torch.float64),
                       os.path.join(WORK, f"ref64_{name}.pt"))
        return
    for name, case in cases().items():
        torch.save(_plain(torch, name, case),
                   os.path.join(WORK, f"ref_{name}.pt"))


def _configure(name, src, configs):
    """Copy ``src`` with the configuration's edits into its own directory
    and point ``ops/_build.py`` at it (the histogram library only); print
    its kernels' registers and spills."""
    d = os.path.join(WORK, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, os.path.join(d, "csrc"))
    for f, a, b in configs.get(name, []):
        p = os.path.join(d, "csrc", f)
        with open(p) as fh:
            s = fh.read()
        if a not in s:
            raise SystemExit(f"{name}: {a!r} not in {f}")
        with open(p, "w") as fh:
            fh.write(s.replace(a, b))
    from lightgbm_tpu_torch.ops import _build
    _build.CSRC = os.path.join(d, "csrc")
    _build.BUILD_DIR = os.path.join(d, "kernels")
    _build.SOURCES = ("histogram",)
    _build.build_all(force=True)
    for line in _build.ptxas_report("histogram").splitlines():
        if "Used" in line or "spill" in line:
            print(f"[{name}] ptxas {line.strip()}", flush=True)


def run_config(name, src=CSRC):
    import torch
    from lightgbm_tpu_torch.ops import cuda_histogram as ch
    from lightgbm_tpu_torch.profile_slice import device_ms_by_kernel
    _configure(name, src, CONFIGS)
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
        make_reference(f64=argv[1:] == ["--f64"])
        return 0
    if argv[:1] == ["--config"]:
        run_config(*argv[1:])
        return 0
    if argv[:1] == ["--config-f64"]:
        run_f64(*argv[1:])
        return 0
    f64 = "--f64" in argv
    argv = [a for a in argv if a != "--f64"]
    parent = None
    if argv[:1] == ["--parent-csrc"]:
        parent, argv = os.path.abspath(argv[1]), argv[2:]
    names = argv or list(F64_CONFIGS if f64 else CONFIGS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"[device] {smi.stdout.strip()}", flush=True)
    t0 = time.perf_counter()
    rc = subprocess.run([sys.executable, __file__, "--reference"]
                        + ["--f64"] * f64).returncode
    if rc:
        return rc
    print(f"[reference] plain versions on the CPU in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    runs = [[name] for name in names]
    if parent:
        runs.insert(0, ["parent", parent])
    mode = "--config-f64" if f64 else "--config"
    for run in runs:
        rc = subprocess.run([sys.executable, __file__, mode, *run]
                            ).returncode or rc
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
