#!/usr/bin/env python3
"""Configurations of the level histogram (K1'', K2) side by side on one card.

    python3 tools/level_hist_variants.py [--f64] [--parent-csrc DIR]
        [NAME ...]

Each configuration is a copy of ``lightgbm_tpu_torch/csrc`` with a few
constants replaced (features and threads a block, the count table's
size), built by ``ops/_build.py`` into its own directory and run through
the wrapper ``ops/cuda_histogram.histogram_by_leaf_sorted_cuda``, one
configuration per process, as ``chip_smoke.py`` loads the kernels.  On
synthetic inputs made from seed 0 (a 6-level tree's shape: 1M rows, 28
u8 features, 255 bins, 62 of 255 leaf slots live; the same with ~90 % of
every feature's rows in one bin; u16 x 300 and u16 x 5000 bins; one leaf)
each configuration's K1'' (twice) and K2 must equal the plain version
(``histogram_by_leaf_sorted_plain`` on the CPU) bitwise.  At the first
two inputs it prints CUDA-event medians (20 calls after 3) of the whole
call, of the C entry alone (the chunk table and passes 1 and 2, after a
sort done once), of ``level_layout`` (the plain prep) and of the sort
alone, and of one ``index_add_`` of the same sums.  The
outputs of the plain version are kept under ``build/level_hist_variants``.
Needs a CUDA card and nvcc.

``--f64`` selects K1''-f64 (``hist_dtype=float64``) instead: the
configurations of ``F64_CONFIGS`` (the shipped walk) and, with
``--parent-csrc DIR``, another checkout's K1''-f64 (e.g. the earlier
sorted design, one partial a chunk; the tool sizes its table and
scratch, and picks its C entry's arguments, from whether the library has
``lgbm_level_hist_group_chunks``).  Each is held against the plain float64
version (``histogram_by_leaf_sorted_plain`` with ``acc_dtype=float64``)
on the inputs above and a level whose leaves hold 8, 9 and 17 chunks and
none: bitwise, twice, where the library sums in the plain version's
order (another checkout's where every leaf holds at most 9 chunks), else
counts bitwise and sums within rtol 1e-12.  At the first two inputs it
prints the C entry's CUDA-event median (20 calls after 3) and its
kernels' device ms from the profiler (the sort is the wrapper's and not
in it), the scratch bytes, and for ``f64`` the wrapper's whole call and
one float64 ``index_add_``.
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
WORK = os.path.join(ROOT, "build", "level_hist_variants")
TABLE = "constexpr int kTable = 4096;"
# name -> (file, text, replacement) edits of a copy of csrc/
CONFIGS = {
    "shipped": [],
    "k1_2x128": [("level_histogram.cu", "kLevelGroup = 4;",
                  "kLevelGroup = 2;"),
                 ("level_histogram.cu", "kLevelThreads = 256;",
                  "kLevelThreads = 128;")],
    "k1_8x256": [("level_histogram.cu", "kLevelGroup = 4;",
                  "kLevelGroup = 8;")],
    "k2_16x256": [("level_histogram.cu", "kGroupThreads = 512;",
                   "kGroupThreads = 256;")],
    "table_2048": [("hist_chunk.cuh", TABLE, "constexpr int kTable = 2048;")],
    "table_1024": [("hist_chunk.cuh", TABLE, "constexpr int kTable = 1024;")],
}
# K1''-f64's configurations (--f64): edits of hist_chunk.cuh's walk
F64_CONFIGS = {
    "f64": [],
}
CHUNK = 2048


def _case(torch, rng, n, F, B, dt, L, live, dominant=False):
    bins = rng.randint(0, B, (F, n)).astype(dt)
    if dominant:
        bins[rng.rand(F, n) < 0.9] = B // 3
    slots = rng.choice(L, live, replace=False)
    leaf = slots[rng.choice(live, n, p=rng.dirichlet(np.ones(live)))]
    g = rng.randn(n).astype(np.float32)
    h = np.abs(rng.randn(n)).astype(np.float32)
    m = (rng.rand(n) < 0.8).astype(np.float32)
    return [torch.from_numpy(a) for a in (bins, leaf.astype(np.int32), g, h,
                                          m)] + [B, L]


def _chunked(torch, rng):
    """Leaves of 8, 9 and 17 chunks, one chunk, one row and none, their
    rows shuffled (28 u8 features, 255 bins)."""
    sizes = (8 * CHUNK, 0, 9 * CHUNK, 17 * CHUNK, 0, CHUNK, 1)
    n = sum(sizes)
    leaf = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    bins = rng.randint(0, 255, (28, n)).astype(np.uint8)
    g = rng.randn(n).astype(np.float32)
    h = np.abs(rng.randn(n)).astype(np.float32)
    m = (rng.rand(n) < 0.8).astype(np.float32)
    return [torch.from_numpy(a) for a in (bins, leaf.astype(np.int32), g, h,
                                          m)] + [255, len(sizes)]


def cases(torch, f64=False):
    rng = np.random.RandomState(0)
    if f64:
        return dict(cases(torch), chunked=_chunked(torch, rng))
    return {
        "level6": _case(torch, rng, 1_000_000, 28, 255, np.uint8, 255, 62),
        "dominant": _case(torch, rng, 1_000_000, 28, 255, np.uint8, 255, 62,
                          dominant=True),
        "u16x300": _case(torch, rng, 100_000, 28, 300, np.uint16, 64, 64),
        "u16x5000": _case(torch, rng, 100_000, 4, 5000, np.uint16, 64, 64),
        "one-leaf": _case(torch, rng, 300_000, 28, 255, np.uint8, 1, 1),
    }


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


def make_reference(f64=False):
    import torch
    from lightgbm_tpu_torch.ops.histogram import (
        histogram_by_leaf_sorted_plain)
    os.makedirs(WORK, exist_ok=True)
    dt, tag = (torch.float64, "ref64") if f64 else (None, "ref")
    for name, (bins, leaf, g, h, m, B, L) in cases(torch, f64).items():
        torch.save(histogram_by_leaf_sorted_plain(bins, leaf, g, h, m, B, L,
                                                  dt),
                   os.path.join(WORK, f"{tag}_{name}.pt"))


def _configure(name, configs, src=CSRC):
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
    _build.SOURCES = ("level_histogram",)
    _build.build_all(force=True)


def _f64_entry(torch, lib, bins, leaf, g, h, m, B, L):
    """(a function calling lgbm_level_hist_f64 after the wrapper's sort,
    into buffers allocated once, its output, its scratch bytes): the
    table, products and partials of a library with groups of
    lgbm_level_hist_group_chunks() chunks, else one partial a chunk."""
    import ctypes
    from lightgbm_tpu_torch.ops import _build

    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    groups = hasattr(lib, "lgbm_level_hist_group_chunks")
    lib.lgbm_level_hist_f64.restype = i
    lib.lgbm_level_hist_f64.argtypes = (
        [vp, i, vp, vp, vp, vp, vp, i, i64, i, i, i, vp] + [vp] * groups
        + [vp, vp, vp])
    F, n = bins.shape
    sorted_leaf, order = torch.sort(leaf, stable=True)
    cap = -(-n // CHUNK) + L
    size, parts, extra = 2 * (L + 1) + 3 * cap, cap, []
    if groups:
        lib.lgbm_level_hist_group_chunks.restype = i
        parts = -(-n // (CHUNK * lib.lgbm_level_hist_group_chunks())) + L
        size += L + 1 + 3 * parts
        extra = [torch.empty((3, n), dtype=torch.float64, device="cuda")]
    f64 = dict(dtype=torch.float64, device="cuda")
    table = torch.empty(size, dtype=torch.int64, device="cuda")
    part = torch.empty((parts, F, B, 3), **f64)
    out = torch.empty((L, F, B, 3), **f64)

    def call():
        code = lib.lgbm_level_hist_f64(
            bins.data_ptr(), bins.element_size(), g.data_ptr(), h.data_ptr(),
            m.data_ptr(), order.data_ptr(), sorted_leaf.data_ptr(),
            sorted_leaf.element_size(), n, F, L, B, table.data_ptr(),
            *[t.data_ptr() for t in extra], part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        _build.check(code, "float64 level histogram")
        return out

    scratch = (table.numel() + part.numel()
               + sum(t.numel() for t in extra)) * 8
    return call, scratch


def run_f64(name, src=CSRC):
    import torch
    from lightgbm_tpu_torch.ops import _build
    from lightgbm_tpu_torch.ops import cuda_histogram as ch
    from lightgbm_tpu_torch.profile_slice import device_ms_by_kernel
    _configure(name, F64_CONFIGS, src)
    lib = _build.load("level_histogram")
    mine = hasattr(lib, "lgbm_level_hist_group_chunks")
    for cname, case in cases(torch, f64=True).items():
        bins, leaf, g, h, m = (t.cuda() for t in case[:5])
        B, L = case[5:]
        want = torch.load(os.path.join(WORK, f"ref64_{cname}.pt"))
        call, scratch = _f64_entry(torch, lib, bins, leaf, g, h, m, B, L)
        a = call().clone()
        b = call()
        torch.cuda.synchronize()
        counts = torch.bincount(case[1].long(), minlength=L)
        exact = mine or int(counts.max()) <= 9 * CHUNK
        a = a.cpu()
        ok = torch.equal(a, b.cpu()) and (
            torch.equal(a, want) if exact else
            torch.equal(a[..., 2], want[..., 2])
            and bool(((a - want).abs() <= 1e-12 * want.abs()).all()))
        print(f"[{name}] {cname}: K1''-f64 twice == plain "
              f"({'bitwise' if exact else 'counts bitwise, rtol 1e-12'}): "
              f"{ok}", flush=True)
        if not ok:
            raise SystemExit(1)
        if cname not in ("level6", "dominant"):
            continue
        ms = time_ms(torch, call)
        dev = device_ms_by_kernel(torch, call)
        top = ", ".join(f"{k[:48]} {v:.4f}" for k, v in sorted(
            dev.items(), key=lambda kv: -kv[1]))
        line = (f"[{name}] {cname}: entry {ms:.4f} ms | device "
                f"{sum(dev.values()):.4f} ms ({top}) | scratch {scratch} B")
        if name == "f64":
            F, n = bins.shape
            whole = time_ms(
                torch, lambda: ch.histogram_by_leaf_sorted_f64_cuda(
                    bins, leaf, g, h, m, B, L))
            keys = ((leaf.to(torch.int64)[None, :] * F
                     + torch.arange(F, device="cuda")[:, None]) * B
                    + bins.to(torch.int64)).reshape(-1)
            md = m.double()
            src_ = torch.stack([g.double() * md, h.double() * md, md],
                               -1).repeat(F, 1)
            lib_ms = time_ms(torch, lambda: torch.zeros(
                L * F * B, 3, dtype=torch.float64, device="cuda").index_add_(
                    0, keys, src_))
            line += f" | call {whole:.4f} ms | index_add_ {lib_ms:.4f} ms"
        print(line, flush=True)


def run_config(name):
    import torch
    _configure(name, CONFIGS)
    from lightgbm_tpu_torch.ops import _build
    from lightgbm_tpu_torch.ops import cuda_histogram as ch
    from lightgbm_tpu_torch.ops.histogram import CHUNK_ROWS, level_layout
    lib = ch._level_lib()
    for cname, case in cases(torch).items():
        bins, leaf, g, h, m = (t.cuda() for t in case[:5])
        B, L = case[5:]
        want = torch.load(os.path.join(WORK, f"ref_{cname}.pt"))
        outs = [ch.histogram_by_leaf_sorted_cuda(bins, leaf, g, h, m, B, L, v)
                for v in ("v1", "v1", "bsub")]
        torch.cuda.synchronize()
        ok = all(torch.equal(o.cpu(), want) for o in outs)
        print(f"[{name}] {cname}: K1'' twice and K2 bitwise == plain: {ok}",
              flush=True)
        if not ok:
            raise SystemExit(1)
        if cname not in ("level6", "dominant"):
            continue
        F, n = bins.shape
        sorted_leaf, order = torch.sort(leaf, stable=True)
        nch = -(-n // CHUNK_ROWS) + L
        table = torch.empty(2 * (L + 1) + 3 * nch, dtype=torch.int64,
                            device="cuda")
        out = torch.empty((L, F, B, 3), device="cuda")
        part = torch.empty((nch, F, B, 3), device="cuda")

        def entry(v):
            code = lib.lgbm_level_hist(
                bins.data_ptr(), bins.element_size(), g.data_ptr(),
                h.data_ptr(), m.data_ptr(), order.data_ptr(),
                sorted_leaf.data_ptr(), sorted_leaf.element_size(), n, F, L,
                B, v, table.data_ptr(), part.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            _build.check(code, "level histogram")

        call = {v: time_ms(torch, lambda v=v: ch.histogram_by_leaf_sorted_cuda(
            bins, leaf, g, h, m, B, L, v)) for v in ("v1", "bsub")}
        alone = {v: time_ms(torch, lambda v=v: entry(v)) for v in (0, 1)}
        layout = time_ms(torch, lambda: level_layout(leaf, L))
        sort = time_ms(torch, lambda: torch.sort(leaf, stable=True))
        keys = ((leaf.to(torch.int64)[None, :] * F
                 + torch.arange(F, device="cuda")[:, None]) * B
                + bins.to(torch.int64)).reshape(-1)
        src = torch.stack([g * m, h * m, m], -1).repeat(F, 1)
        lib_ms = time_ms(torch, lambda: torch.zeros(
            L * F * B, 3, device="cuda").index_add_(0, keys, src))
        print(f"[{name}] {cname}: call K1'' {call['v1']:.4f} K2 "
              f"{call['bsub']:.4f} ms | entry K1'' {alone[0]:.4f} K2 "
              f"{alone[1]:.4f} ms | level_layout {layout:.4f} ms | sort "
              f"{sort:.4f} ms | "
              f"index_add_ {lib_ms:.4f} ms", flush=True)


def main(argv) -> int:
    if argv[:1] == ["--reference"]:
        make_reference(f64=argv[1:] == ["--f64"])
        return 0
    if argv[:1] == ["--config"]:
        run_config(argv[1])
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
    print(f"[reference] plain version on the CPU in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    runs = [[name] for name in names]
    if parent:
        runs.insert(0, ["parent", parent])
    mode = "--config-f64" if f64 else "--config"
    if parent and not f64:
        raise SystemExit("--parent-csrc goes with --f64")
    for run in runs:
        rc = subprocess.run([sys.executable, __file__, mode, *run]
                            ).returncode or rc
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
