#!/usr/bin/env python3
"""Configurations of the level histogram (K1'', K2) side by side on one card.

    python3 tools/level_hist_variants.py [NAME ...]

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


def cases(torch):
    rng = np.random.RandomState(0)
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


def make_reference():
    import torch
    from lightgbm_tpu_torch.ops.histogram import (
        histogram_by_leaf_sorted_plain)
    os.makedirs(WORK, exist_ok=True)
    for name, (bins, leaf, g, h, m, B, L) in cases(torch).items():
        torch.save(histogram_by_leaf_sorted_plain(bins, leaf, g, h, m, B, L),
                   os.path.join(WORK, f"ref_{name}.pt"))


def run_config(name):
    import torch
    d = os.path.join(WORK, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, os.path.join(d, "csrc"))
    for f, a, b in CONFIGS[name]:
        p = os.path.join(d, "csrc", f)
        with open(p) as fh:
            s = fh.read()
        if a not in s:
            raise SystemExit(f"{name}: {a!r} not in {f}")
        with open(p, "w") as fh:
            fh.write(s.replace(a, b))
    from lightgbm_tpu_torch.ops import _build
    from lightgbm_tpu_torch.ops import cuda_histogram as ch
    from lightgbm_tpu_torch.ops.histogram import CHUNK_ROWS, level_layout
    _build.CSRC = os.path.join(d, "csrc")
    _build.BUILD_DIR = os.path.join(d, "kernels")
    _build.build_all(force=True)
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
        make_reference()
        return 0
    if argv[:1] == ["--config"]:
        run_config(argv[1])
        return 0
    names = argv or list(CONFIGS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"[device] {smi.stdout.strip()}", flush=True)
    t0 = time.perf_counter()
    rc = subprocess.run([sys.executable, __file__, "--reference"]).returncode
    if rc:
        return rc
    print(f"[reference] plain version on the CPU in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for name in names:
        rc = subprocess.run([sys.executable, __file__, "--config", name]
                            ).returncode or rc
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
