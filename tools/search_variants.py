#!/usr/bin/env python3
"""The split-search kernels (K3, K4, K5; K3-f64 with ``--f64``) on one
card, at several feature and bin counts, beside another checkout's and
with other block sizes.

    python3 tools/search_variants.py [--parent-csrc DIR] [--only-parent]
    python3 tools/search_variants.py --f64 [--parent-csrc DIR]

K3 (``search2_rows``), K4 (``search2_update``) and K5 (``search2_pool``
with the parent resident) live in ``csrc/search.cu``.  Each variant is a
copy of ``lightgbm_tpu_torch/csrc`` built by ``nvcc`` with
``ops/_build.py``'s flags into its own directory (all builds started
together) and run through its checkout's own wrapper
(``ops/cuda_search.py``) in a process of its own:

* ``w4``: this checkout as shipped (4 warps a block);
* ``w2``, ``w8``: this checkout with 2 or 8 warps a block (``kWarps``);
* ``parent``: another checkout's ``csrc`` (``--parent-csrc DIR``, with
  ``DIR`` = ``<checkout>/lightgbm_tpu_torch/csrc``) through that
  checkout's wrapper, run first; ``--only-parent`` runs nothing else.

Shapes: F = 28, 200, 2000 and 5000 features at 255 bins and at 5,000
bins (random f32 histograms, seed 0, every feature on); the parent skips
the shapes of 2,000 features or more at 5,000 bins (its one-block step
walks 30M cells and more) and reports what its wrapper refuses.  For
each kernel and shape it prints the CUDA-event median of 20 calls after
3 (5 after 1 above 10M cells), the kernel's device ms under the profiler,
the grid and a bitwise check of the first call against the plain version
(``ops/split.py``) on the card.  It prints each build's registers, stack
and spills (``nvcc -Xptxas -v``).  Builds go under
``build/search_variants``.  Needs a CUDA card and nvcc.

``--f64`` times kernel 3-f64 instead, in float64: its root form
(``search2_rows``) and its step form (``search2_update``: the
subtraction, both rows written and both searches) at F = 28, 64, 136,
200, 2000 and 5000 features x 255 bins and F = 28 x 5000 bins, in
search64_config's choice and forced through ``_forced_config`` on each
side of the size switch (the ticketed grid, and clusters of other block
and warp counts), each call checked bitwise against the plain version on
the CPU (rows and the written buffer).  With ``--parent-csrc`` it first
runs that checkout's K3-f64, whose step is the composition its learner
ran (a PyTorch subtraction, the root-form search, two row copies).  For
each it prints the CUDA-event median ms a call and the device ms (every
kernel of the call, under the profiler).  At F = 28 it also splits one
call's host time into its stages (perf_counter means over 2,000 calls of
each stage alone) and prints the CPU operations ``torch.profiler``
records for 200 calls.
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
CSRC = os.path.join(ROOT, "lightgbm_tpu_torch", "csrc")
WORK = os.path.join(ROOT, "build", "search_variants")
SHAPES = [(f, b) for b in (255, 5000) for f in (28, 200, 2000, 5000)]
WARPS = {"w4": 4, "w2": 2, "w8": 8}  # variant -> warps a block
_ANCHOR = "constexpr int kWarps = 4;"


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def _prepare(variant: str, src: str) -> str:
    """A copy of ``src`` with the variant's block size, under WORK."""
    d = os.path.join(WORK, variant)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, os.path.join(d, "csrc"))
    if variant in F64_VARIANTS:
        anchor, repl = F64_VARIANTS[variant]
        p = os.path.join(d, "csrc", "search.cu")
        with open(p) as fh:
            s = fh.read()
        if anchor not in s:
            raise SystemExit(f"{variant}: no {anchor!r} in search.cu")
        with open(p, "w") as fh:
            fh.write(s.replace(anchor, repl, 1))
    if variant in WARPS:
        p = os.path.join(d, "csrc", "search.cu")
        with open(p) as fh:
            s = fh.read()
        if _ANCHOR not in s:
            raise SystemExit(f"{variant}: no {_ANCHOR!r} in search.cu")
        with open(p, "w") as fh:
            fh.write(s.replace(_ANCHOR, f"constexpr int kWarps = "
                               f"{WARPS[variant]};", 1))
    return d


def _build_all(dirs) -> None:
    """nvcc of every copy's search.cu, all started together, with the
    flags of ops/_build.py."""
    sys.path.insert(0, ROOT)
    from lightgbm_tpu_torch.ops import _build

    procs = []
    for d in dirs:
        out = os.path.join(d, "kernels")
        os.makedirs(out, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               os.path.join(out, "libsearch.so"),
               os.path.join(d, "csrc", "search.cu")]
        procs.append((d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True)))
    for d, p in procs:
        text, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {d}:\n{text}")
        with open(os.path.join(d, "kernels", "libsearch.ptxas.txt"),
                  "w") as fh:
            fh.write(text)


def _time_ms(torch, fn, reps, warm):
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


def run_variant(variant: str, d: str, pkg_root: str) -> None:
    """Time one built variant's three kernels at every shape."""
    sys.path.insert(0, pkg_root)
    import torch

    from lightgbm_tpu_torch.ops import _build
    _build.CSRC = os.path.join(d, "csrc")
    _build.BUILD_DIR = os.path.join(d, "kernels")
    _build.SOURCES = ("search",)
    from lightgbm_tpu_torch.ops import cuda_search as S
    from lightgbm_tpu_torch.ops import split as plain
    from lightgbm_tpu_torch.profile_slice import device_ms_by_kernel

    for line in _build.ptxas_report("search").splitlines():
        if "Compiling" in line or "Used" in line or "spill" in line:
            print(f"[{variant}] ptxas {line.strip()}", flush=True)
    warps = WARPS.get(variant)
    for F, B in SHAPES:
        if variant == "parent" and F >= 2000 and B > 255:
            print(f"[{variant}] F={F} B={B} skipped", flush=True)
            continue
        rng = np.random.RandomState(0)
        hl, hr = (torch.from_numpy(np.stack(
            [rng.randn(F, B), np.abs(rng.randn(F, B)) + 0.1,
             rng.randint(1, 50, (F, B))], -1).astype(np.float32)).cuda()
            for _ in range(2))
        meta = S.pack_meta(torch.ones(F, dtype=torch.bool),
                           torch.full((F,), B),
                           torch.zeros(F, dtype=torch.bool), "cuda")
        scal = ([1.0] + hl[0].sum(0).tolist() + hr[0].sum(0).tolist()
                + [100.0, 1e-3, 0.0, 1.0, 0.0])
        bufs = torch.zeros((4, F, B, 3), dtype=torch.float32, device="cuda")
        bufs[1] = hl + hr
        big = F * B * 3 > 10_000_000
        reps, warm = (5, 1) if big else (20, 3)
        calls = {
            "K3": (lambda: S._search2_rows_cuda(hl, hr, scal, meta),
                   lambda: plain.search2_rows(hl, hr, scal, meta), None,
                   2 * F),
            "K4": (lambda b: S._search2_update_cuda(b, hl, 1, 3, True, scal,
                                                    meta),
                   lambda b: plain.search2_update(b, hl, 1, 3, True, scal,
                                                  meta), bufs, F),
            "K5": (lambda b: S._search2_pool_cuda(b, hl, 1, 1, 3, True, scal,
                                                  meta),
                   lambda b: plain.search2_pool(b, hl, 1, 1, 3, True, scal,
                                                meta), bufs, F),
        }
        for name, (kern, ref, buf, nwarps) in calls.items():
            line = f"[{variant}] {name} F={F} B={B}"
            try:
                if buf is None:
                    same = torch.equal(kern(), ref())
                    fn = kern
                else:
                    bk, bp = buf.clone(), buf.clone()
                    rk, rp = kern(bk), ref(bp)
                    same = torch.equal(rk, rp) and torch.equal(bk, bp)
                    fn = lambda: kern(bk)  # noqa: E731
            except ValueError as e:  # a wrapper's refusal
                print(f"{line} refused: {e}", flush=True)
                continue
            torch.cuda.synchronize()
            if not same:
                raise SystemExit(f"{line}: differs from the plain version")
            ms = _time_ms(torch, fn, reps, warm)
            dev = sum(v for k, v in device_ms_by_kernel(
                torch, fn, reps=reps, warm=warm).items() if "search2" in k)
            if warps:
                line += f" grid={-(-nwarps // warps)} x {warps} warps"
            print(f"{line} bitwise==plain ms={ms:.4f} device_ms={dev:.4f}",
                  flush=True)
        del hl, hr, bufs


F64_SHAPES = [(1, 7), (28, 255), (32, 255), (48, 255), (64, 255),
              (136, 255), (2000, 255), (5000, 255), (28, 5000)]
# compile-time variants of the cluster kernel (an edit of search.cu), run
# at the first shapes only: other constants, and parts of the call left
# out (timing only: those are not held against the plain version), so the
# time a part takes is the shipped call's less the variant's
F64_VARIANTS = {
    "u2": ("#pragma unroll 1  //", "#pragma unroll 2  //"),
    "no-gains": ("  for (int j = lane; j < B; j += 32) {\n    const int q = j >> 4,",
                 "  for (int j = lane; j < 0; j += 32) {\n    const int q = j >> 4,"),
    "no-scan": ("    scan_cells_warp(x, B, mf[0] > 0, mf[1], mf[2] > 0, p, c, "
                "res);", "    res[0] = -INFINITY;"),
    "no-pick": ("  if (rank != 0) return;", "  return;"),
}
F64_TIMING_ONLY = ("no-gains", "no-scan", "no-pick")
F64_VARIANT_SHAPES = F64_SHAPES[:3]


def _f64_case(torch, F, B):
    """Seeded float64 cells of a parent and its smaller child, meta and
    the constants, on the card."""
    rng = np.random.RandomState(F + B)

    def cells():
        return np.stack([rng.randn(F, B), np.abs(rng.randn(F, B)) + 0.1,
                         rng.randint(1, 50, (F, B)).astype(np.float64)], -1)

    small = torch.from_numpy(cells()).cuda()
    parent = small + torch.from_numpy(cells()).cuda()
    ts, tp = small[0].sum(0).tolist(), parent[0].sum(0).tolist()
    scal = [1.0, *ts, *[a - b for a, b in zip(tp, ts)], 100.0, 1e-3, 0.0,
            1.0, 0.0]
    return parent, small, scal


def _f64_configs(S, F, B):
    """(name, forced configuration) pairs: the shipped choice, the
    ticketed grid and, at B <= 512, clusters of 8, 4, 2 and 1 blocks."""
    out = [("shipped", None), ("grid", (0, 0))]
    if B <= S.CLUSTER_BINS:
        pairs = 2 * F
        for c in (8, 4):
            out.append((f"cluster{c}", (c, min(S.CLUSTER_WARPS,
                                               -(-pairs // c)))))
    return out


def _host_split(torch, S, F=28, B=255, reps=2000):
    """One float64 split's host time by stage (mean us over ``reps`` calls
    of each stage alone), then the CPU operations torch.profiler sees."""
    from torch.profiler import ProfilerActivity, profile

    parent, small, scal = _f64_case(torch, F, B)
    meta = S.pack_meta(torch.ones(F, dtype=torch.bool), torch.full((F,), B),
                       torch.zeros(F, dtype=torch.bool), "cuda")
    dev = parent.device
    buf = torch.zeros((4, F, B, 3), dtype=torch.float64, device="cuda")
    buf[1] = parent
    left, right = small, parent - small

    def us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return t

    def stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    stages = {
        "search2_rows call": lambda: S._search2_rows_cuda(left, right, scal,
                                                          meta),
        "_check_search": lambda: S._check_search(
            [("h_left", left), ("h_right", right)], meta, scal, F,
            torch.float64),
        "device context + current_stream": stream,
        "torch.empty rows": lambda: torch.empty((2, 16), dtype=torch.float64,
                                                device=dev),
        "_workspace": lambda: S._workspace(dev, F, torch.float64),
        "subtraction (torch)": lambda: buf[1] - small,
        "row copy (torch)": lambda: buf.__setitem__(3, right),
    }
    if hasattr(S, "F64Step"):
        step = S.F64Step(buf, meta)
        stages["F64Step.update call"] = lambda: step.update(small, 1, 3, True,
                                                            scal)
        stages["F64Step per tree"] = lambda: S.F64Step(buf, meta)
    for name, fn in stages.items():
        print(f"[host] {name}: {us(fn):.2f} us", flush=True)

    def composition():
        h_large = buf[1] - small
        rows = S._search2_rows_cuda(small, h_large, scal, meta)
        buf[1] = small
        buf[3] = h_large
        return rows

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(200):
            composition()
        torch.cuda.synchronize()
    for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total
                    )[:8]:
        print(f"[host profiler, composition] {e.key}: {e.count / 200:.1f} a "
              f"split, self {e.self_cpu_time_total / 200:.2f} us a split",
              flush=True)


def run_f64_variant(variant: str, d: str, pkg_root: str) -> None:
    """Kernel 3-f64's forms at every F64 shape in one built checkout."""
    sys.path.insert(0, pkg_root)
    import torch

    from lightgbm_tpu_torch.ops import _build
    _build.CSRC = os.path.join(d, "csrc")
    _build.BUILD_DIR = os.path.join(d, "kernels")
    _build.SOURCES = ("search",)
    from lightgbm_tpu_torch.ops import cuda_search as S
    from lightgbm_tpu_torch.ops import split as plain
    from lightgbm_tpu_torch.profile_slice import device_ms_by_kernel

    for line in _build.ptxas_report("search").splitlines():
        if "double" in line or "Used" in line or "spill" in line:
            print(f"[{variant}] ptxas {line.strip()}", flush=True)
    shapes = F64_SHAPES
    if variant in F64_VARIANTS:
        shapes = F64_VARIANT_SHAPES
    else:
        _host_split(torch, S)
    step_form = hasattr(S, "F64Step")
    for F, B in shapes:
        parent, small, scal = _f64_case(torch, F, B)
        meta = S.pack_meta(torch.ones(F, dtype=torch.bool),
                           torch.full((F,), B),
                           torch.zeros(F, dtype=torch.bool), "cuda")
        mc, pc, sc = meta.cpu(), parent.cpu(), small.cpu()
        want_rows = plain.search2_rows(sc, pc - sc, scal, mc)
        bp = torch.zeros((4, F, B, 3), dtype=torch.float64)
        bp[1] = pc
        want_step = plain.search2_update(bp, sc, 1, 3, True, scal, mc)
        big = F * B * 3 > 10_000_000
        reps, warm = (5, 1) if big else (20, 3)
        h_large = parent - small
        configs = _f64_configs(S, F, B) if step_form else [("old", None)]
        for name, forced in configs:
            if step_form:
                S._forced_config = forced
            buf = torch.zeros((4, F, B, 3), dtype=torch.float64,
                              device="cuda")
            buf[1] = parent

            def root():
                return S._search2_rows_cuda(small, h_large, scal, meta)

            if step_form:  # bound once, as the learner binds it a tree
                f64_step = S.F64Step(buf, meta)

                def step(st=f64_step):
                    return st.update(small, 1, 3, True, scal)
            else:  # the composition the parent's learner ran
                def step(b=buf):
                    large = b[1] - small
                    rows = S._search2_rows_cuda(small, large, scal, meta)
                    b[1] = small
                    b[3] = large
                    return rows
            same = torch.equal(root().cpu(), want_rows)
            got = step()
            same = same and torch.equal(got.cpu(), want_step) and \
                torch.equal(buf.cpu(), bp)
            torch.cuda.synchronize()
            held = "bitwise==plain"
            if variant in F64_TIMING_ONLY:
                held = "timing only"
            elif not same:
                raise SystemExit(f"[{variant}] {name} F={F} B={B}: differs "
                                 "from the plain version")
            cfg = S.search64_config(F, B) if step_form else "grid"
            for form, fn in (("root", root), ("step", step)):
                ms = _time_ms(torch, fn, reps, warm)
                dev = sum(device_ms_by_kernel(torch, fn, reps=reps,
                                              warm=warm).values())
                print(f"[{variant}] K3-f64 {form} F={F} B={B} {name} "
                      f"config={cfg} {held} ms={ms:.4f} "
                      f"device_ms={dev:.4f}", flush=True)
        if step_form:
            S._forced_config = None
        del parent, small, h_large


def main(argv) -> int:
    if argv[:1] == ["--variant"]:
        run_variant(*argv[1:])
        return 0
    if argv[:1] == ["--f64-variant"]:
        run_f64_variant(*argv[1:])
        return 0
    parent = None
    if "--parent-csrc" in argv:
        parent = os.path.abspath(argv[argv.index("--parent-csrc") + 1])
    print(f"[device] {_smi()}", flush=True)
    if "--f64" in argv:
        trees = [("f64", CSRC)] + [(v, CSRC) for v in F64_VARIANTS]
        flag = "--f64-variant"
    else:
        trees = [] if "--only-parent" in argv else [(v, CSRC) for v in WARPS]
        flag = "--variant"
    if parent:
        trees.insert(0, ("parent", parent))
    runs = [(v, _prepare(v, src), os.path.dirname(os.path.dirname(src)))
            for v, src in trees]
    _build_all([d for _, d, _ in runs])
    rc = 0
    for v, d, pkg in runs:
        rc = subprocess.run([sys.executable, __file__, flag, v, d,
                             pkg]).returncode or rc
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
