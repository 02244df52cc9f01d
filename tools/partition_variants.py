#!/usr/bin/env python3
"""The record partition's kernels (K6 compact, K7 place) on one card, at
several window sizes, beside another checkout's and with other grids.

    python3 tools/partition_variants.py [--parent-csrc DIR] [--only-parent]
        [--variants V,V,...]

K6 and K7 live in ``csrc/record.cu``.  Each variant is a copy of
``lightgbm_tpu_torch/csrc`` built by ``nvcc`` with ``ops/_build.py``'s
flags into its own directory (all builds started together) and run
through its checkout's own wrapper (``ops/cuda_record.py``) in a process
of its own:

* ``ship``: this checkout as shipped;
* ``k6w1``, ``k6w2``: K6 with 1 or 2 times as many blocks as fit on the
  card at once (8 as shipped), so more tiles a block, their units staged
  in turn (``kCompactWaves``);
* ``k6lb``: K6 free to take more than 32 registers, so fewer blocks an
  SM (``__launch_bounds__(kTile)`` without its minimum of 4 blocks);
* ``k6t2``, ``k6t4``: K6 splitting a small window's rows until the grid
  holds 2 or 4 blocks an SM (``kSliceBlocksPerSM``);
* ``k6r16``: K6 splitting rows 16 a block at least (``kSliceRows``), so a
  12-row record is never split;
* ``k6s8``: K6 staging 8 rows a unit (``kStageRows``);
* combinations joined by ``+``, e.g. ``k6w1+k6t2``;
* ``k7b1``, ``k7b4``, ``k7b8``: K7's grid at most 1, 4 or 8 blocks an SM
  (``kPlaceBlocksPerSM``), so more or fewer tiles a block;
* ``k7q2``: K7 with 2 (row, run)s a warp in flight (``kPlaceBatch``);
* ``parent``: another checkout's ``csrc`` (``--parent-csrc DIR``, with
  ``DIR`` = ``<checkout>/lightgbm_tpu_torch/csrc``) through that
  checkout's wrapper, run first; ``--only-parent`` runs nothing else.

Windows of 400, 2,048, 16,683 (the median split window of the bench
tree), 60,000 and 1,000,000 columns at begin 0 and 37 of a record of W =
12 rows (the bench shape: 28 features at u8 bins) and W = 505 (2,000
features), random words from seed 0, split on one feature near its
median.  For each kernel and window it prints the CUDA-event median of
20 whole calls after 3, the device ms a call under the profiler (the
kernel's own, and all kernels the call launches: the parent's K7 call
also runs the run-offset scan), the grid where the wrapper reports it,
and a bitwise check of the first call against the plain versions
(``compact_tiles``' run lanes and counts; the record after
``place_runs``).  It prints each build's registers, shared memory and
spills (``nvcc -Xptxas -v``).  Builds go under ``build/partition_variants``.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "lightgbm_tpu_torch", "csrc")
WORK = os.path.join(ROOT, "build", "partition_variants")
WINDOWS = (400, 2048, 16_683, 60_000, 1_000_000)
BEGINS = (0, 37)
HEIGHTS = {12: (13, 127), 505: (1777, 127)}  # W -> (split feature, bin)
# variant -> (anchor in record.cu, its replacement)
VARIANTS = {
    "ship": None,
    "k6w1": ("kCompactWaves = 8;", "kCompactWaves = 1;"),
    "k6w2": ("kCompactWaves = 8;", "kCompactWaves = 2;"),
    "k6lb": ("__launch_bounds__(kTile, 4)\n    compact_kernel",
             "__launch_bounds__(kTile)\n    compact_kernel"),
    "k6t2": ("kSliceBlocksPerSM = 1;", "kSliceBlocksPerSM = 2;"),
    "k6t4": ("kSliceBlocksPerSM = 1;", "kSliceBlocksPerSM = 4;"),
    "k6r16": ("kSliceRows = 4;", "kSliceRows = 16;"),
    "k6s8": ("kStageRows = 16;", "kStageRows = 8;"),
    "k7b1": ("kPlaceBlocksPerSM = 2;", "kPlaceBlocksPerSM = 1;"),
    "k7b4": ("kPlaceBlocksPerSM = 2;", "kPlaceBlocksPerSM = 4;"),
    "k7b8": ("kPlaceBlocksPerSM = 2;", "kPlaceBlocksPerSM = 8;"),
    "k7q2": ("kPlaceBatch = 1;", "kPlaceBatch = 2;"),
}


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def _prepare(variant: str, src: str) -> str:
    """A copy of ``src`` with the variant's constant, under WORK."""
    d = os.path.join(WORK, variant)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, os.path.join(d, "csrc"))
    edits = [VARIANTS[v] for v in variant.split("+") if VARIANTS.get(v)]
    if edits:
        p = os.path.join(d, "csrc", "record.cu")
        with open(p) as fh:
            s = fh.read()
        for old, new in edits:
            if old not in s:
                raise SystemExit(f"{variant}: no {old!r} in record.cu")
            s = s.replace(old, new, 1)
        with open(p, "w") as fh:
            fh.write(s)
    return d


def _build_all(dirs) -> None:
    """nvcc of every copy's record.cu, all started together, with the
    flags of ops/_build.py."""
    sys.path.insert(0, ROOT)
    from lightgbm_tpu_torch.ops import _build

    procs = []
    for d in dirs:
        out = os.path.join(d, "kernels")
        os.makedirs(out, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               os.path.join(out, "librecord.so"),
               os.path.join(d, "csrc", "record.cu")]
        procs.append((d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True)))
    for d, p in procs:
        text, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {d}:\n{text}")
        with open(os.path.join(d, "kernels", "librecord.ptxas.txt"),
                  "w") as fh:
            fh.write(text)


def _time_ms(torch, fn, reps=20, warm=3):
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


def _device(torch, fn, kernel):
    """(the named kernel's, all kernels') device ms a call."""
    from lightgbm_tpu_torch.profile_slice import device_ms_by_kernel

    ms = device_ms_by_kernel(torch, fn)
    return (sum(v for k, v in ms.items() if kernel in k), sum(ms.values()))


def run_variant(variant: str, d: str, pkg_root: str) -> None:
    """Time one built variant's K6 and K7 at every window."""
    sys.path.insert(0, pkg_root)
    import torch

    from lightgbm_tpu_torch.ops import _build
    _build.CSRC = os.path.join(d, "csrc")
    _build.BUILD_DIR = os.path.join(d, "kernels")
    _build.SOURCES = ("record",)
    from lightgbm_tpu_torch.ops import cuda_record as C
    from lightgbm_tpu_torch.ops import record as R

    for line in _build.ptxas_report("record").splitlines():
        if ("compact" in line or "place" in line or "Used" in line
                or "spill" in line):
            print(f"[{variant}] ptxas {line.strip()}", flush=True)
    T, k = R.TILE, 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    for W, (f, thr) in HEIGHTS.items():
        n = max(WINDOWS) + max(BEGINS) + 100
        rec = torch.randint(-2**31, 2**31 - 1, (W, n), dtype=torch.int32,
                            device="cuda", generator=gen)
        for pcnt in WINDOWS:
            for begin in BEGINS:
                line = f"[{variant}] W={W} pcnt={pcnt} begin={begin}"
                go = R.go_flags(rec, f, thr, False, begin, pcnt, k)
                comp_p, cl, cr = R.compact_tiles(
                    rec[:W - 1, begin:begin + pcnt], go)
                comp, counts = C.compact_cuda(rec, f, thr, False, begin,
                                              pcnt, k)
                lane = torch.arange(T, device="cuda")[None]
                same6 = (torch.equal(counts[0], cl)
                         and torch.equal(counts[1], cr))
                for half, cnt in ((slice(0, T), cl), (slice(T, 2 * T), cr)):
                    valid = lane < cnt[:, None]
                    same6 = same6 and torch.equal(
                        comp[:, :, half].permute(1, 0, 2)[:, valid],
                        comp_p[:, :, half].permute(1, 0, 2)[:, valid])
                del comp_p
                rk, rp = rec.clone(), rec.clone()
                nl = C.place_cuda(rk, comp, counts, begin, pcnt, 3, 9)
                R.place_runs(rp, comp, cl, cr, begin, pcnt, int(cl.sum()),
                             3, 9)
                same7 = torch.equal(rk, rp) and int(nl) == int(cl.sum())
                del rp
                torch.cuda.synchronize()
                if not (same6 and same7):
                    raise SystemExit(f"{line}: K6 == plain {same6}, K7 == "
                                     f"plain {same7}")

                def k6():
                    return C.compact_cuda(rec, f, thr, False, begin, pcnt, k)

                def k7():
                    return C.place_cuda(rk, comp, counts, begin, pcnt, 3, 9)

                k6_ms, k7_ms = _time_ms(torch, k6), _time_ms(torch, k7)
                k6_dev, k6_all = _device(torch, k6, "compact_kernel")
                k7_dev, k7_all = _device(torch, k7, "place_kernel")
                grid = ""
                if hasattr(C, "grids"):
                    grid = " grid " + str(C.grids(-(-pcnt // T), W,
                                                  rec.device))
                print(f"{line} bitwise==plain K6 ms={k6_ms:.4f} "
                      f"device_ms={k6_dev:.4f} (all {k6_all:.4f}) K7 "
                      f"ms={k7_ms:.4f} device_ms={k7_dev:.4f} (all "
                      f"{k7_all:.4f}){grid}", flush=True)
                del comp, counts, rk
        del rec
        torch.cuda.empty_cache()


def main(argv) -> int:
    if argv[:1] == ["--variant"]:
        run_variant(*argv[1:])
        return 0
    parent = None
    if "--parent-csrc" in argv:
        parent = os.path.abspath(argv[argv.index("--parent-csrc") + 1])
    names = list(VARIANTS)
    if "--variants" in argv:
        names = argv[argv.index("--variants") + 1].split(",")
    unknown = {v for n in names for v in n.split("+")} - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    print(f"[device] {_smi()}", flush=True)
    sys.path.insert(0, ROOT)
    from lightgbm_tpu_torch.ops import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(f"[nvcc] {nvcc[-1] if nvcc else 'unknown'}", flush=True)
    trees = [] if "--only-parent" in argv else [(v, CSRC) for v in names]
    if parent:
        trees.insert(0, ("parent", parent))
    runs = [(v, _prepare(v, src), os.path.dirname(os.path.dirname(src)))
            for v, src in trees]
    _build_all([d for _, d, _ in runs])
    rc = 0
    for v, d, pkg in runs:
        rc = subprocess.run([sys.executable, __file__, "--variant", v, d,
                             pkg]).returncode or rc
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
