#!/usr/bin/env python3
"""The split-search kernels (K3, K4, K5) on one card, at several feature
and bin counts, beside another checkout's and with other block sizes.

    python3 tools/search_variants.py [--parent-csrc DIR] [--only-parent]

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
"""

from __future__ import annotations

import os
import shutil
import statistics
import subprocess
import sys

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


def main(argv) -> int:
    if argv[:1] == ["--variant"]:
        run_variant(*argv[1:])
        return 0
    parent = None
    if "--parent-csrc" in argv:
        parent = os.path.abspath(argv[argv.index("--parent-csrc") + 1])
    print(f"[device] {_smi()}", flush=True)
    trees = [] if "--only-parent" in argv else [(v, CSRC) for v in WARPS]
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
