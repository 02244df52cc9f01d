#!/usr/bin/env python3
"""The mega split step (K8) phase by phase on one card, at four windows.

    python3 tools/split_step_phases.py [--parent-csrc DIR] [--only-parent]

K8 (``csrc/split_step.cu``) is one cooperative launch whose phases are
separated by grid barriers: A (the compaction tiles and the left child's
chunk partials), B (the reduction, the subtraction and both buffer rows)
and C (both children's searches).  Each variant is a copy of
``lightgbm_tpu_torch/csrc`` with a few lines replaced so that the kernel
returns early:

* ``tiles``: phase A with its compaction items only;
* ``A``: the whole of phase A;
* ``B``: phases A and B;
* ``full``: the kernel as shipped;
* ``g2``, ``g4``: the whole kernel with 2 or 4 features a phase-A
  histogram item (``kGroup``; this checkout only).

Each copy is built by ``nvcc`` with ``ops/_build.py``'s flags into its
own directory (all builds started together) and run through the wrapper
``ops/cuda_split_step.split_step_cuda`` in a process of its own, as
``chip_smoke.py`` loads the kernels.  The windows are those of the bench
shape's record (1M columns, 28 u8 features, 255 bins, seed 0): the root
(1M columns), a 60,000-column interior window, a 6,000-column window and
a 400-column one-tile window (most parents of a tree have 9,600-33,000
columns, ``profile_slice``'s K8 quartiles).  For each it prints
the CUDA-event median of 20 calls after 3 of every variant and its
kernel's device ms under the profiler (the phase times are the
differences), and for a whole kernel a bitwise check against the plain
version (``ops/record.split_step_plain``) on the CPU.  It prints each
build's registers, shared memory and spills (``nvcc -Xptxas -v``), the
grid at each window and the resident blocks an SM (the grid of a window
larger than the card holds over the card's SM count:
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the shipped dynamic
shared memory).

``--parent-csrc DIR`` runs the same variants of another checkout's
``csrc`` (``DIR`` is ``<checkout>/lightgbm_tpu_torch/csrc``) through that
checkout's own wrappers first; ``--only-parent`` runs nothing else.
Builds go under ``build/split_step_phases``.  Needs a CUDA card and nvcc.
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
WORK = os.path.join(ROOT, "build", "split_step_phases")
F, NB, N = 28, 255, 1_000_000
# (name, begin, pcnt, split feature, threshold)
WINDOWS = (("root", 0, N, 13, 127), ("interior", 333_333, 60_000, 6, 90),
           ("small", 777_777, 6_000, 20, 60), ("one-tile", 5_003, 400, 2,
                                                100))

_RET = "  return;  // variant\n"
# variant -> edits of split_step.cu: (text, replacement) pairs, of which
# at least one must apply (the shipped kernel and the one before it word
# phase A's item count differently)
VARIANTS = {
    "tiles": [[("(int64_t)nchunks * a.F;", "0;"),
               ("(int64_t)nchunks * groups;", "0;")],
              [("  grid_sync(a.bar);\n\n  // ---- B",
                _RET + "  grid_sync(a.bar);\n\n  // ---- B")]],
    "A": [[("  grid_sync(a.bar);\n\n  // ---- B",
            _RET + "  grid_sync(a.bar);\n\n  // ---- B")]],
    "B": [[("  grid_sync(a.bar);\n\n  // ---- C",
            _RET + "  grid_sync(a.bar);\n\n  // ---- C")]],
    "full": [],
    "g2": [[("constexpr int kGroup = 1;", "constexpr int kGroup = 2;")]],
    "g4": [[("constexpr int kGroup = 1;", "constexpr int kGroup = 4;")]],
}
PHASES = ("tiles", "A", "B")  # the variants that return early


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def _prepare(tag: str, variant: str, src: str) -> str:
    """A copy of ``src`` with the variant's edits, under WORK."""
    d = os.path.join(WORK, tag, variant)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, os.path.join(d, "csrc"))
    p = os.path.join(d, "csrc", "split_step.cu")
    with open(p) as fh:
        s = fh.read()
    for alternatives in VARIANTS[variant]:
        hits = [(a, b) for a, b in alternatives if a in s]
        if not hits:
            raise SystemExit(f"{tag}/{variant}: no anchor of {alternatives!r}"
                             " in split_step.cu")
        for a, b in hits:
            s = s.replace(a, b, 1)
    with open(p, "w") as fh:
        fh.write(s)
    return d


def _build_all(dirs) -> None:
    """nvcc of every copy's split_step.cu, all started together, with the
    flags of ops/_build.py."""
    sys.path.insert(0, ROOT)
    from lightgbm_tpu_torch.ops import _build

    procs = []
    for d in dirs:
        out = os.path.join(d, "kernels")
        os.makedirs(out, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               os.path.join(out, "libsplit_step.so"),
               os.path.join(d, "csrc", "split_step.cu")]
        procs.append((d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True)))
    for d, p in procs:
        text, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {d}:\n{text}")
        with open(os.path.join(d, "kernels", "libsplit_step.ptxas.txt"),
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


def run_variant(tag: str, variant: str, d: str, pkg_root: str) -> None:
    """Time one built variant at the four windows (one line each)."""
    sys.path.insert(0, pkg_root)
    import torch

    from lightgbm_tpu_torch.ops import _build
    _build.CSRC = os.path.join(d, "csrc")
    _build.BUILD_DIR = os.path.join(d, "kernels")
    _build.SOURCES = ("split_step",)
    from lightgbm_tpu_torch.ops import cuda_split_step as K8
    from lightgbm_tpu_torch.ops import record as R
    from lightgbm_tpu_torch.ops.cuda_search import pack_meta
    from lightgbm_tpu_torch.ops.histogram import histogram_record_window
    from lightgbm_tpu_torch.profile_slice import device_ms_by_kernel

    for line in _build.ptxas_report("split_step").splitlines():
        if "Used" in line or "spill" in line:
            print(f"[{tag} {variant}] ptxas {line.strip()}", flush=True)
    rng = np.random.RandomState(0)
    bins = torch.from_numpy(rng.randint(0, NB, (F, N)).astype(np.uint8))
    g = torch.from_numpy(rng.randn(N).astype(np.float32))
    h = torch.from_numpy(np.abs(rng.randn(N)).astype(np.float32))
    m = torch.from_numpy((rng.rand(N) < 0.8).astype(np.float32))
    rec = R.build_record(*(t.cuda() for t in (bins, g, h, m)))
    rec_cpu = rec.cpu()
    k, wb = 4, R.num_words(F, 4)
    meta = pack_meta(torch.ones(F, dtype=torch.bool), torch.full((F,), NB),
                     torch.zeros(F, dtype=torch.bool), "cuda")
    for name, begin, pcnt, f, thr in WINDOWS:
        hists = torch.zeros((4, F, NB, 3), dtype=torch.float32,
                            device="cuda")
        hists[1] = histogram_record_window(rec, begin, pcnt, F, k, NB)
        go = R.go_flags(rec, f, thr, False, begin, pcnt, k).float()
        gw, hw, mw = (rec[wb + i, begin:begin + pcnt].view(torch.float32)
                      for i in range(3))
        scal = [1.0]
        for side in (go, 1.0 - go):
            scal += [float((gw * mw * side).sum()),
                     float((hw * mw * side).sum()), float((mw * side).sum())]
        scal += [100.0, 1e-3, 0.0, 0.0, 0.0]
        args = (f, thr, False, begin, pcnt, 1, 3, scal, meta, k, NB)
        hk = hists.clone()

        def call():
            return K8.split_step_cuda(rec, hk, *args)

        line = f"[{tag} {variant}] {name} pcnt={pcnt}"
        if variant not in PHASES:
            hp = hists.cpu()
            _, counts_p, rows_p = R.split_step_plain(
                rec_cpu, hp, *args[:8], meta.cpu(), k, NB)
            _, counts, rows = call()
            torch.cuda.synchronize()
            ok = (torch.equal(hk.cpu(), hp) and torch.equal(rows.cpu(), rows_p)
                  and torch.equal(counts.cpu(), counts_p))
            if not ok:
                raise SystemExit(f"[{tag}] {name}: K8 differs from the plain "
                                 "version")
            try:
                grid = K8.grid_blocks(pcnt, F, NB)
            except TypeError:  # a checkout whose grid ignores the bins
                grid = K8.grid_blocks(pcnt, F)
            line += f" grid={grid} bitwise==plain"
        ms = _time_ms(torch, call)  # timed before the profiler runs
        dev = sum(v for name, v in device_ms_by_kernel(torch, call).items()
                  if "split_step_kernel" in name)
        line += f" device_ms={dev:.4f} ms={ms:.4f}"
        print(line, flush=True)
    if variant not in PHASES:
        try:
            cap = K8.grid_blocks(1 << 40, F, NB)
        except TypeError:
            cap = K8.grid_blocks(1 << 40, F)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"[{tag}] resident grid {cap} blocks on {sms} SMs: "
              f"{cap / sms:g} blocks an SM", flush=True)


def main(argv) -> int:
    if argv[:1] == ["--variant"]:
        run_variant(*argv[1:])
        return 0
    parent = None
    only_parent = "--only-parent" in argv
    if "--parent-csrc" in argv:
        parent = os.path.abspath(argv[argv.index("--parent-csrc") + 1])
    print(f"[device] {_smi()}", flush=True)
    trees = [] if only_parent else [("this", CSRC)]
    if parent:
        trees.insert(0, ("parent", parent))
    runs = [(tag, v, _prepare(tag, v, src),
             os.path.dirname(os.path.dirname(src)))
            for tag, src in trees for v in VARIANTS
            if tag == "this" or not v.startswith("g")]
    _build_all([d for _, _, d, _ in runs])
    rc = 0
    for tag, v, d, pkg in runs:
        rc = subprocess.run([sys.executable, __file__, "--variant", tag, v, d,
                             pkg]).returncode or rc
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
