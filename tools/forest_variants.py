#!/usr/bin/env python3
"""The forest's lane kernels F1 and F3 (csrc/forest.cu) and one forest step
on one card, stage by stage, beside another checkout's.

    python3 tools/forest_variants.py [--parent-csrc DIR]

Each checkout's ``csrc`` is copied under ``build/forest_variants/<name>``
and its ``forest.cu`` built there by ``nvcc`` with ``ops/_build.py``'s
flags (all builds started together); each then runs through its own
package (``ops/cuda_forest.py``, ``learners/forest.py``) in a process of
its own: ``parent`` (``--parent-csrc DIR``, with ``DIR`` =
``<checkout>/lightgbm_tpu_torch/csrc``) first, then this checkout.

For each it prints:

* F1's root form (every lane's histogram of its leaf 0) at phase 24's
  timed shapes (8 and 64 lanes x 2,048 rows, 4 and 64 lanes x 1M rows,
  F = 28, 255 u8 bins; ``chip_smoke.py``'s generator): the CUDA-event
  median ms a call, the device ms a call with no host in the loop (50
  calls queued behind a spin kernel), each kernel's device ms under the
  profiler, and the host stages of a call (perf_counter means over 2,000
  calls of each stage alone: the checks, the allocations, the device and
  stream, the whole call; with a ``ForestStep``, its construction, once a
  round, and its ``root_histogram``);
* with a ``ForestStep``, F1's and F3's step forms at 8 lanes x 2,048 rows
  and 64 lanes x 1M rows: the same times, the map partitioned by the first
  call (later calls find no row to move: the same reads, fewer writes);
* F3's root form (a lane's root histogram as both children) at 8 and 64
  lanes, F = 28, and 8 lanes, F = 136 (the parent's ``forest_search``,
  which sets up its scratch a call; a ``ForestStep``'s ``root_search``),
  and ``root_search`` at the step shapes: the same times;
* ``grow_forest`` at phase 24's (b) shape (8 lanes, 2,048 rows, 31
  leaves; seeded bins and gradients): wall ms a forest step, and under
  ``torch.profiler`` the CPU operations a step (count and self us) and
  the device events a step, by name.

Card name and power limit first (nvidia-smi).  Needs a CUDA card and nvcc.
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
WORK = os.path.join(ROOT, "build", "forest_variants")
ROWS = 1_000_000
# (name, lanes, rows, leaves the rows spread over, lanes with no row of
# leaf 0)
F1_CASES = [("b8-n2048", 8, 2048, 4, (2,)),
            ("b64-n2048", 64, 2048, 8, (7,)),
            ("b4-n1M", 4, ROWS, 1, ()),
            ("b64-n1M", 64, ROWS, 64, (5,))]
F, NB = 28, 255
F3_CASES = [(8, 28), (64, 28), (8, 136)]
STEP_CASES = [("b8-n2048", 8, 2048, 4), ("b64-n1M", 64, ROWS, 64)]
SPIN_CYCLES = 100_000_000


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def _build_all(dirs) -> None:
    """nvcc of every copy's forest.cu, all started together."""
    sys.path.insert(0, ROOT)
    from lightgbm_tpu_torch.ops import _build

    procs = []
    for d in dirs:
        out = os.path.join(d, "kernels")
        os.makedirs(out, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               os.path.join(out, "libforest.so"),
               os.path.join(d, "csrc", "forest.cu")]
        procs.append((d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True)))
    for d, p in procs:
        text, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {d}:\n{text}")
        with open(os.path.join(d, "kernels", "libforest.ptxas.txt"),
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


def _queued_ms(torch, fn, calls=50, reps=5):
    """Device ms a call: ``calls`` calls enqueued behind a spin kernel."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / calls)
    return statistics.median(ts)


def _host_us(torch, fn, reps=2000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return t


def _f1_case(torch, rng, B, n, leaves, empty):
    """chip_smoke.py's root case on the card: ~1/(leaves + 1) of each
    lane's rows outside every leaf, lanes ``empty`` with no row of leaf 0;
    the target (leaf 0 of every lane) for the parent's function."""
    bins = torch.from_numpy(rng.randint(0, NB, (F, n)).astype(np.uint8))
    g = torch.from_numpy(rng.randn(B, n).astype(np.float32))
    h = torch.from_numpy(np.abs(rng.randn(B, n)).astype(np.float32))
    m = torch.from_numpy((rng.rand(B, n) < 0.8).astype(np.float32))
    lid = rng.randint(-1, leaves, (B, n)).astype(np.int32)
    for b in empty:
        lid[b][lid[b] == 0] = -1
    return [t.cuda() for t in (bins, g, h, m, torch.from_numpy(lid),
                               torch.zeros(B, dtype=torch.int32))]


def _meta(torch, B, Fs, share=0.8):
    """[B, Fs, 4] meta of lanes each with ``share`` of its features on
    (its own draws: the cases' data stay the same in every variant)."""
    from lightgbm_tpu_torch.ops.cuda_search import pack_meta

    rng = np.random.RandomState(B * 1000 + Fs)
    return torch.stack([pack_meta(torch.from_numpy(rng.rand(Fs) < share),
                                  torch.full((Fs,), NB),
                                  torch.zeros(Fs, dtype=torch.bool), "cuda")
                        for _ in range(B)])


def _report(variant, what, torch, fn, stages):
    from lightgbm_tpu_torch.profile_slice import device_ms_by_kernel

    ms = _time_ms(torch, fn)
    dev = _queued_ms(torch, fn)
    by = device_ms_by_kernel(torch, fn, reps=20, warm=3)
    print(f"[{variant}] {what}: ms={ms:.4f} queued_device_ms={dev:.4f} "
          f"kernels={len(by)}", flush=True)
    for k, v in sorted(by.items(), key=lambda kv: -kv[1]):
        print(f"[{variant}]   device {k}: {v:.4f} ms", flush=True)
    for k, fn_ in stages.items():
        print(f"[{variant}]   host {k}: {_host_us(torch, fn_):.2f} us",
              flush=True)


def _f1(variant, torch, C):
    rng = np.random.RandomState(24)
    stepped = hasattr(C, "ForestStep")
    for name, B, n, leaves, empty in F1_CASES:
        bins, g, h, m, lid, tgt = _f1_case(torch, rng, B, n, leaves, empty)
        dev = bins.device
        if stepped:
            meta = _meta(torch, B, F)
            hists = torch.zeros((B, 1, F, NB, 3), device=dev)
            fs = C.ForestStep(bins, g, h, m, lid, NB, meta=meta, hists=hists)
            fn = fs.root_histogram
            stages = {"call": fn,
                      "ForestStep (once a round)": lambda: C.ForestStep(
                          bins, g, h, m, lid, NB, meta=meta, hists=hists)}
        else:
            def fn():
                return C.forest_histogram_cuda(bins, g, h, m, lid, tgt, NB)

            cap = B * -(-n // 2048)
            ntiles = -(-n // 2048)

            def empties():
                torch.empty(2 * B * ntiles + 2 * B + 1, dtype=torch.int32,
                            device=dev)
                torch.empty(cap * 2048, dtype=torch.int64, device=dev)
                torch.empty((cap, F, NB, 3), dtype=torch.float32, device=dev)
                torch.empty((B, F, NB, 3), dtype=torch.float32, device=dev)

            def stream():
                with torch.cuda.device(dev):
                    return torch.cuda.current_stream(dev).cuda_stream

            stages = {"call": fn,
                      "_check_lanes": lambda: C._check_lanes(
                          bins, g, h, m, lid, tgt),
                      "four torch.empty": empties,
                      "device + current_stream": stream}
        _report(variant, f"F1 root {name}", torch, fn, stages)
        del bins, g, h, m, lid, tgt
        torch.cuda.empty_cache()


def _step_case(torch, rng, B, n, leaves):
    """A step of every lane: leaf ``bl`` of lane b split on a random
    feature at a random numerical threshold; the map of ``leaves`` leaves
    and the lane's parent count."""
    bins = torch.from_numpy(rng.randint(0, NB, (F, n)).astype(np.uint8))
    g = torch.from_numpy(rng.randn(B, n).astype(np.float32))
    h = torch.from_numpy(np.abs(rng.randn(B, n)).astype(np.float32))
    m = torch.from_numpy((rng.rand(B, n) < 0.8).astype(np.float32))
    lid = rng.randint(0, leaves, (B, n)).astype(np.int32)
    bl = rng.randint(0, leaves, B)
    pcnt = (lid == bl[:, None]).sum(1)
    lanes = np.arange(B)
    feats = rng.randint(0, F, B)
    thrs = rng.randint(0, NB, B)
    cats = np.zeros(B, bool)
    scal = np.tile(np.array([1, 0, 1, 100, 0, 1, 100, 20, 1e-3, 0, 1, 0],
                            np.float32), (B, 1))
    dev = [t.cuda() for t in (bins, g, h, m, torch.from_numpy(lid))]
    return dev, (lanes, bl, feats, thrs, cats, pcnt, leaves, scal)


def _steps(variant, torch, C):
    rng = np.random.RandomState(25)
    L = 0
    for name, B, n, leaves in STEP_CASES:
        (bins, g, h, m, lid), spec = _step_case(torch, rng, B, n, leaves)
        L = leaves + 1
        meta = _meta(torch, B, F, share=1.0)
        hists = torch.rand((B, L, F, NB, 3), device="cuda")
        fs = C.ForestStep(bins, g, h, m, lid, NB, meta=meta, hists=hists)
        fs.step(*spec)
        torch.cuda.synchronize()
        _report(variant, f"F1 step {name}", torch,
                lambda: fs.split_histogram(*spec),
                {"call": lambda: fs.split_histogram(*spec),
                 "pack (the step's values into the pinned buffer)":
                     lambda: fs._pack(*spec)})
        _report(variant, f"F3 step {name}", torch, fs.search,
                {"call": fs.search})
        _report(variant, f"F1 + F3 step {name}", torch,
                lambda: fs.step(*spec), {"call": lambda: fs.step(*spec)})
        scal = np.tile(spec[-1][:1], (B, 1))
        _report(variant, f"F3 root (ForestStep.root_search) {name}", torch,
                lambda: fs.root_search(scal),
                {"call": lambda: fs.root_search(scal)})
        del bins, g, h, m, lid, hists, fs
        torch.cuda.empty_cache()


def _f3(variant, torch, C):
    rng = np.random.RandomState(26)
    for A, Fs in F3_CASES:
        hists = torch.rand((A, 1, Fs, NB, 3), device="cuda")
        meta = _meta(torch, A, Fs)
        scal = np.array([[1, 100, 300, 500, 100, 300, 500, 20, 1e-3, 0, 1,
                          0]] * A, np.float32)
        dev = hists.device
        stages = {}
        if hasattr(C, "ForestStep"):
            n = 64  # the roots' rows: F3 reads only the buffer
            fs = C.ForestStep(
                torch.zeros((Fs, n), dtype=torch.uint8, device=dev),
                *(torch.zeros((A, n), device=dev) for _ in range(3)),
                torch.zeros((A, n), dtype=torch.int32, device=dev), NB,
                meta=meta, hists=hists)

            def fn():
                return fs.root_search(scal)
        else:
            h0 = hists[:, 0].contiguous()
            scal_d = torch.from_numpy(scal).to(dev)

            def fn():
                return C.forest_search_cuda(h0, h0, meta, scal_d)

            def empties():
                torch.empty((A, 2, 16), dtype=torch.float32, device=dev)
                torch.empty(A * 2 * Fs * 8, dtype=torch.float32, device=dev)

            stages["two torch.empty"] = empties
        _report(variant, f"F3 root A={A} F={Fs}", torch, fn,
                {"call": fn, **stages})


def _grow(variant, torch):
    """``grow_forest`` at phase 24's (b) shape (8 lanes, 2,048 rows, F =
    28, 255 bins, 31 leaves; seeded bins and gradients): wall ms a step
    over three calls, then one profiled call's CPU operations and device
    events a step (its root included)."""
    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch.learners.forest import grow_forest
    from lightgbm_tpu_torch.learners.serial import TreeLearnerParams
    from lightgbm_tpu_torch.ops import cuda_forest

    rng = np.random.RandomState(27)
    B, n, L = 8, 2048, 31
    bins = torch.from_numpy(rng.randint(0, NB, (F, n)).astype(np.uint8))
    g = torch.from_numpy(rng.randn(B, n).astype(np.float32))
    h = torch.from_numpy(np.abs(rng.randn(B, n)).astype(np.float32) + .1)
    m = torch.ones((B, n))
    fm = torch.from_numpy(rng.rand(B, F) < 0.8)
    args = [t.cuda() for t in (bins, g, h, m, fm,
                               torch.full((F,), NB, dtype=torch.int32),
                               torch.zeros(F, dtype=torch.bool))]
    params = [TreeLearnerParams(20.0, 1e-3, 0.0, float(b), 0.0, 0)
              for b in range(B)]

    def grow():
        s0 = cuda_forest.SEARCH_LAUNCHES
        grow_forest(*args, params, NB, L)
        torch.cuda.synchronize()
        return cuda_forest.SEARCH_LAUNCHES - s0 - 1  # the steps

    grow()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        steps = grow()
        walls.append((time.perf_counter() - t0) / steps)
    print(f"[{variant}] grow_forest (b): {steps} steps, "
          f"{statistics.median(walls) * 1e3:.4f} ms a step (a call's wall "
          "over its steps, the root included; median of 3)", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps = grow()
    dev = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = e.name[:60]
            dev[key] = dev.get(key, 0) + 1
    print(f"[{variant}] grow_forest (b) profiled: "
          f"{sum(dev.values()) / steps:.2f} device events a step (the "
          "root's included)", flush=True)
    for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:14]:
        print(f"[{variant}]   device events {k}: {v / steps:.2f} a step",
              flush=True)
    for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total
                    )[:24]:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        print(f"[{variant}]   cpu {e.key[:60]}: {e.count / steps:.2f} a "
              f"step, self {e.self_cpu_time_total / steps:.2f} us a step",
              flush=True)


def run_variant(variant: str, d: str, pkg_root: str) -> None:
    sys.path.insert(0, pkg_root)
    import torch

    from lightgbm_tpu_torch.ops import _build
    _build.CSRC = os.path.join(d, "csrc")
    _build.BUILD_DIR = os.path.join(d, "kernels")
    _build.SOURCES = ("forest",)
    from lightgbm_tpu_torch.ops import cuda_forest as C

    for line in _build.ptxas_report("forest").splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print(f"[{variant}] ptxas {line.strip()}", flush=True)
    _f1(variant, torch, C)
    if hasattr(C, "ForestStep"):
        _steps(variant, torch, C)
    _f3(variant, torch, C)
    _grow(variant, torch)


def main(argv) -> int:
    if argv[:1] == ["--variant"]:
        run_variant(*argv[1:])
        return 0
    print(f"[device] {_smi()}", flush=True)
    trees = [("this", CSRC)]
    if "--parent-csrc" in argv:
        trees.insert(0, ("parent", os.path.abspath(
            argv[argv.index("--parent-csrc") + 1])))
    runs = []
    for v, src in trees:
        d = os.path.join(WORK, v)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, os.path.join(d, "csrc"))
        runs.append((v, d, os.path.dirname(os.path.dirname(src))))
    _build_all([d for _, d, _ in runs])
    rc = 0
    for v, d, pkg in runs:
        rc = subprocess.run([sys.executable, __file__, "--variant", v, d,
                             pkg]).returncode or rc
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
