#!/usr/bin/env python3
"""Kernel P2 (``csrc/predict_binned.cu``) on one card: held bitwise against
its plain version at the training path's shapes, and timed in other
configurations beside the one ``p2_config`` picks, beside P1 on the same
trees and beside another checkout's P2.

    python3 tools/p2_variants.py [--parent-csrc DIR] [--trees N]

It trains the bench model (``synthetic.bench_data`` seed 7, 1M rows x 28
features and 200k valid rows, 255 leaves, ``N`` trees, default 100) on
the mega route with the valid set, then:

* holds P2 bitwise against ``binned_update_`` / ``binned_replay_`` on the
  card in every configuration timed below (one tree, 3 trees and all
  trees over the 1M training rows in update mode; the valid replay of
  30 and of all trees over the 200k valid rows);
* times each (CUDA-event median of 20 calls after 3, and the device ms a
  call of back-to-back calls enqueued behind a spin kernel, as
  ``chip_smoke.py`` times them), with the node visits a second, in the
  configuration ``p2_config`` picks and in others (rows a tile 64-256,
  tiled or wide, records staged or through L1), P1 over the same trees
  and the raw rows, and the table build ``binned_table([tree])``;
* times one tree over the training rows sorted by their leaf in it and
  over one row repeated 1M times: a warp's lanes on one path, against
  the unsorted rows';
* at the shapes where ``p2_config`` picks tree slots (the first 3,000
  and 30,000 valid rows, 30 and 100 trees, update and replay mode),
  holds and times its configuration beside the kernel of one row a
  thread (256 rows, records through L1 or staged);
* with ``--parent-csrc DIR`` (``DIR`` = ``<checkout>/lightgbm_tpu_torch/
  csrc`` of a checkout whose P2 takes a per-tree meta array, before the
  class offset and the scale were kernel arguments), builds that
  ``predict_binned.cu`` beside this one, holds it equal to this P2 and
  times it on the same table in turns (parent, this, this, parent); and
  when ``DIR/../models/tree.py`` is there, times that checkout's
  ``binned_table`` of one tree beside this one's.

Builds go under ``build/p2_variants``; the numbers are also written to
``chiprun_out/p2_variants.json``.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "p2_variants")
ROWS, VALID = 1_000_000, 200_000
# few rows and many trees, where p2_config picks tree slots
SLOT_ROWS, SLOT_TREES = (3_000, 30_000), (30, 100)
HBM_BYTES_PER_S = 3.35e12


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


class Parent:
    """Another checkout's P2, which reads a per-tree ``[T, 4]`` meta of
    {root, class, the scale's f32 bits, 0}."""

    def __init__(self, so):
        VP, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        self.lib = ctypes.CDLL(so)
        self.lib.lgbm_p2_walk.restype = I
        self.lib.lgbm_p2_walk.argtypes = [
            VP, VP, VP, VP, I, I64, I, I, I, I, I, VP, VP]

    @staticmethod
    def meta(torch, table, K, c0, scale):
        T = table.num_trees
        m = np.zeros((T, 4), np.int32)
        m[:, 0] = table.root
        m[:, 1] = [(c0 + t) % K for t in range(T)]
        m[:, 2] = np.full(T, scale, np.float32).view(np.int32)
        return torch.from_numpy(m).cuda()

    def walk(self, torch, scores, table, bins, meta, replay, chunk):
        K, n = scores.shape
        code = self.lib.lgbm_p2_walk(
            table.node.data_ptr(), table.leaf_value.data_ptr(),
            meta.data_ptr(), bins.data_ptr(), bins.element_size(), n, K,
            table.num_trees, table.max_steps, int(replay), chunk,
            scores.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return scores


# copies of this checkout's predict_binned.cu cut after the scores' read
# and write (stages1) or after the tile's load (stages2): the stage times
VARIANTS = {"stages1": ["-DP2_STAGES=1"], "stages2": ["-DP2_STAGES=2"]}


def _build(parent_csrc):
    """This checkout's kernels, its P2 VARIANTS and, given, the parent's
    predict_binned.cu, all nvcc runs started together.  Returns (the
    parent, {variant: library}, seconds)."""
    from lightgbm_tpu_torch.ops import _build as b

    os.makedirs(WORK, exist_ok=True)
    src = os.path.join(b.CSRC, "predict_binned.cu")
    jobs = {name: (flags, src) for name, flags in VARIANTS.items()}
    if parent_csrc:
        jobs["parent"] = ([], os.path.join(parent_csrc, "predict_binned.cu"))
    procs = {}
    for name, (flags, path) in jobs.items():
        so = os.path.join(WORK, f"libp2_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [b._nvcc(), *b.NVCC_FLAGS, *flags, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    b.build_all(force=True)
    for line in b.ptxas_report("predict_binned").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"[ptxas predict_binned] {line.strip()}")
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name} build failed:\n{out}")
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
        libs[name] = so
    parent = Parent(libs.pop("parent")) if parent_csrc else None
    return parent, {k: ctypes.CDLL(v) for k, v in libs.items()}, \
        time.perf_counter() - t0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("p2_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import lightgbm_tpu_torch as lt
    from chip_smoke import _visits, queued_ms, time_ms
    from lightgbm_tpu_torch.models import tree as pt
    from lightgbm_tpu_torch.ops import cuda_predict as cp
    from lightgbm_tpu_torch.ops import cuda_predict_binned as P2
    from lightgbm_tpu_torch.synthetic import bench_data

    parent_csrc = None
    if "--parent-csrc" in argv:
        parent_csrc = os.path.abspath(argv[argv.index("--parent-csrc") + 1])
    n_trees = int(argv[argv.index("--trees") + 1]) if "--trees" in argv \
        else 100
    card = _smi()
    print(f"[device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    parent, variant_libs, build_s = _build(parent_csrc)
    print(f"[build] {build_s:.1f}s", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    X, y, Xv, yv = bench_data(ROWS, seed=7, n_valid=VALID)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 100, "verbose": -1}
    train = lt.Dataset(X, label=y, params=params)
    valid = train.create_valid(Xv, label=yv)
    t0 = time.perf_counter()
    bst = lt.train(params, train, n_trees, valid_sets=[valid],
                   valid_names=["valid"], verbose_eval=False)
    torch.cuda.synchronize()
    print(f"[train] {n_trees} trees {time.perf_counter() - t0:.1f}s",
          flush=True)
    gb = bst._gbdt
    trees = gb.models
    T = len(trees)
    tr, va = gb._bins_T, gb._valid_bins[0]
    one, three, every = (pt.binned_table(trees[-1:]),
                         pt.binned_table(trees[:3]), pt.binned_table(trees))
    thirty = pt.binned_table(trees[:30])
    res = {"card": card, "trees": T, "sms": sms, "holds": [], "times": []}

    # P1 leaves on the raw rows give each row's leaf, so its depth: the
    # visits of a walk of the same trees over the same rows' bins
    p = gb._packed()
    Xc = torch.from_numpy(np.ascontiguousarray(X)).cuda()
    Xvc = torch.from_numpy(np.ascontiguousarray(Xv)).cuda()
    lv1m = cp.ensemble_leaves_cuda(p, Xc, T)
    lv200k = cp.ensemble_leaves_cuda(p, Xvc, T)
    vis = {("train", n): _visits(torch, trees[-n:] if n == 1 else trees[:n],
                                 lv1m[-n:] if n == 1 else lv1m[:n])
           for n in (1, 3, T)}
    vis.update({("valid", n): _visits(torch, trees[-n:] if n == 1
                                      else trees[:n],
                                      lv200k[-n:] if n == 1 else lv200k[:n])
                for n in (1, 30, T)})
    few_vis = {(n, k): _visits(torch, trees[:k], lv200k[:k, :n])
               for n in SLOT_ROWS for k in SLOT_TREES if k <= T}
    del lv1m, lv200k

    # (name, table, bins, replay, chunk, visits)
    shapes = [("one_tree_1M", one, tr, False, 1, vis[("train", 1)]),
              ("one_tree_200k", one, va, False, 1, vis[("valid", 1)]),
              ("three_trees_1M", three, tr, False, 1, vis[("train", 3)]),
              (f"{T}_trees_1M", every, tr, False, 1, vis[("train", T)]),
              ("replay_30_200k", thirty, va, True, gb._iter_chunk(VALID),
               vis[("valid", 30)]),
              (f"replay_{T}_200k", every, va, True, gb._iter_chunk(VALID),
               vis[("valid", T)])]
    oks = []

    def configs(table, bins, replay):
        F, n = bins.shape
        bb = bins.element_size()
        auto = P2.p2_config(n, F, bb, table.num_trees, 1, sms,
                            table.max_steps, replay)
        st = auto[3] or 768
        out = [None]
        for cfg in [(256, True, 0), (256, True, st), (128, True, 0),
                    (64, True, 0), (256, False, 0)]:
            if cfg[2] and cfg[2] < table.max_steps:
                continue
            if P2.smem_bytes(cfg[0], F, bb, 1, replay, cfg[1],
                             cfg[2]) > P2.SMEM_BYTES:
                continue
            if (cfg[0], cfg[1], P2.THREADS // cfg[0], cfg[2]) == auto:
                continue
            out.append(cfg)
        return auto, out

    def forced(cfg, fn):
        """``fn()`` with P2 in ``cfg`` (rows, tiled, records staged; None:
        p2_config's choice)."""
        P2._forced_config = None if cfg is None else (
            int(cfg[0]), bool(cfg[1]), int(cfg[2]))
        try:
            return fn()
        finally:
            P2._forced_config = None

    shipped_lib = P2._lib

    def on(lib, fn):
        """``fn`` with P2's wrapper calling ``lib`` (a variant's)."""
        def run():
            lib.lgbm_p2_walk.restype = shipped_lib().lgbm_p2_walk.restype
            lib.lgbm_p2_walk.argtypes = shipped_lib().lgbm_p2_walk.argtypes
            P2._lib = lambda: lib
            try:
                return fn()
            finally:
                P2._lib = shipped_lib
        return run

    for name, table, bins, replay, chunk, visits in shapes:
        n = bins.shape[1]
        init = torch.randn((1, n), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(3))
        if replay:
            want = pt.binned_replay_(init.clone(), table, bins, 1, chunk)
        else:
            want = pt.binned_update_(init.clone(), table, bins, 0, 2 / 3)
        auto, cfgs = configs(table, bins, replay)

        def run(cfg, s):
            if replay:
                return forced(cfg, lambda: P2.binned_replay_cuda_(
                    s, table, bins, 1, chunk))
            return forced(cfg, lambda: P2.binned_update_cuda_(
                s, table, bins, 0, 2 / 3))

        runs = [(str(cfg or f"auto{auto}"), lambda s, cfg=cfg: run(cfg, s))
                for cfg in cfgs]
        for label, fn in runs:
            got = fn(init.clone())
            again = fn(init.clone())
            torch.cuda.synchronize()
            ok = torch.equal(got, want) and torch.equal(got, again)
            oks.append(ok)
            print(f"[hold {name}] {label}: bitwise the plain version's and "
                  f"two launches equal: {ok}", flush=True)
            res["holds"].append(dict(name=name, config=label, ok=ok))
        pmeta = None
        if parent is not None:
            pmeta = Parent.meta(torch, table, 1, 0,
                                1.0 if replay else 2 / 3)
            got = parent.walk(torch, init.clone(), table, bins, pmeta,
                              replay, chunk)
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            oks.append(ok)
            print(f"[hold {name}] parent P2 == this P2: {ok}", flush=True)
        s = init.clone()
        fns = []
        if parent is not None:
            fns.append(("parent", lambda: parent.walk(
                torch, s, table, bins, pmeta, replay, chunk)))
        fns += [(label, lambda fn=fn: fn(s)) for label, fn in runs]
        for vname, vlib in variant_libs.items():
            fn = on(vlib, lambda: run(None, s))
            if not vname.startswith("stages"):
                got = on(vlib, lambda: run(None, init.clone()))()
                torch.cuda.synchronize()
                oks.append(torch.equal(got, want))
                print(f"[hold {name}] {vname} auto{auto}: bitwise the "
                      f"plain version's: {oks[-1]}", flush=True)
            fns.append((f"{vname} auto{auto}", fn))
        fns.append((f"auto{auto}-again", lambda: run(None, s)))
        if parent is not None:
            fns.append(("parent-again", fns[0][1]))
        bound = (bins.numel() * bins.element_size() + 8 * n) \
            / HBM_BYTES_PER_S * 1e3
        row = {"name": name, "rows": n, "trees": table.num_trees,
               "visits": visits, "bound_ms": bound}
        for label, fn in fns:
            ms = time_ms(torch, fn)
            dev = queued_ms(torch, fn, 50 if table.num_trees < 30 else 10)
            row[label] = (ms, dev)
            print(f"[time {name}] {label}: {ms:.4f} ms a call, {dev:.4f} "
                  f"ms device ({visits / dev * 1e3:.4g} visits/s; byte "
                  f"bound {bound:.5f} ms, {100 * bound / dev:.1f} % of it) "
                  f"[{card}]", flush=True)
        res["times"].append(row)

    # the walk's cost with a warp's lanes on one path: the one tree over
    # the training rows sorted by their leaf in it (neighbouring lanes
    # walk the same path), and over 1M copies of one row
    leaf1 = cp.ensemble_leaves_cuda(p, Xc, T)[-1].long()
    order = torch.argsort(leaf1, stable=True)
    for label, bins in (("sorted by leaf", tr[:, order].contiguous()),
                        ("one row 1M times",
                         tr[:, :1].expand(-1, ROWS).contiguous())):
        s = torch.zeros((1, ROWS), device="cuda")
        for cfg in (None, (256, True, 0)):
            fn = lambda: forced(cfg, lambda: P2.binned_update_cuda_(  # noqa: E731
                s, one, bins, 0, 1.0))
            ms, dev = time_ms(torch, fn), queued_ms(torch, fn, 50)
            print(f"[time one_tree_1M {label}] {cfg or 'auto'}: {ms:.4f} "
                  f"ms a call, {dev:.4f} ms device [{card}]", flush=True)
            res["times"].append({"name": f"one_tree_1M {label}",
                                 str(cfg or "auto"): (ms, dev)})
    del leaf1, order

    # where p2_config picks tree slots (a list of trees over few rows):
    # its configuration against the kernel of one row a thread (256 rows,
    # records staged or through L1) at the same shapes
    res["slots"] = []
    for n, k in few_vis:
        sub = va[:, :n].contiguous()
        table = pt.binned_table(trees[:k])
        for replay in (False, True):
            init = torch.randn((1, n), device="cuda",
                               generator=torch.Generator("cuda").manual_seed(5))
            chunk = gb._iter_chunk(n)

            def run(cfg, s, table=table, sub=sub, replay=replay,
                    chunk=chunk):
                if replay:
                    return forced(cfg, lambda: P2.binned_replay_cuda_(
                        s, table, sub, 1, chunk))
                return forced(cfg, lambda: P2.binned_update_cuda_(
                    s, table, sub, 0, 2 / 3))

            want = (pt.binned_replay_(init.clone(), table, sub, 1, chunk)
                    if replay else
                    pt.binned_update_(init.clone(), table, sub, 0, 2 / 3))
            auto = P2.p2_config(n, sub.shape[0], 1, k, 1, sms,
                                table.max_steps, replay)
            row = {"rows": n, "trees": k, "replay": replay,
                   "auto": auto, "visits": few_vis[(n, k)]}
            for cfg in (None, (256, True, 0), (256, True, 768)):
                got = run(cfg, init.clone())
                torch.cuda.synchronize()
                oks.append(torch.equal(got, want))
                label = str(cfg or f"auto{auto}")
                print(f"[hold slots {n}x{k}{' replay' if replay else ''}] "
                      f"{label}: bitwise the plain version's: {oks[-1]}",
                      flush=True)
                s = init.clone()
                fn = lambda cfg=cfg, s=s: run(cfg, s)  # noqa: E731
                ms, dev = time_ms(torch, fn), queued_ms(torch, fn, 20)
                row[label] = (ms, dev)
                print(f"[time slots] {n} rows x {k} trees "
                      f"{'replay' if replay else 'update'}: {label}: "
                      f"{ms:.4f} ms a call, {dev:.4f} ms device "
                      f"({few_vis[(n, k)] / dev * 1e3:.4g} visits/s) "
                      f"[{card}]", flush=True)
            res["slots"].append(row)

    # P1 over the same trees and the raw training rows
    chunk = gb._iter_chunk(ROWS)
    fn = lambda: cp.ensemble_sum_cuda(p, Xc, T, chunk)  # noqa: E731
    ms, dev = time_ms(torch, fn, reps=10, warm=2), queued_ms(torch, fn, 5)
    print(f"[time P1] {T} trees over {ROWS} raw rows: {ms:.4f} ms a call, "
          f"{dev:.4f} ms device ({vis[('train', T)] / dev * 1e3:.4g} "
          f"visits/s) [{card}]", flush=True)
    res["p1"] = (ms, dev)

    # the table build of one new tree: ms a call and its device events a
    # call (three calls in one trace), this checkout's and the parent's
    from torch.profiler import ProfilerActivity, profile

    builds = [("this", pt.binned_table)]
    parent_tree = parent_csrc and os.path.join(
        os.path.dirname(parent_csrc), "models", "tree.py")
    if parent_tree and os.path.exists(parent_tree):
        import importlib.util

        spec = importlib.util.spec_from_file_location("parent_tree",
                                                      parent_tree)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["parent_tree"] = mod  # its dataclasses look it up
        spec.loader.exec_module(mod)
        builds.append(("parent", mod.binned_table))
    res["table"] = {}
    for label, build in builds:
        ms = time_ms(torch, lambda: build(trees[-1:]))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                build(trees[-1:])
            torch.cuda.synchronize()
        kinds = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = e.name[:60]
                kinds[key] = kinds.get(key, 0) + 1
        events = sum(kinds.values()) / 3
        print(f"[time table] {label} binned_table([tree]): {ms:.4f} ms a "
              f"call; {events:.1f} device events a call: "
              f"{json.dumps(kinds)} [{card}]", flush=True)
        res["table"][label] = dict(ms=ms, events=events, kinds=kinds)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "p2_variants.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    if not all(oks):
        print("FAILED: a hold differs", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
