#!/usr/bin/env python3
"""Kernel P1 (``csrc/predict.cu``) on one card: held bitwise against its
plain version at the main path's shapes, and timed at other block
configurations beside the one ``p1_config`` picks and beside another
checkout's P1.

    python3 tools/p1_variants.py [--parent-csrc DIR] [--trees N]

It trains the bench model (``synthetic.bench_data`` seed 7, 1M rows x 28
features, 255 leaves, ``N`` trees, default 100) on the mega route, then:

* holds P1's sum and leaves modes bitwise against ``ensemble_sum_raw`` /
  ``ensemble_leaves_raw`` on the card: 1M rows in chunks of
  ``GBDT._iter_chunk``; 1, 8, 128 and 1,024 rows in one chunk; 20,000 rows
  at 32 rows a block (8 tree slots) with chunks of 3 iterations, so group
  boundaries fall inside chunks, records through L1 and staged; 256 rows
  a block staged, through L1 and with X from global memory; F = 5,000
  (the model's 28 columns spread over 5,000) at 1,024 rows (tiled) and
  4,096 rows (wide);
* times P1 (CUDA-event median of 20 calls after 3, and the device ms a
  call of back-to-back calls enqueued behind a spin kernel, as
  ``chip_smoke.py`` times them), with the node visits a
  second, in the configuration ``p1_config`` picks and in others: at 1,
  8, 128 and 1,024 rows with 1-16 rows a block (tiled and wide), at 1M
  rows (sums and leaves) with 32-256 rows a block (tiled and wide) and
  256 rows a block staging 512, 768 or 1,024 records (128 rows: 1,024);
* with ``--parent-csrc DIR`` (``DIR`` = ``<checkout>/lightgbm_tpu_torch/
  csrc`` of a checkout whose P1 takes the separate node arrays, as before
  the 16-byte record), builds that ``predict.cu`` beside this one and
  times it on the same packed trees in turns (parent, this, this,
  parent), after holding its sums and leaves equal to this P1's.

Builds go under ``build/p1_variants``; the numbers are also written to
``chiprun_out/p1_variants.json``.  Needs a CUDA card and nvcc.
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
WORK = os.path.join(ROOT, "build", "p1_variants")
ROWS, BUCKETS, WIDE_F = 1_000_000, (1, 8, 128, 1024), 5000
HBM_BYTES_PER_S = 3.35e12


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


class Parent:
    """Another checkout's P1 over the separate node arrays."""

    def __init__(self, so):
        VP, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        self.lib = ctypes.CDLL(so)
        self.lib.lgbm_predict_sum.restype = I
        self.lib.lgbm_predict_sum.argtypes = [
            VP, VP, VP, VP, VP, VP, VP, I, VP, I64, I, I, I, I, VP, VP]
        self.lib.lgbm_predict_leaves.restype = I
        self.lib.lgbm_predict_leaves.argtypes = [
            VP, VP, VP, VP, VP, VP, VP, I, VP, I64, I, I, VP, VP]

    @staticmethod
    def _arrays(p):
        return (p.split_feature.data_ptr(), p.threshold.data_ptr(),
                p.decision_type.data_ptr(), p.left_child.data_ptr(),
                p.right_child.data_ptr())

    def sums(self, torch, p, X, n_trees, chunk):
        n, F = X.shape
        out = torch.empty((p.num_class, n), dtype=torch.float32,
                          device=X.device)
        code = self.lib.lgbm_predict_sum(
            *self._arrays(p), p.leaf_value.data_ptr(), p.root.data_ptr(),
            p.depth, X.data_ptr(), n, F, p.num_class, n_trees // p.num_class,
            chunk, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return out

    def leaves(self, torch, p, X, n_trees):
        n, F = X.shape
        out = torch.empty((n_trees, n), dtype=torch.int32, device=X.device)
        code = self.lib.lgbm_predict_leaves(
            *self._arrays(p), p.root.data_ptr(), p.leaf_offset.data_ptr(),
            p.depth, X.data_ptr(), n, F, n_trees, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return out


def _build(parent_csrc):
    """This checkout's kernels and, given, the parent's predict.cu, all
    nvcc runs started together."""
    from lightgbm_tpu_torch.ops import _build as b

    proc = None
    if parent_csrc:
        os.makedirs(WORK, exist_ok=True)
        so = os.path.join(WORK, "libpredict_parent.so")
        proc = subprocess.Popen(
            [b._nvcc(), *b.NVCC_FLAGS, "-o", so,
             os.path.join(parent_csrc, "predict.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    b.build_all(force=True)
    for line in b.ptxas_report("predict").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"[ptxas predict] {line.strip()}")
    if proc is None:
        return None, time.perf_counter() - t0
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"parent build failed:\n{out}")
    return Parent(so), time.perf_counter() - t0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("p1_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.models.tree import (ensemble_leaves_raw,
                                                ensemble_sum_raw, pack_trees)
    from lightgbm_tpu_torch.ops import cuda_predict as cp
    from chip_smoke import _visits, queued_ms, time_ms
    from lightgbm_tpu_torch.synthetic import bench_data

    parent_csrc = None
    if "--parent-csrc" in argv:
        parent_csrc = os.path.abspath(argv[argv.index("--parent-csrc") + 1])
    trees = int(argv[argv.index("--trees") + 1]) if "--trees" in argv \
        else 100
    card = _smi()
    print(f"[device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    parent, build_s = _build(parent_csrc)
    print(f"[build] {build_s:.1f}s", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    X, y = bench_data(ROWS, seed=7)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 100, "verbose": -1}
    t0 = time.perf_counter()
    bst = lt.train(params, lt.Dataset(X, label=y, params=params), trees)
    torch.cuda.synchronize()
    print(f"[train] {trees} trees {time.perf_counter() - t0:.1f}s",
          flush=True)
    gb = bst._gbdt
    p = gb._packed()
    T = p.num_trees
    Xc = torch.from_numpy(np.ascontiguousarray(X)).cuda()
    # the model's 28 columns spread over 5,000 (the rest noise)
    rng = np.random.RandomState(5)
    perm = rng.choice(WIDE_F, X.shape[1], replace=False)
    wide_trees = [t.replace(split_feature_real=torch.where(
        t.split_feature_real >= 0,
        torch.as_tensor(perm, device=t.split_feature_real.device)[
            t.split_feature_real.clamp(min=0).long()].to(torch.int32),
        t.split_feature_real)) for t in gb.models]
    pw = pack_trees(wide_trees, 1, "cuda")
    Xw = rng.randn(4096, WIDE_F).astype(np.float32)
    Xw[:, perm] = X[:4096]
    Xwc = torch.from_numpy(Xw).cuda()

    res = {"card": card, "trees": T, "sms": sms, "holds": [], "times": []}
    mtn = p.max_tree_nodes

    def hold(name, pk, Xt, chunk, config=None):
        s_k = cp.ensemble_sum_cuda(pk, Xt, T, chunk, config)
        l_k = cp.ensemble_leaves_cuda(pk, Xt, T, config)
        s_p = ensemble_sum_raw(pk, Xt, T, chunk)
        l_p = ensemble_leaves_raw(pk, Xt, T)
        torch.cuda.synchronize()
        ok = torch.equal(s_k, s_p) and torch.equal(l_k, l_p)
        n, F = Xt.shape
        cfg = config or cp.p1_config(n, F, T, pk.num_class, sms, mtn)
        print(f"[hold {name}] {n} rows x {F} features, config {cfg}, "
              f"chunks of {chunk}: sums and leaves bitwise the plain "
              f"version's: {ok} (max |diff| "
              f"{float((s_k - s_p).abs().max()):.3g})", flush=True)
        res["holds"].append(dict(name=name, ok=ok, config=list(cfg)))
        return ok

    X20 = Xc[:20_000].contiguous()
    oks = [hold("1M", p, Xc, gb._iter_chunk(ROWS))]
    oks += [hold(f"rows_{n}", p, Xc[:n].contiguous(), T) for n in BUCKETS]
    oks += [hold("group_in_chunk", p, X20, 3, (32, True, 0)),
            hold("staged_group_in_chunk", p, X20, 3, (32, True, 512)),
            hold("staged_256", p, X20, 3, (256, True, 1024)),
            hold("unstaged_256", p, X20, 16, (256, True, 0)),
            hold("wide_256", p, X20, 16, (256, False, 0)),
            hold("F5000_1024", pw, Xwc[:1024].contiguous(), T),
            hold("F5000_4096", pw, Xwc, T)]
    if parent is not None:
        same = (torch.equal(parent.sums(torch, p, Xc, T, 16),
                            cp.ensemble_sum_cuda(p, Xc, T, 16))
                and torch.equal(parent.leaves(torch, p, Xc[:100_000], T),
                                cp.ensemble_leaves_cuda(p, Xc[:100_000], T)))
        print(f"[hold parent] parent P1 == this P1 (1M sums, 100k "
              f"leaves): {same}", flush=True)
        oks.append(same)

    leaves1m = cp.ensemble_leaves_cuda(p, Xc, T)
    visits_1m = _visits(torch, gb.models, leaves1m)
    del leaves1m
    node_bytes = p.node.numel() * 4 + p.leaf_value.numel() * 4 + T * 4

    def timed(label, n, visits, fns):
        row = {"label": label, "rows": n, "visits": visits}
        for name, fn in fns:
            ms = time_ms(torch, fn)
            dev = queued_ms(torch, fn, 50 if n < ROWS else 5)
            row[name] = (ms, dev)
            print(f"[time {label}] {name}: {ms:.4f} ms a call, "
                  f"{dev:.4f} ms a call queued "
                  f"({visits / dev * 1e3:.4g} visits/s) [{card}]",
                  flush=True)
        res["times"].append(row)

    def variants(n):
        """(rows, tiled, stage) configurations timed beside p1_config's."""
        if n < ROWS:
            return [(r, t, 0) for r in (1, 2, 4, 8, 16) for t in (True,
                                                                   False)]
        return ([(r, t, 0) for r in (32, 64, 128, 256) for t in (True,
                                                                 False)]
                + [(256, True, s) for s in (512, 768, 1024)]
                + [(128, True, 1024)])

    def sweep(label, n, Xn, vis, run, parent_run, leaves):
        auto = cp.p1_config(n, Xn.shape[1], T, 1, sms, mtn, leaves)
        fns = [("parent", parent_run)] if parent is not None else []
        fns.append((f"auto{auto}", lambda: run(None)))
        for cfg in variants(n):
            if cfg != auto and cp.smem_bytes(
                    cfg[0], Xn.shape[1], 1, cfg[1], leaves,
                    cfg[2]) <= cp.SMEM_BYTES:
                fns.append((str(cfg), lambda cfg=cfg: run(cfg)))
        fns.append((f"auto{auto}-again", lambda: run(None)))
        if parent is not None:
            fns.append(("parent-again", parent_run))
        timed(label, n, vis, fns)

    chunk = gb._iter_chunk(ROWS)
    for n in (ROWS,) + BUCKETS:
        Xn = Xc[:n].contiguous()
        ch = chunk if n == ROWS else T
        vis = visits_1m if n == ROWS else _visits(
            torch, gb.models, cp.ensemble_leaves_cuda(p, Xn, T))
        sweep(f"sum_{n}", n, Xn, vis,
              lambda cfg, Xn=Xn, ch=ch: cp.ensemble_sum_cuda(
                  p, Xn, T, ch, cfg),
              lambda Xn=Xn, ch=ch: parent.sums(torch, p, Xn, T, ch), False)
    sweep("leaves_1M", ROWS, Xc, visits_1m,
          lambda cfg: cp.ensemble_leaves_cuda(p, Xc, T, cfg),
          lambda: parent.leaves(torch, p, Xc, T), True)
    bound = (X.nbytes + ROWS * 4 + node_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"[bound] 1M sums: {bound:.5f} ms (bytes), {visits_1m:.4g} node "
          f"visits, mean depth {visits_1m / ROWS / T:.2f} [{card}]")
    res["bound_ms_1M"] = bound
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "p1_variants.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    if not all(oks):
        print("FAILED: a hold differs", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
