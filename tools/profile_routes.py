#!/usr/bin/env python3
"""Profiles of the port's routes on one card, a parent checkout beside this
one, in turns.

    python3 tools/profile_routes.py [--parent DIR] [--routes R,R,...]
        [--trees T] [--out PATH]

For each route (order, pooled, record, hybrid, mega, depthwise) it runs
``python -m lightgbm_tpu_torch.profile_slice --trees T`` with the route's
knobs (``LGBM_TPU_OPT_HISTS=0``; ``--histogram-pool-size 4``;
``LGBM_TPU_FUSE_HIST=0``; ``--growth hybrid``; the default; ``--growth
depthwise``), one process per run, from this checkout and, with
``--parent``, from DIR (another checkout, e.g. a ``git archive`` of the
parent commit unpacked under ``build/``) in the order parent, this, this,
parent.  Each run builds its checkout's kernels into its own ``build/`` at
first use.  Prints one summary line a run (s/tree with and without the
profiler, device busy ms and idle share, the single-leaf histograms'
device ms a tree: K1 and K1' passes 1 and 2 by kernel name, launches,
host syncs, K8's device ms a tree (the mega route's split step), the
split searches' (K3, K4 and K5: kernels named ``search2*``), the record
partition's (K6 ``compact_kernel``, K7 ``place_kernel``), the device
events a tree, K1/K1' row-count and K8/K6/K7 window-size quartiles and
the partition's columns and byte bound a tree where the checkout reports
them)
and writes every run's full JSON to ``--out`` (default
``build/profile_routes.json``).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = {
    "order": ({"LGBM_TPU_OPT_HISTS": "0"}, []),
    "pooled": ({}, ["--histogram-pool-size", "4"]),
    "record": ({"LGBM_TPU_FUSE_HIST": "0"}, []),
    "hybrid": ({}, ["--growth", "hybrid"]),
    "mega": ({}, []),
    "depthwise": ({}, ["--growth", "depthwise"]),
}


def hist_pass(name: str):
    """Which single-leaf histogram pass a kernel name (its first 80
    characters) is: this checkout's sorted_partial_kernel over MatrixRows
    (K1) or WindowRows (K1'), the parent's hist_partial_kernel over
    MatrixRows or RecordRows, and hist_reduce_kernel (pass 2 of both);
    None for any other kernel."""
    if "hist_reduce_kernel" in name:
        return "K1/K1' pass 2"
    if "hist_partial_kernel" in name:
        return "K1' pass 1" if "RecordRows" in name else "K1 pass 1"
    if "sorted_partial_kernel" in name:
        if "MatrixRow" in name:
            return "K1 pass 1"
        if "WindowRow" in name:
            return "K1' pass 1"
    return None


def run(tree: str, route: str, trees: int) -> dict:
    env_add, args = ROUTES[route]
    env = dict(os.environ)
    env.update(LGBM_TPU_OPT_HISTS="1", LGBM_TPU_FUSE_HIST="1",
               LGBM_TPU_HIST_KERNEL="v1")
    env.update(env_add)
    out = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch.profile_slice",
         "--trees", str(trees), *args], cwd=tree, env=env,
        capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"profile_slice failed in {tree} ({route}):\n"
                         f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return json.loads(out.stdout[out.stdout.index("{"):])


def summary(tag: str, route: str, r: dict) -> str:
    kms = r["kernel_ms_per_tree"]
    hist = dict.fromkeys(("K1 pass 1", "K1' pass 1", "K1/K1' pass 2"), 0.0)
    for name, v in kms.items():
        if hist_pass(name):
            hist[hist_pass(name)] += v
    k8 = sum(v for name, v in kms.items() if "split_step_kernel" in name)
    search = sum(v for name, v in kms.items() if "search2" in name)
    k6 = sum(v for name, v in kms.items() if "compact_kernel" in name)
    k7 = sum(v for name, v in kms.items() if "place_kernel" in name)
    events = r.get("device_events_per_tree",
                   r["device_events"] / r["trees"])
    launches = {k: v for k, v in r["launches_per_tree"].items() if v}
    line = (f"[{route} {tag}] s/tree {r['wall_s_per_tree_unprofiled']:.4f} "
            f"(profiled {r['wall_s_per_tree_profiled']:.4f}) busy ms/tree "
            f"{r['device_busy_s_per_tree'] * 1e3:.2f} idle "
            f"{r['idle_share']:.3f} | "
            + " ".join(f"{k} {v:.3f}" for k, v in hist.items())
            + f" K8 {k8:.3f} K3/K4/K5 {search:.3f} K6 {k6:.3f} K7 {k7:.3f}"
            f" ms/tree | device events/tree {events:.1f} | launches/tree "
            f"{json.dumps(launches)}"
            f" host syncs/tree {r['host_syncs_per_tree']:.1f} leaves "
            f"{r['leaves']}")
    if "rows_per_launch" in r:
        line += f" | rows per launch {json.dumps(r['rows_per_launch'])}"
    if "partition" in r:
        line += f" | partition {json.dumps(r['partition'])}"
    top = sorted(kms.items(), key=lambda kv: -kv[1])[:6]
    line += " | top " + "; ".join(f"{k[:60]} {v:.2f}" for k, v in top)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--routes", default="order,pooled,record,hybrid,mega")
    ap.add_argument("--trees", type=int, default=3)
    ap.add_argument("--out",
                    default=os.path.join(ROOT, "build", "profile_routes.json"))
    a = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"[device] {smi.stdout.strip()}", flush=True)
    order = [("this", ROOT)]
    if a.parent:
        parent = ("parent", os.path.abspath(a.parent))
        order = [parent, ("this", ROOT), ("this", ROOT), parent]
    results = []
    for route in a.routes.split(","):
        for tag, tree in order:
            r = run(tree, route, a.trees)
            results.append({"route": route, "tree": tag, **r})
            print(summary(tag, route, r), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
