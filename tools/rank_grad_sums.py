#!/usr/bin/env python3
"""What the LambdaRank gradients' fixed add order costs on the card.

    python tools/rank_grad_sums.py [--queries N] [--reps R]

The port's ``LambdarankNDCG`` adds each row's Q pair terms in the order
of XLA's CPU tree reduction (``ops.histogram.xla_sum``: about 62
elementwise launches a chunk, plus a copy for each of its two sums), so
that the card and the CPU give the same bits.  This script builds the
objective on chip_smoke.py's LambdaRank data (``synthetic.rank_data``,
10,000 MSLR-WEB10K-shaped queries by default) with scores drawn from
seed 0, and times one ``get_gradients`` call two ways, in turns within
one process: as shipped, and with ``xla_sum`` replaced by ``torch.sum``
(one reduction kernel each, another add order).  For each it prints the
call's ms (CUDA events), its device ms a call and the count of kernel
names it launches (the profiler, ``profile_slice.device_ms_by_kernel``),
and its peak device
memory; then the share of the gradients' device time the fixed order
costs, and how far ``torch.sum``'s gradients are from the shipped ones
(largest absolute difference, whether within rtol 1e-5 / atol 1e-7).
One JSON object on stdout, with the card's name and power limit.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("rank_grad_sums: needs a CUDA card", file=sys.stderr)
        return 2
    from lightgbm_tpu_torch import objectives_rank, synthetic
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.metadata import Metadata
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.profile_slice import device_ms_by_kernel

    params = synthetic.workload("lambdarank")[0]
    _, y, sizes = synthetic.rank_data(args.queries)
    n = len(y)
    meta = Metadata(label=y, query_boundaries=np.concatenate(
        [[0], np.cumsum(sizes)]))
    obj = create_objective(Config.from_dict(params), meta, n, "cuda")
    scores = torch.from_numpy(
        np.random.RandomState(0).randn(n).astype(np.float32)).cuda()
    shipped = objectives_rank.xla_sum

    def run(sum_fn):
        objectives_rank.xla_sum = sum_fn
        try:
            grads = lambda: obj.get_gradients(scores)  # noqa: E731
            ms = _time_ms(torch, grads, args.reps)
            by_kernel = device_ms_by_kernel(torch, grads, reps=args.reps,
                                            warm=1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            g, h = grads()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        finally:
            objectives_rank.xla_sum = shipped
        return dict(ms=ms, device_ms=sum(by_kernel.values()),
                    kernels=len(by_kernel), peak_bytes=peak), (g, h)

    out = {}
    grads = {}
    for name, fn in [("xla_sum", shipped),
                     ("torch_sum", lambda x, d: x.sum(d)),
                     ("torch_sum", lambda x, d: x.sum(d)),
                     ("xla_sum", shipped)]:
        rec, gh = run(fn)
        out.setdefault(name, []).append(rec)
        grads.setdefault(name, gh)
    for name, recs in out.items():
        out[name] = {k: [r[k] for r in recs] for k in recs[0]}
    xla_dev = min(out["xla_sum"]["device_ms"])
    sum_dev = min(out["torch_sum"]["device_ms"])
    (g0, h0), (g1, h1) = grads["xla_sum"], grads["torch_sum"]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    out.update(
        card=card[0] if card else "not read", rows=n, queries=args.queries,
        buckets=[int(b["pad_idx"].shape[1]) for b in obj._buckets],
        fixed_order_share_of_device_ms=(xla_dev - sum_dev) / xla_dev,
        torch_sum_max_abs_diff=[float((g1 - g0).abs().max()),
                                float((h1 - h0).abs().max())],
        max_abs=[float(g0.abs().max()), float(h0.abs().max())],
        torch_sum_within_rtol_1e5=bool(
            torch.allclose(g1, g0, rtol=1e-5, atol=1e-7)
            and torch.allclose(h1, h0, rtol=1e-5, atol=1e-7)),
        torch_sum_values_differ=int((g1 != g0).sum() + (h1 != h0).sum()))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
