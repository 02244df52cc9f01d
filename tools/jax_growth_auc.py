#!/usr/bin/env python3
"""The JAX package's metrics on chip_smoke.py's main-path data.

    JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth depthwise
    JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth leafwise \
        --histogram-pool-size 4
    JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth leafwise \
        --objective regression
    JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth leafwise \
        --objective multiclass [--rows 300000]
    JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth leafwise \
        --objective lambdarank
    JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth leafwise \
        --boosting dart
    JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth leafwise \
        --hist-dtype float64

Trains ``lightgbm_tpu`` on the data and config ``chip_smoke.py`` trains
the port on (both from ``lightgbm_tpu_torch.synthetic.workload``, with its
``ROUNDS``), and prints one JSON line with the metrics chip_smoke.py holds
the port's within a band of:

* ``binary`` (default): bench.py's workload (1M x 28 HIGGS-like rows from
  seed 7 plus 200k valid rows, 255 bins, 255 leaves, learning_rate 0.1,
  min_data_in_leaf 100) for 10 rounds with the given
  ``tree_growth`` (and ``histogram_pool_size`` in MB, 0 = no pool: 4 MB
  keeps 48 of the 255 leaves' histograms at this shape): train and valid
  AUC;
* ``regression``: the same rows and config, the target of
  ``synthetic.regression_labels``: train and valid RMSE (metric l2);
* ``multiclass``: the same rows and config, the five classes of
  ``synthetic.multiclass_labels``, 4 rounds (20 trees): train and valid
  multi_logloss and multi_error (``--rows`` trains on fewer rows of the
  same generator, with a fifth as many valid rows);
* ``lambdarank``: ``synthetic.rank_data(10000)`` (~1.38M rows x 136
  features in 10,000 queries), tools/bench_lambdarank.py's config (31
  leaves, 255 bins, learning_rate 0.1, min_data_in_leaf 50): train
  NDCG@1/3/5.

``--boosting dart`` trains DART (its default drop_rate, skip_drop,
max_drop and drop_seed) for ``synthetic.DART_ROUNDS`` rounds instead.
``--hist-dtype float64`` accumulates histograms and split statistics in
float64 (``hist_dtype=float64``: the JAX package's segment-sum route
under x64, no Pallas kernel).  Its depthwise and hybrid growers raise
under float64 (ROADMAP C9), so only leaf-wise growth takes it.

Multiclass trains with ``forest_batching="off"`` (the JAX package's forest
lanes, bitwise equal to it, fail under JAX 0.9).  It runs the JAX package
on whatever backend JAX picks (the CPU under ``JAX_PLATFORMS=cpu``); the
metrics, not the time, are its output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--objective", default="binary",
                    choices=("binary", "regression", "multiclass",
                             "lambdarank"))
    ap.add_argument("--growth", default="depthwise",
                    choices=("leafwise", "depthwise", "hybrid"))
    ap.add_argument("--histogram-pool-size", type=float, default=0.0)
    ap.add_argument("--boosting", default="gbdt", choices=("gbdt", "dart"))
    ap.add_argument("--hist-dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--rows", type=int, default=None,
                    help="training rows of the bench data (default "
                    "synthetic.ROWS; valid rows a fifth of them)")
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    import lightgbm_tpu as lgb
    import lightgbm_tpu.engine as engine
    from lightgbm_tpu.metrics import AUCMetric
    from lightgbm_tpu.io.metadata import Metadata
    from lightgbm_tpu_torch import synthetic

    t0 = time.perf_counter()
    rows = args.rows or synthetic.ROWS
    params, (X, y, group), valid = synthetic.workload(
        args.objective, rows,
        n_valid=0 if args.objective == "lambdarank" else rows // 5,
        growth=args.growth, pool_mb=args.histogram_pool_size,
        boosting=args.boosting, hist_dtype=args.hist_dtype)
    rounds = (synthetic.DART_ROUNDS if args.boosting == "dart"
              else synthetic.ROUNDS[args.objective])
    out = {"objective": args.objective, "growth": args.growth,
           "boosting": args.boosting, "hist_dtype": args.hist_dtype}
    if args.objective == "multiclass":
        params["forest_batching"] = "off"
    train_set = lgb.Dataset(X, label=y, group=group,
                            max_bin=params["max_bin"])
    if valid is None:
        bst = engine.train(params, train_set, num_boost_round=rounds,
                           verbose_eval=False)
        out.update(queries=len(group),
                   train={name: v for _, name, v, _ in bst.eval_train()})
    else:
        Xv, yv = valid
        bst = engine.train(params, train_set, num_boost_round=rounds,
                           valid_sets=[train_set,
                                       train_set.create_valid(Xv, label=yv)],
                           valid_names=["train", "valid"], verbose_eval=False)
        if args.objective == "binary":
            def auc(Xs, ys):
                m = AUCMetric()
                m.init(Metadata(label=ys), len(ys))
                return float(m.eval(np.asarray(bst.predict(Xs, raw_score=True),
                                               np.float64)))

            out.update(histogram_pool_size=args.histogram_pool_size,
                       pool_slots=bst._gbdt._hist_pool_slots(),
                       train_auc=auc(X, y), valid_auc=auc(Xv, yv))
        else:  # the path GBDT.eval_at takes (eval_jax), as the port's does
            out.update(train=bst._gbdt.eval_at(0), valid=bst._gbdt.eval_at(1))
    out.update(rows=len(y), trees=len(bst._gbdt.models),
               leaves=[int(t.num_leaves) for t in bst._gbdt.models],
               backend=jax.default_backend(),
               seconds=round(time.perf_counter() - t0, 1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
