#!/usr/bin/env python3
"""The JAX package's train and valid AUC on chip_smoke.py's bench data.

    JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth depthwise
    JAX_PLATFORMS=cpu python tools/jax_growth_auc.py --growth leafwise \
        --histogram-pool-size 4

Trains ``lightgbm_tpu`` on the data and config ``chip_smoke.py`` trains
the port on (bench.py's: 1M x 28 HIGGS-like rows from seed 7 plus 200k
valid rows, binary, 255 bins, 255 leaves, learning_rate 0.1,
min_data_in_leaf 100) for ``--trees`` rounds with the given
``tree_growth`` (and ``histogram_pool_size`` in MB, 0 = no pool: 4 MB
keeps 48 of the 255 leaves' histograms at this shape), and prints one JSON
line with both AUCs.  chip_smoke.py holds the port's AUC for the same
growth within +-0.005 of these numbers.
It runs the JAX package on whatever backend JAX picks (the CPU under
``JAX_PLATFORMS=cpu``); the AUC, not the time, is its output.
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
    ap.add_argument("--growth", default="depthwise",
                    choices=("leafwise", "depthwise", "hybrid"))
    ap.add_argument("--trees", type=int, default=10)
    ap.add_argument("--histogram-pool-size", type=float, default=0.0)
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    import chip_smoke
    import lightgbm_tpu as lgb
    import lightgbm_tpu.engine as engine
    from lightgbm_tpu.metrics import AUCMetric
    from lightgbm_tpu.io.metadata import Metadata

    t0 = time.perf_counter()
    X, y, Xv, yv = chip_smoke.make_data(chip_smoke.ROWS, seed=7,
                                        n_valid=chip_smoke.VALID_ROWS)
    params = {"objective": "binary", "num_leaves": chip_smoke.NUM_LEAVES,
              "max_bin": chip_smoke.NUM_BINS,
              "learning_rate": chip_smoke.LEARNING_RATE,
              "min_data_in_leaf": chip_smoke.MIN_DATA,
              "tree_growth": args.growth,
              "histogram_pool_size": args.histogram_pool_size, "verbose": -1}
    bst = engine.train(params, lgb.Dataset(X, label=y,
                                           max_bin=chip_smoke.NUM_BINS),
                       num_boost_round=args.trees, verbose_eval=False)

    def auc(Xs, ys):
        m = AUCMetric()
        m.init(Metadata(label=ys), len(ys))
        return float(m.eval(np.asarray(bst.predict(Xs, raw_score=True),
                                       np.float64)))

    print(json.dumps({
        "growth": args.growth, "trees": args.trees,
        "histogram_pool_size": args.histogram_pool_size,
        "pool_slots": bst._gbdt._hist_pool_slots(),
        "train_auc": auc(X, y), "valid_auc": auc(Xv, yv),
        "leaves": [int(t.num_leaves) for t in bst._gbdt.models],
        "backend": jax.default_backend(),
        "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
