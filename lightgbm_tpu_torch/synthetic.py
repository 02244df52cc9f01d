"""Seeded synthetic data for the port's smoke run and profiler (numpy only).

* ``bench_data``: bench.py's HIGGS-like binary workload (28 correlated
  features, nonlinear boundary; valid rows from the same boundary).
* ``regression_labels`` / ``multiclass_labels``: a regression target and
  five quantile classes over the same rows.
* ``rank_data``: tools/bench_lambdarank.py's MSLR-WEB10K-shaped ranking
  data (136 features, lognormal query sizes clipped to 8-1250, graded
  labels 0-4 by within-query quantile of a latent score).
* ``workload``: the params and data of chip_smoke.py's main path for one
  objective, with its rounds in ``ROUNDS``.

chip_smoke.py, lightgbm_tpu_torch/profile_slice.py and
tools/jax_growth_auc.py (which trains the JAX package) all build their
config and data with ``workload``, so that chip_smoke.py can hold the
port's metrics against the JAX package's numbers.
"""

from __future__ import annotations

import numpy as np

N_FEAT = 28  # bench.py's width
RANK_FEAT = 136  # MSLR-WEB10K's
ROWS = 1_000_000  # bench.py's training rows (a fifth as many valid rows)
RANK_QUERIES = 10_000
# rounds of each objective's main path (multiclass: 4 x 5 classes = 20
# trees)
ROUNDS = {"binary": 10, "regression": 10, "multiclass": 4, "lambdarank": 10}
# rounds of the DART main path (binary, DART's default drop parameters)
DART_ROUNDS = 30


def bench_data(n: int, seed: int = 7, n_valid: int = 0):
    """bench.py make_data: (X, y) or, with ``n_valid``, (X, y, Xv, yv)."""
    rng = np.random.RandomState(seed)

    def draw(m):
        return rng.randn(m, N_FEAT).astype(np.float32)

    def label(X, w1, w2):
        z = X @ w1 + 0.5 * (X**2 - 1.0) @ w2 + 0.8 * X[:, 0] * X[:, 1]
        z = (z - z.mean()) / z.std()
        return (z + 0.5 * rng.randn(len(X)) > 0).astype(np.float32)

    X = draw(n)
    w1, w2 = rng.randn(N_FEAT), rng.randn(N_FEAT)
    y = label(X, w1, w2)
    if not n_valid:
        return X, y
    Xv = draw(n_valid)
    return X, y, Xv, label(Xv, w1, w2)


def regression_labels(X: np.ndarray, Xv: np.ndarray, seed: int = 11):
    """``X @ w1 + 0.5 X[:, 0] X[:, 1] + 0.5 noise`` for the train and the
    valid rows, w1 and the noise from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    w1 = rng.randn(X.shape[1])

    def label(Z):
        return (Z @ w1 + 0.5 * Z[:, 0] * Z[:, 1]
                + 0.5 * rng.randn(len(Z))).astype(np.float32)

    return label(X), label(Xv)


def multiclass_labels(X: np.ndarray, Xv: np.ndarray, num_class: int = 5,
                      seed: int = 11):
    """Classes 0..num_class-1 cut at the train rows' equal quantiles of
    ``X @ w`` (20/40/60/80 % for five), w from ``RandomState(seed)``."""
    w = np.random.RandomState(seed).randn(X.shape[1])
    cuts = np.quantile(X @ w, np.arange(1, num_class) / num_class)
    return tuple(np.digitize(Z @ w, cuts).astype(np.float32) for Z in (X, Xv))


def _rank_sizes(rng, nq: int) -> np.ndarray:
    return np.clip(np.rint(np.exp(rng.normal(np.log(100), 0.8, nq))), 8,
                   1250).astype(np.int64)


def rank_rows(nq: int = RANK_QUERIES, seed: int = 29) -> int:
    """The row count of ``rank_data(nq, seed)``, without its features."""
    return int(_rank_sizes(np.random.RandomState(seed), nq).sum())


def rank_data(nq: int, seed: int = 29):
    """tools/bench_lambdarank.py make_data: (X, y, query sizes)."""
    rng = np.random.RandomState(seed)
    sizes = _rank_sizes(rng, nq)
    n = int(sizes.sum())
    X = rng.randn(n, RANK_FEAT).astype(np.float32)
    w = rng.randn(RANK_FEAT).astype(np.float32) * (rng.rand(RANK_FEAT) < 0.2)
    score = X @ w + 0.5 * rng.randn(n).astype(np.float32)
    y = np.zeros(n, np.int32)
    start = 0
    for s in sizes:
        q = score[start:start + s]
        ranks = np.searchsorted(np.sort(q), q, side="left") / max(s - 1, 1)
        y[start:start + s] = np.clip((ranks * 5).astype(int), 0, 4)
        start += s
    return X, y.astype(np.float32), sizes


def workload(objective: str, rows: int = ROWS, n_valid: int = 0,
             growth: str = "leafwise", pool_mb: float = 0.0,
             boosting: str = "gbdt", hist_dtype: str = "float32"):
    """chip_smoke.py's main path for ``objective``: (params, (X, y, query
    sizes or None), (X_valid, y_valid) or None).

    bench.py's config (255 leaves, 255 bins, learning rate 0.1,
    min_data_in_leaf 100) on ``bench_data(rows)`` for binary, regression
    (``regression_labels``, metric l2) and five-class multiclass
    (``multiclass_labels``, multi_logloss and multi_error), ``n_valid``
    valid rows from the same generator; LambdaRank on
    ``rank_data(RANK_QUERIES)`` with tools/bench_lambdarank.py's 31
    leaves and min_data_in_leaf 50 (no valid rows).  ``growth``,
    ``pool_mb``, ``boosting`` and ``hist_dtype`` set tree_growth,
    histogram_pool_size, boosting_type (DART with its default drop_rate
    0.1, skip_drop 0.5, max_drop 50 and drop_seed 4) and hist_dtype."""
    params = {"objective": objective, "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 100,
              "tree_growth": growth, "histogram_pool_size": pool_mb,
              "boosting_type": boosting, "hist_dtype": hist_dtype,
              "verbose": -1}
    if objective == "lambdarank":
        params.update(num_leaves=31, min_data_in_leaf=50,
                      ndcg_eval_at=[1, 3, 5])
        return params, rank_data(RANK_QUERIES), None
    data = bench_data(rows, n_valid=n_valid)
    X, y = data[:2]
    Xv, yv = data[2:] if n_valid else (X[:0], None)
    if objective == "regression":
        y, yv = regression_labels(X, Xv)
        params["metric"] = ["l2"]
    elif objective == "multiclass":
        y, yv = multiclass_labels(X, Xv)
        params.update(num_class=5, metric=["multi_logloss", "multi_error"])
    return params, (X, y, None), (Xv, yv) if n_valid else None
