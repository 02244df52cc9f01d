"""Ensemble prediction on raw features: kernel P1 on a CUDA tensor, its
plain version (``models/tree.py``) on a CPU tensor.

Counterpart of the JAX package's device prediction
(lightgbm_tpu/models/tree.py ``ensemble_sum_raw`` / ``ensemble_leaves_raw``
and ops/predict_matmul.py).  The path-incidence tables of
``predict_matmul`` are a TPU layout and are not ported: on the card P1
walks the packed node table (csrc/predict.cu), and the port reads neither
``LGBM_TPU_PREDICT_MATMUL`` nor ``LGBM_TPU_PREDICT_ROW_CHUNK``.  A failed
build or launch raises; a CUDA tensor never falls back to the plain
version.
"""

from __future__ import annotations

import torch

from ..models.tree import PackedTrees, ensemble_leaves_raw, ensemble_sum_raw
from .cuda_predict import ensemble_leaves_cuda, ensemble_sum_cuda


def ensemble_sum(p: PackedTrees, X: torch.Tensor, n_trees: int,
                 chunk_iters: int) -> torch.Tensor:
    """``[K, n]`` f32 raw scores of the first ``n_trees`` trees on ``X``
    ``[n, F]`` f32, in chunks of ``chunk_iters`` iterations."""
    if X.device.type == "cuda":
        return ensemble_sum_cuda(p, X, n_trees, chunk_iters)
    return ensemble_sum_raw(p, X, n_trees, chunk_iters)


def ensemble_leaves(p: PackedTrees, X: torch.Tensor,
                    n_trees: int) -> torch.Tensor:
    """``[n_trees, n]`` int32 leaf index of every row in each tree."""
    if X.device.type == "cuda":
        return ensemble_leaves_cuda(p, X, n_trees)
    return ensemble_leaves_raw(p, X, n_trees)
