"""Ensemble walks: on raw features (prediction) kernel P1, on binned rows
(training's score updates) kernel P2, each on a CUDA tensor, and their
plain versions (``models/tree.py``) on a CPU tensor.

Counterpart of the JAX package's device prediction
(lightgbm_tpu/models/tree.py ``ensemble_sum_raw`` / ``ensemble_leaves_raw``
and ops/predict_matmul.py).  The path-incidence tables of
``predict_matmul`` are a TPU layout and are not ported: on the card P1
walks the packed node table (csrc/predict.cu), and the port reads neither
``LGBM_TPU_PREDICT_MATMUL`` nor ``LGBM_TPU_PREDICT_ROW_CHUNK``.  A failed
build or launch raises; a CUDA tensor never falls back to the plain
version.  The binned walks replace the JAX package's jnp
``predict_binned`` / ``ensemble_sum_binned`` (models/tree.py:114, :211).
"""

from __future__ import annotations

import torch

from ..models.tree import (BinnedTrees, PackedTrees, binned_replay_,
                           binned_update_, ensemble_leaves_raw,
                           ensemble_sum_raw)
from .cuda_predict import ensemble_leaves_cuda, ensemble_sum_cuda
from .cuda_predict_binned import binned_replay_cuda_, binned_update_cuda_


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


def ensemble_update_binned_(scores: torch.Tensor, table: BinnedTrees,
                            X_binT: torch.Tensor, c0: int,
                            scale: float) -> torch.Tensor:
    """``scores[(c0 + t) % K] += f32(scale) * leaf_t`` over ``[F, n]`` bins
    for each tree t of ``table`` in order, in place."""
    if X_binT.device.type == "cuda":
        return binned_update_cuda_(scores, table, X_binT, c0, scale)
    return binned_update_(scores, table, X_binT, c0, scale)


def ensemble_replay_binned_(scores: torch.Tensor, table: BinnedTrees,
                            X_binT: torch.Tensor, num_class: int,
                            chunk_iters: int) -> torch.Tensor:
    """The table's iteration-major trees added to ``scores`` in chunks of
    ``chunk_iters`` iterations, in place."""
    if X_binT.device.type == "cuda":
        return binned_replay_cuda_(scores, table, X_binT, num_class,
                                   chunk_iters)
    return binned_replay_(scores, table, X_binT, num_class, chunk_iters)
