"""Kernel P1, ensemble prediction (``csrc/predict.cu``), bound with ctypes.

Sum mode gives ``[K, n]`` f32 raw scores in the JAX package's chunked
float order; leaves mode gives ``[T, n]`` int32 leaf indices.  Each
wrapper adds one to ``LAUNCHES`` when it launches the kernel.  The plain
versions are ``models/tree.py`` ``ensemble_sum_raw`` /
``ensemble_leaves_raw``; ``ops/predict.py`` picks between them by the
input's device.  csrc/predict.cu says what the kernel replaces, its bound
and its design.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..models.tree import PackedTrees
from . import _build

# kernel launches since the last reset (chip_smoke.py reads and resets them);
# the serving queue's dispatcher and HTTP handler threads launch P1 at once,
# so the count is taken under a lock
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1

_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    lib = _build.load("predict")
    if not getattr(lib, "_typed", False):
        lib.lgbm_predict_sum.restype = _I
        lib.lgbm_predict_sum.argtypes = [
            _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _VP, _I64, _I, _I, _I, _I,
            _VP, _VP]
        lib.lgbm_predict_leaves.restype = _I
        lib.lgbm_predict_leaves.argtypes = [
            _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _VP, _I64, _I, _I, _VP,
            _VP]
        lib._typed = True
    return lib


def _check(p: PackedTrees, X: torch.Tensor, n_trees: int) -> None:
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"X must be a CUDA tensor, got {dev}")
    if X.dtype != torch.float32 or X.dim() != 2 or not X.is_contiguous():
        raise ValueError("X must be a contiguous [n, F] float32 tensor")
    if X.shape[1] < p.num_features:
        raise ValueError(f"X has {X.shape[1]} features; the model splits on "
                         f"column {p.num_features - 1}")
    if not 0 <= n_trees <= p.num_trees:
        raise ValueError(f"n_trees={n_trees} outside [0, {p.num_trees}]")
    for name in ("split_feature", "threshold", "decision_type", "left_child",
                 "right_child", "leaf_value", "root", "leaf_offset"):
        t = getattr(p, name)
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"the packed {name} must be contiguous on {dev}")


def _forest(p: PackedTrees):
    return (p.split_feature.data_ptr(), p.threshold.data_ptr(),
            p.decision_type.data_ptr(), p.left_child.data_ptr(),
            p.right_child.data_ptr())


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ensemble_sum_cuda(p: PackedTrees, X: torch.Tensor, n_trees: int,
                      chunk_iters: int) -> torch.Tensor:
    """P1's sum mode: ``[K, n]`` f32 over the first ``n_trees`` trees
    (whole iterations), chunk sums of ``chunk_iters`` iterations."""
    _check(p, X, n_trees)
    K, (n, F) = p.num_class, X.shape
    n_iter = n_trees // K
    out = torch.empty((K, n), dtype=torch.float32, device=X.device)
    lib = _lib()
    with torch.cuda.device(X.device):
        code = lib.lgbm_predict_sum(
            *_forest(p), p.leaf_value.data_ptr(), p.root.data_ptr(), p.depth,
            X.data_ptr(), n, F, K, n_iter, max(int(chunk_iters), 1),
            out.data_ptr(), _stream(X.device))
    _build.check(code, "predict sum kernel")
    if n:
        _count_launch()
    return out


def ensemble_leaves_cuda(p: PackedTrees, X: torch.Tensor,
                         n_trees: int) -> torch.Tensor:
    """P1's leaves mode: ``[n_trees, n]`` int32 leaf indices."""
    _check(p, X, n_trees)
    n, F = X.shape
    out = torch.empty((n_trees, n), dtype=torch.int32, device=X.device)
    lib = _lib()
    with torch.cuda.device(X.device):
        code = lib.lgbm_predict_leaves(
            *_forest(p), p.root.data_ptr(), p.leaf_offset.data_ptr(),
            p.depth, X.data_ptr(), n, F, n_trees, out.data_ptr(),
            _stream(X.device))
    _build.check(code, "predict leaves kernel")
    if n and n_trees:
        _count_launch()
    return out
