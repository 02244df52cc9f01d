"""Kernel P2, the binned ensemble walk (``csrc/predict_binned.cu``), bound
with ctypes.

Update mode adds ``f32(scale_t) * leaf_t(row)`` of each listed tree, in
order, to its class's row of the ``[K, n]`` f32 scores; replay mode adds
the trees' chunked sum (``GBDT.add_valid_dataset``'s order).  Both walk
``[F, n]`` uint8/uint16 bins in place and update the scores in place.
Each wrapper adds one to ``LAUNCHES`` when it launches the kernel.  The
plain versions are ``models/tree.py`` ``binned_update_`` /
``binned_replay_``; ``ops/predict.py`` picks between them by the bins'
device.  Nothing here reads the card's memory back: the per-tree meta
goes up from pinned memory without blocking the host.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np
import torch

from ..models.tree import BinnedTrees, upload
from . import _build

# kernel launches since the last reset (chip_smoke.py reads and resets them)
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_BIN_BYTES = {torch.uint8: 1, torch.uint16: 2}


def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def _lib():
    lib = _build.load("predict_binned")
    if not getattr(lib, "_typed", False):
        lib.lgbm_p2_walk.restype = _I
        lib.lgbm_p2_walk.argtypes = [
            _VP, _VP, _VP, _VP, _I, _I64, _I, _I, _I, _I, _I, _VP, _VP]
        lib._typed = True
    return lib


def walk_meta(table: BinnedTrees, classes: Sequence[int],
              scales: Sequence[float], device) -> torch.Tensor:
    """The kernel's per-tree ``[T, 4]`` int32 ``{root, class, the scale's
    f32 bits, 0}`` on ``device``."""
    meta = np.zeros((table.num_trees, 4), np.int32)
    meta[:, 0] = table.root
    meta[:, 1] = classes
    meta[:, 2] = np.asarray(scales, np.float32).view(np.int32)
    return upload(meta, device)


def launch_walk(scores: torch.Tensor, table: BinnedTrees,
                X_binT: torch.Tensor, meta: torch.Tensor, replay: bool,
                chunk_iters: int) -> None:
    """One launch of P2 with a ``walk_meta`` already on the card (the
    wrappers below build it; chip_smoke.py times the kernel alone)."""
    dev = X_binT.device
    if dev.type != "cuda":
        raise ValueError(f"the bins must be a CUDA tensor, got {dev}")
    bin_bytes = _BIN_BYTES.get(X_binT.dtype)
    if bin_bytes is None or X_binT.dim() != 2 or not X_binT.is_contiguous():
        raise TypeError("the bins must be a contiguous [F, n] uint8 or uint16 "
                        f"tensor, got {X_binT.dtype} {tuple(X_binT.shape)}")
    K, n = scores.shape
    if (scores.dtype != torch.float32 or scores.device != dev
            or not scores.is_contiguous() or n != X_binT.shape[1]):
        raise ValueError("the scores must be a contiguous [K, "
                         f"{X_binT.shape[1]}] float32 tensor on {dev}")
    for name, t in (("node", table.node), ("leaf_value", table.leaf_value)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"the table's {name} must be contiguous on {dev}")
    if table.node.data_ptr() % 16:
        raise ValueError("the table's node records must be 16-byte aligned")
    T = table.num_trees
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.lgbm_p2_walk(
            table.node.data_ptr(), table.leaf_value.data_ptr(),
            meta.data_ptr(), X_binT.data_ptr(), bin_bytes, n, K, T,
            table.max_steps, int(replay), max(int(chunk_iters), 1),
            scores.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "binned walk kernel")
    if n and T:
        _count_launch()


def binned_update_cuda_(scores: torch.Tensor, table: BinnedTrees,
                        X_binT: torch.Tensor, classes: Sequence[int],
                        scales: Sequence[float]) -> torch.Tensor:
    """P2's update mode: ``scores[classes[t]] += f32(scales[t]) *
    leaf_t`` for each tree t of ``table`` in order, one launch."""
    if len(classes) != table.num_trees or len(scales) != table.num_trees:
        raise ValueError("one class and one scale a tree")
    if any(not 0 <= int(c) < scores.shape[0] for c in classes):
        raise ValueError(f"a class outside [0, {scores.shape[0]})")
    meta = walk_meta(table, classes, scales, X_binT.device)
    launch_walk(scores, table, X_binT, meta, False, 1)
    return scores


def binned_replay_cuda_(scores: torch.Tensor, table: BinnedTrees,
                        X_binT: torch.Tensor, num_class: int,
                        chunk_iters: int) -> torch.Tensor:
    """P2's replay mode: the table's iteration-major trees added to the
    scores in chunks of ``chunk_iters`` iterations, one launch."""
    K, T = int(num_class), table.num_trees
    if K != scores.shape[0] or T % K:
        raise ValueError(f"{T} trees are not whole iterations of {K} "
                         f"classes, or the scores have {scores.shape[0]}")
    meta = walk_meta(table, [t % K for t in range(T)], [1.0] * T,
                     X_binT.device)
    launch_walk(scores, table, X_binT, meta, True, chunk_iters)
    return scores
