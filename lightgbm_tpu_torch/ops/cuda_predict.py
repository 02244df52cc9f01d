"""Kernel P1, ensemble prediction (``csrc/predict.cu``), bound with ctypes.

Sum mode gives ``[K, n]`` f32 raw scores in the JAX package's chunked
float order; leaves mode gives ``[T, n]`` int32 leaf indices.  Each
wrapper adds one to ``LAUNCHES`` when it launches the kernel.  The plain
versions are ``models/tree.py`` ``ensemble_sum_raw`` /
``ensemble_leaves_raw``; ``ops/predict.py`` picks between them by the
input's device.  csrc/predict.cu says what the kernel replaces, its bound
and its design; ``p1_config`` picks its configuration from the shapes.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from ..models.tree import PackedTrees
from . import _build

# kernel launches since the last reset (chip_smoke.py reads and resets them);
# the serving queue's dispatcher and HTTP handler threads launch P1 at once,
# so the count is taken under a lock
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

THREADS = 256  # a block: R rows x S = THREADS / R tree slots
SMEM_BYTES = 48 * 1024  # csrc/predict.cu kSmemLimit
MIN_TILED_ROWS = 32  # a tile of X is not cut below this many rows
BLOCKS_PER_SM = 2  # the grid P1 aims for, in blocks a streaming processor
# node records a block stages in shared memory at a time (about three
# trees of 255 leaves), when it walks THREADS rows a block; without them a
# large batch takes UNSTAGED_ROWS rows a block (tools/p1_variants.py, the
# fastest of each at 1M rows)
STAGE_RECORDS = 768
UNSTAGED_ROWS = 64


def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def smem_bytes(rows: int, F: int, K: int, tiled: bool, leaves: bool,
               stage: int = 0) -> int:
    """Shared memory of a block (csrc/predict.cu ``smem_bytes``): the
    staged node records, the tile of X (row stride ``F | 1``), and in sum
    mode each (row, class)'s chunk sum and total and, with more than one
    tree slot, two buffers of leaf values."""
    cells = 4 * stage + (rows * (F | 1) if tiled else 0)
    if not leaves:
        cells += 2 * rows * K + (2 * THREADS if rows < THREADS else 0)
    return 4 * cells


def p1_config(n: int, F: int, n_trees: int, K: int, sms: int,
              max_tree_nodes: int, leaves: bool = False
              ) -> Tuple[int, bool, int]:
    """P1's configuration for ``n`` rows of ``F`` features and ``n_trees``
    trees of ``K`` classes (none of more than ``max_tree_nodes`` internal
    nodes) on a card of ``sms`` streaming processors: ``(rows a block, X
    tiled in shared memory, node records staged in shared memory)``.

    Rows a block: as many as keep ``BLOCKS_PER_SM`` blocks an SM busy, but
    few enough that the tree slots (``THREADS / rows``) cover the whole
    model when that fits: a small batch is walked one tree deep.  X is
    tiled when the tile fits in ``SMEM_BYTES``, cutting the rows to no
    fewer than ``MIN_TILED_ROWS`` (or the rows chosen, if fewer); a wider
    input reads X from global memory (the wide configuration).  A tile of
    ``THREADS`` rows stages ``STAGE_RECORDS`` records at a time when every
    tree fits in them; a large batch that cannot takes ``UNSTAGED_ROWS``
    rows a block."""
    rows = max(THREADS // min(_pow2_ceil(max(n_trees, 1)), THREADS), 1)
    while rows < THREADS and -(-n // (2 * rows)) >= BLOCKS_PER_SM * sms:
        rows *= 2
    while rows > 1 and smem_bytes(rows, F, K, False, leaves) > SMEM_BYTES:
        rows //= 2  # many classes: the sums' scratch alone
    if smem_bytes(1, F, K, False, leaves) > SMEM_BYTES:
        raise ValueError(f"P1 cannot hold the sums of {K} classes")
    if (rows == THREADS and max_tree_nodes <= STAGE_RECORDS
            and smem_bytes(rows, F, K, True, leaves, STAGE_RECORDS)
            <= SMEM_BYTES):
        return rows, True, STAGE_RECORDS
    rows = min(rows, max(UNSTAGED_ROWS, THREADS // _pow2_ceil(
        max(n_trees, 1))))
    r = rows
    while r >= min(rows, MIN_TILED_ROWS):
        if smem_bytes(r, F, K, True, leaves) <= SMEM_BYTES:
            return r, True, 0
        r //= 2
    return rows, False, 0


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    lib = _build.load("predict")
    if not getattr(lib, "_typed", False):
        lib.lgbm_p1_sum.restype = _I
        lib.lgbm_p1_sum.argtypes = [
            _VP, _VP, _VP, _VP, _I, _VP, _I64, _I, _I, _I, _I, _I, _I, _I,
            _VP, _VP]
        lib.lgbm_p1_leaves.restype = _I
        lib.lgbm_p1_leaves.argtypes = [
            _VP, _VP, _VP, _VP, _I, _VP, _I64, _I, _I, _I, _I, _I, _VP, _VP]
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
    for name in ("node", "node_offset", "leaf_value", "root", "leaf_offset"):
        t = getattr(p, name)
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"the packed {name} must be contiguous on {dev}")
    if p.node.data_ptr() % 16:
        raise ValueError("the packed node records must be 16-byte aligned")


def _config(p: PackedTrees, X: torch.Tensor, n_trees: int, leaves: bool,
            config: Optional[Tuple[int, bool, int]]) -> Tuple[int, bool, int]:
    if config is None:
        n, F = X.shape
        return p1_config(n, F, n_trees, p.num_class,
                         _sms(X.device.index or 0), p.max_tree_nodes, leaves)
    rows, tiled, stage = config
    if stage and stage < p.max_tree_nodes:
        raise ValueError(f"a stage of {stage} records cannot hold a tree of "
                         f"{p.max_tree_nodes} nodes")
    return int(rows), bool(tiled), int(stage)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ensemble_sum_cuda(p: PackedTrees, X: torch.Tensor, n_trees: int,
                      chunk_iters: int,
                      config: Optional[Tuple[int, bool, int]] = None
                      ) -> torch.Tensor:
    """P1's sum mode: ``[K, n]`` f32 over the first ``n_trees`` trees
    (whole iterations), chunk sums of ``chunk_iters`` iterations.
    ``config`` ``(rows a block, tiled, records staged)`` replaces
    ``p1_config``'s choice."""
    _check(p, X, n_trees)
    K, (n, F) = p.num_class, X.shape
    rows, tiled, stage = _config(p, X, n_trees, False, config)
    out = torch.empty((K, n), dtype=torch.float32, device=X.device)
    lib = _lib()
    with torch.cuda.device(X.device):
        code = lib.lgbm_p1_sum(
            p.node.data_ptr(), p.node_offset.data_ptr(),
            p.leaf_value.data_ptr(), p.root.data_ptr(), p.depth,
            X.data_ptr(), n, F, K, n_trees // K, max(int(chunk_iters), 1),
            rows, int(tiled), stage, out.data_ptr(), _stream(X.device))
    _build.check(code, "predict sum kernel")
    if n:
        _count_launch()
    return out


def ensemble_leaves_cuda(p: PackedTrees, X: torch.Tensor, n_trees: int,
                         config: Optional[Tuple[int, bool, int]] = None
                         ) -> torch.Tensor:
    """P1's leaves mode: ``[n_trees, n]`` int32 leaf indices."""
    _check(p, X, n_trees)
    n, F = X.shape
    rows, tiled, stage = _config(p, X, n_trees, True, config)
    out = torch.empty((n_trees, n), dtype=torch.int32, device=X.device)
    lib = _lib()
    with torch.cuda.device(X.device):
        code = lib.lgbm_p1_leaves(
            p.node.data_ptr(), p.node_offset.data_ptr(), p.root.data_ptr(),
            p.leaf_offset.data_ptr(), p.depth, X.data_ptr(), n, F, n_trees,
            rows, int(tiled), stage, out.data_ptr(), _stream(X.device))
    _build.check(code, "predict leaves kernel")
    if n and n_trees:
        _count_launch()
    return out
