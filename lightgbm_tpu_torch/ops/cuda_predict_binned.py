"""Kernel P2, the binned ensemble walk (``csrc/predict_binned.cu``), bound
with ctypes.

Update mode adds ``f32(scale) * leaf_t(row)`` of each listed tree, in
order, to its class's row of the ``[K, n]`` f32 scores (listed tree t is
class ``(c0 + t) % K``); replay mode adds the trees' chunked sum
(``GBDT.add_valid_dataset``'s order).  Both walk ``[F, n]`` uint8/uint16
bins in place and update the scores in place.  Each wrapper adds one to
``LAUNCHES`` when it launches the kernel.  The plain versions are
``models/tree.py`` ``binned_update_`` / ``binned_replay_``;
``ops/predict.py`` picks between them by the bins' device.  A call
uploads nothing and reads nothing back: the table's roots and offsets are
on the card already (``binned_table``), and the class offset and the
scale are kernel arguments.  ``p2_config`` picks the kernel's
configuration from the shapes; csrc/predict_binned.cu says what it
replaces, its bound and its design.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from ..models.tree import BinnedTrees
from . import _build

# kernel launches since the last reset (chip_smoke.py reads and resets them)
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

THREADS = 256  # a block: R rows x S = THREADS / R tree slots
SMEM_BYTES = 48 * 1024  # csrc/predict_binned.cu kSmemLimit
MIN_TILED_ROWS = 32  # a tile of bins is not cut below this many rows
BLOCKS_PER_SM = 2  # the grid P2 aims for, in blocks a streaming processor
# node records a tile of THREADS rows stages in shared memory at a time
# (about three trees of 255 leaves), with stage + 4 leaf values
STAGE_RECORDS = 768
# (rows a tile, tiled, records staged) in place of p2_config's choice, for
# every launch while it is set: tools/p2_variants.py times the
# configurations p2_config does not pick at a shape beside the one it does
_forced_config: Optional[Tuple[int, bool, int]] = None

_VP, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_float
_BIN_BYTES = {torch.uint8: 1, torch.uint16: 2}


def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def tile_stride(rows: int, bin_bytes: int) -> int:
    """Bytes of one feature's row in a tile of ``rows`` bins (csrc
    ``tile_stride``): a 16-byte multiple, widened by ``32 * bin_bytes``
    when it is a multiple of 128, so that the next feature starts
    ``8 * bin_bytes`` banks further on."""
    b = -(-rows * bin_bytes // 16) * 16
    return b + 32 * bin_bytes if b % 128 == 0 else b


def stage_leaves(stage: int) -> int:
    """Leaf values staged beside ``stage`` records (csrc: ``(stage + 4)
    & ~3``, at least one tree's ``stage + 1``)."""
    return (stage + 4) & ~3 if stage else 0


def smem_bytes(rows: int, F: int, bin_bytes: int, K: int, replay: bool,
               tiled: bool, stage: int = 0) -> int:
    """Shared memory of a block (csrc ``smem_bytes``): the tile of bins,
    the ``[K, rows]`` scores (and chunk sums in replay mode) and, at
    ``THREADS`` rows, the staged records and leaf values; below, two
    buffers of leaf values for the tree slots."""
    b = F * tile_stride(rows, bin_bytes) if tiled else 0
    b += 4 * rows * K * (2 if replay else 1)
    if rows == THREADS:
        return b + 16 * stage + 4 * stage_leaves(stage)
    return b + 4 * 2 * THREADS


@functools.lru_cache(maxsize=4096)
def p2_config(n: int, F: int, bin_bytes: int, n_trees: int, K: int,
              sms: int, max_tree_nodes: int, replay: bool = False
              ) -> Tuple[int, bool, int, int]:
    """P2's configuration for ``n`` rows of ``F`` features in bins of
    ``bin_bytes`` bytes and a list of ``n_trees`` trees of ``K`` classes
    (none of more than ``max_tree_nodes`` internal nodes) on a card of
    ``sms`` streaming processors: ``(rows a tile, bins tiled in shared
    memory, tree slots, records staged)``.

    Rows a tile: as many as keep ``BLOCKS_PER_SM`` blocks an SM busy, but
    few enough that the tree slots (``THREADS / rows``) cover the whole
    list when that fits: a call of many trees over few rows is walked one
    tree deep.  A tile of ``THREADS`` rows (one a thread, its trees in
    turn) stages up to ``STAGE_RECORDS`` records (no more than the list
    holds) when every tree fits in them.  Otherwise the bins
    are tiled at the rows chosen, or at fewer (down to ``MIN_TILED_ROWS``,
    or the rows chosen if fewer) when the tile does not fit in
    ``SMEM_BYTES``; wider bins are read from global memory (the wide
    configuration)."""
    rows = max(THREADS // min(_pow2_ceil(max(n_trees, 1)), THREADS), 1)
    while rows < THREADS and -(-n // (2 * rows)) >= BLOCKS_PER_SM * sms:
        rows *= 2

    def smem(r, tiled, stage=0):
        return smem_bytes(r, F, bin_bytes, K, replay, tiled, stage)

    while rows > 1 and smem(rows, False) > SMEM_BYTES:
        rows //= 2  # many classes: the scores' scratch alone
    if smem(1, False) > SMEM_BYTES:
        raise ValueError(f"P2 cannot hold the scores of {K} classes")
    if rows == THREADS:
        stage = -(-min(STAGE_RECORDS, n_trees * max_tree_nodes) // 4) * 4
        if 0 < max_tree_nodes <= stage and smem(rows, True, stage) \
                <= SMEM_BYTES:
            return rows, True, 1, stage
    r = rows
    while r >= min(rows, MIN_TILED_ROWS):
        if smem(r, True) <= SMEM_BYTES:
            return r, True, THREADS // r, 0
        r //= 2
    return rows, False, THREADS // rows, 0


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    lib = _build.load("predict_binned")
    if not getattr(lib, "_typed", False):
        lib.lgbm_p2_walk.restype = _I
        lib.lgbm_p2_walk.argtypes = [
            _VP, _VP, _VP, _VP, _VP, _VP, _I, _I64, _I, _I, _I, _I, _F, _I,
            _I, _I, _I, _I, _I, _VP, _VP]
        lib._typed = True
    return lib


def _table_ptrs(table: BinnedTrees, dev: torch.device) -> tuple:
    """The table's five device pointers, its tensors checked on ``dev``
    once a table (``binned_table`` builds them contiguous, and no caller
    changes a table after it is built)."""
    got = table.__dict__.get("_p2_ptrs")
    if got is not None and got[0] == dev:
        return got[1]
    names = ("node", "leaf_value", "root_dev", "node_offset", "leaf_offset")
    for name in names:
        t = getattr(table, name)
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"the table's {name} must be contiguous on {dev}")
    if table.node.data_ptr() % 16:
        raise ValueError("the table's node records must be 16-byte aligned")
    ptrs = tuple(getattr(table, name).data_ptr() for name in names)
    table.__dict__["_p2_ptrs"] = (dev, ptrs)
    return ptrs


def _launch(scores: torch.Tensor, table: BinnedTrees, X_binT: torch.Tensor,
            c0: int, scale: float, replay: bool, chunk_iters: int) -> None:
    """One launch of P2 on the current stream of the bins' card, in
    ``p2_config``'s configuration."""
    dev = X_binT.device
    if dev.type != "cuda":
        raise ValueError(f"the bins must be a CUDA tensor, got {dev}")
    bin_bytes = _BIN_BYTES.get(X_binT.dtype)
    if bin_bytes is None or X_binT.dim() != 2 or not X_binT.is_contiguous():
        raise TypeError("the bins must be a contiguous [F, n] uint8 or uint16 "
                        f"tensor, got {X_binT.dtype} {tuple(X_binT.shape)}")
    F, n = X_binT.shape
    K = scores.shape[0]
    if (scores.dtype != torch.float32 or scores.dim() != 2
            or scores.get_device() != dev.index or not scores.is_contiguous()
            or scores.shape[1] != n):
        raise ValueError(f"the scores must be a contiguous [K, {n}] float32 "
                         f"tensor on {dev}")
    ptrs = _table_ptrs(table, dev)
    T = table.num_trees
    if _forced_config is None:
        rows, tiled, _, stage = p2_config(
            n, F, bin_bytes, T, K, _sms(dev.index), table.max_steps, replay)
    else:
        rows, tiled, stage = _forced_config
    lib = _lib()
    args = (*ptrs, X_binT.data_ptr(), bin_bytes, n, F, K, T, int(c0),
            float(scale), table.max_steps, int(replay),
            max(int(chunk_iters), 1), rows, int(tiled), stage,
            scores.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
    if torch.cuda.current_device() == dev.index:
        code = lib.lgbm_p2_walk(*args)
    else:
        with torch.cuda.device(dev):
            code = lib.lgbm_p2_walk(*args)
    _build.check(code, "binned walk kernel")
    if n and T:
        _count_launch()


def binned_update_cuda_(scores: torch.Tensor, table: BinnedTrees,
                        X_binT: torch.Tensor, c0: int, scale: float
                        ) -> torch.Tensor:
    """P2's update mode: ``scores[(c0 + t) % K] += f32(scale) * leaf_t``
    for each tree t of ``table`` in order, one launch."""
    if not 0 <= int(c0) < scores.shape[0]:
        raise ValueError(f"class offset {c0} outside [0, {scores.shape[0]})")
    _launch(scores, table, X_binT, c0, scale, False, 1)
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
    _launch(scores, table, X_binT, 0, 1.0, True, chunk_iters)
    return scores
