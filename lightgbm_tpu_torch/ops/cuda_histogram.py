"""Histograms: the CUDA kernels and their dispatch.

Counterpart of lightgbm_tpu/ops/pallas_histogram.py
``histogram_single_leaf``: ``hist[F, num_bins, 3]`` = (Σ g·m, Σ h·m, Σ m)
over the ``cap`` rows of ``bins_T [F, cap]``.  On a CUDA tensor it
launches kernel 1 (csrc/histogram.cu, which says what it replaces, its
bound and its design) and adds one to ``LAUNCHES``; on a CPU tensor it
returns the plain version (ops/histogram.py).  Nothing else selects
between the two.  Kernel 1 builds each 2048-row chunk's partials with a
stable bin sort in shared memory (``hist_sorted``, csrc/hist_chunk.cuh),
then sums them in chunk order: each bin's rows in row order, the plain
version's order, so the two agree bitwise.

``histogram_record_window`` is the same for a window of the packed record
(the counterpart of ``histogram_single_leaf_raw`` on ``unpack_window``):
kernel 1' on a CUDA record, counted in ``RECORD_LAUNCHES``, the plain
version on a CPU one.  Kernel 1' runs kernel 1's passes over the record's
words (each word of a row loaded once and unpacked) and equals kernel 1
on the unpacked rows bitwise.

``histogram_by_leaf_sorted`` is the level histogram ``hist[L, F,
num_bins, 3]`` of depthwise growth (the counterpart of
pallas_histogram.py ``histogram_by_leaf_sorted``): kernel 1''
(csrc/level_histogram.cu, counted in ``LEVEL_LAUNCHES``) or, under the
``bsub`` variant, kernel 2 (``BSUB_LAUNCHES``) on a CUDA tensor; the
plain version (ops/histogram.py ``histogram_by_leaf_sorted_plain``) on a
CPU one.  The variant comes from ``LGBM_TPU_HIST_KERNEL`` (the JAX
package's knob, read per call) unless the caller names it; under
``bsub`` ``histogram_single_leaf`` launches kernel 2 with one leaf.  The
plain versions of kernels 1'' and 2 are one function: the kernels sum in
the same order.

``acc_dtype=torch.float64`` (``hist_dtype=float64``) takes the same float32
rows and returns float64 sums: kernel 1-f64 (``histogram_single_leaf``,
counted in ``F64_LAUNCHES``) and kernel 1''-f64 (``histogram_by_leaf_sorted``,
``LEVEL_F64_LAUNCHES``) on the card, the plain versions with
``acc_dtype=float64`` on the CPU.  Under float64 the variant is not read:
the JAX package reaches no kernel there, so there is no float64 kernel 2.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from . import _build
from . import histogram as plain
from .histogram import CHUNK_ROWS, histogram_feature_major
from .record import rec_height

# kernel launches since the last reset (chip_smoke.py reads and resets them)
LAUNCHES = 0  # kernel 1
RECORD_LAUNCHES = 0  # kernel 1'
LEVEL_LAUNCHES = 0  # kernel 1''
BSUB_LAUNCHES = 0  # kernel 2
F64_LAUNCHES = 0  # kernel 1-f64
LEVEL_F64_LAUNCHES = 0  # kernel 1''-f64

ACC_DTYPES = (torch.float32, torch.float64)

VARIANTS = ("v1", "bsub")
# features per kernel-2 block; must equal kGroup in csrc/level_histogram.cu
# (pallas_histogram.FGROUP_BSUB)
BSUB_GROUP = 16

_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _acc(acc_dtype: torch.dtype) -> bool:
    """True for float64 accumulation; raises on anything but float32 /
    float64."""
    if acc_dtype not in ACC_DTYPES:
        raise TypeError(f"acc_dtype must be float32 or float64, got "
                        f"{acc_dtype}")
    return acc_dtype == torch.float64


def hist_variant(variant: Optional[str] = None) -> str:
    """``variant``, else ``LGBM_TPU_HIST_KERNEL``, else ``"v1"``; an
    unknown name raises ``ValueError`` (pallas_histogram._kernel_variant)."""
    v = variant or os.environ.get("LGBM_TPU_HIST_KERNEL", "v1")
    if v not in VARIANTS:
        raise ValueError(f"unknown histogram kernel variant {v!r}; expected "
                         f"one of {VARIANTS}")
    return v


def _lib():
    lib = _build.load("histogram")
    if not getattr(lib, "_typed", False):
        lib.lgbm_hist_single_leaf.restype = _I
        lib.lgbm_hist_single_leaf.argtypes = [
            _VP, _I, _VP, _VP, _VP, _I, _I64, _I, _VP, _VP, _VP]
        lib.lgbm_hist_record_window.restype = _I
        lib.lgbm_hist_record_window.argtypes = [
            _VP, _I64, _I64, _I64, _I, _I, _I, _VP, _VP, _VP]
        lib.lgbm_hist_single_leaf_f64.restype = _I
        lib.lgbm_hist_single_leaf_f64.argtypes = [
            _VP, _I, _VP, _VP, _VP, _I, _I64, _I, _VP, _VP, _VP]
        lib.lgbm_hist_chunk_rows.restype = _I
        lib.lgbm_hist_chunk_rows.argtypes = []
        if lib.lgbm_hist_chunk_rows() != CHUNK_ROWS:
            raise RuntimeError("csrc/histogram.cu kChunk differs from "
                               "ops/histogram.py CHUNK_ROWS")
        lib._typed = True
    return lib


def _level_lib():
    lib = _build.load("level_histogram")
    if not getattr(lib, "_typed", False):
        lib.lgbm_level_hist.restype = _I
        lib.lgbm_level_hist.argtypes = [
            _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _I64, _I, _I, _I, _I, _VP,
            _VP, _VP, _VP]
        lib.lgbm_level_hist_f64.restype = _I
        lib.lgbm_level_hist_f64.argtypes = [
            _VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _I64, _I, _I, _I, _VP, _VP,
            _VP, _VP]
        lib.lgbm_hist_single_leaf_bsub.restype = _I
        lib.lgbm_hist_single_leaf_bsub.argtypes = [
            _VP, _I, _VP, _VP, _VP, _I, _I64, _I, _VP, _VP, _VP]
        for fn in (lib.lgbm_level_hist_chunk_rows, lib.lgbm_level_hist_group):
            fn.restype = _I
            fn.argtypes = []
        if (lib.lgbm_level_hist_chunk_rows() != CHUNK_ROWS
                or lib.lgbm_level_hist_group() != BSUB_GROUP):
            raise RuntimeError("csrc/level_histogram.cu kChunk/kGroup differ "
                               "from CHUNK_ROWS/BSUB_GROUP")
        lib._typed = True
    return lib


def histogram_single_leaf(bins_T: torch.Tensor, grad: torch.Tensor,
                          hess: torch.Tensor, mask: torch.Tensor,
                          num_bins: int, variant: Optional[str] = None,
                          acc_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """``bins_T`` [F, cap] uint8/uint16; ``grad``/``hess``/``mask`` [cap]
    float32.  Returns [F, num_bins, 3] in ``acc_dtype``: kernel 1, or
    kernel 2 with one leaf under the ``bsub`` variant (``hist_variant``);
    kernel 1-f64 for float64."""
    f64 = _acc(acc_dtype)
    v = "v1" if f64 else hist_variant(variant)
    if bins_T.device.type == "cpu":
        return histogram_feature_major(bins_T, grad, hess, mask, num_bins,
                                       acc_dtype)
    if f64:
        return histogram_single_leaf_f64_cuda(bins_T, grad, hess, mask,
                                              num_bins)
    if v == "bsub":
        return histogram_single_leaf_bsub_cuda(bins_T, grad, hess, mask,
                                               num_bins)
    return histogram_single_leaf_cuda(bins_T, grad, hess, mask, num_bins)


def _check_rows(bins_T, grad, hess, mask, num_bins):
    """Shared argument checks of kernels 1, 1'' and 2: returns (F, n,
    bytes per bin)."""
    if bins_T.device.type != "cuda":
        raise ValueError(f"bins_T must be a CUDA tensor, got {bins_T.device}")
    if bins_T.dim() != 2:
        raise ValueError(f"bins_T must be [F, n], got {tuple(bins_T.shape)}")
    F, n = bins_T.shape
    bin_bytes = {torch.uint8: 1, torch.uint16: 2}.get(bins_T.dtype)
    if bin_bytes is None:
        raise TypeError(f"bins_T must be uint8 or uint16, got {bins_T.dtype}")
    dev = bins_T.device
    for name, t in (("grad", grad), ("hess", hess), ("mask", mask)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, bins_T on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.shape != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not bins_T.is_contiguous():
        raise ValueError("bins_T must be contiguous")
    if num_bins < 1:
        raise ValueError("num_bins must be >= 1")
    return F, n, bin_bytes


def histogram_single_leaf_cuda(bins_T, grad, hess, mask, num_bins):
    """Kernel 1 on the card (raises on anything it does not take): pass 1
    over (2048-row chunks, features), pass 2 over the cells; the
    [ceil(cap / 2048), F, num_bins, 3] partials are scratch."""
    global LAUNCHES
    F, cap, bin_bytes = _check_rows(bins_T, grad, hess, mask, num_bins)
    out = _launch(_lib().lgbm_hist_single_leaf, "histogram kernel",
                  bins_T.device, F, cap, num_bins, bins_T.data_ptr(),
                  bin_bytes, grad.data_ptr(), hess.data_ptr(),
                  mask.data_ptr(), F, cap, num_bins)
    LAUNCHES += 1
    return out


def histogram_single_leaf_f64_cuda(bins_T, grad, hess, mask, num_bins):
    """Kernel 1-f64 on the card (raises on anything it does not take):
    kernel 1's passes over the same float32 rows, summed in float64; the
    [ceil(cap / 2048), F, num_bins, 3] float64 partials are scratch."""
    global F64_LAUNCHES
    F, cap, bin_bytes = _check_rows(bins_T, grad, hess, mask, num_bins)
    out = _launch(_lib().lgbm_hist_single_leaf_f64, "float64 histogram "
                  "kernel", bins_T.device, F, cap, num_bins, bins_T.data_ptr(),
                  bin_bytes, grad.data_ptr(), hess.data_ptr(),
                  mask.data_ptr(), F, cap, num_bins, dtype=torch.float64)
    F64_LAUNCHES += 1
    return out


def histogram_single_leaf_bsub_cuda(bins_T, grad, hess, mask, num_bins):
    """Kernel 2 with one leaf on the card: kernel 1's function and sums,
    built 16 features per block (raises on anything it does not take)."""
    global BSUB_LAUNCHES
    F, cap, bin_bytes = _check_rows(bins_T, grad, hess, mask, num_bins)
    out = _launch(_level_lib().lgbm_hist_single_leaf_bsub,
                  "single-leaf bsub histogram kernel", bins_T.device, F, cap,
                  num_bins, bins_T.data_ptr(), bin_bytes, grad.data_ptr(),
                  hess.data_ptr(), mask.data_ptr(), F, cap, num_bins)
    BSUB_LAUNCHES += 1
    return out


def histogram_by_leaf_sorted(bins_T: torch.Tensor, leaf_id: torch.Tensor,
                             grad: torch.Tensor, hess: torch.Tensor,
                             mask: torch.Tensor, num_bins: int,
                             num_leaves: int, variant: Optional[str] = None,
                             acc_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """``bins_T`` [F, n] uint8/uint16; ``leaf_id`` [n] int32/int64, every
    id in [0, num_leaves); ``grad``/``hess``/``mask`` [n] float32.  Returns
    [num_leaves, F, num_bins, 3] in ``acc_dtype`` (an empty leaf's rows are
    zero): kernel 1'' or 2, or kernel 1''-f64 for float64."""
    f64 = _acc(acc_dtype)
    v = "v1" if f64 else hist_variant(variant)
    if bins_T.device.type == "cpu":
        return plain.histogram_by_leaf_sorted_plain(
            bins_T, leaf_id, grad, hess, mask, num_bins, num_leaves,
            acc_dtype)
    if f64:
        return histogram_by_leaf_sorted_f64_cuda(bins_T, leaf_id, grad, hess,
                                                 mask, num_bins, num_leaves)
    return histogram_by_leaf_sorted_cuda(bins_T, leaf_id, grad, hess, mask,
                                         num_bins, num_leaves, v)


def make_level_hist_fn(num_bins: int,
                       acc_dtype: torch.dtype = torch.float32):
    """The level growers' ``hist_fn(bins_T, leaf_id, grad, hess, mask,
    num_leaves)`` over ``histogram_by_leaf_sorted`` (pallas_histogram.py
    ``make_sorted_hist_fn``), summing in ``acc_dtype``."""
    def hist_fn(bins_T, leaf_id, grad, hess, mask, num_leaves):
        return histogram_by_leaf_sorted(bins_T, leaf_id, grad, hess, mask,
                                        num_bins, num_leaves,
                                        acc_dtype=acc_dtype)
    return hist_fn


def histogram_by_leaf_sorted_cuda(bins_T, leaf_id, grad, hess, mask,
                                  num_bins, num_leaves, variant="v1"):
    """Kernel 1'' (``variant="v1"``) or kernel 2 (``"bsub"``) on the card
    (raises on anything it does not take)."""
    global LEVEL_LAUNCHES, BSUB_LAUNCHES
    v = hist_variant(variant)
    out = _level_launch("lgbm_level_hist", v, bins_T, leaf_id,
                        grad, hess, mask, num_bins, num_leaves,
                        0 if v == "v1" else 1)
    if v == "v1":
        LEVEL_LAUNCHES += 1
    else:
        BSUB_LAUNCHES += 1
    return out


def histogram_by_leaf_sorted_f64_cuda(bins_T, leaf_id, grad, hess, mask,
                                      num_bins, num_leaves):
    """Kernel 1''-f64 on the card (raises on anything it does not take):
    kernel 1'''s sort, chunk table and passes over the same float32 rows,
    summed in float64."""
    global LEVEL_F64_LAUNCHES
    out = _level_launch("lgbm_level_hist_f64", "float64", bins_T,
                        leaf_id, grad, hess, mask, num_bins, num_leaves,
                        dtype=torch.float64)
    LEVEL_F64_LAUNCHES += 1
    return out


def _level_launch(entry, what, bins_T, leaf_id, grad, hess, mask,
                  num_bins, num_leaves, *variant, dtype=torch.float32):
    """Checks, scratch in ``dtype`` and the launch of the level library's
    C entry named ``entry`` (``lgbm_level_hist`` with its ``variant``
    flag: kernel 1'' or 2; ``lgbm_level_hist_f64``: kernel 1''-f64);
    returns the [num_leaves, F, num_bins, 3] output."""
    F, n, bin_bytes = _check_rows(bins_T, grad, hess, mask, num_bins)
    dev = bins_T.device
    if leaf_id.device != dev or leaf_id.shape != (n,) \
            or leaf_id.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"leaf_id must be an int32/int64 [{n}] tensor on "
                         f"{dev}")
    if num_leaves < 1:
        raise ValueError("num_leaves must be >= 1")
    # the prep of ops/histogram.level_layout: the stable sort here, the
    # chunk table (level_layout's other arrays) in the kernel's scratch
    sorted_leaf, order = torch.sort(leaf_id, stable=True)
    nchunks = (n + CHUNK_ROWS - 1) // CHUNK_ROWS + num_leaves
    table = torch.empty(2 * (num_leaves + 1) + 3 * nchunks,
                        dtype=torch.int64, device=dev)
    out = torch.empty((num_leaves, F, num_bins, 3), dtype=dtype, device=dev)
    partial = torch.empty((nchunks, F, num_bins, 3), dtype=dtype,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(_level_lib(), entry)(
            bins_T.data_ptr(), bin_bytes, grad.data_ptr(), hess.data_ptr(),
            mask.data_ptr(), order.data_ptr(), sorted_leaf.data_ptr(),
            sorted_leaf.element_size(), n, F, num_leaves, num_bins,
            *variant, table.data_ptr(), partial.data_ptr(), out.data_ptr(),
            stream)
    _build.check(code, f"level histogram kernel ({what})")
    return out


def _launch(entry, what, dev, F, cnt, num_bins, *args, dtype=torch.float32):
    """Allocate the output and the per-chunk scratch in ``dtype``, call
    the C entry on the current stream (``args`` then the two buffers and
    the stream) and raise on a launch error.  Returns the [F, num_bins, 3]
    output."""
    nchunks = (cnt + CHUNK_ROWS - 1) // CHUNK_ROWS
    out = torch.empty((F, num_bins, 3), dtype=dtype, device=dev)
    partial = torch.empty((nchunks, F, num_bins, 3), dtype=dtype,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = entry(*args, partial.data_ptr(), out.data_ptr(), stream)
    _build.check(code, what)
    return out


def histogram_record_window(rec: torch.Tensor, begin: int, cnt: int, F: int,
                            k: int, num_bins: int) -> torch.Tensor:
    """Columns ``[begin, begin+cnt)`` of the ``[W, n]`` int32 record
    (ops/record.py, ``k`` bins per word).  Returns [F, num_bins, 3]
    float32."""
    if rec.device.type == "cpu":
        return plain.histogram_record_window(rec, begin, cnt, F, k, num_bins)
    return histogram_record_window_cuda(rec, begin, cnt, F, k, num_bins)


def histogram_record_window_cuda(rec, begin, cnt, F, k, num_bins):
    """Kernel 1' on the card (raises on anything it does not take): kernel
    1's passes over the window, each bin unpacked from its record word."""
    global RECORD_LAUNCHES
    if rec.device.type != "cuda":
        raise ValueError(f"rec must be a CUDA tensor, got {rec.device}")
    if rec.dtype != torch.int32 or rec.dim() != 2 or not rec.is_contiguous():
        raise ValueError("rec must be a contiguous [W, n] int32 tensor")
    if k not in (2, 4):
        raise ValueError(f"k must be 2 or 4 bins per word, got {k}")
    W, n = rec.shape
    if W != rec_height(F, k):
        raise ValueError(f"a record of {F} features at {k} per word has "
                         f"{rec_height(F, k)} rows, got {W}")
    if begin < 0 or cnt < 0 or begin + cnt > n:
        raise ValueError(f"window [{begin}, {begin + cnt}) is outside "
                         f"[0, {n})")
    if num_bins < 1:
        raise ValueError("num_bins must be >= 1")
    out = _launch(_lib().lgbm_hist_record_window, "record histogram kernel",
                  rec.device, F, cnt, num_bins, rec.data_ptr(), n, begin, cnt,
                  F, k, num_bins)
    RECORD_LAUNCHES += 1
    return out
