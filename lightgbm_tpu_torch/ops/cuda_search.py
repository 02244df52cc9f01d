"""Two-child split search: the CUDA kernel and its dispatch.

Counterpart of lightgbm_tpu/ops/pallas_search.py ``search2_pallas``.
``search2`` takes both children's [F, B, 3] histograms and returns two
SplitResults; ``search2_rows`` is the same search in the packed [2, 16]
row layout of pallas_search._unpack (gain, feature, threshold, lg, lh,
lc, rg, rh, rc, left_out, right_out, 0...), which the grower consumes.
On CUDA tensors it launches kernel 2 (csrc/search.cu, which says what it
replaces, its bound and its design) and adds one to ``LAUNCHES``; on CPU
tensors it runs the plain version (ops/split.py).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build
from .split import SplitResult, find_best_split_leaves

# kernel launches since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = _build.load("search")
    if not getattr(lib, "_typed", False):
        lib.lgbm_search2.restype = _I
        lib.lgbm_search2.argtypes = [_VP, _VP, _VP, _I, _I] + [_F] * 13 + [
            _VP, _VP]
        lib.lgbm_search2_max_features.restype = _I
        lib.lgbm_search2_max_features.argtypes = []
        lib._typed = True
    return lib


def pack_meta(feature_mask, num_bins_per_feature, is_categorical,
              device) -> torch.Tensor:
    """[F] feature metadata -> the kernel's [F, 4] int32 operand
    (feature_mask, num_bins, is_categorical, 0)."""
    fm = torch.as_tensor(feature_mask).to(device=device, dtype=torch.int32)
    return torch.stack([
        fm,
        torch.as_tensor(num_bins_per_feature).to(device=device,
                                                 dtype=torch.int32),
        torch.as_tensor(is_categorical).to(device=device, dtype=torch.int32),
        torch.zeros_like(fm),
    ], dim=1).contiguous()


def search2_rows(h_left: torch.Tensor, h_right: torch.Tensor,
                 scal: Sequence[float], meta: torch.Tensor) -> torch.Tensor:
    """Both children's best splits as a [2, 16] float32 tensor.

    ``scal`` = (can, lsg, lsh, lc, rsg, rsh, rc, min_data, min_hess, l1,
    l2, min_gain) as Python floats; ``meta`` is ``pack_meta``'s [F, 4]."""
    if h_left.device.type == "cpu":
        return _search2_rows_plain(h_left, h_right, scal, meta)
    return _search2_rows_cuda(h_left, h_right, scal, meta)


def _search2_rows_plain(h_left, h_right, scal, meta):
    can, lsg, lsh, lc, rsg, rsh, rc, md, mh, l1, l2, mg = scal
    dt, dev = h_left.dtype, h_left.device
    res = find_best_split_leaves(
        torch.stack([h_left, h_right]),
        torch.tensor([lsg, rsg], dtype=dt, device=dev),
        torch.tensor([lsh, rsh], dtype=dt, device=dev),
        torch.tensor([lc, rc], dtype=dt, device=dev),
        meta[:, 0] > 0, meta[:, 1], meta[:, 2] > 0, md, mh, l1, l2, mg,
        torch.tensor([bool(can), bool(can)], device=dev))
    out = torch.zeros((2, 16), dtype=torch.float32, device=dev)
    out[:, :11] = torch.stack([a.to(torch.float32) for a in res], dim=1)
    return out


def _search2_rows_cuda(h_left, h_right, scal, meta):
    global LAUNCHES
    F, B, three = h_left.shape
    dev = h_left.device
    if three != 3 or h_right.shape != h_left.shape:
        raise ValueError(
            f"histograms must both be [F, B, 3], got {tuple(h_left.shape)} "
            f"and {tuple(h_right.shape)}")
    for name, t in (("h_left", h_left), ("h_right", h_right)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    if (meta.dtype != torch.int32 or meta.shape != (F, 4)
            or meta.device != dev or not meta.is_contiguous()):
        raise ValueError(f"meta must be a contiguous [{F}, 4] int32 tensor "
                         f"on {dev}")
    if len(scal) != 12:
        raise ValueError("scal must hold 12 values")
    lib = _lib()
    if F > lib.lgbm_search2_max_features():
        raise ValueError(f"search kernel takes at most "
                         f"{lib.lgbm_search2_max_features()} features")
    can, lsg, lsh, lc, rsg, rsh, rc, md, mh, l1, l2, mg = (
        float(v) for v in scal)
    out = torch.empty((2, 16), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.lgbm_search2(
            h_left.data_ptr(), h_right.data_ptr(), meta.data_ptr(), F, B,
            can, lsg, lsh, lc, can, rsg, rsh, rc, md, mh, l1, l2, mg,
            out.data_ptr(), stream)
    _build.check(code, "search kernel")
    LAUNCHES += 1
    return out


def unpack(rows: torch.Tensor, i: int) -> SplitResult:
    """Row ``i`` of a [2, 16] result as a SplitResult of 0-d tensors."""
    r = rows[i]
    return SplitResult(r[0], r[1].to(torch.int32), r[2].to(torch.int32),
                       *[r[k] for k in range(3, 11)])


def search2(h_left, h_right, lsg, lsh, lc, rsg, rsh, rc, can,
            feature_mask, num_bins_per_feature, is_categorical,
            min_data_in_leaf, min_sum_hessian_in_leaf, lambda_l1, lambda_l2,
            min_gain_to_split) -> Tuple[SplitResult, SplitResult]:
    """``search2_pallas``'s signature: both children's SplitResults."""
    meta = pack_meta(feature_mask, num_bins_per_feature, is_categorical,
                     h_left.device)
    scal = [float(can), float(lsg), float(lsh), float(lc), float(rsg),
            float(rsh), float(rc), float(min_data_in_leaf),
            float(min_sum_hessian_in_leaf), float(lambda_l1),
            float(lambda_l2), float(min_gain_to_split)]
    rows = search2_rows(h_left, h_right, scal, meta)
    return unpack(rows, 0), unpack(rows, 1)
