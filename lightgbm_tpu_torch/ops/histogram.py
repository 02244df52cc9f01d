"""Histogram construction — the plain PyTorch versions.

Counterpart of lightgbm_tpu/ops/histogram.py ``histogram_feature_major``:
``hist[F, num_bins, 3]`` = (Σ g·m, Σ h·m, Σ m) over one masked row set.
It is the CPU path of ``ops/cuda_histogram.histogram_single_leaf`` and
the oracle the CUDA kernel is held against on the card; nothing on the
training path calls it for a CUDA tensor.  ``histogram_record_window`` is
the same sums over a window of the packed record (ops/record.py), the
plain version of kernel 1'; with a go mask it is the left child's
histogram of kernel 8 (ops/record.py ``split_step_plain``).

The sums follow the kernel's order: rows in blocks of ``CHUNK_ROWS``,
each block summed in row order (``index_add_`` is sequential on the
CPU), the block partials then added in block order.  On the CPU the two
agree bitwise, so trees grown with the plain version and with the
kernel see the same histograms.
"""

from __future__ import annotations

from typing import Optional

import torch

from .record import unpack_window

# rows per block; must equal kChunk in csrc/histogram.cu
CHUNK_ROWS = 2048


def histogram_feature_major(bins_T: torch.Tensor, grad: torch.Tensor,
                            hess: torch.Tensor, mask: torch.Tensor,
                            num_bins: int) -> torch.Tensor:
    """``bins_T`` [F, n] integer bins (feature-major); ``grad``/``hess``/
    ``mask`` [n].  Returns [F, num_bins, 3] in ``grad``'s dtype."""
    F, n = bins_T.shape
    dev, dt = grad.device, grad.dtype
    stats = torch.stack([grad * mask, hess * mask, mask.to(dt)], dim=-1)
    offs = torch.arange(F, device=dev)[:, None] * num_bins
    out = torch.zeros(F * num_bins, 3, dtype=dt, device=dev)
    for r0 in range(0, n, CHUNK_ROWS):
        r1 = min(n, r0 + CHUNK_ROWS)
        keys = bins_T[:, r0:r1].to(torch.int64) + offs
        part = torch.zeros_like(out)
        part.index_add_(0, keys.reshape(-1), stats[r0:r1].repeat(F, 1))
        out += part
    return out.reshape(F, num_bins, 3)


def histogram_record_window(rec: torch.Tensor, begin: int, cnt: int, F: int,
                            k: int, num_bins: int,
                            go: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Columns ``[begin, begin+cnt)`` of the ``[W, n]`` record (``k`` bins
    per word) -> [F, num_bins, 3] float32: ``unpack_window`` then
    ``histogram_feature_major``, in the same summation order.  With ``go``
    ([cnt] bool) each column's mask is multiplied by its go flag, so only
    the left-going columns count (the JAX package's ``mw = mrow * govf``,
    record.py:485)."""
    bins, g, h, m = unpack_window(rec[:, begin:begin + cnt], F, k,
                                  torch.uint8 if k == 4 else torch.uint16)
    if go is not None:
        m = m * go.to(m.dtype)
    return histogram_feature_major(bins, g, h, m, num_bins)
