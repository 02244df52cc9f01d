"""LambdaRank-NDCG objective as tensor ops.

Counterpart of lightgbm_tpu/objectives_rank.py (the reference's
LambdarankNDCG, rank_objective.hpp:19-227).  Queries are bucketed by
power-of-two length (at least 16); each bucket is padded to its own
bound and processed in chunks of queries whose ``[C, Q, Q]`` pair
tensors hold at most 2^24 cells (64 MB in float32), freed chunk by
chunk.  The bucket tensors are built once, in ``init``, on the device.

Per pair (high = rank i, low = rank j, label_high > label_low):
  delta_ndcg = (gain[lh]-gain[ll]) * |disc_i - disc_j| * inv_max_dcg
               [/ (0.01 + |s_h - s_l|) when best != worst score]
  p        = 2 / (1 + exp(clip(2*sigma*(s_h - s_l), -88, 88)))
  lambda_h += -delta_ndcg * p        lambda_l -= -delta_ndcg * p
  hess_{h,l} += 2 * delta_ndcg * p * (2 - p)

Every float32 op runs in the JAX package's order, with its exp
(``exp_f32``), and the sums over a row's Q pair terms add in the order
of XLA's CPU reduction (``ops.histogram.xla_sum``): every op is
elementwise, so the card and the CPU give the same bits, and for buckets
of 64 and more they are the JAX package's bits.  In buckets of 16 and 32
XLA fuses the pair terms into the reduction and rounds some of them
otherwise, so there the two agree to float32 rounding of a sum of at
most 32 terms.
"""

from __future__ import annotations

import numpy as np
import torch

from .dcg import (build_padded_query_layout, label_gains_from_config,
                  max_dcg_at_k, position_discounts)
from .objectives import ObjectiveFunction, _f32, exp_f32
from .ops.histogram import xla_sum

PAIR_CELLS = 1 << 24  # [C, Q, Q] cells a chunk may hold


class LambdarankNDCG(ObjectiveFunction):
    name = "lambdarank"

    def __init__(self, config):
        if config.sigmoid <= 0:
            raise ValueError("sigmoid parameter must be > 0")
        self.sigmoid = float(config.sigmoid)
        self.optimize_pos_at = int(config.max_position)
        self._gains_np = label_gains_from_config(config.label_gain)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            raise ValueError("Lambdarank tasks require query information")
        dev = self.label.device
        qb = np.asarray(metadata.query_boundaries)
        label_np = np.asarray(metadata.label)
        nq = len(qb) - 1
        sizes = qb[1:] - qb[:-1]
        inv_max_dcg = np.zeros(nq, np.float64)
        for q in range(nq):
            m = max_dcg_at_k(self.optimize_pos_at,
                             label_np[qb[q]:qb[q + 1]], self._gains_np)
            inv_max_dcg[q] = 1.0 / m if m > 0 else 0.0
        self._gains = torch.as_tensor(self._gains_np, dtype=torch.float32,
                                      device=dev)
        bucket_of = np.maximum(
            16, 1 << np.ceil(np.log2(np.maximum(sizes, 1))).astype(np.int64))
        self._buckets = []
        for Qb in sorted(set(int(b) for b in bucket_of)):
            qsel = np.flatnonzero(bucket_of == Qb)
            pad_idx = build_padded_query_layout(qb, num_data, qsel,
                                                Qb)[0].astype(np.int64)
            valid = pad_idx < num_data
            labels = np.where(valid, label_np[np.minimum(pad_idx,
                                                         num_data - 1)],
                              0).astype(np.int32)
            disc = torch.as_tensor(position_discounts(Qb), dtype=torch.float32)
            self._buckets.append(dict(
                pad_idx=torch.from_numpy(pad_idx).to(dev),
                valid=torch.from_numpy(valid).to(dev),
                labels=torch.from_numpy(labels).to(dev),
                inv_max_dcg=torch.as_tensor(inv_max_dcg[qsel],
                                            dtype=torch.float32, device=dev),
                # |disc_i - disc_j|, the same float32 values the JAX
                # package computes per chunk
                pos_gap=(disc[:, None] - disc[None, :]).abs().to(dev),
                chunk=max(1, min(len(qsel), PAIR_CELLS // (Qb * Qb)))))

    def get_gradients(self, scores):
        n = self.num_data
        s_ext = torch.cat([scores, scores.new_zeros(1)])  # sentinel slot n
        grad = torch.zeros(n + 1, dtype=torch.float32, device=scores.device)
        hess = torch.zeros_like(grad)
        two_sigma = _f32(2.0 * self.sigmoid)
        for b in self._buckets:
            c = b["chunk"]
            for lo in range(0, b["pad_idx"].shape[0], c):
                idx = b["pad_idx"][lo:lo + c]
                lam, hes = _chunk_grads(
                    s_ext, idx, b["valid"][lo:lo + c],
                    b["labels"][lo:lo + c], b["inv_max_dcg"][lo:lo + c],
                    self._gains, b["pos_gap"], two_sigma)
                # every real row sits in one cell of one bucket; padding
                # cells all land on the sentinel slot, which is dropped
                grad[idx] = lam
                hess[idx] = hes
        grad, hess = grad[:n], hess[:n]
        if self.weights is not None:
            grad, hess = grad * self.weights, hess * self.weights
        return grad, hess


def _chunk_grads(s_ext, idx, vld, lab, imd, gains, pos_gap, two_sigma):
    """One chunk of queries (``_lambdarank_grads``' ``one_chunk``): the
    lambdas and hessians ``[C, Q]`` in slot order."""
    s = torch.where(vld, s_ext[idx], float("-inf"))
    order = torch.argsort(-s, dim=1, stable=True)  # rank -> slot
    s_r = s.gather(1, order)
    l_r = lab.gather(1, order)
    v_r = vld.gather(1, order)
    last = (vld.sum(1) - 1).clamp(min=0)
    worst = s_r.gather(1, last[:, None])[:, 0]
    regularize = (s_r[:, 0] != worst)[:, None, None]
    g_r = gains[l_r.clamp(0, gains.shape[0] - 1).long()]
    cond = ((l_r[:, :, None] > l_r[:, None, :]) & v_r[:, :, None]
            & v_r[:, None, :])
    D = s_r[:, :, None] - s_r[:, None, :]  # s_high - s_low
    dn = (g_r[:, :, None] - g_r[:, None, :]) * pos_gap * imd[:, None, None]
    dn = torch.where(regularize, dn / (0.01 + D.abs()), dn)
    p = 2.0 / (1.0 + exp_f32((two_sigma * D).clamp(-88.0, 88.0)))
    del D
    pair = dn.new_empty((2,) + dn.shape)  # lambdas, hessians
    zero = dn.new_zeros(())
    torch.where(cond, -dn * p, zero, out=pair[0])
    torch.where(cond, 2.0 * dn * p * (2.0 - p), zero, out=pair[1])
    del dn, p, cond
    as_high, as_low = xla_sum(pair, 3), xla_sum(pair, 2)
    del pair
    lam_r = as_high[0] - as_low[0]  # high gets +, low gets -
    hes_r = as_high[1] + as_low[1]
    # back to slot order
    return (torch.empty_like(lam_r).scatter_(1, order, lam_r),
            torch.empty_like(hes_r).scatter_(1, order, hes_r))

