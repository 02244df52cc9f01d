"""SplitInfo exchange shared by the sharded-search learners.

Counterpart of lightgbm_tpu/parallel/split_comm.py.  The reference
ships one fixed-size SplitInfo buffer through Network::Allreduce with a
deterministic MaxReducer (split_info.hpp:58-104,
feature_parallel_tree_learner.cpp:64-77).  Here the eleven fields of a
SplitResult (ops/split.py) are packed into one float tensor, all-gathered
in one collective and reduced with the reference's order: the larger
gain, ties to the smaller feature index.  The packed form is the
search's own dtype (float32, or float64 under hist_dtype=float64);
feature and threshold are below 2**24, so they are exact in float32.
The search kernels' [.., 16] rows carry the same eleven fields first, so
``rows[..., :11]`` is already the packed form.
"""

from __future__ import annotations

import torch

from ..ops.split import SplitResult

_INT_MAX = 2 ** 31 - 1
NFIELDS = len(SplitResult._fields)
_F_FEATURE = SplitResult._fields.index("feature")
_F_THRESH = SplitResult._fields.index("threshold")


def pack_split(r: SplitResult) -> torch.Tensor:
    """``[..., 11]`` transport form in the gain's dtype."""
    ft = r.gain.dtype
    return torch.stack([torch.as_tensor(f).to(ft) for f in r], dim=-1)


def unpack_split(a: torch.Tensor) -> SplitResult:
    fields = [a[..., i] for i in range(NFIELDS)]
    fields[_F_FEATURE] = fields[_F_FEATURE].to(torch.int32)
    fields[_F_THRESH] = fields[_F_THRESH].to(torch.int32)
    return SplitResult(*fields)


def combine_packed(g: torch.Tensor) -> torch.Tensor:
    """Reduce all-gathered packed rows ``[D, ..., >= 11]`` over the
    leading rank axis: per trailing position the row of the largest
    gain, ties to the smallest non-negative feature, then to the lowest
    rank (split_info.hpp:98-103)."""
    gain, feat = g[..., 0], g[..., _F_FEATURE]
    feats = torch.where(feat < 0, torch.full_like(feat, _INT_MAX), feat)
    tied = gain == gain.max(dim=0, keepdim=True).values
    key = torch.where(tied, feats, torch.full_like(feats, _INT_MAX))
    # argmin's first minimum: the lowest rank among equal keys
    winner = torch.argmin(key, dim=0, keepdim=True)
    idx = winner.unsqueeze(-1).expand((1,) + tuple(g.shape[1:]))
    return torch.gather(g, 0, idx)[0]


def combine_gathered_split_infos(g: SplitResult) -> SplitResult:
    """The SplitResult form of ``combine_packed`` (a leading rank axis
    on every field)."""
    return unpack_split(combine_packed(pack_split(g)))


def gather_and_combine(r: SplitResult, mesh, site: str = None
                       ) -> SplitResult:
    """One packed all-gather over ``mesh`` + the deterministic max."""
    return unpack_split(combine_packed(mesh.all_gather(pack_split(r),
                                                       site=site)))


def gather_rows(rows: torch.Tensor, start: int, mesh, site: str = None
                ) -> torch.Tensor:
    """A shard search's packed rows (its features from ``start`` on), with
    global feature ids, gathered over ``mesh`` and combined: the winners'
    ``[..., 11]`` rows, the same on every rank."""
    rows = rows[..., :NFIELDS].clone()
    f = rows[..., _F_FEATURE]
    rows[..., _F_FEATURE] = torch.where(f >= 0, f + start, f)
    return combine_packed(mesh.all_gather(rows, site=site))
