"""Distributed data loading: each rank's row partition and bin finding
sharded by feature.

Counterpart of lightgbm_tpu/io/distributed.py, itself the reference's
distributed loader (src/io/dataset_loader.cpp):

* **Row partition at load** (dataset_loader.cpp:500-605,
  ``is_pre_partition=false``): every rank reads the same file and keeps
  the rows a shared-seed RNG assigns to it, query by query for ranking
  data, so no query is split across ranks.
* **Bin finding sharded by feature** (dataset_loader.cpp:692-755): each
  rank fits the BinMappers of its contiguous feature shard from the
  shared sample, and the mappers are all-gathered (``BinMapper.to_dict``
  JSON through ``all_gather_object`` over the ``torch.distributed``
  world), so every rank ends with every feature's mapper.

Host numpy by design: binning happens once at ingest.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np

from .binner import BinMapper, find_bin_mappers


def partition_rows(num_rows: int, rank: int, num_machines: int, seed: int,
                   query_boundaries: Optional[np.ndarray] = None
                   ) -> np.ndarray:
    """Row indices this rank keeps (dataset_loader.cpp:500-605): every
    rank draws the same RNG stream, so the assignment agrees without
    communication.  With ``query_boundaries`` whole queries are assigned
    (dataset_loader.cpp:560-605)."""
    rng = np.random.RandomState(seed)
    if query_boundaries is not None:
        qb = np.asarray(query_boundaries)
        owner = rng.randint(0, num_machines, size=len(qb) - 1)
        keep_q = np.nonzero(owner == rank)[0]
        if not len(keep_q):
            return np.empty(0, np.int64)
        return np.concatenate([np.arange(qb[q], qb[q + 1])
                               for q in keep_q]).astype(np.int64)
    owner = rng.randint(0, num_machines, size=num_rows)
    return np.nonzero(owner == rank)[0].astype(np.int64)


def shard_features(num_features: int, num_machines: int) -> List[np.ndarray]:
    """Contiguous feature shards, one a rank (the reference balances them
    by bin count, dataset_loader.cpp:697-716)."""
    bounds = np.linspace(0, num_features, num_machines + 1).astype(np.int64)
    return [np.arange(bounds[r], bounds[r + 1]) for r in range(num_machines)]


def world_gather(payload: str) -> List[str]:
    """Every rank's ``payload`` in rank order over the default process
    group; the payload alone where no group of more than one rank is up."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return [payload]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, payload)
    return out


def distributed_find_bin_mappers(
        sample_local: np.ndarray, rank: int, num_machines: int,
        max_bin: int = 256, categorical_features: Sequence[int] = (),
        total_sample_cnt: Optional[int] = None) -> List[BinMapper]:
    """The mappers of every feature, each rank fitting only its feature
    shard's from ``sample_local`` (dataset_loader.cpp:692-755), exchanged
    through ``world_gather``."""
    F = sample_local.shape[1]
    shards = shard_features(F, num_machines)
    mine = shards[rank]
    cats = set(int(c) for c in categorical_features)
    local = find_bin_mappers(
        sample_local[:, mine] if len(mine) else sample_local[:, :0],
        total_sample_cnt=total_sample_cnt or len(sample_local),
        max_bin=max_bin,
        categorical_features=[i for i, j in enumerate(mine) if int(j) in cats])
    payload = json.dumps({"rank": rank,
                          "mappers": [m.to_dict() for m in local]})
    gathered = [json.loads(s) for s in world_gather(payload)]
    if len(gathered) == 1 and num_machines == 1:
        return local
    by_rank = {g["rank"]: g["mappers"] for g in gathered}
    if len(by_rank) != num_machines:
        raise RuntimeError(f"distributed bin finding expected {num_machines} "
                           f"payloads, got ranks {sorted(by_rank)}")
    out: List[Optional[BinMapper]] = [None] * F
    for r in range(num_machines):
        for i, j in enumerate(shards[r]):
            out[int(j)] = BinMapper.from_dict(by_rank[r][i])
    return out  # type: ignore[return-value]
