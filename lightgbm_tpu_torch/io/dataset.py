"""Binned dataset: the column store the port trains on.

Counterpart of lightgbm_tpu/io/dataset.py for the in-memory matrix path
(``from_matrix`` / ``align_with``) and row subsets (``subset``).
Binning is host numpy — the same BinMapper code and the same
shared-seed sample draw as the JAX package, so the bin matrix and the
bin boundaries are bitwise equal to it.  The
device-side form is the feature-major ``[F, n]`` uint8/uint16 tensor
(``bins_T``), uploaded once per device and cached on the dataset.

File loading, CSR/sparse storage and the binary cache are not part of
this slice (ROADMAP queue A).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from .binner import BinMapper, CATEGORICAL, NUMERICAL, find_bin_mappers
from .metadata import Metadata


def _encode_bins(X: np.ndarray, used_map: np.ndarray,
                 mappers: List[BinMapper], X_bin: np.ndarray) -> None:
    """``X_bin[:, inner] = mappers[inner].value_to_bin(X[:, orig])`` for
    every used column (Feature::PushData, feature.h:79-85)."""
    for orig, inner in enumerate(used_map):
        if inner >= 0:
            X_bin[:, inner] = mappers[inner].value_to_bin(X[:, orig])


def _sample_row_indices(n: int, config: Config) -> np.ndarray:
    """The shared-seed bin-construction sample (config.h:108): the same
    draw as lightgbm_tpu/io/dataset.py, so bin mappers match it."""
    cnt = min(n, int(config.bin_construct_sample_cnt))
    rng = np.random.RandomState(config.data_random_seed)
    if cnt >= n:
        return np.arange(n)
    return np.sort(rng.choice(n, size=cnt, replace=False))


class BinnedDataset:
    """Columns binned to integers + metadata."""

    def __init__(self, X_bin: np.ndarray, bin_mappers: List[BinMapper],
                 used_feature_map: np.ndarray, num_total_features: int,
                 metadata: Metadata,
                 feature_names: Optional[List[str]] = None):
        if X_bin.ndim != 2 or X_bin.shape[1] != len(bin_mappers):
            raise ValueError("X_bin must be [n, len(bin_mappers)]")
        self.X_bin = X_bin  # [n, F_used] uint8/uint16, host
        self.bin_mappers = bin_mappers
        self.used_feature_map = used_feature_map
        self.num_total_features = int(num_total_features)
        self.metadata = metadata
        self.feature_names = feature_names or [
            f"Column_{i}" for i in range(num_total_features)]
        self._bins_T = {}  # device -> [F, n] tensor

    # ---------------------------------------------------------------- props
    def bins_T(self, device: torch.device) -> torch.Tensor:
        """Feature-major ``[F, n]`` bins on ``device`` (the counterpart of
        ``dense_bins_T_device``), uploaded once and cached."""
        device = torch.device(device)
        key = str(device)
        if key not in self._bins_T:
            host = torch.from_numpy(np.ascontiguousarray(self.X_bin.T))
            self._bins_T[key] = host.to(device)
        return self._bins_T[key]

    @property
    def num_data(self) -> int:
        return self.X_bin.shape[0]

    @property
    def num_features(self) -> int:
        return self.X_bin.shape[1]

    @property
    def num_bins_per_feature(self) -> np.ndarray:
        return np.array([m.num_bin for m in self.bin_mappers], dtype=np.int32)

    @property
    def max_num_bin(self) -> int:
        return int(self.num_bins_per_feature.max()) if self.num_features else 1

    @property
    def is_categorical(self) -> np.ndarray:
        return np.array([m.bin_type == CATEGORICAL for m in self.bin_mappers],
                        dtype=bool)

    @property
    def real_feature_indices(self) -> np.ndarray:
        out = np.full(self.num_features, -1, dtype=np.int64)
        for orig, inner in enumerate(self.used_feature_map):
            if inner >= 0:
                out[inner] = orig
        return out

    # ------------------------------------------------------------ construct
    @staticmethod
    def from_matrix(X: np.ndarray, metadata: Metadata,
                    config: Optional[Config] = None,
                    categorical_features: Sequence[int] = (),
                    feature_names: Optional[List[str]] = None
                    ) -> "BinnedDataset":
        """Bin a dense feature matrix (trivial single-bin columns dropped,
        tracked through ``used_feature_map``, dataset.h:286-307)."""
        config = config or Config()
        X = np.ascontiguousarray(X, dtype=np.float64)
        n, f_total = X.shape
        bad = [c for c in categorical_features if not 0 <= int(c) < f_total]
        if bad:
            raise ValueError(
                f"categorical_feature indices out of range: {bad} "
                f"(num_features={f_total})")
        sample_idx = _sample_row_indices(n, config)
        mappers_all = find_bin_mappers(
            X[sample_idx], total_sample_cnt=len(sample_idx),
            max_bin=config.max_bin,
            categorical_features=categorical_features)
        used_map = np.full(f_total, -1, dtype=np.int64)
        used: List[BinMapper] = []
        for j, m in enumerate(mappers_all):
            if not m.is_trivial:
                used_map[j] = len(used)
                used.append(m)
        max_nb = max((m.num_bin for m in used), default=1)
        if max_nb > 65536:
            raise ValueError(
                f"a feature produced {max_nb} bins; max 65536 bins per "
                "feature (uint16 storage) are supported")
        dtype = np.uint8 if max_nb <= 256 else np.uint16
        X_bin = np.empty((n, len(used)), dtype=dtype)
        _encode_bins(X, used_map, used, X_bin)
        return BinnedDataset(X_bin, used, used_map, f_total, metadata,
                             feature_names)

    def align_with(self, X: np.ndarray, metadata: Metadata) -> "BinnedDataset":
        """Bin another raw matrix with THIS dataset's mappers (valid set
        alignment, dataset_loader.cpp:223-264)."""
        X = np.ascontiguousarray(X, dtype=np.float64)
        n, f_total = X.shape
        if f_total < self.num_total_features:
            X = np.hstack([X, np.zeros((n, self.num_total_features - f_total))])
        X_bin = np.empty((n, self.num_features), dtype=self.X_bin.dtype)
        _encode_bins(X, self.used_feature_map, self.bin_mappers, X_bin)
        return BinnedDataset(X_bin, self.bin_mappers, self.used_feature_map,
                             self.num_total_features, metadata,
                             self.feature_names)

    def subset(self, indices: np.ndarray) -> "BinnedDataset":
        """The rows ``indices``, sharing this dataset's bin mappers
        (Dataset::Subset, dataset.cpp:59; the JAX package's
        io/dataset.py:933)."""
        indices = np.asarray(indices)
        return BinnedDataset(self.X_bin[indices], self.bin_mappers,
                             self.used_feature_map, self.num_total_features,
                             self.metadata.subset(indices),
                             self.feature_names)

    def check_align(self, other: "BinnedDataset") -> bool:
        """Valid-data bin compatibility (Dataset::CheckAlign)."""
        if other.num_features != self.num_features:
            return False
        return all(a.num_bin == b.num_bin
                   for a, b in zip(self.bin_mappers, other.bin_mappers))

    def bin_thresholds_real(self) -> List[np.ndarray]:
        """Per-feature real-valued threshold of each bin (tree.cpp:70)."""
        return [m.bin_upper_bound if m.bin_type == NUMERICAL
                else np.asarray(m.bin_to_category, dtype=np.float64)
                for m in self.bin_mappers]
