"""Dataset metadata: labels, weights, query boundaries, init scores.

Mirrors the reference ``Metadata`` (include/LightGBM/dataset.h:36-247,
src/io/metadata.cpp): side files ``<data>.weight``, ``<data>.query``,
``<data>.init`` are auto-loaded next to the data file
(metadata.cpp:380-476); query sizes are converted to cumulative
boundaries; query weights are means of member weights.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class Metadata:
    def __init__(
        self,
        label: Optional[np.ndarray] = None,
        weights: Optional[np.ndarray] = None,
        query_boundaries: Optional[np.ndarray] = None,
        init_score: Optional[np.ndarray] = None,
    ):
        self.label = None if label is None else np.asarray(label, dtype=np.float32)
        self.weights = None if weights is None else np.asarray(weights, dtype=np.float32)
        self.query_boundaries = (
            None if query_boundaries is None else np.asarray(query_boundaries, dtype=np.int64)
        )
        self.init_score = (
            None if init_score is None else np.asarray(init_score, dtype=np.float64)
        )
        self.query_weights: Optional[np.ndarray] = None
        self._finish()

    # ------------------------------------------------------------------
    def _finish(self) -> None:
        if self.query_boundaries is not None and self.weights is not None:
            qb = self.query_boundaries
            # per-query weight = mean of member weights (metadata.cpp:95-105)
            sums = np.add.reduceat(self.weights, qb[:-1])
            self.query_weights = (sums / np.maximum(np.diff(qb), 1)).astype(np.float32)

    @property
    def num_data(self) -> int:
        return 0 if self.label is None else len(self.label)

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None else len(self.query_boundaries) - 1

    def set_field(self, name: str, data) -> None:
        if data is not None:
            data = np.asarray(data)
        if name == "label":
            self.label = None if data is None else data.astype(np.float32)
        elif name == "weight":
            self.weights = None if data is None else data.astype(np.float32)
        elif name == "init_score":
            self.init_score = None if data is None else data.astype(np.float64)
        elif name == "group" or name == "query":
            if data is None:
                self.query_boundaries = None
            else:
                data = data.astype(np.int64)
                if len(data) and data[0] == 0 and np.all(np.diff(data) >= 0):
                    # already boundaries
                    self.query_boundaries = data
                else:  # group sizes -> boundaries (metadata.cpp:437-453)
                    self.query_boundaries = np.concatenate(
                        [[0], np.cumsum(data)]
                    ).astype(np.int64)
        else:
            raise ValueError(f"Unknown field {name!r}")
        self._finish()

    def get_field(self, name: str):
        if name == "label":
            return self.label
        if name == "weight":
            return self.weights
        if name == "init_score":
            return self.init_score
        if name in ("group", "query"):
            # group SIZES, matching what callers set and what custom
            # objectives expect; boundaries stay internal
            if self.query_boundaries is None:
                return None
            return np.diff(self.query_boundaries)
        raise ValueError(f"Unknown field {name!r}")

    def subset(self, indices: np.ndarray) -> "Metadata":
        """Row subset (used by bagging-by-subset and Dataset.Subset).

        Query boundaries are remapped to the selected rows, dropping
        now-empty queries (reference Metadata::Init(fullset, used_indices),
        metadata.cpp:48-110)."""
        indices = np.asarray(indices)
        lab = None if self.label is None else self.label[indices]
        w = None if self.weights is None else self.weights[indices]
        ini = None
        if self.init_score is not None:
            ncls = len(self.init_score) // max(self.num_data, 1)
            ini = (
                self.init_score.reshape(ncls, -1)[:, indices].reshape(-1)
                if ncls > 1
                else self.init_score[indices]
            )
        qb = None
        if self.query_boundaries is not None:
            # per-row query id, then boundary rebuild over the kept rows
            qid = np.searchsorted(self.query_boundaries, indices, side="right") - 1
            if len(qid) and np.any(np.diff(qid) < 0):
                raise ValueError("subset indices must be sorted for query data")
            per_query = np.bincount(qid, minlength=self.num_queries)
            sizes = per_query[per_query > 0]
            qb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        return Metadata(lab, w, qb, ini)

    # ------------------------------------------------------------- side files
    @staticmethod
    def load_side_files(data_path: str) -> dict:
        """Auto-load <data>.weight/.query/.init if present
        (metadata.cpp:380-476)."""
        out = {}
        wpath = data_path + ".weight"
        if os.path.exists(wpath):
            out["weights"] = np.loadtxt(wpath, dtype=np.float32).reshape(-1)
        qpath = data_path + ".query"
        if os.path.exists(qpath):
            sizes = np.loadtxt(qpath, dtype=np.int64).reshape(-1)
            out["query_boundaries"] = np.concatenate([[0], np.cumsum(sizes)])
        ipath = data_path + ".init"
        if os.path.exists(ipath):
            out["init_score"] = np.loadtxt(ipath, dtype=np.float64).reshape(-1)
        return out
