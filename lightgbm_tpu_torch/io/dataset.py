"""Binned dataset: the column store the port trains on.

Counterpart of lightgbm_tpu/io/dataset.py.  Binning is host numpy: the
same BinMapper code and the same shared-seed sample draw as the JAX
package, so the bin matrix and the bin boundaries are bitwise equal to
it.  Storage is the dense ``[n, F_used]`` uint8/uint16 matrix, or for
sparse input (LibSVM files, scipy CSR) with density below 0.2 the binned
CSR structure ``SparseBins`` (io/sparse.py).

Loading (DatasetLoader::LoadFromFile, dataset_loader.cpp:162): parse
text -> resolve column roles (label, weight, group, ignore and
categorical columns, by index or ``name:``) -> sample rows -> find the
BinMappers -> encode every row.  ``use_two_round_loading`` streams the
file twice instead (``_from_file_streaming``), LibSVM files stream into
CSR (``_from_libsvm_sparse``), and the side files ``<data>.weight``,
``.query`` and ``.init`` are read beside the data (io/metadata.py).
Valid sets are encoded with the training set's mappers.  A binary cache
(``save_binary`` / ``load_binary``, ``<data>.bin`` under
``is_save_binary_file`` / ``enable_load_from_binary_file``) skips parse
and binning; its npz format is the JAX package's, so a cache written by
either package loads in the other.

On the device the dataset gives the feature-major dense bins ``bins_T``
(the routing bins of every learner; the counterpart of
``dense_bins_T_device``) and, for sparse storage, the CSR entries
regrouped by feature (``sparse_device``, the input of kernel S1).  Both
are built once per device and cached on the dataset.

``from_jax_arrays`` carries a JAX ``BinnedDataset`` across through its
numpy fields.  With ``num_machines > 1`` (and ``is_pre_partition=false``)
under a ``torch.distributed`` world of that size, ``from_file`` keeps the
rank's partition of the rows (io/distributed.py); the parallel learners
then train on it.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..config import Config
from ..log import Log
from ..obs import telemetry
from .binner import BinMapper, CATEGORICAL, NUMERICAL, find_bin_mappers
from .metadata import Metadata
from .parser import ParseError, parse_file
from .sparse import SparseBins

BINARY_MAGIC = "lightgbm_tpu_binned_dataset_v1"

_SIDE = ("weights", "query_boundaries", "init_score")


def _distributed_rank(config: Config) -> Optional[int]:
    """This process's rank where ``num_machines > 1`` asks for a
    partitioned load (``is_pre_partition=false``), else None.  The load
    needs a ``torch.distributed`` world of exactly ``num_machines``
    ranks; without one it is refused: bringing a world up from a
    machine list is ROADMAP A8 step 3."""
    if config.num_machines <= 1 or config.is_pre_partition:
        return None
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    if not up or dist.get_world_size() != config.num_machines:
        raise NotImplementedError(
            f"distributed loading with num_machines={config.num_machines} "
            "needs a torch.distributed world of that many ranks (e.g. "
            "torchrun); starting one from a machine list is not ported to "
            "lightgbm_tpu_torch yet (ROADMAP queue A8 step 3)")
    return dist.get_rank()


def _finite_label_mask(label_col: np.ndarray, config: Config, path: str,
                       has_side_rows: bool = False) -> Optional[np.ndarray]:
    """Rows with non-finite labels are a counted, logged skip (telemetry
    ``bad_rows``).  Returns the keep mask, or None when every label is
    finite.  ``strict_data=true`` raises; so do row-aligned side files
    (weights/query/init_score), which a skipped row would desynchronize."""
    bad = ~np.isfinite(np.asarray(label_col, np.float64))
    n_bad = int(bad.sum())
    if n_bad == 0:
        return None
    msg = (f"{path}: {n_bad} row(s) with non-finite labels "
           f"(first at data row {int(np.argmax(bad))})")
    if config.strict_data:
        raise ParseError(msg + " (strict_data=true)")
    if has_side_rows:
        raise ParseError(
            msg + " — cannot skip rows: row-aligned side files "
            "(.weight/.query/.init) would desynchronize. Clean the data "
            "or regenerate the side files.")
    telemetry.count("bad_rows", n_bad)
    Log.warning(msg + "; skipping them (strict_data=false)")
    return ~bad


def _feature_major(sb: SparseBins, device) -> torch.Tensor:
    """``sb.toarray().T`` built on ``device``: each feature's row filled
    with its default bin, then every stored entry written at (feature,
    row).  16-bit bins move as int16, the same bits: CUDA scatters no
    uint16."""
    n, f = sb.shape
    dev = torch.device(device)
    wide = sb.dtype == np.uint16

    def tensor(a):
        a = np.ascontiguousarray(a, sb.dtype)
        return torch.from_numpy(a.view(np.int16) if wide else a).to(dev)

    out = tensor(sb.default_bins)[:, None].repeat(1, n)
    rows = torch.repeat_interleave(
        torch.arange(n, device=dev),
        torch.from_numpy(np.diff(sb.indptr)).to(dev))
    cols = torch.from_numpy(sb.col).to(dev).to(torch.int64)
    out.view(-1)[cols * n + rows] = tensor(sb.bin)
    return out.view(torch.uint16) if wide else out


def _has_side_rows(side: dict) -> bool:
    return any(side.get(k) is not None for k in _SIDE)


ENCODE_THREADS = 8  # host threads that bin columns at once
ENCODE_POOL_ROWS = 1 << 16  # fewer rows are binned on the calling thread


def _encode_bins(X: np.ndarray, used_map: np.ndarray,
                 mappers: List[BinMapper], X_bin: np.ndarray) -> None:
    """``X_bin[:, inner] = mappers[inner].value_to_bin(X[:, orig])`` for
    every used column (Feature::PushData, feature.h:79-85).  Numerical
    columns go through the native encoder (one OpenMP pass over the rows,
    bitwise ``value_to_bin``) unless ``LIGHTGBM_TPU_NO_NATIVE`` is set.
    The other columns, on large inputs, are binned on a pool of threads
    (numpy's searchsorted releases the GIL); each column is written by one
    thread, so the bins do not depend on the pool."""
    with telemetry.span("load.encode"):
        _encode_columns(X, used_map, mappers, X_bin)


def _encode_columns(X, used_map, mappers, X_bin) -> None:
    cols = [(orig, inner) for orig, inner in enumerate(used_map)
            if inner >= 0]
    if native.enabled():
        num = [(o, i) for o, i in cols if mappers[i].bin_type == NUMERICAL]
        cols = [(o, i) for o, i in cols if mappers[i].bin_type != NUMERICAL]
        if num:
            orig, inner = (np.asarray(c, np.int64) for c in zip(*num))
            direct = (X_bin.flags.c_contiguous
                      and np.array_equal(inner, np.arange(X_bin.shape[1])))
            out = X_bin if direct else np.empty((len(X), len(num)),
                                                X_bin.dtype)
            native.value_to_bin_numerical(
                np.ascontiguousarray(X, np.float64), orig,
                [mappers[i].bin_upper_bound[:mappers[i].num_bin]
                 for i in inner], out)
            if not direct:
                X_bin[:, inner] = out

    def encode(col):
        orig, inner = col
        X_bin[:, inner] = mappers[inner].value_to_bin(X[:, orig])

    if len(X) < ENCODE_POOL_ROWS or len(cols) < 2:
        for col in cols:
            encode(col)
        return
    with ThreadPoolExecutor(min(ENCODE_THREADS, len(cols))) as pool:
        list(pool.map(encode, cols))


def _timed_chunks(chunks):
    """``chunks`` with each chunk's parse timed (span ``load.parse``)."""
    while True:
        with telemetry.span("load.parse"):
            chunk = next(chunks, None)
        if chunk is None:
            return
        yield chunk


def _sample_row_indices(n: int, config: Config) -> np.ndarray:
    """The shared-seed bin-construction sample (config.h:108): the same
    draw as lightgbm_tpu/io/dataset.py, so bin mappers match it."""
    cnt = min(n, int(config.bin_construct_sample_cnt))
    rng = np.random.RandomState(config.data_random_seed)
    if cnt >= n:
        return np.arange(n)
    return np.sort(rng.choice(n, size=cnt, replace=False))


def _used(mappers_all: List[BinMapper]):
    """(used_feature_map, used mappers): trivial single-bin columns
    dropped (dataset.h:286-307)."""
    used_map = np.full(len(mappers_all), -1, dtype=np.int64)
    used: List[BinMapper] = []
    for j, m in enumerate(mappers_all):
        if not m.is_trivial:
            used_map[j] = len(used)
            used.append(m)
    return used_map, used


def _bin_dtype(mappers: List[BinMapper]):
    max_nb = max((m.num_bin for m in mappers), default=1)
    if max_nb > 65536:
        raise ValueError(
            f"a feature produced {max_nb} bins; max 65536 bins per "
            "feature (uint16 storage) are supported")
    return np.uint8 if max_nb <= 256 else np.uint16


def _resolve_roles(config: Config, names: Optional[List[str]]):
    """(label_col, ignore set, categorical cols, weight_col, group_col) in
    raw column space, weight and group added to the ignore set
    (dataset_loader.cpp:23-160)."""
    label_col = _resolve_column(config.label_column, names)
    if label_col is None:
        label_col = 0
    ignore = set(_resolve_column_list(config.ignore_column, names, label_col))
    cats = _resolve_column_list(config.categorical_column, names, label_col)
    weight_col = _resolve_column(config.weight_column, names, label_col)
    group_col = _resolve_column(config.group_column, names, label_col)
    if weight_col is not None:
        ignore.add(weight_col)
    if group_col is not None:
        ignore.add(group_col)
    return label_col, ignore, cats, weight_col, group_col


def _merge_api_categoricals(cat_inner, categorical_features, num_features):
    """Union API-level (feature-space) categorical declarations into the
    config-derived list; an index out of range raises."""
    if not categorical_features:
        return cat_inner
    bad = [c for c in categorical_features if not 0 <= int(c) < num_features]
    if bad:
        raise ValueError(
            f"categorical_feature indices out of range: {bad} "
            f"(num_features={num_features})")
    return sorted(set(cat_inner) | {int(c) for c in categorical_features})


def _resolve_column(spec: str, names: Optional[List[str]],
                    label_col: Optional[int] = None) -> Optional[int]:
    """'name:foo' or an integer string -> a RAW column index.  Numeric
    weight/group/ignore/categorical specs are feature-space in the
    reference (the label removed, parser.hpp:28-33); ``label_col``
    converts them.  The label spec itself resolves raw."""
    if spec is None or spec == "":
        return None
    if spec.startswith("name:"):
        if names is None:
            raise ValueError("column given by name but data has no header")
        return names.index(spec[5:])
    v = int(spec)
    if label_col is not None and v >= label_col:
        v += 1
    return v


def _resolve_column_list(spec: str, names: Optional[List[str]],
                         label_col: Optional[int] = None) -> List[int]:
    """List form of :func:`_resolve_column`."""
    if not spec:
        return []
    if spec.startswith("name:"):
        if names is None:
            raise ValueError("columns given by name but data has no header")
        return [names.index(s) for s in spec[5:].split(",")]
    out = [int(s) for s in spec.replace(",", " ").split()]
    if label_col is not None:
        out = [v if v < label_col else v + 1 for v in out]
    return out


def _group_boundaries(gid: np.ndarray, n: int) -> np.ndarray:
    """Contiguous group ids -> query boundaries."""
    change = np.nonzero(np.diff(gid))[0] + 1
    return np.concatenate([[0], change, [n]])


def _csr_rows_kept(indptr, indices, values, keep_entries):
    """The CSR with only the entries ``keep_entries`` (rows kept)."""
    n = len(indptr) - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    rows, indices, values = (rows[keep_entries], indices[keep_entries],
                             values[keep_entries])
    row_lens = np.bincount(rows, minlength=n)
    return (np.concatenate([[0], np.cumsum(row_lens, dtype=np.int64)]),
            indices, values)


class BinnedDataset:
    """Columns binned to integers + metadata."""

    def __init__(self, X_bin, bin_mappers: List[BinMapper],
                 used_feature_map: np.ndarray, num_total_features: int,
                 metadata: Metadata,
                 feature_names: Optional[List[str]] = None):
        if len(X_bin.shape) != 2 or X_bin.shape[1] != len(bin_mappers):
            raise ValueError("X_bin must be [n, len(bin_mappers)]")
        # [n, F_used] uint8/uint16 host matrix, or SparseBins
        self.X_bin = X_bin
        self.bin_mappers = bin_mappers
        self.used_feature_map = np.asarray(used_feature_map)
        self.num_total_features = int(num_total_features)
        self.metadata = metadata
        self.feature_names = feature_names or [
            f"Column_{i}" for i in range(num_total_features)]
        self._bins_T: Dict[str, torch.Tensor] = {}
        self._sparse_dev: Dict[str, dict] = {}
        # the rank whose partition of a file this is (a load with
        # num_machines > 1), None for whole data
        self.partition_rank: Optional[int] = None

    def _mark_partition(self, rank: Optional[int]) -> "BinnedDataset":
        self.partition_rank = rank
        return self

    # ---------------------------------------------------------------- props
    @property
    def is_sparse(self) -> bool:
        return not isinstance(self.X_bin, np.ndarray)

    @property
    def density(self) -> float:
        """Stored entries over n * F_used (1.0 for dense storage)."""
        if not self.is_sparse:
            return 1.0
        return self.X_bin.nnz / max(1, self.num_data * self.num_features)

    def dense_bins(self) -> np.ndarray:
        """The dense [n, F_used] binned matrix, built on demand for sparse
        storage (trivial columns are already dropped)."""
        return self.X_bin.toarray() if self.is_sparse else self.X_bin

    def bins_T(self, device) -> torch.Tensor:
        """Feature-major ``[F, n]`` dense bins on ``device`` (the
        counterpart of ``dense_bins_T_device``): the routing bins of every
        learner, built once and cached.  Sparse storage fills them on
        ``device`` from the stored entries, with no dense host copy."""
        key = str(torch.device(device))
        if key not in self._bins_T:
            if self.is_sparse:
                self._bins_T[key] = _feature_major(self.X_bin, device)
            else:
                host = torch.from_numpy(np.ascontiguousarray(self.X_bin.T))
                self._bins_T[key] = host.to(device)
        return self._bins_T[key]

    def sparse_device(self, device) -> dict:
        """The CSR entries regrouped by feature on ``device``, rows
        ascending within a feature (a CSC copy, built once and cached):
        ``col_ptr`` int64 [F+1], ``row`` int32 [nnz], ``bin`` uint8/uint16
        [nnz], ``default_bins`` int32 [F] (ops/sparse_hist.py)."""
        if not self.is_sparse:
            raise ValueError("sparse_device needs sparse storage")
        key = str(torch.device(device))
        if key not in self._sparse_dev:
            from ..ops.sparse_hist import csc_from_csr, segment_entries

            sb = self.X_bin
            self._sparse_dev[key] = csc_from_csr(
                sb.indptr, sb.col, sb.bin, sb.default_bins, sb.shape[1],
                device, segment_entries(self.max_num_bin))
        return self._sparse_dev[key]

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
                    feature_names: Optional[List[str]] = None,
                    mappers_all: Optional[List[BinMapper]] = None
                    ) -> "BinnedDataset":
        """Bin a dense feature matrix.  ``mappers_all`` (one BinMapper per
        column) skips bin finding."""
        config = config or Config()
        X = np.ascontiguousarray(X, dtype=np.float64)
        n, f_total = X.shape
        bad = [c for c in categorical_features if not 0 <= int(c) < f_total]
        if bad:
            raise ValueError(
                f"categorical_feature indices out of range: {bad} "
                f"(num_features={f_total})")
        if mappers_all is None:
            with telemetry.span("load.bin_find"):
                sample_idx = _sample_row_indices(n, config)
                mappers_all = find_bin_mappers(
                    X[sample_idx], total_sample_cnt=len(sample_idx),
                    max_bin=config.max_bin,
                    categorical_features=categorical_features)
        if len(mappers_all) != f_total:
            raise ValueError(f"mappers_all covers {len(mappers_all)} "
                             f"columns, data has {f_total}")
        used_map, used = _used(mappers_all)
        X_bin = np.empty((n, len(used)), dtype=_bin_dtype(used))
        _encode_bins(X, used_map, used, X_bin)
        return BinnedDataset(X_bin, used, used_map, f_total, metadata,
                             feature_names)

    @staticmethod
    def from_csr(indptr: np.ndarray, indices: np.ndarray, values: np.ndarray,
                 num_cols: int, metadata: Metadata,
                 config: Optional[Config] = None,
                 categorical_features: Sequence[int] = (),
                 feature_names: Optional[List[str]] = None,
                 mappers_all: Optional[List[BinMapper]] = None,
                 keep_sparse: Optional[bool] = None) -> "BinnedDataset":
        """Bin a CSR matrix in O(nnz) memory: mappers from a sampled row
        subset with elided zeros counted (bin.cpp:48-85), then every stored
        entry encoded in place.  Storage stays CSR when density < 0.2 and
        ``is_enable_sparse`` (``keep_sparse`` overrides), else dense."""
        from .sparse import encode_csr_bins, find_bin_mappers_csr

        config = config or Config()
        n = len(indptr) - 1
        if mappers_all is None:
            sample_idx = _sample_row_indices(n, config)
            mappers_all = find_bin_mappers_csr(
                indptr, indices, values, num_cols, sample_idx,
                max_bin=config.max_bin,
                categorical_features=categorical_features)
        used_map, used = _used(mappers_all)
        _bin_dtype(used)
        sb = encode_csr_bins(indptr, indices, values, used_map, used)
        density = sb.nnz / float(max(n, 1) * max(len(used), 1))
        if keep_sparse is None:
            # is_enable_sparse=false forces dense storage (config.h:104)
            keep_sparse = config.is_enable_sparse and density < 0.2
        return BinnedDataset(sb if keep_sparse else sb.toarray(), used,
                             used_map, num_cols, metadata, feature_names)

    def align_with(self, X: np.ndarray, metadata: Metadata) -> "BinnedDataset":
        """Bin another raw matrix with THIS dataset's mappers (valid set
        alignment, dataset_loader.cpp:223-264)."""
        X = np.ascontiguousarray(X, dtype=np.float64)
        n, f_total = X.shape
        if f_total < self.num_total_features:
            X = np.hstack([X, np.zeros((n, self.num_total_features - f_total))])
        X_bin = np.empty((n, self.num_features),
                         dtype=_bin_dtype(self.bin_mappers))
        _encode_bins(X, self.used_feature_map, self.bin_mappers, X_bin)
        return BinnedDataset(X_bin, self.bin_mappers, self.used_feature_map,
                             self.num_total_features, metadata,
                             self.feature_names)

    def align_with_csr(self, indptr: np.ndarray, indices: np.ndarray,
                       values: np.ndarray, metadata: Metadata,
                       keep_sparse: Optional[bool] = None
                       ) -> "BinnedDataset":
        """Sparse counterpart of ``align_with``: bin CSR rows with THIS
        dataset's mappers in O(nnz)."""
        from .sparse import encode_csr_bins

        # entries in columns this dataset never saw map to no used feature
        in_range = indices < len(self.used_feature_map)
        if not in_range.all():
            indptr, indices, values = _csr_rows_kept(indptr, indices, values,
                                                     in_range)
        sb = encode_csr_bins(indptr, indices, values, self.used_feature_map,
                             self.bin_mappers)
        if keep_sparse is None:
            keep_sparse = self.is_sparse
        return BinnedDataset(sb if keep_sparse else sb.toarray(),
                             self.bin_mappers, self.used_feature_map,
                             self.num_total_features, metadata,
                             self.feature_names)

    @staticmethod
    def from_file(path: str, config: Optional[Config] = None,
                  reference: Optional["BinnedDataset"] = None,
                  categorical_features: Optional[Sequence[int]] = None
                  ) -> "BinnedDataset":
        """Load + bin a text data file, or its binary cache ``<path>.bin``
        (when ``enable_load_from_binary_file`` and no reference or API
        categorical declaration is given)."""
        config = config or Config()
        rank = _distributed_rank(config)
        bin_path = path + ".bin"
        if (config.enable_load_from_binary_file and os.path.exists(bin_path)
                and reference is None and not categorical_features
                and rank is None):
            try:
                with telemetry.span("load.binary_cache"):
                    ds = BinnedDataset.load_binary(bin_path)
            except (ValueError, KeyError, OSError) as e:
                Log.warning(f"{bin_path}: not a usable binary cache "
                            f"({type(e).__name__}: {e}); parsing {path}")
            else:
                if ds.is_sparse and not config.is_enable_sparse:
                    ds.X_bin = ds.dense_bins()
                return ds
        from .parser import detect_file_format

        fmt = detect_file_format(path, config.has_header)
        if (fmt == "libsvm" and not config.weight_column
                and not config.group_column):
            return BinnedDataset._from_libsvm_sparse(
                path, config, reference=reference,
                categorical_features=categorical_features, rank=rank)
        # auto-stream only for files too big to hold as f64 comfortably
        # (one machine's load: a partitioned load parses the whole file)
        want_stream = config.use_two_round_loading or (
            os.path.getsize(path) > (4 << 30))
        if want_stream and fmt != "libsvm" and rank is None:
            try:
                return BinnedDataset._from_file_streaming(
                    path, config, fmt, reference=reference,
                    categorical_features=categorical_features)
            except ParseError:
                raise
            except ValueError as e:
                # a malformed row mid-stream: the counted preallocation
                # cannot drop it, so the one-shot lenient load below takes
                # over (strict_data raises instead)
                if config.strict_data:
                    raise ParseError(
                        f"{path}: malformed rows in streaming load "
                        f"(strict_data=true): {type(e).__name__}: "
                        f"{str(e)[:200]}") from e
                Log.warning(
                    f"{path}: streaming parse failed ({type(e).__name__}: "
                    f"{str(e)[:120]}); falling back to one-shot lenient "
                    "load (malformed rows will be counted and skipped)")
        with telemetry.span("load.parse"):
            raw, names = parse_file(path, has_header=config.has_header,
                                    fmt=fmt, strict=config.strict_data)
        with telemetry.span("load.labels"):
            side = Metadata.load_side_files(path)
            label_col, ignore, cats, weight_col, group_col = _resolve_roles(
                config, names)
            keep = _finite_label_mask(raw[:, label_col], config, path,
                                      has_side_rows=_has_side_rows(side))
            if keep is not None:
                raw = raw[keep]
            n = raw.shape[0]
            weights = side.get("weights")
            if weight_col is not None:
                weights = raw[:, weight_col].astype(np.float32)
            qb = side.get("query_boundaries")
            if group_col is not None:
                qb = _group_boundaries(raw[:, group_col].astype(np.int64), n)
            feat_cols = [j for j in range(raw.shape[1])
                         if j != label_col and j not in ignore]
            fnames = ([names[j] for j in feat_cols] if names is not None
                      else [f"Column_{j}" for j in range(len(feat_cols))])
            cat_inner = _merge_api_categoricals(
                [feat_cols.index(c) for c in cats if c in feat_cols],
                categorical_features, len(feat_cols))
            meta = Metadata(label=raw[:, label_col].astype(np.float32),
                            weights=weights, query_boundaries=qb,
                            init_score=side.get("init_score"))
            X = raw[:, feat_cols]
        mappers_all = None
        if rank is not None:
            # the rank's rows (query by query for ranked data), and every
            # feature's mapper from the whole file's shared-seed sample,
            # each rank fitting its feature shard's (io/dataset.py:
            # 566-600)
            from .distributed import (distributed_find_bin_mappers,
                                      partition_rows)

            keep = partition_rows(n, rank, config.num_machines,
                                  seed=config.data_random_seed,
                                  query_boundaries=meta.query_boundaries)
            if reference is None:
                sample_idx = _sample_row_indices(n, config)
                mappers_all = distributed_find_bin_mappers(
                    X[sample_idx], rank, config.num_machines,
                    max_bin=config.max_bin, categorical_features=cat_inner,
                    total_sample_cnt=len(sample_idx))
            X = X[keep]
            meta = meta.subset(keep)
        if reference is not None:
            return reference.align_with(X, meta)._mark_partition(rank)
        ds = BinnedDataset.from_matrix(X, meta, config,
                                       categorical_features=cat_inner,
                                       feature_names=fnames,
                                       mappers_all=mappers_all)
        # the binary cache holds whole files only
        if config.is_save_binary_file and rank is None:
            ds.save_binary(bin_path)
        return ds._mark_partition(rank)

    @staticmethod
    def _from_file_streaming(path: str, config: Config, fmt: str,
                             reference: Optional["BinnedDataset"] = None,
                             chunk_rows: int = 200_000,
                             categorical_features: Optional[Sequence[int]]
                             = None) -> "BinnedDataset":
        """Two-round loading (use_two_round_loading, dataset_loader.cpp:
        181-209): round one streams the lines and parses only the
        bin-construction sample, round two streams again encoding each
        chunk into the preallocated binned matrix.  Peak memory is the
        binned matrix plus one text chunk.  The sample is the in-memory
        path's shared-seed draw over the counted rows, so the mappers (and
        trees) are bit-identical to one-shot loading."""
        from .parser import _read_head, count_data_rows, parse_file_chunks

        names: Optional[List[str]] = None
        if config.has_header:
            head = _read_head(path, 1)
            sep = "," if fmt == "csv" else None
            names = [s.strip() for s in head[0].strip().split(sep)]
        side = Metadata.load_side_files(path)
        with telemetry.span("load.parse"):  # a pass over the text
            n = count_data_rows(path, config.has_header)
        label_col, ignore, cats, weight_col, group_col = _resolve_roles(
            config, names)

        def features_of(width):
            return [j for j in range(width)
                    if j != label_col and j not in ignore]

        feat_cols: Optional[List[int]] = None
        if reference is None:
            # ---- round 1: stream chunks, parse only the sampled rows
            sample_idx = _sample_row_indices(n, config)
            buf: List[np.ndarray] = []
            for chunk in _timed_chunks(parse_file_chunks(
                    path, config.has_header, fmt, chunk_rows,
                    select=sample_idx)):
                if feat_cols is None:
                    feat_cols = features_of(chunk.shape[1])
                buf.append(chunk[:, feat_cols])
            cat_inner = _merge_api_categoricals(
                [feat_cols.index(c) for c in cats if c in feat_cols],
                categorical_features, len(feat_cols))
            with telemetry.span("load.bin_find"):
                mappers_all = find_bin_mappers(
                    np.vstack(buf), total_sample_cnt=len(sample_idx),
                    max_bin=config.max_bin, categorical_features=cat_inner)
            used_map, used_mappers = _used(mappers_all)
        else:
            used_map = reference.used_feature_map
            used_mappers = reference.bin_mappers

        # ---- round 2: stream again, encoding chunks into the binned matrix
        X_bin = np.empty((n, len(used_mappers)),
                         dtype=_bin_dtype(used_mappers))
        label = np.empty(n, np.float32)
        weights = np.empty(n, np.float32) if weight_col is not None else None
        gid = np.empty(n, np.int64) if group_col is not None else None
        offset = 0
        for chunk in _timed_chunks(parse_file_chunks(
                path, config.has_header, fmt, chunk_rows)):
            if feat_cols is None:
                feat_cols = features_of(chunk.shape[1])
            m_rows = len(chunk)
            with telemetry.span("load.labels"):
                X = chunk[:, feat_cols]
                if reference is not None and X.shape[1] < len(used_map):
                    X = np.hstack([X, np.zeros((m_rows, len(used_map)
                                                - X.shape[1]))])
                label[offset:offset + m_rows] = chunk[:, label_col]
                if weights is not None:
                    weights[offset:offset + m_rows] = chunk[:, weight_col]
                if gid is not None:
                    gid[offset:offset + m_rows] = chunk[:, group_col]
            _encode_bins(X, used_map, used_mappers,
                         X_bin[offset:offset + m_rows])
            offset += m_rows

        keep = _finite_label_mask(label, config, path,
                                  has_side_rows=_has_side_rows(side))
        if keep is not None:
            X_bin, label = X_bin[keep], label[keep]
            weights = weights[keep] if weights is not None else None
            gid = gid[keep] if gid is not None else None
            n = int(keep.sum())
        qb = side.get("query_boundaries")
        if gid is not None:
            qb = _group_boundaries(gid, n)
        meta = Metadata(
            label=label,
            weights=side.get("weights") if weights is None else weights,
            query_boundaries=qb, init_score=side.get("init_score"))
        if reference is not None:
            return BinnedDataset(X_bin, reference.bin_mappers,
                                 reference.used_feature_map,
                                 reference.num_total_features, meta,
                                 reference.feature_names)
        fnames = [names[j] for j in feat_cols] if names is not None else None
        ds = BinnedDataset(X_bin, used_mappers, used_map, len(feat_cols),
                           meta, fnames)
        if config.is_save_binary_file:
            ds.save_binary(path + ".bin")
        return ds

    @staticmethod
    def _from_libsvm_sparse(path: str, config: Config,
                            reference: Optional["BinnedDataset"] = None,
                            categorical_features: Optional[Sequence[int]]
                            = None, rank: Optional[int] = None
                            ) -> "BinnedDataset":
        """LibSVM ingest in O(nnz) memory: streamed CSR parse, sparse bin
        finding with elided zeros, in-place bin encoding.  Numeric
        ``ignore_column`` / ``categorical_column`` specs are feature
        indices, which LibSVM token indices are (parser.hpp:28-33)."""
        from .sparse import parse_libsvm_csr

        label, indptr, indices, values, num_cols = parse_libsvm_csr(
            path, has_header=config.has_header)
        side = Metadata.load_side_files(path)
        keep = _finite_label_mask(label, config, path,
                                  has_side_rows=_has_side_rows(side))
        if keep is not None:
            nz_keep = np.repeat(keep, np.diff(indptr))
            indices, values = indices[nz_keep], values[nz_keep]
            label = label[keep]
            indptr = np.concatenate(
                [[0], np.cumsum(np.diff(indptr)[keep], dtype=np.int64)])
        ignore = _resolve_column_list(config.ignore_column, None)
        if ignore:
            indptr, indices, values = _csr_rows_kept(
                indptr, indices, values,
                ~np.isin(indices, np.asarray(sorted(set(ignore)))))
        cats = _merge_api_categoricals(
            _resolve_column_list(config.categorical_column, None),
            categorical_features, num_cols)
        meta = Metadata(label=label, weights=side.get("weights"),
                        query_boundaries=side.get("query_boundaries"),
                        init_score=side.get("init_score"))
        mappers_all = None
        if rank is not None:
            # the rank's rows; the mappers from the whole file's shared
            # sample, with no communication (io/dataset.py:820-850)
            from .distributed import partition_rows
            from .sparse import find_bin_mappers_csr

            n = len(label)
            keep = partition_rows(n, rank, config.num_machines,
                                  seed=config.data_random_seed,
                                  query_boundaries=meta.query_boundaries)
            if reference is None:
                mappers_all = find_bin_mappers_csr(
                    indptr, indices, values, num_cols,
                    _sample_row_indices(n, config), max_bin=config.max_bin,
                    categorical_features=cats)
            lens = np.diff(indptr)[keep]
            take = (np.concatenate([np.arange(indptr[r], indptr[r + 1])
                                    for r in keep]).astype(np.int64)
                    if len(keep) else np.empty(0, np.int64))
            indices, values = indices[take], values[take]
            indptr = np.concatenate([[0], np.cumsum(lens, dtype=np.int64)])
            meta = meta.subset(keep)
        if reference is not None:
            return reference.align_with_csr(indptr, indices, values,
                                            meta)._mark_partition(rank)
        ds = BinnedDataset.from_csr(indptr, indices, values, num_cols, meta,
                                    config, categorical_features=cats,
                                    mappers_all=mappers_all)
        if config.is_save_binary_file and rank is None:
            ds.save_binary(path + ".bin")
        return ds._mark_partition(rank)

    @staticmethod
    def from_jax_arrays(X_bin, bin_mapper_dicts: List[dict],
                        used_feature_map: np.ndarray,
                        num_total_features: int, label=None, weights=None,
                        query_boundaries=None, init_score=None,
                        feature_names: Optional[List[str]] = None
                        ) -> "BinnedDataset":
        """A JAX ``BinnedDataset`` carried across through numpy: its
        ``X_bin`` (a uint8/uint16 matrix, or its ``SparseBins`` fields as
        an object with ``indptr``, ``col``, ``bin``, ``default_bins`` and
        ``shape``), ``[m.to_dict() for m in bin_mappers]`` and its
        metadata fields.  The binary cache carries the same through a
        file."""
        if isinstance(X_bin, np.ndarray):
            storage = X_bin
        else:
            storage = SparseBins(X_bin.indptr, X_bin.col,
                                 np.asarray(X_bin.bin),
                                 X_bin.default_bins, X_bin.shape)
        meta = Metadata(label=label, weights=weights,
                        query_boundaries=query_boundaries,
                        init_score=init_score)
        return BinnedDataset(storage,
                             [BinMapper.from_dict(d) for d in bin_mapper_dicts],
                             np.asarray(used_feature_map),
                             num_total_features, meta, feature_names)

    # ---------------------------------------------------------- binary cache
    def save_binary(self, path: str) -> None:
        """The npz cache of the JAX package's ``save_binary``, moved onto
        ``path`` atomically."""
        tmp = path + ".tmp.npz"
        sparse_fields = {}
        if self.is_sparse:
            sb = self.X_bin
            sparse_fields = dict(sp_indptr=sb.indptr, sp_col=sb.col,
                                 sp_bin=sb.bin, sp_default=sb.default_bins,
                                 sp_shape=np.asarray(sb.shape, np.int64))
        md = self.metadata

        def arr(v, dtype=None):
            return np.empty(0, dtype) if v is None else v

        np.savez_compressed(
            tmp, magic=BINARY_MAGIC,
            X_bin=np.empty((0, 0), np.uint8) if self.is_sparse else self.X_bin,
            **sparse_fields,
            used_feature_map=self.used_feature_map,
            num_total_features=self.num_total_features,
            mappers=json.dumps([m.to_dict() for m in self.bin_mappers]),
            feature_names=json.dumps(self.feature_names),
            label=arr(md.label), weights=arr(md.weights),
            query_boundaries=arr(md.query_boundaries, np.int64),
            init_score=arr(md.init_score))
        os.replace(tmp, path)

    @staticmethod
    def load_binary(path: str) -> "BinnedDataset":
        with np.load(path, allow_pickle=False) as z:
            if str(z["magic"]) != BINARY_MAGIC:
                raise ValueError("not a lightgbm_tpu binary dataset file")
            mappers = [BinMapper.from_dict(d)
                       for d in json.loads(str(z["mappers"]))]

            def opt(key):
                return z[key] if z[key].size else None

            meta = Metadata(label=opt("label"), weights=opt("weights"),
                            query_boundaries=opt("query_boundaries"),
                            init_score=opt("init_score"))
            if "sp_indptr" in z:
                storage = SparseBins(z["sp_indptr"], z["sp_col"], z["sp_bin"],
                                     z["sp_default"], tuple(z["sp_shape"]))
            else:
                storage = z["X_bin"]
            return BinnedDataset(storage, mappers, z["used_feature_map"],
                                 int(z["num_total_features"]), meta,
                                 json.loads(str(z["feature_names"])))

    # -------------------------------------------------------------- numerics
    def subset(self, indices: np.ndarray) -> "BinnedDataset":
        """The rows ``indices``, sharing this dataset's bin mappers
        (Dataset::Subset, dataset.cpp:59)."""
        indices = np.asarray(indices)
        return BinnedDataset(
            self.X_bin.rows(indices) if self.is_sparse else self.X_bin[indices],
            self.bin_mappers, self.used_feature_map, self.num_total_features,
            self.metadata.subset(indices), self.feature_names)

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
