"""GBDT boosting driver.

Counterpart of lightgbm_tpu/models/gbdt.py for the slice: single-device
growth, leaf-wise (on the mega or record route on the card and the
order-based route on the CPU: ``_leafwise_hist_fn_raw``, ``_fuse_hist``;
on the pooled order route under ``histogram_pool_size``:
``_hist_pool_slots``), depthwise or hybrid (``tree_growth``; the level
histogram of ``_level_hist_fn``, kernel 1'' or 2 on the card).
Scores are class-major ``[K, n]`` (K = num_class, 1 but for
multiclass).  Each iteration computes the objective's gradients for all
K classes, re-draws the bagging mask (query by query for ranking data)
and the K feature samples, in class order before any tree grows (numpy
RandomState, draw for draw the JAX package's), then grows one tree per
class, applies shrinkage and updates row k of the train scores through
the final row -> leaf map and of the valid scores through a binned walk
(kernel P2, ``ops/predict.ensemble_update_binned_``: one launch a tree a
valid set, over the valid set's ``[F, n]`` bins in their stored dtype).
``models`` is flat and iteration-major: tree i*K + k is class k's tree of
iteration i.  Model text save/load is the reference format,
byte-compatible with the JAX package's.

The training API's state (the JAX package's): user gradients for a
custom objective (``objective=none``), ``rollback_one_iter``, exact
``snapshot_state`` / ``restore_state``, and continued training
(``merge_from``), which rebinds a loaded model's trees into this
dataset's bins (``_rebind_tree``, exact where the JAX package's is not:
ROADMAP C4) and replays them tree by tree into the scores.  Every
binned walk of training (the valid updates and replay, rollback, the
init model's replay, DART's in models/dart.py) is one P2 launch a score
set on the card, and none of them reads the card back.

The non-finite guards (``nonfinite_policy``, resilience/guards.py) hook
into ``train_one_iter`` where the JAX package's do (gbdt.py:703-717,
:750-753, :846-849), with its ``nan_grads`` fault before them.

``hist_dtype=float64`` (the reference's double accumulation; the JAX
package's x64 route, gbdt.py:818-830) grows every tree with float64
histograms, totals and searches over the objective's float32 gradients
(``_acc_dtype``): on the order route (pooled or not) and in depthwise and
hybrid growth, with kernels 1-f64, 1''-f64 and 3-f64 on the card and never
a float32 histogram or search kernel; the finished tree is float32.  Its
count channel is exact past 2**24 rows, so the envelope check
(``check_count_envelope``) refuses only float32 beyond it.

Forest batching (gbdt.py:615-813, :1362): where ``_forest_eligible``,
an iteration's K class trees grow as the lanes of one forest
(learners/forest.py), and ``train_forest_round`` grows several boosters'
trees as one forest (``train_many``, cv's bin-once folds); an iteration
is ``_begin_iter`` (gradients, guard, bagging, feature samples), the
growth, then ``_finish_iter``.  ``set_base_row_mask`` trains a cv fold on
the whole dataset's bins with its rows as every tree's root row set.

The parallel learners (``tree_learner`` data, feature, voting, grid;
parallel/*) grow where a ``torch.distributed`` world of more than one
rank is up (``_create_tree_learner``); every rank runs this boosting
loop on the same data and grows the same trees, checked tree by tree by
the desync sentinel (parallel/multihost.py).
Depthwise and hybrid growth ignore histogram_pool_size with the JAX
package's warning.  The lagged stop check is not carried (the port's
stop check is eager).

The obs hooks are the JAX package's (gbdt.py:203-224, :560-612):
``train_one_iter`` counts ``train_iters``, records its host wall into the
``tree_dispatch_s`` reservoir (dispatch time: the card may still be
running), samples the allocator at ``phase_boundary("train")`` and turns
an out-of-memory error (``faults.maybe_oom_dispatch("train")`` fakes one)
into a flight-recorder post-mortem carrying the census and
``obs/memmodel``'s prediction for ``_memmodel_params()``; the training
data registers the ``dataset`` and ``scores`` census owners.  None of
them reads the card.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..backend import resolve_device
from ..config import Config
from ..io.dataset import BinnedDataset
from ..learners.depthwise import grow_tree_depthwise
from ..learners.forest import grow_forest
from ..learners.hybrid import grow_tree_hybrid
from ..learners.serial import TreeLearnerParams, grow_tree
from ..log import Log
from ..metrics import Metric, create_metrics
from ..objectives import ObjectiveFunction, objective_kind
from ..obs import memory as obs_memory
from ..obs import telemetry
from ..obs.device_time import phase_scope
from ..ops.cuda_histogram import (hist_variant, histogram_record_window,
                                  histogram_single_leaf, make_level_hist_fn)
from ..ops.cuda_sparse_hist import MAX_BINS as S1_MAX_BINS
from ..ops.predict import (ensemble_leaves, ensemble_replay_binned_,
                           ensemble_sum, ensemble_update_binned_)
from ..ops.sparse_hist import make_sparse_hist_fn
from ..parallel.data_parallel import (data_parallel_sharded,
                                      make_data_parallel_grower)
from ..parallel.feature_parallel import make_feature_parallel_grower
from ..parallel.grid_parallel import grid_mesh, make_grid_parallel_grower
from ..parallel.mesh import data_mesh, world_size
from ..parallel.multihost import make_multihost_grower
from ..parallel.voting_parallel import make_voting_parallel_grower
from ..resilience import faults
from ..resilience.guards import make_guard
from ..resilience.retry import collective_deadline_s
from .tree import (TREE_FIELDS, BinnedTrees, PackedTrees, Tree, binned_table,
                   empty_tree, finalize_thresholds_device,
                   pack_threshold_bounds, pack_trees)

# forest_batching="auto" batches lanes at most this many rows
# (LGBM_TPU_FOREST_MAX_ROWS, the JAX package's knob and default,
# gbdt.py:63-69; read per call here)
FOREST_AUTO_MAX_ROWS = 2048


def forest_auto_max_rows() -> int:
    return int(os.environ.get("LGBM_TPU_FOREST_MAX_ROWS",
                              str(FOREST_AUTO_MAX_ROWS)))


# leaf_count/internal_count ride the float32 histogram count channel,
# integer-exact only up to 2**24 rows (lightgbm_tpu/learners/serial.py:78)
F32_COUNT_EXACT_ROWS = 1 << 24


def check_count_envelope(num_rows: int, hist_dtype: str) -> None:
    """Refuse a float32 dataset whose row count can overflow the float32
    integer-exact range of the count channel (the JAX package's rule and
    message, learners/serial.py:81-90); float64 counts are exact."""
    if hist_dtype == "float32" and num_rows > F32_COUNT_EXACT_ROWS:
        raise ValueError(
            f"num_data={num_rows} exceeds the float32 integer-exact "
            f"envelope ({F32_COUNT_EXACT_ROWS} = 2**24) for the "
            "histogram count channel: leaf_count/internal_count could "
            "round silently.  Set hist_dtype=float64 (the reference's "
            "double accumulation) for datasets this large.")


def fuse_hist_fits(F: int, num_bins: int) -> bool:
    """The JAX package's gate on its mega route under its default
    ``prefix`` routing (serial.py:520-536): round_up(F, 8) *
    round_up(num_bins, 128) * 16 bytes <= 4 MiB.  The figure is the TPU
    kernel's VMEM budget for its histogram block and means nothing on the
    card; it is kept only so that both packages take the same route, and
    so grow comparable trees, at every shape."""
    def up(x, m):
        return -(-x // m) * m

    return up(F, 8) * up(num_bins, 128) * 16 <= 1 << 22


def check_supported(config: Config) -> None:
    """Refuse a configuration the port cannot train: ``num_class`` that
    does not fit the objective.  (Every ROADMAP item it once refused is
    ported; the parallel learners' were the last.)"""
    if config.objective == "none":  # a custom objective: any num_class
        return
    kind = objective_kind(config.objective)
    if (int(config.num_class) > 1) != (kind == "multiclass"):
        raise ValueError(f"objective={config.objective} with num_class="
                         f"{config.num_class}: num_class > 1 is for "
                         "objective=multiclass, which needs it")


def raw_score_output(out: np.ndarray, num_class: int) -> np.ndarray:
    """[K, n] raw scores -> the public raw-score shape ([n] or [n, K])."""
    return out[0] if num_class == 1 else out.T


def transform_scores(out: np.ndarray, num_class: int, sigmoid: float,
                     objective_name: str) -> np.ndarray:
    """GBDT::Predict's host-side f64 output transform (gbdt.cpp:631-645):
    the sigmoid for binary, the softmax over classes for K > 1 ([n, K])."""
    if sigmoid > 0 and num_class == 1 and objective_name == "binary":
        return 1.0 / (1.0 + np.exp(-2.0 * sigmoid * out[0]))
    if num_class > 1:
        z = out - out.max(axis=0, keepdims=True)
        e = np.exp(z)
        return (e / e.sum(axis=0, keepdims=True)).T
    return out[0]


class GBDT:
    """Gradient Boosting Decision Trees (gbdt.h:17)."""

    name = "gbdt"

    def __init__(self, config: Config, train_set: Optional[BinnedDataset] = None,
                 objective: Optional[ObjectiveFunction] = None,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.num_class = int(config.num_class)
        self.learning_rate = float(config.learning_rate)
        self.max_leaves = config.num_leaves_
        self.models: List[Tree] = []
        # bumped by every change of ``models``: the packed ensemble's key
        self._model_version = 0
        self._pack_cache: Optional[tuple] = None
        self.iter_ = 0
        self.num_init_iteration = 0
        self.label_idx = 0
        self.max_feature_idx = -1
        self.feature_names: List[str] = []
        self.sigmoid = float(config.sigmoid)
        self.objective = objective
        self.train_set: Optional[BinnedDataset] = None
        self.valid_sets: List[BinnedDataset] = []
        self.train_metrics: List[Metric] = []
        self.valid_metrics: List[List[Metric]] = []
        self._valid_bins: List[torch.Tensor] = []
        self._valid_scores: List[torch.Tensor] = []
        self._bag_rng = np.random.RandomState(config.bagging_seed)
        self._feat_rng = np.random.RandomState(config.feature_fraction_seed)
        # the non-finite guard (resilience/guards.py); None under "off"
        self._nf_guard = make_guard(config.nonfinite_policy)
        self._base_row_mask: Optional[torch.Tensor] = None
        self._root_rows: Optional[torch.Tensor] = None
        self._learner = None  # the parallel learner (_create_tree_learner)
        if train_set is not None:
            self.reset_training_data(train_set, objective)

    # ------------------------------------------------------------------ setup
    def reset_training_data(self, train_set: BinnedDataset,
                            objective: Optional[ObjectiveFunction]) -> None:
        """GBDT::ResetTrainingData (gbdt.cpp:49-122)."""
        check_supported(self.config)
        if (float(self.config.histogram_pool_size) > 0
                and self.config.tree_growth != "leafwise"):
            # gbdt.py:364-372
            Log.warning(
                f"histogram_pool_size is ignored for tree_growth="
                f"{self.config.tree_growth} (depthwise levels build "
                "transient histograms; the hybrid resume runs unpooled)")
        n = train_set.num_data
        check_count_envelope(n, self.config.hist_dtype)
        self.train_set = train_set
        self.objective = objective
        self.num_data = n
        self.max_feature_idx = train_set.num_total_features - 1
        self.feature_names = list(train_set.feature_names)
        if objective is not None and objective.name == "binary":
            self.sigmoid = objective.sigmoid
        dev = self.device
        self._bins_T = train_set.bins_T(dev)
        self._num_bins = max(int(train_set.max_num_bin), 2)
        self._nbpf = torch.as_tensor(train_set.num_bins_per_feature,
                                     device=dev)
        self._is_cat = torch.as_tensor(train_set.is_categorical, device=dev)
        self._params = TreeLearnerParams.from_config(self.config)
        self._bounds_mat, self._real_feat_dev = pack_threshold_bounds(
            train_set.bin_thresholds_real(), train_set.real_feature_indices,
            dev)
        self._scores = self._init_scores(train_set)
        self._bag_mask = torch.ones(n, dtype=torch.float32, device=dev)
        # the root row set of a cv fold on shared bins (set_base_row_mask)
        self._base_row_mask: Optional[torch.Tensor] = None
        self._root_rows: Optional[torch.Tensor] = None
        self.train_metrics = create_metrics(self.config, train_set.metadata, n)
        self._learner = self._create_tree_learner()
        # census owners (obs/memory.py): the getters read the attributes
        # at census time, so reassigned scores stay covered, and the
        # registry holds this booster weakly, so dropping it frees all
        for tok in getattr(self, "_mem_tokens", ()):
            obs_memory.unregister_owner(tok)
        self._mem_tokens = (
            obs_memory.register_owner(
                "dataset", self,
                lambda b: (b._bins_T, b._nbpf, b._is_cat, b._bounds_mat,
                           b._real_feat_dev)),
            obs_memory.register_owner(
                "scores", self,
                lambda b: (b._scores, b._bag_mask, *b._valid_scores,
                           *b._valid_bins)),
        )
        obs_memory.phase_boundary("binning")

    def _create_tree_learner(self):
        """TreeLearner::CreateTreeLearner (tree_learner.cpp:8-20; the JAX
        package's gbdt.py:228-353): None for the serial learner (``grow``'s
        routes), else the parallel learner's grow callable over the
        ``torch.distributed`` world.  A world of one rank grows serially,
        as the JAX package does on one device; with more ranks the learner
        the config names, each rank's share on this booster's device.  A
        rank's partition of a file (a load with ``num_machines > 1``)
        always grows data-parallel, its rows being its own: a serial
        learner there would train on a fraction of the data.  Every
        parallel learner grows under ``make_multihost_grower``: its
        ``dist.grow.*`` spans and one desync-sentinel check a tree."""
        cfg = self.config
        tl = cfg.tree_learner
        W = world_size()
        if W > 1 and cfg.num_machines > 1 and cfg.num_machines != W:
            raise ValueError(f"num_machines={cfg.num_machines} but the "
                             f"torch.distributed world has {W} ranks")
        partitioned = self.train_set.partition_rank is not None
        if W <= 1 or (tl == "serial" and not partitioned):
            return None
        if (cfg.tree_growth == "hybrid"
                and tl in ("feature", "voting", "grid")):
            Log.warning(
                "tree_growth=hybrid runs on serial and data-parallel "
                f"learners; tree_learner={tl} uses leaf-wise growth "
                "(same accuracy, no fused level phase)")
        kw = dict(num_bins=self._num_bins, max_leaves=self.max_leaves,
                  hist_pool=self._hist_pool_slots(),
                  hist_dtype=self._acc_dtype)
        mesh = data_mesh(device=self.device)
        if partitioned:
            if tl != "data":
                Log.warning(f"tree_learner={tl} runs data-parallel on a "
                            "partitioned load (each rank holds its rows)")
            grow = data_parallel_sharded(mesh, growth=cfg.tree_growth, **kw)
        elif tl == "feature":
            grow = make_feature_parallel_grower(mesh, **kw)
        elif tl == "grid":
            c = max(1, min(int(cfg.grid_feature_shards), W))
            grow = make_grid_parallel_grower(
                grid_mesh((W // c, c), device=self.device), **kw)
        elif tl == "voting":
            grow = make_voting_parallel_grower(mesh, top_k=int(cfg.top_k),
                                               **kw)
        else:
            grow = make_data_parallel_grower(mesh, growth=cfg.tree_growth,
                                             **kw)
        # the dist.grow.* spans and the desync sentinel of each tree
        # (parallel/multihost.py), under the config's collective deadline
        return make_multihost_grower(
            grow, mesh, collective_deadline=collective_deadline_s(cfg))

    def set_base_row_mask(self, mask) -> None:
        """Train on the rows where ``mask`` is nonzero only, over the whole
        dataset's bins: how ``cv`` trains each fold on one shared binned
        matrix (gbdt.py:491-515).  The fold's rows, ascending, are every
        tree's root row set (``grow_tree``'s ``root_rows``), so every
        window, block and count is the subset-trained run's and the trees
        are that run's bitwise; the bagging mask is ANDed with it.  Rows
        outside it take leaf 0's value in the training scores, which no
        metric of a fold reads.  Leaf-wise growth only: any other raises
        ``ValueError`` (the JAX package's rule), and ``cv`` then trains on
        the fold's subset."""
        if self.config.tree_growth != "leafwise" or self._learner is not None:
            raise ValueError("set_base_row_mask requires leaf-wise growth "
                             "(the serial leaf-wise learner)")
        m = torch.as_tensor(np.asarray(mask, np.float32)).to(self.device)
        self._base_row_mask = m
        self._root_rows = torch.nonzero(m).flatten()
        self._bag_mask = self._bag_mask * m

    def add_valid_dataset(self, valid_set: BinnedDataset) -> None:
        """GBDT::AddValidDataset (gbdt.cpp:124-140); replays the trees
        already in the model onto the new set in the JAX package's float
        order (gbdt.py:478-489): each chunk of ``_iter_chunk`` iterations
        is summed from zero in tree order, and the chunk sums are added in
        order to the init scores: one P2 launch in replay mode over the
        set's ``[F, n]`` bins (``bins_T``: stored dtype, filled on the
        device for sparse storage).  Every tree in ``models`` is in this
        dataset's bins: trees of a loaded model enter only through
        ``merge_from``, which rebinds them."""
        if self.train_set is None or not self.train_set.check_align(valid_set):
            raise ValueError("validation set is not aligned with the "
                             "training set's bin mappers")
        self.valid_sets.append(valid_set)
        self.valid_metrics.append(
            create_metrics(self.config, valid_set.metadata, valid_set.num_data))
        vb = valid_set.bins_T(self.device)
        acc = self._init_scores(valid_set)
        K = self.num_class
        n_trees = len(self.models) // K * K
        if n_trees:
            ensemble_replay_binned_(
                acc, binned_table(self.models[:n_trees], self.device), vb, K,
                self._iter_chunk(valid_set.num_data))
        self._valid_bins.append(vb)
        self._valid_scores.append(acc)

    def _init_scores(self, data: BinnedDataset) -> torch.Tensor:
        """``[K, n]`` float32 scores from the data's init_score (class-major
        for K > 1), zeros without one."""
        shape = (self.num_class, data.num_data)
        init = data.metadata.init_score
        scores = (np.zeros(shape, np.float32) if init is None
                  else np.asarray(init, np.float32).reshape(shape))
        return torch.from_numpy(scores).to(self.device)

    # --------------------------------------------------------------- sampling
    def _update_bagging(self) -> None:
        """GBDT::Bagging (gbdt.cpp:157-208): every bagging_freq iterations
        draw floor(n * bagging_fraction) rows, or for ranking data
        floor(nq * bagging_fraction) whole queries."""
        cfg = self.config
        if cfg.bagging_fraction >= 1.0 or cfg.bagging_freq <= 0:
            return
        if self.iter_ % cfg.bagging_freq != 0:
            return
        n = self.num_data
        qb = self.train_set.metadata.query_boundaries
        frac = cfg.bagging_fraction
        mask = np.zeros(n, np.float32)
        if qb is not None:
            nq = len(qb) - 1
            for q in self._bag_rng.choice(nq, size=int(nq * frac),
                                          replace=False):
                mask[qb[q]:qb[q + 1]] = 1.0
        else:
            mask[self._bag_rng.choice(n, size=int(n * frac),
                                      replace=False)] = 1.0
        self._bag_mask = torch.from_numpy(mask).to(self.device)
        if self._base_row_mask is not None:
            self._bag_mask = self._bag_mask * self._base_row_mask

    def _sample_features(self) -> torch.Tensor:
        """Per-tree feature_fraction sample (serial_tree_learner.cpp:
        160-165)."""
        F = self.train_set.num_features
        frac = float(self.config.feature_fraction)
        mask = np.ones(F, bool)
        if frac < 1.0:
            idx = self._feat_rng.choice(F, size=max(1, int(F * frac)),
                                        replace=False)
            mask[:] = False
            mask[idx] = True
        return torch.from_numpy(mask).to(self.device)

    # ------------------------------------------------------------------ train
    def _leafwise_hist_fn_raw(self):
        """The record-window histogram that selects ``grow_tree``'s record
        or mega route (gbdt.py:413-432): on a CUDA device with float32
        histograms and the ``v1`` histogram variant, unless
        ``LGBM_TPU_OPT_HISTS=0`` (the JAX package's knobs, read per call).
        Otherwise None, the order route — always on the CPU, as the JAX
        package's is None off the TPU, and under ``bsub``.  Under the
        histogram pool it selects kernel 5's pooled step instead."""
        if (self.device.type == "cuda"
                and self.config.hist_dtype == "float32"
                and hist_variant() == "v1"
                and os.environ.get("LGBM_TPU_OPT_HISTS", "1") != "0"):
            return histogram_record_window
        return None

    def _fuse_hist(self) -> bool:
        """Whether a record-window route is the mega route (kernel 8), as
        serial.py:536 decides it: unless ``LGBM_TPU_FUSE_HIST=0`` (the JAX
        package's knob, read per call here), and where ``fuse_hist_fits``."""
        return (os.environ.get("LGBM_TPU_FUSE_HIST", "1") != "0"
                and fuse_hist_fits(self._bins_T.shape[0], self._num_bins))

    @property
    def _acc_dtype(self) -> torch.dtype:
        """The histograms' accumulation dtype (``hist_dtype``)."""
        return (torch.float64 if self.config.hist_dtype == "float64"
                else torch.float32)

    def _hist_pool_slots(self) -> int:
        """``histogram_pool_size`` (MB) -> the pool's slot count, the JAX
        package's rule (gbdt.py:354-387, the reference's
        serial_tree_learner.cpp:25-37): ``max(2, min(int(MB * 2**20 /
        per_leaf), num_leaves))``, 0 (every leaf resident) when MB <= 0 or
        growth is not leaf-wise.  ``per_leaf`` is the port's slot, ``F *
        num_bins * 3 * itemsize`` bytes on every device (4, or 8 under
        hist_dtype=float64): the JAX package's rule off the TPU
        (gbdt.py:373, :384-385), so CPU trees match its trees slot for
        slot.  Its TPU build sizes a slot by the padded raw layout ``[Fp,
        4, Bp]`` instead (gbdt.py:375-383), a layout the port does not
        have."""
        mb = float(self.config.histogram_pool_size)
        if mb <= 0 or self.config.tree_growth != "leafwise":
            return 0
        itemsize = 8 if self._acc_dtype == torch.float64 else 4
        per_leaf = self._bins_T.shape[0] * self._num_bins * 3 * itemsize
        slots = int(mb * 1024 * 1024 / max(per_leaf, 1))
        return max(2, min(slots, self.max_leaves))

    def _leafwise_hist_fn(self):
        """The single-row-set histogram of leaf-wise growth (kernel 1, or
        kernel 2 under ``bsub``, on the card; kernel 1-f64 under
        hist_dtype=float64)."""
        return functools.partial(histogram_single_leaf,
                                 num_bins=self._num_bins,
                                 acc_dtype=self._acc_dtype)

    def _level_hist_fn(self):
        """The level histogram of depthwise growth and of hybrid's level
        phase (gbdt.py:434-457), signature ``(bins_T, leaf_id, grad, hess,
        mask, num_leaves)``: for a sparse dataset whose density is at most
        ``sparse_hist_density`` (float32 histograms) and whose one leaf
        of bins fits S1's block (at most ``cuda_sparse_hist.MAX_BINS``,
        17,319), the O(nnz) CSR histogram (kernel S1 on the card,
        ops/sparse_hist.py); otherwise kernel 1'', or kernel 2 under
        ``bsub``, on the card (kernel 1''-f64 under hist_dtype=float64,
        sparse sets included, as the JAX package's gate at
        gbdt.py:445-446).  The bin limit is decided on every device, so
        the CPU grows on the card's route."""
        ds = self.train_set
        if (ds is not None and ds.is_sparse
                and self.config.hist_dtype != "float64"
                and ds.density <= self.config.sparse_hist_density
                and self._num_bins <= S1_MAX_BINS):
            return make_sparse_hist_fn(ds, self._num_bins, self.device)
        return make_level_hist_fn(self._num_bins, self._acc_dtype)

    def grow(self, grad: torch.Tensor, hess: torch.Tensor,
             feature_mask: torch.Tensor):
        """One tree on the current bagging mask: (tree, leaf_id), grown as
        ``tree_growth`` says (gbdt.py:274-301)."""
        args = (self._bins_T, grad, hess, self._bag_mask, feature_mask,
                self._nbpf, self._is_cat, self._params, self._num_bins,
                self.max_leaves)
        if self._learner is not None:
            return self._learner(*args[:8])
        growth = self.config.tree_growth
        # every grower sums in the dtype of the histogram functions handed
        # to it
        if growth == "depthwise":
            return grow_tree_depthwise(*args, hist_fn=self._level_hist_fn())
        if growth == "hybrid":
            return grow_tree_hybrid(*args, hist_fn=self._leafwise_hist_fn(),
                                    level_hist_fn=self._level_hist_fn())
        # under the pool grow_tree takes the order route; the raw
        # histogram then selects kernel 5's step (serial.py:404, :427)
        raw = self._leafwise_hist_fn_raw()
        return grow_tree(*args, hist_fn=self._leafwise_hist_fn(),
                         hist_fn_raw=raw,
                         fuse_hist=raw is not None and self._fuse_hist(),
                         hist_pool=self._hist_pool_slots(),
                         root_rows=self._root_rows)

    def _forest_eligible(self) -> bool:
        """Whether this booster's trees may grow as a forest's lanes
        (learners/forest.py), the JAX package's rule (gbdt.py:615-644):
        ``forest_batching`` is not ``off``, the serial learner grows leaf-
        wise with float32 histograms and no histogram pool, and under
        ``auto`` the data has at most ``LGBM_TPU_FOREST_MAX_ROWS`` rows
        (2,048).  The JAX rule also leaves out its kernel routes; that is
        the TPU's, not ported: the port's lanes have kernels F1 and F3 and
        the rule is decided alike on every device, so the CPU and the card
        grow the same trees.  DART and the non-finite guard's ``raise``
        policy grow one tree at a time."""
        cfg = self.config
        knob = cfg.forest_batching
        if knob == "off" or self.name != "gbdt":
            return False
        if cfg.tree_learner != "serial" or cfg.tree_growth != "leafwise":
            return False
        if cfg.hist_dtype != "float32" or self._hist_pool_slots():
            return False
        if self._nf_guard is not None and self._nf_guard.policy == "raise":
            return False
        return knob == "on" or self.num_data <= forest_auto_max_rows()

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration (gbdt.cpp:217-252): one tree per class.
        ``grad`` / ``hess`` are a custom objective's gradients, ``[K·n]``
        class-major (gbdt.py:695-701); without them the objective's.
        Returns True when no tree could be grown (training should stop);
        False also when the ``skip_tree`` guard skipped the iteration.
        The K class trees grow as one forest's lanes where
        ``_forest_eligible`` (gbdt.py:797-813), else one by one.

        Around it the JAX package's obs hooks (gbdt.py:571-590): the
        ``train_iters`` count, the ``tree_dispatch_s`` reservoir (host
        wall: the card may still be running), the ``train`` allocator
        watermark, and an OOM post-mortem with the census and
        ``obs/memmodel``'s prediction; other errors pass untouched."""
        t0 = time.perf_counter()
        try:
            # chaos hook (LGBM_TPU_FAULT=oom_dispatch): a fake
            # RESOURCE_EXHAUSTED through the classifier a real one meets
            faults.maybe_oom_dispatch("train")
            return self._train_one_iter(grad, hess)
        except Exception as e:
            params = self._memmodel_params()
            obs_memory.classify_dispatch_error(
                e, "train.dispatch", shape=params, predict_params=params)
            raise
        finally:
            telemetry.count("train_iters")
            telemetry.record_value("tree_dispatch_s",
                                   time.perf_counter() - t0)
            obs_memory.phase_boundary("train")

    def _memmodel_params(self) -> Optional[dict]:
        """This booster's shape in ``obs/memmodel.predict``'s terms (the
        JAX package's gbdt.py:592-612), in the port's routes: ``forest``
        where its class trees grow as lanes, else the route ``grow``'s
        leaf-wise splits take (``mega``, ``record`` or ``order``: the
        pool's, depthwise's and hybrid's), the growth, the pool's slots
        and the histograms' dtype.  None before the training data is
        set."""
        if getattr(self, "_bins_T", None) is None:
            return None
        try:
            if self.num_class > 1 and self._forest_eligible():
                routing = "forest"
            elif (self._leafwise_hist_fn_raw() is None
                  or self._hist_pool_slots()
                  or self.config.tree_growth != "leafwise"):
                routing = "order"
            else:
                routing = "mega" if self._fuse_hist() else "record"
            return {
                "rows": int(self.num_data),
                "features": int(self._bins_T.shape[0]),
                "bins": int(self._num_bins),
                "leaves": int(self.max_leaves),
                "num_class": int(self.num_class),
                "world": int(world_size()),
                "routing": routing,
                "hist_prec": self.config.hist_dtype,
                "growth": self.config.tree_growth,
                "pool_slots": int(self._hist_pool_slots()),
            }
        except Exception:  # noqa: BLE001 — read inside an error handler
            return None

    def _train_one_iter(self, grad=None, hess=None) -> bool:
        pre = self._begin_iter(grad, hess)
        if pre is None:
            return False
        grad, hess, fmasks, nf_snap = pre
        K = self.num_class
        if K > 1 and self._forest_eligible():
            trees, lids = grow_forest(
                self._bins_T, grad, hess,
                self._bag_mask.expand(K, -1).contiguous(),
                torch.stack(fmasks), self._nbpf, self._is_cat,
                [self._params] * K, self._num_bins, self.max_leaves,
                root_rows=[self._root_rows] * K)
            return self._finish_iter(zip(trees, lids), nf_snap)
        grown = (self.grow(grad[k].contiguous(), hess[k].contiguous(),
                           fmasks[k]) for k in range(K))
        return self._finish_iter(grown, nf_snap)

    def _begin_iter(self, grad=None, hess=None):
        """The first half of an iteration, up to the growth (gbdt.py:667-
        728): the gradients, the non-finite guard, the bagging draw and
        the K feature samples.  Returns (grad [K, n], hess [K, n], the K
        feature masks, the guard's snapshot) or None when the
        ``skip_tree`` guard skips the iteration."""
        K = self.num_class
        if grad is not None and hess is not None:
            grad, hess = (torch.as_tensor(np.asarray(a, np.float32))
                          .reshape(K, self.num_data).to(self.device)
                          for a in (grad, hess))
        elif self.objective is None:
            from ..basic import LightGBMError

            raise LightGBMError(
                "objective=none needs the gradients of a custom objective: "
                "pass fobj to train / Booster.update")
        else:
            grad, hess = self.objective.get_gradients(
                self._scores if K > 1 else self._scores[0])
            if K == 1:
                grad, hess = grad[None], hess[None]
        # chaos hook (LGBM_TPU_FAULT=nan_grads:J): poisoned gradients, so
        # the guard below is exercised by tests, not trusted
        grad, hess = faults.poison_grads(grad, hess, self.iter_)
        guard, nf_snap = self._nf_guard, None
        if guard is not None:
            if guard.policy == "raise":
                # once NaN reaches the scores only an exact restore undoes
                # it (NonFiniteGuard.raise_if_poisoned): a copy of the
                # score buffers an iteration, the opt-in policy's cost
                nf_snap = self.snapshot_state()
            grad, hess, skip = guard.check_gradients(grad, hess)
            if skip:
                return None
        self._update_bagging()
        # the K feature samples in class order before any tree grows: the
        # JAX package's _feat_rng draws (gbdt.py:719-724)
        fmasks = [self._sample_features() for _ in range(K)]
        return grad, hess, fmasks, nf_snap

    def _finish_tree(self, k: int, tree: Tree, leaf_id: torch.Tensor
                     ) -> bool:
        """The second half, a grown tree at a time (gbdt.py:730-775): the
        leaf-output guard, shrinkage, the train-score update through the
        row -> leaf map, threshold finalization, the valid-score walk and
        the model list.  Returns whether the tree split."""
        guard = self._nf_guard
        if guard is not None:
            # the leaf-output guard; it never drops a tree, so models
            # stays iteration-major
            tree = guard.check_tree(tree)
        # shrinkage + train-score update through the row -> leaf map
        # + threshold finalization (gbdt.cpp:229-247)
        with phase_scope("leaf-update"):
            tree = tree.shrink(self.learning_rate)
            self._scores[k] += tree.leaf_value[leaf_id.to(torch.int64)]
            tree = finalize_thresholds_device(tree, self._bounds_mat,
                                              self._real_feat_dev)
        if self._valid_bins:
            self._walk_into(binned_table([tree], self.device), k, None, 1.0)
        self.models.append(tree)
        return tree.num_leaves > 1

    def _finish_iter(self, grown, nf_snap) -> bool:
        """Close an iteration whose K trees ``grown`` yields as (tree,
        leaf_id) in class order (gbdt.py:777-790); True when no tree
        split."""
        could_split = False
        for k, (tree, leaf_id) in enumerate(grown):
            could_split |= self._finish_tree(k, tree, leaf_id)
        self._models_changed()
        self.iter_ += 1
        if self._nf_guard is not None:
            # policy=raise reads its parked counts here, restoring nf_snap
            # before it raises
            self._nf_guard.raise_if_poisoned(self, nf_snap)
        return not could_split

    def _walk_into(self, table: BinnedTrees, c0: int,
                   train_scale: Optional[float],
                   valid_scale: Optional[float]) -> None:
        """Each tree of ``table`` walked over the training rows (unless
        ``train_scale`` is None) and every valid set, ``f32(scale) *
        leaf`` added in table order to the scores of its class (listed
        tree t is class ``(c0 + t) % K``): one P2 launch a score set."""
        if train_scale is not None:
            ensemble_update_binned_(self._scores, table, self._bins_T, c0,
                                    train_scale)
        if valid_scale is not None:
            for vi, vb in enumerate(self._valid_bins):
                ensemble_update_binned_(self._valid_scores[vi], table, vb,
                                        c0, valid_scale)

    def finalize_guards(self) -> None:
        """End-of-training drain of the non-finite guard's parked counts
        (gbdt.py:868-875): a short clip run reports its clipped values,
        and under policy=raise a poisoned last iteration raises here."""
        if self._nf_guard is not None:
            self._nf_guard.finalize()

    def snapshot_state(self) -> tuple:
        """Every per-iteration mutable of the training state, for an exact
        rewind (gbdt.py:877-899): copies of the train and valid scores,
        the model count, ``iter_``, both RandomStates and the bag mask.
        Unlike ``rollback_one_iter`` (whose (s + d) - d round trip leaves
        float32 residue), ``restore_state`` is bitwise."""
        return (self._scores.clone(), len(self.models), self.iter_,
                self._bag_rng.get_state(), self._feat_rng.get_state(),
                self._bag_mask.clone(),
                [v.clone() for v in self._valid_scores])

    def restore_state(self, snap: tuple) -> None:
        """Rewind to a ``snapshot_state`` capture; installs copies, so the
        snapshot stays reusable (gbdt.py:901-919)."""
        scores, n_models, it, bag_state, feat_state, bag_mask, valid = snap
        self._scores = scores.clone()
        del self.models[n_models:]
        self._models_changed()
        self.iter_ = it
        self._bag_rng.set_state(bag_state)
        self._feat_rng.set_state(feat_state)
        self._bag_mask = bag_mask.clone()
        for i, v in enumerate(valid):
            self._valid_scores[i] = v.clone()

    def install_models(self, models: List[Tree]) -> None:
        """Replace the tree list with ``models`` (a checkpoint's trees,
        resilience/checkpoint.py): the packed ensemble and every table
        built from the old list are stale after it."""
        self.models = list(models)
        self._models_changed()

    def rollback_one_iter(self) -> None:
        """GBDT::RollbackOneIter (gbdt.cpp:254-271): subtract the last
        iteration's K trees from the train and valid scores and pop them.
        Trees of an init model are not rolled back."""
        if self.iter_ <= 0:
            return
        K = self.num_class
        # scale -1: s + (-d) is the JAX package's .at[k].add(-delta)
        self._walk_into(binned_table(self.models[-K:], self.device), 0,
                        -1.0, -1.0)
        del self.models[-K:]
        self._models_changed()
        self.iter_ -= 1

    def merge_from(self, other: "GBDT", prepend: bool = False) -> None:
        """GBDT::MergeFrom (gbdt.h:44-61): add another model's trees.
        ``prepend`` puts them first (continued training from an init
        model, gbdt.cpp:589-592) and replays them into the train and
        valid scores one tree at a time in model order, in float32, as
        the training loop adds its trees (one P2 launch a score set), so
        the scores equal the init model's own training scores bitwise."""
        if other.num_class != self.num_class:
            raise ValueError("cannot merge models with different num_class")
        K = self.num_class
        incoming = [_tree_to(t, self.device) for t in other.models]
        if self.train_set is not None:
            bounds = self._bounds_mat.cpu().numpy()
            incoming = [self._rebind_tree(t, bounds) for t in incoming]
        if prepend:
            self.models = incoming + self.models
            self.num_init_iteration = len(incoming) // K
            if self.train_set is not None and incoming:
                self._walk_into(binned_table(incoming, self.device), 0,
                                1.0, 1.0)
        else:
            self.models = self.models + incoming
        self._models_changed()
        self.iter_ = len(self.models) // K - self.num_init_iteration

    def _rebind_tree(self, tree: Tree, bounds: np.ndarray) -> Tree:
        """A tree of another model in THIS dataset's bins (gbdt.py:1269-
        1315).  Only the raw-value program (``split_feature_real``,
        ``threshold_real``, ``decision_type``) is read.  A numerical
        node's bin is the first whose float32 bound is >= the float32
        threshold: ``threshold_real`` is the float32 rounding of the
        split bin's float64 bound (``finalize_thresholds_device``;
        ``bounds`` is that float32 matrix), so a model of this dataset
        gets every ``threshold_bin`` back exactly (the JAX package's
        float64 search with a relative epsilon lands one bin too high
        wherever float32 rounded the bound up: ROADMAP C4).  A
        categorical node's bin is its category's; a feature that is
        trivial here sends every row left."""
        nl = tree.num_leaves
        if nl <= 1:
            return tree
        sf = tree.split_feature_real.cpu().numpy()
        tr = tree.threshold_real.cpu().numpy().astype(np.float32)
        dt = tree.decision_type.cpu().numpy()
        ds = self.train_set
        lens = [len(b) for b in ds.bin_thresholds_real()]
        tb = np.zeros(sf.shape, np.int32)
        sf_inner = np.zeros(sf.shape, np.int32)
        dt2 = dt.copy()
        for i in range(nl - 1):
            if sf[i] < 0:
                continue
            inner = int(ds.used_feature_map[int(sf[i])])
            if inner < 0:  # bin <= num_bins: always left
                tb[i], dt2[i] = self._num_bins, 0
                continue
            sf_inner[i] = inner
            if dt[i] == 1:
                tb[i] = ds.bin_mappers[inner].category_to_bin.get(
                    int(tr[i]), self._num_bins)
            else:
                row = bounds[inner, :lens[inner]]
                tb[i] = min(int(np.searchsorted(row, tr[i], side="left")),
                            lens[inner] - 1)

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        return tree.replace(split_feature=dev(sf_inner),
                            threshold_bin=dev(tb), decision_type=dev(dt2))

    # ------------------------------------------------------------------- eval
    def eval_at(self, data_idx: int) -> Dict[str, float]:
        """Metrics on train (0) or valid set ``data_idx`` (1..): a metric
        with a device path (``eval_torch``) reads the scores where they
        are, the others one host copy of them; a metric at several
        positions (ndcg) reports each as ``name@k``."""
        if data_idx == 0:
            scores, metrics = self._scores, self.train_metrics
        else:
            scores = self._valid_scores[data_idx - 1]
            metrics = self.valid_metrics[data_idx - 1]
        dev = scores if self.num_class > 1 else scores[0]
        host = None
        out: Dict[str, float] = {}
        for m in metrics:
            if m.eval_torch is not None:
                out[m.name] = m.eval_torch(dev)
                continue
            if host is None:
                host = dev.cpu().numpy()
            if hasattr(m, "eval_multi"):
                out.update((f"{m.name}@{k}", v)
                           for k, v in zip(m.eval_at, m.eval_multi(host)))
            else:
                out[m.name] = m.eval(host)
        return out

    def predict_at(self, data_idx: int) -> np.ndarray:
        """A host copy of the ``[K, n]`` float32 scores of train (0) or
        valid set ``data_idx`` (1..); never a view of the live scores,
        which training updates in place."""
        scores = (self._scores if data_idx == 0
                  else self._valid_scores[data_idx - 1])
        return np.array(scores.cpu())

    @property
    def current_iteration(self) -> int:
        return len(self.models) // max(self.num_class, 1)

    # ---------------------------------------------------------------- predict
    def _models_changed(self) -> None:
        """Every change of ``models`` calls this: a packed ensemble built
        before it is stale (gbdt.py:993-1006's version counter)."""
        self._model_version += 1

    def _packed(self) -> PackedTrees:
        """The whole ensemble as one ``PackedTrees`` on the model's device,
        built once per model version (a prediction takes a prefix of it)."""
        cache = self._pack_cache
        if cache is None or cache[0] != self._model_version:
            cache = (self._model_version,
                     pack_trees(self.models, self.num_class, self.device))
            self._pack_cache = cache
        return cache[1]

    def _iter_chunk(self, n_rows: int) -> int:
        """Boosting iterations a chunk sum holds (gbdt.py:1035-1044): the
        JAX package bounds rows * trees a dispatch, and its chunk sums set
        the float order that P1 and its plain version keep."""
        return max(1, 16_000_000 // max(n_rows * self.num_class, 1))

    def _n_trees(self, num_iteration: int) -> int:
        """Trees of the first ``num_iteration`` iterations (all for <= 0)."""
        K = self.num_class
        n_iter = len(self.models) // K
        if num_iteration > 0:
            n_iter = min(n_iter, num_iteration)
        return n_iter * K

    def _device_rows(self, X) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(
            self.device)

    def _raw_scores(self, X, num_iteration: int = -1) -> np.ndarray:
        """Σ over each class's trees of raw-feature walks, in float32 in
        tree order within chunks of ``_iter_chunk`` iterations, as float64
        [K, n] (gbdt.py:1046-1088): one P1 launch on the card and one
        copy back; ``num_iteration`` counts iterations (K trees each)."""
        Xt = self._device_rows(X)
        n_trees = self._n_trees(num_iteration)
        if n_trees == 0:
            return np.zeros((self.num_class, Xt.shape[0]), np.float64)
        acc = ensemble_sum(self._packed(), Xt, n_trees,
                           self._iter_chunk(Xt.shape[0]))
        return acc.cpu().numpy().astype(np.float64)

    def predict_leaf_index(self, X, num_iteration: int = -1) -> np.ndarray:
        """Each row's leaf in each tree, ``[n, trees]`` int32
        (gbdt.py:1100-1133): one P1 launch on the card; ``num_iteration``
        counts iterations (K trees each)."""
        Xt = self._device_rows(X)
        n_trees = self._n_trees(num_iteration)
        if n_trees == 0:
            return np.zeros((Xt.shape[0], 0), np.int32)
        return ensemble_leaves(self._packed(), Xt, n_trees).cpu().numpy().T

    def predict_raw_score(self, X, num_iteration: int = -1) -> np.ndarray:
        return raw_score_output(self._raw_scores(X, num_iteration),
                                self.num_class)

    def predict(self, X, num_iteration: int = -1) -> np.ndarray:
        return transform_scores(self._raw_scores(X, num_iteration),
                                self.num_class, self.sigmoid,
                                self.objective_name())

    def objective_name(self) -> str:
        if self.objective is not None:
            return self.objective.name
        return getattr(self, "_loaded_objective", "")

    # ------------------------------------------------------------- model text
    def feature_importance_array(self, importance_type: str = "split"
                                 ) -> np.ndarray:
        imp = np.zeros(self.max_feature_idx + 1, np.float64)
        for tree in self.models:
            nl = tree.num_leaves
            sfr = tree.split_feature_real.cpu().numpy()[: nl - 1]
            gains = tree.split_gain.cpu().numpy()[: nl - 1]
            for j, f in enumerate(sfr):
                if f >= 0:
                    imp[f] += gains[j] if importance_type == "gain" else 1
        return imp

    def feature_importance(self) -> Dict[str, int]:
        imp = self.feature_importance_array("split")
        names = self.feature_names or [
            f"Column_{i}" for i in range(self.max_feature_idx + 1)]
        return {names[i]: int(imp[i]) for i in range(len(imp)) if imp[i] > 0}

    def save_model_to_string(self, num_iteration: int = -1) -> str:
        """Reference text format (gbdt.cpp:479-521), byte-compatible with
        lightgbm_tpu's GBDT.save_model_to_string."""
        out = [self.name, f"num_class={self.num_class}",
               f"label_index={self.label_idx}",
               f"max_feature_idx={self.max_feature_idx}"]
        if self.objective_name():
            out.append(f"objective={self.objective_name()}")
        out.append(f"sigmoid={_fmt(self.sigmoid)}")
        names = self.feature_names or [
            f"Column_{i}" for i in range(self.max_feature_idx + 1)]
        out.append("feature_names=" + " ".join(names))
        out.append("")
        num_used = len(self.models)
        if num_iteration > 0:
            num_used = min(num_iteration * self.num_class, num_used)
        for i in range(num_used):
            out.append(f"Tree={i}")
            out.append(_tree_to_string(self.models[i]))
        out.append("")
        out.append("feature importances:")
        pairs = sorted(self.feature_importance().items(), key=lambda kv: -kv[1])
        for name, cnt in pairs:
            out.append(f"{name}={cnt}")
        return "\n".join(out) + "\n"

    def load_model_from_string(self, model_str: str) -> None:
        """gbdt.cpp:523-592."""
        lines = model_str.splitlines()
        kv = {}
        blocks: List[List[str]] = []
        i = 0
        while i < len(lines):
            line = lines[i].strip()
            if line.startswith("Tree="):
                i += 1
                block = []
                while (i < len(lines) and not lines[i].startswith("Tree=")
                       and not lines[i].startswith("feature importances")):
                    block.append(lines[i])
                    i += 1
                blocks.append(block)
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                kv.setdefault(k.strip(), v.strip())
            i += 1
        self.num_class = int(kv.get("num_class", 1))
        self.label_idx = int(kv.get("label_index", 0))
        self.max_feature_idx = int(kv.get("max_feature_idx", -1))
        self.sigmoid = float(kv.get("sigmoid", -1.0))
        self._loaded_objective = kv.get("objective", "")
        self.feature_names = kv.get("feature_names", "").split()
        self.models = [_tree_from_lines(b, self.device) for b in blocks]
        self._models_changed()
        self.num_init_iteration = len(self.models) // max(self.num_class, 1)
        self.iter_ = 0

    def dump_model(self, num_iteration: int = -1) -> Dict:
        """GBDT::DumpModel (gbdt.cpp:438-477) as a JSON-ready dict."""
        names = self.feature_names or [
            f"Column_{i}" for i in range(self.max_feature_idx + 1)]
        num_used = len(self.models)
        if num_iteration > 0:
            num_used = min(num_iteration * self.num_class, num_used)
        return {"name": self.name, "num_class": self.num_class,
                "label_index": self.label_idx,
                "max_feature_idx": self.max_feature_idx,
                "objective": self.objective_name(), "sigmoid": self.sigmoid,
                "feature_names": names,
                "tree_info": [_tree_to_json(self.models[i], i)
                              for i in range(num_used)]}

    @property
    def num_trees(self) -> int:
        return len(self.models)


def train_forest_round(gbdts: List[GBDT]) -> List[bool]:
    """Advance every booster in ``gbdts`` one iteration, all their trees
    (each booster's K class trees) grown as the lanes of one forest
    (gbdt.py:1362-1470): ``train_many``'s models and ``cv``'s bin-once
    folds.  Every booster must be ``_forest_eligible``, share one binned
    matrix (the same ``BinnedDataset.bins_T`` tensor), ``num_bins`` and
    ``max_leaves``, and all or none have a base row mask; else
    ``ValueError``.  Per-lane constraints, feature samples, bagging and
    root row sets may differ.  Returns each booster's "should stop"
    flag; a booster whose guard skipped the iteration grows no lane."""
    if not gbdts:
        return []
    ref = gbdts[0]
    for b in gbdts:
        if not b._forest_eligible():
            raise ValueError(
                "train_forest_round: a booster is not forest-eligible "
                "(forest_batching=off, DART, float64 or pooled histograms, "
                "another growth or learner, or more rows than the auto "
                "ceiling)")
        if b._bins_T is not ref._bins_T:
            raise ValueError("train_forest_round: boosters must share one "
                             "binned dataset (bin once)")
        if b._num_bins != ref._num_bins or b.max_leaves != ref.max_leaves:
            raise ValueError("train_forest_round: max_bin and num_leaves "
                             "must match across boosters")
        if (b._base_row_mask is None) != (ref._base_row_mask is None):
            raise ValueError("train_forest_round: base row masks (cv folds) "
                             "must be set on all boosters or none")
    stops = [False] * len(gbdts)
    active, pres = [], []
    for i, b in enumerate(gbdts):
        pre = b._begin_iter()
        if pre is not None:
            active.append(i)
            pres.append(pre)
    if not active:
        return stops
    grads, hesses, bags, fmasks, params, rows = [], [], [], [], [], []
    for i, (grad, hess, fms, _snap) in zip(active, pres):
        b = gbdts[i]
        for k in range(b.num_class):
            grads.append(grad[k])
            hesses.append(hess[k])
            bags.append(b._bag_mask)
            fmasks.append(fms[k])
            params.append(b._params)
            rows.append(b._root_rows)
    trees, lids = grow_forest(
        ref._bins_T, torch.stack(grads), torch.stack(hesses),
        torch.stack(bags), torch.stack(fmasks), ref._nbpf, ref._is_cat,
        params, ref._num_bins, ref.max_leaves, root_rows=rows)
    lane = 0
    for i, pre in zip(active, pres):
        K = gbdts[i].num_class
        grown = [(trees[lane + k], lids[lane + k]) for k in range(K)]
        lane += K
        stops[i] = gbdts[i]._finish_iter(grown, pre[3])
    return stops


def _fmt(x) -> str:
    """Compact float formatting matching C++ default ostream behavior."""
    x = float(x)
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(x)


def _arr_str(a: torch.Tensor, n: int, fmt=str) -> str:
    return " ".join(fmt(v) for v in a.cpu().numpy()[:n])


def _tree_to_string(tree: Tree) -> str:
    """Tree::ToString (tree.cpp:124-151)."""
    nl = tree.num_leaves
    ni = max(nl - 1, 0)
    f = lambda v: _fmt(float(v))  # noqa: E731
    cnt = lambda v: str(int(float(v)))  # noqa: E731
    out = [f"num_leaves={nl}",
           "split_feature=" + _arr_str(tree.split_feature_real, ni),
           "split_gain=" + _arr_str(tree.split_gain, ni, f),
           "threshold=" + _arr_str(tree.threshold_real, ni, f),
           "decision_type=" + _arr_str(tree.decision_type, ni),
           "left_child=" + _arr_str(tree.left_child, ni),
           "right_child=" + _arr_str(tree.right_child, ni),
           "leaf_parent=" + _arr_str(tree.leaf_parent, nl),
           "leaf_value=" + _arr_str(tree.leaf_value, nl, f),
           "leaf_count=" + _arr_str(tree.leaf_count, nl, cnt),
           "internal_value=" + _arr_str(tree.internal_value, ni, f),
           "internal_count=" + _arr_str(tree.internal_count, ni, cnt),
           ""]
    return "\n".join(out)


def _tree_to_json(tree: Tree, index: int) -> Dict:
    """Tree::ToJSON (tree.cpp:153-191): nested node dicts."""
    nl = tree.num_leaves
    a = {k: getattr(tree, k).cpu().numpy() for k in TREE_FIELDS}

    def leaf_node(leaf: int) -> Dict:
        return {"leaf_index": int(leaf),
                "leaf_parent": int(a["leaf_parent"][leaf]),
                "leaf_value": float(a["leaf_value"][leaf]),
                "leaf_count": int(a["leaf_count"][leaf])}

    # a child is always created after its parent (tree.cpp:52-96), so a
    # reverse sweep builds every child's dict before its parent's
    built: Dict[int, Dict] = {}
    for i in range(nl - 2, -1, -1):
        li, ri = int(a["left_child"][i]), int(a["right_child"][i])
        built[i] = {
            "split_index": i,
            "split_feature": int(a["split_feature_real"][i]),
            "split_gain": float(a["split_gain"][i]),
            "threshold": float(a["threshold_real"][i]),
            "decision_type": "==" if a["decision_type"][i] == 1 else "<=",
            "internal_value": float(a["internal_value"][i]),
            "internal_count": int(a["internal_count"][i]),
            "left_child": built[li] if li >= 0 else leaf_node(~li),
            "right_child": built[ri] if ri >= 0 else leaf_node(~ri)}
    return {"tree_index": index, "num_leaves": nl,
            "tree_structure": built[0] if nl > 1 else leaf_node(0)}


def _tree_to(tree: Tree, device) -> Tree:
    """``tree`` with every tensor on ``device``."""
    return tree.replace(**{k: getattr(tree, k).to(device)
                           for k in TREE_FIELDS})


def _tree_from_lines(lines: List[str], device) -> Tree:
    """Tree::Tree(const string&) (tree.cpp:193-231).  Bin-space fields
    are not in the text format; loaded trees predict on raw values."""
    kv = {}
    for line in lines:
        if "=" in line:
            k, v = line.split("=", 1)
            if k.strip() and v.strip():
                kv[k.strip()] = v.strip()
    nl = int(kv["num_leaves"])
    max_leaves = max(nl, 2)
    t = empty_tree(max_leaves, device)

    def padded(key, n, total, dtype, fill=0):
        v = np.full(total, fill, dtype)
        if n and key in kv:
            v[:n] = np.array(kv[key].split()[:n], np.float64).astype(dtype)
        return torch.from_numpy(v).to(device)

    ni, li = nl - 1, max_leaves - 1
    return t.replace(
        num_leaves=nl,
        split_feature=padded("split_feature", ni, li, np.int32),
        split_feature_real=padded("split_feature", ni, li, np.int32),
        threshold_real=padded("threshold", ni, li, np.float32),
        decision_type=padded("decision_type", ni, li, np.int32),
        left_child=padded("left_child", ni, li, np.int32),
        right_child=padded("right_child", ni, li, np.int32),
        split_gain=padded("split_gain", ni, li, np.float32),
        internal_value=padded("internal_value", ni, li, np.float32),
        internal_count=padded("internal_count", ni, li, np.float32),
        leaf_value=padded("leaf_value", nl, max_leaves, np.float32),
        leaf_count=padded("leaf_count", nl, max_leaves, np.float32),
        leaf_parent=padded("leaf_parent", nl, max_leaves, np.int32, -1),
    )
