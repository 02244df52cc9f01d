"""Configuration system (a copy of lightgbm_tpu/config.py, kept verbatim
so params dicts are interchangeable between the two packages; the
"TPU extension" keys are accepted here and the PyTorch port rejects the
values it does not support in models/gbdt.py).

Re-expresses the reference's layered ``key=value`` config with alias
normalization (reference: include/LightGBM/config.h:320-410 alias table,
config.h:91-262 defaults, src/io/config.cpp:35-61 dispatch) as a single
Python dataclass.  Reference configs (``examples/*/train.conf``) parse
unchanged via :func:`Config.from_dict` / :func:`parse_config_file`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

from .log import Log

_warned_unknown_params: set = set()

# Alias table mirrors reference config.h:320-410 (KeyAliasTransform):
# an alias never overrides an explicitly-given canonical key.
PARAM_ALIASES: Dict[str, str] = {
    "config": "config_file",
    "nthread": "num_threads",
    "num_thread": "num_threads",
    "random_seed": "seed",
    "boosting": "boosting_type",
    "boost": "boosting_type",
    "application": "objective",
    "app": "objective",
    "train_data": "data",
    "train": "data",
    "model_output": "output_model",
    "model_out": "output_model",
    "model_input": "input_model",
    "model_in": "input_model",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "valid": "valid_data",
    "test_data": "valid_data",
    "test": "valid_data",
    "is_sparse": "is_enable_sparse",
    "tranining_metric": "is_training_metric",
    "train_metric": "is_training_metric",
    "ndcg_at": "ndcg_eval_at",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "num_leaf": "num_leaves",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "num_iteration": "num_iterations",
    "num_tree": "num_iterations",
    "num_round": "num_iterations",
    "num_trees": "num_iterations",
    "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "subsample_freq": "bagging_freq",
    "shrinkage_rate": "learning_rate",
    "tree": "tree_learner",
    "num_machine": "num_machines",
    "local_port": "local_listen_port",
    "two_round_loading": "use_two_round_loading",
    "two_round": "use_two_round_loading",
    "mlist": "machine_list_file",
    "is_save_binary": "is_save_binary_file",
    "save_binary": "is_save_binary_file",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "verbosity": "verbose",
    "header": "has_header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "query": "group_column",
    "query_column": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
    "categorical_feature": "categorical_column",
    "cat_column": "categorical_column",
    "cat_feature": "categorical_column",
    "predict_raw_score": "is_predict_raw_score",
    "predict_leaf_index": "is_predict_leaf_index",
    "raw_score": "is_predict_raw_score",
    "leaf_index": "is_predict_leaf_index",
    "min_split_gain": "min_gain_to_split",
    "topk": "top_k",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "num_classes": "num_class",
    "metrics": "metric",
    "metric_types": "metric",
}


def key_alias_transform(params: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize alias keys to canonical names (canonical key wins on clash)."""
    out: Dict[str, Any] = {}
    aliased: Dict[str, Any] = {}
    for k, v in params.items():
        canon = PARAM_ALIASES.get(k)
        if canon is None:
            out[k] = v
        else:
            aliased[canon] = v
    for k, v in aliased.items():
        out.setdefault(k, v)
    return out


def _to_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    return str(v).strip().lower() in ("true", "1", "yes", "y", "on", "+")


def _to_int_list(v: Any) -> List[int]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(x) for x in str(v).replace(",", " ").split()]


def _to_str_list(v: Any) -> List[str]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [str(x) for x in v]
    return [s for s in str(v).replace(",", " ").split()]


@dataclasses.dataclass
class Config:
    """All training/prediction parameters with reference defaults.

    Defaults mirror reference config.h:91-262 (max_bin=256, num_leaves=127,
    learning_rate=0.1, min_data_in_leaf=100, min_sum_hessian_in_leaf=10, ...).
    """

    # ---- task / IO (IOConfig, config.h:91-135)
    task: str = "train"
    # task=train_many: number of independent models trained on the one
    # shared binned dataset as a single batched program (engine.
    # train_many / learners/forest.py); model i gets seed+i so the
    # sweep is a seed-ensemble by default
    num_models: int = 2
    data: str = ""
    valid_data: List[str] = dataclasses.field(default_factory=list)
    max_bin: int = 256
    num_class: int = 1
    data_random_seed: int = 1
    output_model: str = "LightGBM_model.txt"
    input_model: str = ""
    output_result: str = "LightGBM_predict_result.txt"
    # use only the first N iterations at prediction time (config.h:102,
    # SetNumIterationForPred); <= 0 means all
    num_iteration_predict: int = -1
    verbose: int = 1
    has_header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_column: str = ""
    bin_construct_sample_cnt: int = 50000
    is_pre_partition: bool = False
    is_enable_sparse: bool = True
    # density below which the depthwise histogram switches to the O(nnz)
    # CSR path (ops/sparse_hist.py; reference ordered_sparse_bin.hpp:79-92
    # uses sparse_rate >= 0.8 per feature, i.e. density <= 0.2 — this is
    # the whole-dataset analog, conservative by default)
    sparse_hist_density: float = 0.05
    # when false, ignore an existing <data>.bin cache (config.h:107)
    enable_load_from_binary_file: bool = True
    use_two_round_loading: bool = False
    is_save_binary_file: bool = False
    is_predict_raw_score: bool = False
    is_predict_leaf_index: bool = False

    # ---- objective (ObjectiveConfig, config.h:137-152)
    objective: str = "regression"
    sigmoid: float = 1.0
    label_gain: List[float] = dataclasses.field(default_factory=list)
    max_position: int = 20
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0

    # ---- metric (MetricConfig, config.h:154-163)
    metric: List[str] = dataclasses.field(default_factory=list)
    metric_freq: int = 1  # a.k.a. output_freq
    is_training_metric: bool = False
    ndcg_eval_at: List[int] = dataclasses.field(default_factory=lambda: [1, 2, 3, 4, 5])

    # ---- tree (TreeConfig, config.h:165-190)
    min_data_in_leaf: int = 100
    min_sum_hessian_in_leaf: float = 10.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    num_leaves: int = 127
    feature_fraction_seed: int = 2
    feature_fraction: float = 1.0
    max_depth: int = -1
    top_k: int = 20
    # TPU extension: tree growth strategy.  "leafwise" reproduces the
    # reference's best-first growth exactly (serial_tree_learner.cpp:116-150);
    # "depthwise" grows level-by-level (one fused histogram pass per level,
    # much faster on TPU) while keeping the num_leaves budget via best-gain
    # masking at the final level.
    tree_growth: str = "leafwise"
    # TPU extension: histogram implementation for depthwise growth.
    # "segment" = jax.ops.segment_sum scatter; "matmul" = leaf-sorted MXU
    # one-hot matmul Pallas kernel (ops/pallas_histogram.py); "auto" picks
    # matmul on TPU backends, segment elsewhere.
    hist_impl: str = "auto"
    # TPU extension: histogram accumulation dtype.  The reference always
    # keeps sum_gradients/sum_hessians in double (include/LightGBM/
    # bin.h:21-22, split_info.hpp:24-40); float32 is the TPU-fast default
    # here, float64 restores the reference's accumulation exactly (and
    # makes parallel == serial trees bit-identical) at the cost of
    # emulated f64 on TPU hardware.
    hist_dtype: str = "float32"  # float32 | float64
    # Histogram HBM bound in MB (config.h:178, serial_tree_learner.cpp:
    # 25-37): <= 0 keeps every leaf's histogram resident; otherwise the
    # learner keeps floor(MB / per-leaf-histogram-MB) LRU slots (clamped
    # to [2, num_leaves]) and recomputes evicted parents from their
    # contiguous partition range.
    histogram_pool_size: float = -1.0
    # TPU extension: forest-level batched dispatch (learners/forest.py).
    # "auto" batches the K multiclass trees of an iteration into one
    # launch when the shape is small enough to win on dispatch overhead
    # (num_data <= LGBM_TPU_FOREST_MAX_ROWS, default 2048); "on" forces
    # batching regardless of shape; "off" keeps the sequential per-tree
    # grow loop.  Batched trees are bitwise-identical to sequential ones
    # (docs/forest_batching.md).
    forest_batching: str = "auto"

    # ---- boosting (BoostingConfig, config.h:192-221)
    boosting_type: str = "gbdt"
    num_iterations: int = 10
    learning_rate: float = 0.1
    bagging_fraction: float = 1.0
    bagging_seed: int = 3
    bagging_freq: int = 0
    early_stopping_round: int = 0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4

    # ---- tree learner selection (config.cpp:324-335)
    tree_learner: str = "serial"  # serial | feature | data | voting |
    # grid (TPU extension: rows x feature-search over a 2-D mesh)
    grid_feature_shards: int = 2  # feature-axis width of the grid mesh

    # ---- network (NetworkConfig, config.h:223-231): on TPU the "machines"
    # are mesh devices; these remain accepted for config compatibility.
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_file: str = ""

    seed: int = 0
    num_threads: int = 0

    # TPU extension (SURVEY 5.1), read by the CLI's task=train: a
    # torch.profiler trace of the training loop (host and, on the card,
    # CUDA kernels) into profile_dir as Chrome trace JSON (Perfetto).
    profile: bool = False
    profile_dir: str = "lightgbm_tpu_profile"

    # ---- resilience (docs/resilience.md)
    # checkpoint every N boosting iterations (0 = off); SIGTERM/SIGINT
    # always checkpoint before exiting regardless
    snapshot_freq: int = 0
    # checkpoint directory; default "<output_model>.ckpt"
    snapshot_dir: str = ""
    # resume from the newest valid checkpoint (bare --resume on the CLI);
    # the resumed run's final model is bitwise-identical to an
    # uninterrupted run of the same config
    resume: bool = False
    # non-finite gradient/hessian/leaf-output guard:
    # off (no checks) | raise (abort loudly) | skip_tree | clip
    nonfinite_policy: str = "off"
    # malformed rows / non-finite labels: false = counted+logged skip
    # (telemetry bad_rows), true = raise at load time
    strict_data: bool = False
    # multihost collective deadline in seconds (0 = wait forever);
    # LGBM_TPU_COLLECTIVE_DEADLINE_S overrides
    collective_deadline_s: float = 0.0

    # ---- online serving (task=serve; docs/serving.md)
    serve_host: str = "127.0.0.1"
    serve_port: int = 9090  # 0 = ephemeral (tests)
    # largest coalesced dispatch; also the top padded-shape bucket
    serve_max_batch_rows: int = 1024
    # micro-batch coalescing window: the oldest pending request never
    # waits longer than this before its batch dispatches
    serve_max_delay_ms: float = 2.0
    # explicit bucket ladder ("8 16 64 256"); empty = powers of two up
    # to serve_max_batch_rows
    serve_buckets: str = ""
    # require a .sha256 sidecar on the model loaded at serve startup
    # (hot-swap candidates ALWAYS require one; see docs/serving.md)
    serve_require_checksum: bool = False
    # admission control: rows admitted to the micro-batch queue at once
    # (0 = unbounded); an overflowing submit is shed with HTTP 429 and
    # a Retry-After hint instead of growing the backlog until every
    # request times out (docs/serving.md overload contract)
    serve_max_queue_rows: int = 8192
    # when set, the serve task writes {url, pid, model_id} here (atomic)
    # once the server is listening — the supervisor's readiness signal
    serve_ready_file: str = ""

    # ---- serving fleet (task=serve_fleet; serving/supervisor.py)
    # replica subprocesses at fleet start; also the scale-down floor
    serve_replicas: int = 2
    # autoscale ceiling off the queue-depth gauge; 0 = no autoscaling
    serve_max_replicas: int = 0
    # total replica restarts the supervisor performs (with jittered
    # exponential backoff) before failing the whole fleet loudly
    serve_restart_budget: int = 8

    # ---- training gang (task=train_fleet; resilience/gang.py)
    # rank subprocesses in the training gang
    train_ranks: int = 2
    # coordinated checkpoint barrier cadence in boosting iterations;
    # 0 = inherit snapshot_freq (one of the two must be > 0 for
    # task=train_fleet — a gang without barriers cannot roll back)
    gang_barrier_every: int = 0
    # total gang recoveries (restart or shrink, with jittered
    # exponential backoff) before the supervisor fails loudly
    gang_restart_budget: int = 8
    gang_backoff_base_s: float = 0.2
    gang_backoff_max_s: float = 5.0
    # consecutive deaths of ONE rank before the gang stops paying for it
    # and shrinks (escalation stage 3); same-world restarts below this
    gang_rank_fail_limit: int = 2
    # smallest world size the gang may shrink to
    gang_min_ranks: int = 1
    # heartbeat staleness (seconds) after which a live-looking rank is
    # declared hung and SIGKILLed; 0 disables hang detection
    gang_heartbeat_timeout_s: float = 60.0
    gang_ready_timeout_s: float = 180.0
    # shard the data file across ranks (reshard on shrink, gated on
    # global-histogram parity); false = every rank trains the full data
    gang_shard_data: bool = False
    # gang working dir (per-rank models/checkpoints/heartbeats/logs);
    # default "<output_model>.gang"
    gang_dir: str = ""

    def __post_init__(self):
        if not self.metric:
            self.metric = []
        # the reference's CHECKs fire on every construction path
        # (config.cpp:275-307 runs from Config::Init) — a direct
        # Config(...) call must not bypass them
        self._check_conflicts()

    # -- derived flags (CheckParamConflict, config.cpp:136-175)
    @property
    def is_parallel(self) -> bool:
        return self.tree_learner in ("feature", "data", "voting", "grid")

    @property
    def num_leaves_(self) -> int:
        return max(2, int(self.num_leaves))

    @classmethod
    def from_dict(cls, params: Dict[str, Any]) -> "Config":
        params = key_alias_transform(dict(params))
        known = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        for k, v in params.items():
            if k == "output_freq":
                k = "metric_freq"
            if k not in known:
                # reference warns on unrecognized params (config.cpp
                # unknown-param path) — a typo'd key must not train
                # silently with the default value.  Warn once per key:
                # from_dict runs several times per training session.
                if k not in _warned_unknown_params:
                    _warned_unknown_params.add(k)
                    Log.warning(f"Unknown parameter: {k}")
                continue
            f = known[k]
            if f.type in ("int", int):
                kwargs[k] = int(float(v))
            elif f.type in ("float", float):
                kwargs[k] = float(v)
            elif f.type in ("bool", bool):
                kwargs[k] = _to_bool(v)
            elif k in ("valid_data", "metric"):
                kwargs[k] = _to_str_list(v)
            elif k == "ndcg_eval_at":
                kwargs[k] = _to_int_list(v)
            elif k == "label_gain":
                kwargs[k] = [float(x) for x in _to_str_list(v)]
            else:
                kwargs[k] = str(v)
        return cls(**kwargs)  # __post_init__ runs _check_conflicts

    def _check_conflicts(self) -> None:
        """Mirror CheckParamConflict (config.cpp:136-175)."""
        if self.tree_learner not in (
            "serial", "feature", "data", "voting", "grid"
        ):
            raise ValueError(f"Unknown tree_learner: {self.tree_learner!r}")
        if self.grid_feature_shards < 1:
            raise ValueError(
                f"grid_feature_shards must be >= 1, got {self.grid_feature_shards}"
            )
        if self.boosting_type == "gbrt":  # accepted synonym (config.cpp:78)
            self.boosting_type = "gbdt"
        if self.boosting_type not in ("gbdt", "dart"):
            raise ValueError(f"Unknown boosting_type: {self.boosting_type!r}")
        if self.tree_growth not in ("leafwise", "depthwise", "hybrid"):
            raise ValueError(f"Unknown tree_growth: {self.tree_growth!r}")
        if self.hist_impl not in ("auto", "segment", "matmul"):
            raise ValueError(f"Unknown hist_impl: {self.hist_impl!r}")
        if self.hist_dtype not in ("float32", "float64"):
            raise ValueError(f"Unknown hist_dtype: {self.hist_dtype!r}")
        if self.forest_batching not in ("auto", "on", "off"):
            raise ValueError(
                f"Unknown forest_batching: {self.forest_batching!r}"
            )
        if self.max_bin < 2:
            raise ValueError("max_bin must be >= 2")
        # value-range CHECKs from the reference (config.cpp:275-307)
        if self.num_leaves <= 1:
            raise ValueError("num_leaves must be > 1")
        if not 0.0 < self.feature_fraction <= 1.0:
            raise ValueError("feature_fraction must be in (0, 1]")
        if not 0.0 < self.bagging_fraction <= 1.0:
            raise ValueError("bagging_fraction must be in (0, 1]")
        if self.bagging_freq < 0:
            raise ValueError("bagging_freq must be >= 0")
        if self.learning_rate <= 0.0:
            raise ValueError("learning_rate must be > 0")
        if self.lambda_l1 < 0.0 or self.lambda_l2 < 0.0:
            raise ValueError("lambda_l1/lambda_l2 must be >= 0")
        if self.min_gain_to_split < 0.0:
            raise ValueError("min_gain_to_split must be >= 0")
        # no max_depth CHECK: the reference accepts any value and treats
        # <= 0 as unlimited (config.h:182, serial_tree_learner.cpp:238),
        # and the learners here gate on max_depth <= 0 the same way
        if self.num_iterations < 0:
            raise ValueError("num_iterations must be >= 0")
        if self.early_stopping_round < 0:
            raise ValueError("early_stopping_round must be >= 0")
        if not (self.min_sum_hessian_in_leaf > 1.0 or self.min_data_in_leaf > 0):
            raise ValueError(
                "need min_sum_hessian_in_leaf > 1.0 or min_data_in_leaf > 0"
            )
        if self.metric_freq < 0:
            raise ValueError("metric_freq must be >= 0")
        if not 0.0 <= self.drop_rate <= 1.0:
            raise ValueError("drop_rate must be in [0, 1]")
        if self.nonfinite_policy not in ("off", "raise", "skip_tree", "clip"):
            raise ValueError(
                f"Unknown nonfinite_policy: {self.nonfinite_policy!r}"
            )
        if self.snapshot_freq < 0:
            raise ValueError("snapshot_freq must be >= 0")
        if self.collective_deadline_s < 0:
            raise ValueError("collective_deadline_s must be >= 0")
        if not 0 <= self.serve_port <= 65535:
            raise ValueError("serve_port must be in [0, 65535]")
        if self.serve_max_batch_rows < 1:
            raise ValueError("serve_max_batch_rows must be >= 1")
        if self.serve_max_delay_ms < 0:
            raise ValueError("serve_max_delay_ms must be >= 0")
        if self.serve_max_queue_rows < 0:
            raise ValueError(
                "serve_max_queue_rows must be >= 0 (0 = unbounded)")
        if self.serve_replicas < 1:
            raise ValueError("serve_replicas must be >= 1")
        if self.serve_max_replicas and \
                self.serve_max_replicas < self.serve_replicas:
            raise ValueError(
                "serve_max_replicas must be 0 (off) or >= serve_replicas")
        if self.serve_restart_budget < 0:
            raise ValueError("serve_restart_budget must be >= 0")
        if self.train_ranks < 1:
            raise ValueError("train_ranks must be >= 1")
        if self.gang_barrier_every < 0:
            raise ValueError("gang_barrier_every must be >= 0")
        if self.gang_restart_budget < 0:
            raise ValueError("gang_restart_budget must be >= 0")
        if self.gang_rank_fail_limit < 1:
            raise ValueError("gang_rank_fail_limit must be >= 1")
        if not 1 <= self.gang_min_ranks <= self.train_ranks:
            raise ValueError(
                "gang_min_ranks must be in [1, train_ranks]")
        if self.gang_backoff_base_s <= 0 or \
                self.gang_backoff_max_s < self.gang_backoff_base_s:
            raise ValueError(
                "need gang_backoff_base_s > 0 and "
                "gang_backoff_max_s >= gang_backoff_base_s")
        if self.gang_heartbeat_timeout_s < 0:
            raise ValueError("gang_heartbeat_timeout_s must be >= 0")
        if self.gang_ready_timeout_s <= 0:
            raise ValueError("gang_ready_timeout_s must be > 0")
        if not 0.0 <= self.skip_drop <= 1.0:
            raise ValueError("skip_drop must be in [0, 1]")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def parse_line_params(items: Sequence[str]) -> Dict[str, str]:
    """Parse ``key=value`` tokens (CLI argv / config lines), like Str2Map."""
    out: Dict[str, str] = {}
    for item in items:
        item = item.strip()
        if not item or item.startswith("#"):
            continue
        if "=" in item:
            k, v = item.split("=", 1)
            out[k.strip()] = v.split("#", 1)[0].strip()
    return out


def parse_config_file(path: str) -> Dict[str, str]:
    """Parse a reference-style config file (``key = value`` lines, # comments)."""
    with open(path, "r") as fh:
        return parse_line_params(fh.readlines())
