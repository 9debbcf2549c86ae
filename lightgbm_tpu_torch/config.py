"""Configuration for the PyTorch port (counterpart of lightgbm_tpu/config.py).

The alias table and parsing pipeline are the reference package's (raw
strings -> alias resolution -> typed ``Config`` fields -> consistency
checks).  ``Config`` has every field of the JAX package's, with its
default: the port implements it, or accepts it where the JAX package
gives it no effect either; ``refused_item`` names the ROADMAP item of a
parameter still to come (none is left).  ``tpu_on_device_error=fallback``
is refused for good.
Only parameters neither package knows warn, as in the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .utils import log

# Alias table (reference: src/io/config_auto.cpp:10-200), copied from
# lightgbm_tpu/config.py.  Maps alias -> canonical name.
_ALIASES: Dict[str, str] = {
    "config_file": "config",
    "task_type": "task",
    "objective_type": "objective", "app": "objective", "application": "objective",
    "boosting_type": "boosting", "boost": "boosting",
    "train": "data", "train_data": "data", "train_data_file": "data", "data_filename": "data",
    "test": "valid", "valid_data": "valid", "valid_data_file": "valid",
    "test_data": "valid", "test_data_file": "valid", "valid_filenames": "valid",
    "num_iteration": "num_iterations", "n_iter": "num_iterations",
    "num_tree": "num_iterations", "num_trees": "num_iterations",
    "num_round": "num_iterations", "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations", "n_estimators": "num_iterations",
    "shrinkage_rate": "learning_rate", "eta": "learning_rate",
    "num_leaf": "num_leaves", "max_leaves": "num_leaves", "max_leaf": "num_leaves",
    "tree": "tree_learner", "tree_type": "tree_learner", "tree_learner_type": "tree_learner",
    "num_thread": "num_threads", "nthread": "num_threads", "nthreads": "num_threads",
    "n_jobs": "num_threads",
    "device": "device_type",
    "random_seed": "seed", "random_state": "seed",
    "min_data_per_leaf": "min_data_in_leaf", "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf", "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "sub_row": "bagging_fraction", "subsample": "bagging_fraction", "bagging": "bagging_fraction",
    "pos_sub_row": "pos_bagging_fraction", "pos_subsample": "pos_bagging_fraction",
    "pos_bagging": "pos_bagging_fraction",
    "neg_sub_row": "neg_bagging_fraction", "neg_subsample": "neg_bagging_fraction",
    "neg_bagging": "neg_bagging_fraction",
    "subsample_freq": "bagging_freq",
    "bagging_fraction_seed": "bagging_seed",
    "sub_feature": "feature_fraction", "colsample_bytree": "feature_fraction",
    "sub_feature_bynode": "feature_fraction_bynode", "colsample_bynode": "feature_fraction_bynode",
    "early_stopping_rounds": "early_stopping_round", "early_stopping": "early_stopping_round",
    "n_iter_no_change": "early_stopping_round",
    "max_tree_output": "max_delta_step", "max_leaf_output": "max_delta_step",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2", "lambda": "lambda_l2",
    "min_split_gain": "min_gain_to_split",
    "rate_drop": "drop_rate",
    "topk": "top_k",
    "mc": "monotone_constraints", "monotone_constraint": "monotone_constraints",
    "feature_contrib": "feature_contri", "fc": "feature_contri", "fp": "feature_contri",
    "feature_penalty": "feature_contri",
    "fs": "forcedsplits_filename", "forced_splits_filename": "forcedsplits_filename",
    "forced_splits_file": "forcedsplits_filename", "forced_splits": "forcedsplits_filename",
    "verbose": "verbosity",
    "max_bins": "max_bin",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "hist_pool_size": "histogram_pool_size",
    "data_seed": "data_random_seed",
    "model_output": "output_model", "model_out": "output_model",
    "save_period": "snapshot_freq",
    "model_input": "input_model", "model_in": "input_model",
    "model_file": "input_model",
    "predict_result": "output_result", "prediction_result": "output_result",
    "predict_name": "output_result", "prediction_name": "output_result",
    "pred_name": "output_result", "name_pred": "output_result",
    "init_score_filename": "initscore_filename", "init_score_file": "initscore_filename",
    "init_score": "initscore_filename", "input_init_score": "initscore_filename",
    "is_pre_partition": "pre_partition",
    "is_enable_bundle": "enable_bundle", "bundle": "enable_bundle",
    "is_sparse": "is_enable_sparse", "enable_sparse": "is_enable_sparse", "sparse": "is_enable_sparse",
    "two_round_loading": "two_round", "use_two_round_loading": "two_round",
    "is_save_binary": "save_binary", "is_save_binary_file": "save_binary",
    "has_header": "header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column", "group_id": "group_column",
    "query_column": "group_column", "query": "group_column", "query_id": "group_column",
    "ignore_feature": "ignore_column", "blacklist": "ignore_column",
    "cat_feature": "categorical_feature", "categorical_column": "categorical_feature",
    "cat_column": "categorical_feature",
    "is_predict_raw_score": "predict_raw_score", "predict_rawscore": "predict_raw_score",
    "raw_score": "predict_raw_score",
    "is_predict_leaf_index": "predict_leaf_index", "leaf_index": "predict_leaf_index",
    "is_predict_contrib": "predict_contrib", "contrib": "predict_contrib",
    "convert_model_file": "convert_model",
    "num_classes": "num_class",
    "unbalance": "is_unbalance", "unbalanced_sets": "is_unbalance",
    "metrics": "metric", "metric_types": "metric",
    "output_freq": "metric_freq",
    "training_metric": "is_provide_training_metric", "is_training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "ndcg_eval_at": "eval_at", "ndcg_at": "eval_at", "map_eval_at": "eval_at",
    "map_at": "eval_at",
    "num_machine": "num_machines",
    "local_port": "local_listen_port", "port": "local_listen_port",
    "machine_list_file": "machine_list_filename",
    "machine_list": "machine_list_filename", "mlist": "machine_list_filename",
    "workers": "machines", "nodes": "machines",
}

_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}

# Parameters of the JAX package whose non-default value changes what is
# trained, predicted or written, but which the port does not implement
# yet: canonical name -> the ROADMAP.md item that brings it.  None is left:
# every field of the JAX package's ``Config`` is a field here too,
# implemented, or accepted with no effect where the JAX package gives it
# none (the field's comment says so).
_REFUSED: Dict[str, str] = {}
# tpu_on_device_error=fallback, refused for good: a step that launched
# kernels on the card never carries on on the CPU
_FALLBACK = "CPU fallback of a failed device step"
# tree_learner's LightGBM aliases (reference: config.cpp GetTreeLearnerType)
_TREE_LEARNERS = {
    "serial_tree_learner": "serial", "feature_parallel": "feature",
    "feature_parallel_tree_learner": "feature", "data_parallel": "data",
    "data_parallel_tree_learner": "data", "voting_parallel": "voting",
    "voting_parallel_tree_learner": "voting", "voting_tree_learner": "voting",
}


def refused_item(name: str) -> Optional[str]:
    """The ROADMAP.md item a parameter waits for, or None when the port
    runs every value of it."""
    return _REFUSED.get(name)


def parse_objective_alias(name: str) -> str:
    name = name.strip().lower()
    return _OBJECTIVE_ALIASES.get(name, name)


@dataclass
class Config:
    """Typed parameter set; field names match the reference's."""
    # ---- Core ----
    config: str = ""                    # the CLI's config file (app.py)
    task: str = "train"                 # train, predict, serve, online,
                                        # convert_model, refit
    objective: str = "regression"
    boosting: str = "gbdt"
    data: str = ""
    valid: List[str] = field(default_factory=list)
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"
    num_threads: int = 0                # no effect (as in the JAX package)
    device_type: str = "cuda"           # cuda (alias gpu) or cpu
    seed: int = 0

    # ---- Learning control ----
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    early_stopping_round: int = 0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1              # DART (boosting/dart.py)
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2               # GOSS: kept share by |g*h|
    other_rate: float = 0.1             # GOSS: drawn share of the rest
    min_data_per_group: int = 100       # categorical split search
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20                     # voting parallel only: no effect on
                                        # the serial learner
    monotone_constraints: List[int] = field(default_factory=list)
    feature_contri: List[float] = field(default_factory=list)
    max_bin_by_feature: List[int] = field(default_factory=list)
    forcedsplits_filename: str = ""
    forcedbins_filename: str = ""
    refit_decay_rate: float = 0.9
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)
    verbosity: int = 1

    # ---- IO ----
    max_bin: int = 255
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    histogram_pool_size: float = -1.0   # no effect (as in the JAX package)
    data_random_seed: int = 1
    output_model: str = "LightGBM_model.txt"
    snapshot_freq: int = -1
    input_model: str = ""
    output_result: str = "LightGBM_predict_result.txt"
    initscore_filename: str = ""
    valid_data_initscores: List[str] = field(default_factory=list)
    pre_partition: bool = False         # no effect (as in the JAX package)
    enable_bundle: bool = True
    max_conflict_rate: float = 0.0
    is_enable_sparse: bool = True       # no effect (as in the JAX package)
    sparse_threshold: float = 0.8       # no effect (as in the JAX package)
    use_missing: bool = True
    zero_as_missing: bool = False
    two_round: bool = False
    save_binary: bool = False
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_feature: str = ""

    # ---- Predict ----
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    num_iteration_predict: int = -1
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    predict_disable_shape_check: bool = False  # no effect: the JAX package
                                        # reads it only as a keyword of its
                                        # sklearn wrapper's predict
    convert_model_language: str = ""    # task=convert_model writes C in
                                        # any case, as the JAX package does
    convert_model: str = "gbdt_prediction.cpp"

    # ---- Objective ----
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9                  # huber and quantile
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    max_position: int = 20              # lambdarank: NDCG truncation
    lambdamart_norm: bool = True
    label_gain: List[float] = field(default_factory=list)

    # ---- Metric ----
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1
    auc_mu_weights: List[float] = field(default_factory=list)

    # ---- Network (parallel/; the tpu_fleet family: fleet/) ----
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    machines: str = ""
    tpu_fleet: int = 0
    tpu_fleet_heartbeat_s: float = 30.0
    tpu_fleet_transport: str = "auto"
    tpu_fleet_dir: str = ""
    tpu_fleet_port: int = 0
    tpu_fleet_min_ranks: int = 1
    tpu_fleet_heal: bool = True
    tpu_fleet_max_recoveries: int = 2

    # ---- Device ----
    gpu_platform_id: int = -1           # no effect (as in the JAX package)
    gpu_device_id: int = -1             # no effect (as in the JAX package)
    gpu_use_dp: bool = False
    tpu_hist_dtype: str = "2xbf16"      # histogram input rounding of g/h:
                                        # 2xbf16 = hi/lo bf16 split, bf16
                                        # = one rounding, highest = f32;
                                        # int16 / int8 = quantized g/h,
                                        # integer accumulation
    tpu_fused_grad: bool = True         # the port's gradients are always
                                        # materialised (GBDT.train_one_iter):
                                        # both values take that one path
    tpu_rank_device_eval: bool = True   # NDCG: false = the host loop
    tpu_rank_sharded_grad: bool = True  # no effect on the serial learner
    tpu_wave_overlap: bool = False      # defer each wave's split scan by
                                        # one loop body (the grower's
                                        # overlap="on"; its oracle
                                        # "serial" is a grower argument,
                                        # as in the JAX package)
    tpu_block_rows: int = 1024          # the Pallas kernel's row tile; the
                                        # port's K1 sums fixed point, which
                                        # no tile changes
    tpu_wave_capacity: int = 63         # leaves histogrammed per wave
    tpu_fused_sibling: bool = True      # siblings from the same launch
    tpu_wave_gain_gate: float = 0.5     # split-phase commit throttle
    tpu_batched_split_apply: bool = True  # false = one walk of all rows per
                                        # split (the oracle); same trees
    tpu_compile_cache_dir: str = ""     # no effect (as in the JAX package)
    tpu_mesh_shape: str = ""
    # observability (obs/)
    tpu_telemetry: str = ""             # telemetry sink: a dir or *.jsonl
    tpu_health: str = ""                # "", monitor or strict
    tpu_fingerprint_freq: int = 1       # the health fingerprint's and the
                                        # rank exchange's cadence
    tpu_profile: bool = False           # kernel times against bounds
    tpu_xprof: bool = False             # a torch.profiler window
    tpu_xprof_iters: int = 3            # of this many iterations
    tpu_trace: bool = False             # spans into the sink
    # fault tolerance (robust/)
    tpu_checkpoint_dir: str = ""        # "" = no checkpoints
    tpu_checkpoint_freq: int = 100      # iterations between checkpoints
    tpu_checkpoint_keep: int = 3        # newest checkpoints kept
    tpu_on_device_error: str = "retry"  # retry or abort (fallback refused)
    tpu_watchdog: bool = False          # guard every device step
    tpu_device_retries: int = 3         # transient retries a step
    tpu_wedge_timeout_s: float = 0.0    # stall deadline, 0 = automatic
    # observability, continued (in the JAX package's order, which the
    # parameter block of model text follows)
    tpu_flight_len: int = 256           # flight ring, armed under trace,
                                        # health, the watchdog or serving
    tpu_train_metrics_port: int = -1    # the train board, -1 off, 0 a free
                                        # port (obs/board.py)
    tpu_straggler_factor: float = 2.0   # across ranks: a rank this many
    tpu_straggler_iters: int = 3        # times the median wall for this
                                        # many iterations is a straggler
                                        # (obs/ranks.py; 0: not checked)
    # serving (serve/): task=serve and the heavy task=predict
    tpu_serve_max_batch: int = 1024
    tpu_serve_max_wait_ms: float = 2.0
    tpu_serve_queue_depth: int = 8192
    tpu_serve_host: str = "127.0.0.1"
    tpu_serve_port: int = 0
    tpu_serve_reprobe_s: float = 30.0
    tpu_serve_slo_p99_ms: float = 250.0
    tpu_serve_replicas: int = 2
    tpu_serve_breaker_trip: int = 3
    tpu_serve_breaker_backoff_s: float = 0.5
    tpu_serve_canary_rows: int = 64
    tpu_serve_canary_probes: int = 16
    tpu_serve_canary_p99_ms: float = 0.0
    tpu_serve_rollback_watch_s: float = 30.0
    tpu_serve_rollback_error_rate: float = 0.5
    tpu_serve_rollback_degraded: int = 2
    tpu_serve_rollback_slo_burn: float = 0.0
    tpu_serve_shed_low_frac: float = 0.5
    tpu_serve_shed_normal_frac: float = 0.85
    tpu_serve_retry_after_s: float = 1.0
    tpu_serve_swap_warmup: bool = True
    tpu_serve_aot: bool = True          # false disarms the serving store
    tpu_serve_aot_dir: str = ""
    tpu_serve_arena_bytes: int = 0
    tpu_explain: bool = True
    tpu_explain_max_batch: int = 256
    tpu_explain_max_wait_ms: float = 5.0
    # online learning (online/): the leaf refit's path (true = the
    # device refit, online/refit.py; false = the host oracle), then the
    # online loop's knobs (online/loop.py)
    tpu_refit_device: bool = True
    tpu_online_mode: str = "refit"
    tpu_online_window: int = 50000
    tpu_online_refit_every: int = 5000
    tpu_online_refit_every_s: float = 0.0
    tpu_online_trees: int = 10
    tpu_online_decay: float = -1.0
    tpu_online_model: str = "default"
    tpu_online_source: str = ""
    tpu_online_follow: bool = False
    tpu_online_dir: str = ""
    # streaming ingestion (ingest/)
    tpu_ingest: bool = False
    tpu_ingest_chunk_rows: int = 65536
    tpu_ingest_memmap: str = ""
    tpu_ingest_shards: int = 0
    tpu_ingest_shard_id: int = -1
    tpu_ingest_sample_seed: int = -1
    # drift and quality (obs/drift.py, serve/quality.py)
    tpu_drift: bool = True              # arm drift monitoring in serving
                                        # where a model's sidecar is found
    tpu_quality_profile: bool = True    # write <model>.quality.json beside
                                        # a saved model
    tpu_drift_sample_rate: float = 0.05
    tpu_drift_check_s: float = 30.0
    tpu_drift_min_rows: int = 200
    tpu_drift_psi_warn: float = 0.25
    tpu_quality_window: int = 512
    tpu_quality_drop_warn: float = 0.05
    tpu_serve_rollback_on_drift: bool = False
    is_parallel: bool = field(default=False, repr=False)  # derived

    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]]) -> "Config":
        cfg = cls()
        cfg.update(params or {})
        return cfg

    def update(self, params: Dict[str, Any]) -> None:
        resolved: Dict[str, Any] = {}
        for key, value in params.items():
            canon = _ALIASES.get(key, key)
            if canon in resolved and key != canon:
                continue  # explicit canonical name wins over alias
            resolved[canon] = value
        fields = {f.name: f for f in dataclasses.fields(self)}
        for key, value in resolved.items():
            if key not in fields:
                log.warning("Unknown parameter: %s", key)
                continue
            setattr(self, key, _coerce(fields[key], value))
        self._post_process()

    def _post_process(self) -> None:
        log.set_verbosity(self.verbosity)
        self.objective = parse_objective_alias(self.objective)
        self.boosting = {"gbrt": "gbdt", "random_forest": "rf"}.get(
            self.boosting, self.boosting)
        self.tree_learner = _TREE_LEARNERS.get(self.tree_learner,
                                               self.tree_learner)
        if self.tree_learner not in ("serial", "feature", "data", "voting"):
            log.fatal(f"Unknown tree learner type {self.tree_learner}")
        self.is_parallel = (self.tree_learner != "serial"
                            or self.num_machines > 1)
        if self.is_parallel and self.monotone_constraints:
            log.fatal("Cannot use monotone constraints in parallel learning")
        if self.boosting not in ("gbdt", "goss", "dart", "rf"):
            log.fatal(f"Unknown boosting type {self.boosting}")
        for f in dataclasses.fields(self):
            item = refused_item(f.name)
            if item is not None and getattr(self, f.name) != _default(f):
                log.refuse(f"{f.name}={getattr(self, f.name)!r}", item)
        if self.boosting == "rf" and (self.bagging_freq <= 0 or not (
                0.0 < self.bagging_fraction < 1.0)):
            log.fatal("bagging_freq and bagging_fraction (in (0,1)) are "
                      "required for rf")
        if self.tpu_on_device_error == "fallback":
            log.refuse("tpu_on_device_error='fallback'", _FALLBACK)
        if self.tpu_on_device_error not in ("abort", "retry"):
            log.fatal("tpu_on_device_error should be abort or retry")
        if self.tpu_checkpoint_freq < 0:
            log.fatal("tpu_checkpoint_freq should be >= 0")
        if self.tpu_checkpoint_keep < 1:
            log.fatal("tpu_checkpoint_keep should be >= 1")
        if self.tpu_device_retries < 0:
            log.fatal("tpu_device_retries should be >= 0")
        if self.tpu_wedge_timeout_s < 0:
            log.fatal("tpu_wedge_timeout_s should be >= 0")
        if self.tpu_serve_max_batch < 1:
            log.fatal("tpu_serve_max_batch should be >= 1")
        if self.tpu_serve_max_wait_ms < 0:
            log.fatal("tpu_serve_max_wait_ms should be >= 0")
        if self.tpu_serve_queue_depth < self.tpu_serve_max_batch:
            log.fatal("tpu_serve_queue_depth should be >= "
                      "tpu_serve_max_batch")
        if not (0 <= self.tpu_serve_port <= 65535):
            log.fatal("tpu_serve_port should be in [0, 65535]")
        if self.tpu_serve_slo_p99_ms < 0:
            log.fatal("tpu_serve_slo_p99_ms should be >= 0")
        if self.tpu_serve_replicas < 1:
            log.fatal("tpu_serve_replicas should be >= 1")
        if self.tpu_serve_breaker_trip < 1:
            log.fatal("tpu_serve_breaker_trip should be >= 1")
        if self.tpu_serve_canary_rows < 1:
            log.fatal("tpu_serve_canary_rows should be >= 1")
        if not (0.0 <= self.tpu_serve_rollback_error_rate <= 1.0):
            log.fatal("tpu_serve_rollback_error_rate should be in [0, 1]")
        if not (0.0 <= self.tpu_serve_shed_low_frac <= 1.0):
            log.fatal("tpu_serve_shed_low_frac should be in [0, 1]")
        if not (0.0 <= self.tpu_serve_shed_normal_frac <= 1.0):
            log.fatal("tpu_serve_shed_normal_frac should be in [0, 1]")
        if self.tpu_serve_rollback_watch_s < 0:
            log.fatal("tpu_serve_rollback_watch_s should be >= 0")
        if self.tpu_serve_arena_bytes < 0:
            log.fatal("tpu_serve_arena_bytes should be >= 0")
        if self.tpu_explain_max_batch < 1:
            log.fatal("tpu_explain_max_batch should be >= 1")
        if self.tpu_explain_max_wait_ms < 0:
            log.fatal("tpu_explain_max_wait_ms should be >= 0")
        if self.tpu_serve_reprobe_s < 0:
            log.fatal("tpu_serve_reprobe_s should be >= 0")
        if self.tpu_online_mode not in ("refit", "continue"):
            log.fatal("tpu_online_mode should be refit or continue")
        if self.tpu_online_window < 1:
            log.fatal("tpu_online_window should be >= 1")
        if self.tpu_online_refit_every < 0:
            log.fatal("tpu_online_refit_every should be >= 0")
        if self.tpu_online_refit_every_s < 0:
            log.fatal("tpu_online_refit_every_s should be >= 0")
        if self.tpu_online_trees < 1:
            log.fatal("tpu_online_trees should be >= 1")
        if self.tpu_online_decay > 1.0:
            log.fatal("tpu_online_decay should be <= 1 (negative = "
                      "inherit refit_decay_rate)")
        if (self.task == "online" and self.tpu_online_refit_every <= 0
                and self.tpu_online_refit_every_s <= 0):
            log.fatal("task=online needs a refresh cadence: set "
                      "tpu_online_refit_every (rows) and/or "
                      "tpu_online_refit_every_s (seconds)")
        if self.tpu_ingest_chunk_rows < 1:
            log.fatal("tpu_ingest_chunk_rows should be >= 1")
        if self.tpu_ingest_shards < 0:
            log.fatal("tpu_ingest_shards should be >= 0")
        if (self.tpu_ingest_shards > 1
                and self.tpu_ingest_shard_id >= self.tpu_ingest_shards):
            log.fatal("tpu_ingest_shard_id should be < tpu_ingest_shards "
                      "(or -1 for the process rank)")
        if self.tpu_fleet < 0:
            log.fatal("tpu_fleet should be >= 0")
        if self.tpu_fleet_heartbeat_s <= 0:
            log.fatal("tpu_fleet_heartbeat_s should be > 0 (seconds)")
        if self.tpu_fleet_transport not in ("auto", "jax", "host"):
            log.fatal("tpu_fleet_transport should be auto, jax or host")
        if self.tpu_fleet_min_ranks < 1:
            log.fatal("tpu_fleet_min_ranks should be >= 1")
        if self.tpu_fleet_max_recoveries < 0:
            log.fatal("tpu_fleet_max_recoveries should be >= 0")
        if self.tpu_block_rows < 128 or self.tpu_block_rows % 128 != 0:
            log.fatal("tpu_block_rows should be a positive multiple of 128")
        from .obs.health import parse_mode
        self.tpu_health = parse_mode(self.tpu_health, fatal=True)
        if self.tpu_fingerprint_freq < 0:
            log.fatal("tpu_fingerprint_freq should be >= 0")
        if self.tpu_flight_len < 0:
            log.fatal("tpu_flight_len should be >= 0")
        if self.tpu_straggler_factor <= 1.0:
            log.fatal("tpu_straggler_factor should be > 1")
        if self.tpu_straggler_iters < 0:
            log.fatal("tpu_straggler_iters should be >= 0")
        if self.objective in ("multiclass", "multiclassova") \
                and self.num_class < 2:
            log.fatal(f"num_class must be >= 2 for objective {self.objective}")
        if self.objective not in ("multiclass", "multiclassova", "none") \
                and self.num_class != 1:
            log.fatal(f"num_class must be 1 for objective {self.objective}")
        if self.tpu_hist_dtype not in ("2xbf16", "bf16", "highest",
                                       "int16", "int8",
                                       "float32", "bfloat16"):
            log.fatal("tpu_hist_dtype should be 2xbf16, bf16, highest, "
                      "int16 or int8 "
                      "(aliases: float32 -> 2xbf16, bfloat16 -> bf16)")
        if self.tpu_hist_dtype in ("int16", "int8") \
                and self.num_leaves > 32000:
            log.fatal("quantized histogram modes carry leaf ids in the "
                      "int16 vector stream: num_leaves must be <= 32000")
        if not (0.0 < self.bagging_fraction <= 1.0):
            log.fatal("bagging_fraction should be in (0.0, 1.0]")
        if not (0.0 < self.feature_fraction <= 1.0):
            log.fatal("feature_fraction should be in (0.0, 1.0]")
        if not (0.0 < self.feature_fraction_bynode <= 1.0):
            log.fatal("feature_fraction_bynode should be in (0.0, 1.0]")
        if self.num_leaves < 2:
            log.fatal("num_leaves should be >= 2")
        if not (1 < self.max_bin <= 65535):
            log.fatal("max_bin should be in (1, 65535]")
        self.device_type = self.device_type.strip().lower()
        if self.device_type == "gpu":
            self.device_type = "cuda"
        if self.device_type not in ("cuda", "cpu"):
            log.fatal(f"device_type={self.device_type!r}: the PyTorch port "
                      "runs on cuda (alias gpu) or cpu")
        if not (0.0 <= self.tpu_wave_gain_gate <= 1.0):
            log.fatal("tpu_wave_gain_gate should be in [0.0, 1.0]")
        if self.tpu_wave_capacity < 1:
            log.fatal("tpu_wave_capacity should be >= 1")

    def hist_mode(self) -> str:
        """Histogram rounding mode by kernel-mode name (reference:
        gbdt.py ``_hist_mode``)."""
        if self.gpu_use_dp or self.tpu_hist_dtype == "highest":
            return "highest"
        if self.tpu_hist_dtype in ("bfloat16", "bf16"):
            return "bf16"
        if self.tpu_hist_dtype in ("int16", "int8"):
            return self.tpu_hist_dtype
        return "2xbf16"

    def to_params(self) -> Dict[str, Any]:
        """The parameters a model's text lists: the fields off their
        default, and every list-typed field (the JAX package compares a
        ``default_factory`` field against None, so its model text always
        lists them; lightgbm_tpu/config.py ``to_params``)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name != "is_parallel"
                and getattr(self, f.name) != (
                    f.default if f.default is not dataclasses.MISSING
                    else None)}


def _default(fld: dataclasses.Field):
    return (fld.default if fld.default is not dataclasses.MISSING
            else fld.default_factory())


def _coerce(fld: dataclasses.Field, value: Any):
    """Coerce a raw parameter value (possibly a string) to the field's type."""
    ftype = fld.type if isinstance(fld.type, str) else getattr(
        fld.type, "__name__", str(fld.type))
    if "List" in ftype:
        if value is None:
            return []
        if isinstance(value, str):
            items = [x for x in value.replace(",", " ").split() if x]
        elif isinstance(value, (set, frozenset)):
            items = sorted(value, key=str)
        elif isinstance(value, (list, tuple)):
            items = list(value)
        else:
            items = [value]
        if "int" in ftype:
            return [int(float(x)) for x in items]
        if "float" in ftype:
            return [float(x) for x in items]
        return [str(x) for x in items]
    if "bool" in ftype:
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes", "+", "t")
        return bool(value)
    if ftype.startswith("int"):
        return int(float(value))
    if ftype.startswith("float"):
        return float(value)
    if isinstance(value, (list, tuple)):
        return ",".join(str(x) for x in value)
    return str(value)


def read_config_file(path: str) -> Dict[str, str]:
    """Parse a LightGBM ``train.conf``-style file: one ``key = value`` per
    line, ``#`` comments (reference: Application::LoadParameters)."""
    out: Dict[str, str] = {}
    with open(path, "r") as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out
