"""Configuration system.

TPU-native re-design of the reference config layer
(LightGBM's include/LightGBM/config.h:86-284 and src/io/config.cpp):
a single flat dataclass of typed parameters with LightGBM-compatible names,
defaults, and the full alias table (config.h:342-436).  Unlike the reference's
struct-per-layer split (IOConfig/TreeConfig/BoostingConfig/...), one frozen
dataclass is passed everywhere; jitted code receives it as a hashable static
argument.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

# the predict_kernel dial's legal values — defined here (stdlib-only
# module) so config validation and ops/predict.resolve_predict_kernel
# check against ONE tuple and can't drift
PREDICT_KERNELS = ("auto", "tensorized", "walk")

# the costack_kernel dial's legal values — grouped-traversal strategy
# of cross-model co-stacked serving (docs/serving.md "Cross-model
# batching"): "stacked" walks every stacked tree for every row (free
# where launch overhead dominates), "segment" gathers only the row's
# own tenant's tree segment per depth level (node math ~1x a solo
# tenant's on compute-bound tiers), "auto" resolves per backend
# (ops/predict.resolve_costack_kernel).  Both are bitwise-identical
# to per-tenant dispatch.
COSTACK_KERNELS = ("auto", "stacked", "segment")

# the serve_quantize dial's legal values — request-path feature
# quantization (docs/serving.md "Binned inference"): "binned" serves
# integer bins end-to-end against the model's .refbin frozen-mapper
# sidecar, "raw" keeps f32 feature traversal, "auto" picks binned
# whenever a valid sidecar is present
SERVE_QUANTIZE_MODES = ("auto", "binned", "raw")

# tenant ids of the multi-tenant serving catalog (`serve_models`
# entries, /predict `model` routing).  The charset is deliberately
# tight: ids are echoed into HTTP headers, Prometheus label values,
# telemetry attrs, and traffic-log records, so identifier-shaped ids
# need no escaping at any of those hops.
MODEL_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


class ServeModelEntry(str):
    """One parsed `serve_models` entry: the model PATH (this object IS
    the path — a str subclass, so every caller that treats catalog
    values as path strings keeps working) plus the tenant's validated
    per-tenant overrides dict (possibly empty)."""
    __slots__ = ("overrides",)

    def __new__(cls, path: str, overrides: Optional[dict] = None):
        self = super().__new__(cls, path)
        self.overrides = dict(overrides or {})
        return self

    @property
    def path(self) -> str:
        return str(self)


# the per-tenant keys a `serve_models` entry may override after its
# path (docs/serving.md "Cross-model batching"), normalized to the
# catalog's kwarg names; every alias of the fleet-wide parameter is
# accepted so `de=/m/de.txt;num_replicas=2` means what the operator
# expects
_SERVE_OVERRIDE_KEYS: Dict[str, str] = {
    "replicas": "replicas",
    "serve_replicas": "replicas",
    "serving_replicas": "replicas",
    "num_replicas": "replicas",
    "serve_quantize": "serve_quantize",
    "max_pending_rows": "max_pending_rows",
    "costack": "costack",
    "serve_costack": "costack",
    "cross_model_batching": "costack",
}

_BOOL_WORDS = {"true": True, "on": True, "1": True, "yes": True,
               "false": False, "off": False, "0": False, "no": False}


def _parse_serve_override(entry, key: str, value: str):
    """Validate + coerce ONE `;key=value` tenant override."""
    canon = _SERVE_OVERRIDE_KEYS.get(key)
    if canon is None:
        raise ValueError(
            f"serve_models entry {entry!r}: unknown per-tenant "
            f"override {key!r}; use one of "
            f"{sorted(set(_SERVE_OVERRIDE_KEYS.values()))}")
    if canon in ("replicas", "max_pending_rows"):
        try:
            n = int(value)
        except ValueError:
            raise ValueError(
                f"serve_models entry {entry!r}: {key}={value!r} "
                "is not an integer")
        if n < 0:
            raise ValueError(
                f"serve_models entry {entry!r}: {key} must be >= 0")
        return canon, n
    if canon == "serve_quantize":
        if value not in SERVE_QUANTIZE_MODES:
            raise ValueError(
                f"serve_models entry {entry!r}: serve_quantize="
                f"{value!r}; use one of {SERVE_QUANTIZE_MODES}")
        return canon, value
    b = _BOOL_WORDS.get(str(value).strip().lower())
    if b is None:
        raise ValueError(
            f"serve_models entry {entry!r}: {key}={value!r} is not "
            "a boolean (true/false/on/off/1/0)")
    return canon, b


def parse_serve_models(entries) -> Dict[str, "ServeModelEntry"]:
    """``("de=/models/de.txt", "fr=/models/fr.txt;replicas=2")`` →
    ordered ``{id: ServeModelEntry}`` (the value IS the model path — a
    str subclass — carrying a validated per-tenant ``overrides`` dict).
    The ONE place the `serve_models` grammar lives — config validation,
    `task=serve` catalog construction, and the `task=online` per-tenant
    daemon fleet all route through here.  Grammar per entry:
    ``id=path[;key=value]...`` with override keys ``replicas``,
    ``serve_quantize``, ``max_pending_rows``, ``costack`` (fleet-wide
    parameter aliases accepted).  Raises ValueError on a missing ``=``,
    an id outside MODEL_ID_RE, an empty path, a duplicate id, or a
    malformed override."""
    out: Dict[str, ServeModelEntry] = {}
    for entry in entries:
        mid, sep, rest = str(entry).partition("=")
        mid = mid.strip()
        path, *extras = rest.split(";")
        path = path.strip()
        if not sep or not path:
            raise ValueError(
                f"serve_models entry {entry!r} is not "
                "'id=path[;key=value]'")
        if not MODEL_ID_RE.match(mid):
            raise ValueError(
                f"serve_models id {mid!r} must match "
                "[A-Za-z0-9._-]{1,64}")
        if mid in out:
            raise ValueError(f"serve_models id {mid!r} appears twice")
        if path in out.values():
            # two tenants on one file would share publish/state/refbin
            # sidecars: their online daemons would clobber each other's
            # publishes and resume offsets
            raise ValueError(
                f"serve_models path {path!r} appears under two ids")
        overrides: Dict[str, object] = {}
        for extra in extras:
            k, ksep, v = extra.partition("=")
            k, v = k.strip(), v.strip()
            if not ksep or not k or not v:
                raise ValueError(
                    f"serve_models entry {entry!r}: override "
                    f"{extra!r} is not 'key=value'")
            canon, coerced = _parse_serve_override(entry, k, v)
            if canon in overrides:
                raise ValueError(
                    f"serve_models entry {entry!r}: override "
                    f"{canon!r} appears twice")
            overrides[canon] = coerced
        out[mid] = ServeModelEntry(path, overrides)
    return out


def parse_route_backends(entries) -> Tuple[Tuple[str, ...], Dict[str, str]]:
    """``("127.0.0.1:8081", "de=127.0.0.1:8082")`` →
    ``(backends, overrides)``.  The ONE place the `route_backends`
    grammar lives — config validation and the `task=route` router both
    route through here.  A bare ``host:port`` entry is a backend; an
    entry with ``=`` is an explicit placement override pinning a model
    id to one of the listed backends (it must appear as a bare entry
    too — an override may pin placement but never name a backend the
    health loop does not watch).  Raises ValueError on a malformed
    address, an id outside MODEL_ID_RE, a duplicate backend or
    override, or an override whose target is not a listed backend."""
    backends: List[str] = []
    overrides: Dict[str, str] = {}
    for entry in entries:
        mid, sep, addr = str(entry).partition("=")
        if not sep:
            mid, addr = "", mid
        mid, addr = mid.strip(), addr.strip()
        host, hsep, port = addr.rpartition(":")
        if not hsep or not host or not port.isdigit() or not (
                0 < int(port) <= 65535):
            raise ValueError(
                f"route_backends entry {entry!r} is not 'host:port' or "
                "'model_id=host:port'")
        if not mid:
            if addr in backends:
                raise ValueError(
                    f"route_backends backend {addr!r} appears twice")
            backends.append(addr)
        else:
            if not MODEL_ID_RE.match(mid):
                raise ValueError(
                    f"route_backends override id {mid!r} must match "
                    "[A-Za-z0-9._-]{1,64}")
            if mid in overrides:
                raise ValueError(
                    f"route_backends override for {mid!r} appears twice")
            overrides[mid] = addr
    for mid, addr in overrides.items():
        if addr not in backends:
            raise ValueError(
                f"route_backends override {mid}={addr} names a backend "
                "that is not listed as a bare host:port entry")
    return tuple(backends), overrides


# the sparse_store dial's legal values — binned-store layout
# (docs/Sparse.md): "csr" keeps per-row (store column, bin) nonzero
# entries and the histogram kernels iterate only stored entries;
# "dense" keeps the [F_eff, N] matrix; "auto" picks csr for wide
# stores whose zero-bin rate clears `sparse_threshold` (and only when
# `is_enable_sparse` is on — the reference's master sparse switch)
SPARSE_STORE_MODES = ("auto", "csr", "dense")

# Alias table: parity with reference config.h:342-436 (ParameterAlias).
PARAM_ALIASES: Dict[str, str] = {
    "config": "config_file",
    "nthread": "num_threads",
    "random_seed": "seed",
    "num_thread": "num_threads",
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
    "enable_sparse": "is_enable_sparse",
    "pre_partition": "is_pre_partition",
    "tranining_metric": "is_training_metric",  # (sic) kept for parity
    "train_metric": "is_training_metric",
    "ndcg_at": "ndcg_eval_at",
    "eval_at": "ndcg_eval_at",
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
    "unbalanced_sets": "is_unbalance",
    # extra alias of this package
    "tree_learner_type": "tree_learner",
    # serving subsystem (task=serve)
    "serving_port": "serve_port",
    "predict_port": "serve_port",
    "serving_host": "serve_host",
    "serve_address": "serve_host",
    "batch_rows": "max_batch_rows",
    "serve_max_batch_rows": "max_batch_rows",
    "flush_deadline": "flush_deadline_ms",
    "serve_flush_deadline_ms": "flush_deadline_ms",
    "model_poll": "model_poll_seconds",
    "poll_seconds": "model_poll_seconds",
    "serving_replicas": "serve_replicas",
    "num_replicas": "serve_replicas",
    "request_timeout_ms": "serve_request_timeout_ms",
    "serve_timeout_ms": "serve_request_timeout_ms",
    "failure_threshold": "replica_failure_threshold",
    "serve_failure_threshold": "replica_failure_threshold",
    "serve_max_pending_rows": "max_pending_rows",
    "pending_rows_cap": "max_pending_rows",
    "prediction_kernel": "predict_kernel",
    "predict_engine": "predict_kernel",
    "serving_quantize": "serve_quantize",
    "quantized_serving": "serve_quantize",
    # multi-tenant serving catalog (docs/serving.md "Multi-tenant
    # catalog", lightgbm_tpu/serving/catalog.py)
    "serving_models": "serve_models",
    "model_catalog": "serve_models",
    "serve_cache_budget": "serve_cache_budget_mb",
    "cache_budget_mb": "serve_cache_budget_mb",
    "shadow_fraction": "serve_shadow_fraction",
    "canary_fraction": "serve_shadow_fraction",
    "shadow_requests": "serve_shadow_requests",
    "canary_requests": "serve_shadow_requests",
    "shadow_max_divergence": "serve_shadow_max_divergence",
    "canary_max_divergence": "serve_shadow_max_divergence",
    "costack": "serve_costack",
    "cross_model_batching": "serve_costack",
    "serve_costack_kernel": "costack_kernel",
    "cross_model_kernel": "costack_kernel",
    "group_kernel": "costack_kernel",
    "costack_segment_threshold": "costack_segment_trees",
    "segment_trees_threshold": "costack_segment_trees",
    # router tier (task=route, lightgbm_tpu/router/, docs/Router.md)
    "router_backends": "route_backends",
    "backends": "route_backends",
    "router_port": "route_port",
    "routing_port": "route_port",
    "router_health_interval_ms": "route_health_interval_ms",
    "route_health_ms": "route_health_interval_ms",
    "router_backend_timeout_ms": "route_backend_timeout_ms",
    "backend_timeout_ms": "route_backend_timeout_ms",
    "router_max_inflight": "route_max_inflight",
    "route_inflight_cap": "route_max_inflight",
    # online learning (task=online / task=refit, lightgbm_tpu/online/)
    "decay_rate": "refit_decay_rate",
    "refit_decay": "refit_decay_rate",
    "min_refit_rows": "refit_min_rows",
    "refit_min_data": "refit_min_rows",
    "online_trigger": "online_trigger_rows",
    "trigger_rows": "online_trigger_rows",
    "refresh_mode": "online_mode",
    # fault tolerance (task=train checkpoint/resume, docs/Robustness.md)
    "checkpoint": "checkpoint_path",
    "snapshot_path": "checkpoint_path",
    "checkpoint_freq": "checkpoint_interval",
    "snapshot_freq": "checkpoint_interval",
    # sparse binned store + adaptive bin budgets (docs/Sparse.md)
    "sparse_format": "sparse_store",
    "store_format": "sparse_store",
    "sparse_histogram": "sparse_store",
    "total_bin_budget": "bin_budget",
    "adaptive_bin_budget": "bin_budget",
    "adaptive_bins": "bin_budget",
    # exclusive feature bundling (EFB)
    "efb": "enable_bundle",
    "bundle": "enable_bundle",
    "enable_feature_bundle": "enable_bundle",
    "is_enable_bundle": "enable_bundle",
    "max_conflict": "max_conflict_rate",
    "bundle_conflict_rate": "max_conflict_rate",
    # row partition / ordered histograms (docs/Readme.md)
    "ordered_histograms": "hist_rows",
    "row_partition": "hist_rows",
    # data-parallel histogram exchange (docs/Readme.md "Histogram exchange")
    "histogram_reduce": "hist_exchange",
    "hist_exchange_threshold": "hist_exchange_min_bytes",
    "histogram_exchange_min_bytes": "hist_exchange_min_bytes",
    # pod-scale data plane (docs/Distributed-Data.md, lightgbm_tpu/sharded/)
    "bin_finding": "bin_find",
    "distributed_bin_find": "bin_find",
    "quantile_sketch_eps": "sketch_eps",
    "sketch_epsilon": "sketch_eps",
    "stream_chunk_size": "stream_chunk_rows",
    "ingest_chunk_rows": "stream_chunk_rows",
    # observability (docs/Observability.md, lightgbm_tpu/telemetry.py)
    "telemetry": "telemetry_path",
    "trace_path": "telemetry_path",
    "span_path": "telemetry_path",
    "prometheus_port": "metrics_port",
    "telemetry_port": "metrics_port",
}

# objective name aliases (reference config.cpp GetObjectiveType handling)
OBJECTIVE_ALIASES: Dict[str, str] = {
    "mean_squared_error": "regression",
    "mse": "regression",
    "regression_l2": "regression",
    "l2": "regression",
    "mean_absolute_error": "regression_l1",
    "mae": "regression_l1",
    "l1": "regression_l1",
    "softmax": "multiclass",
}

_TRUE = {"true", "1", "yes", "on", "+", "t"}
_FALSE = {"false", "0", "no", "off", "-", "f"}


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    raise ValueError(f"cannot parse boolean value: {v!r}")


def _parse_int_list(v: Any) -> Tuple[int, ...]:
    if v is None:
        return tuple()
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    s = str(v).strip()
    if not s:
        return tuple()
    return tuple(int(x) for x in s.replace(",", " ").split())


def _parse_str_list(v: Any) -> Tuple[str, ...]:
    if v is None:
        return tuple()
    if isinstance(v, (list, tuple)):
        return tuple(str(x) for x in v)
    s = str(v).strip()
    if not s:
        return tuple()
    return tuple(x for x in s.replace(",", " ").split())


@dataclasses.dataclass(frozen=True)
class Config:
    """All training / IO / network parameters (LightGBM-compatible names).

    Defaults match the reference (config.h:86-284).
    """

    # -- task / overall (config.h:256-284)
    task: str = "train"
    objective: str = "regression"
    boosting_type: str = "gbdt"
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_class: int = 1
    seed: int = 0
    num_threads: int = 0
    verbose: int = 1
    # "cuda" runs the hand-written kernels on the GPU; "cpu" runs their
    # plain PyTorch versions and is taken only when the caller asks for it
    device_type: str = "cuda"

    # -- IO (config.h:86-137)
    max_bin: int = 255
    data_random_seed: int = 1
    data: str = ""
    output_model: str = "LightGBM_model.txt"
    input_model: str = ""
    output_result: str = "LightGBM_predict_result.txt"
    valid_data: Tuple[str, ...] = tuple()
    is_enable_sparse: bool = True
    use_two_round_loading: bool = False
    is_save_binary_file: bool = False
    enable_load_from_binary_file: bool = True
    is_predict_raw_score: bool = False
    is_predict_leaf_index: bool = False
    has_header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_column: str = ""
    is_pre_partition: bool = False
    bin_construct_sample_cnt: int = 200000
    sparse_threshold: float = 0.8
    min_data_in_bin: int = 3
    # distributed / out-of-core bin finding (docs/Distributed-Data.md):
    # "allgather" derives mappers from the process-allgathered global
    # sample (the validated PR-era path); "sketch" merges per-host (and
    # per-chunk) mergeable quantile sketches so no host ever
    # materializes the global sample — boundaries hold an eps rank
    # guarantee (`sketch_eps`).  "auto" = the exact allgather path while
    # the global sample fits `bin_construct_sample_cnt`, sketch beyond.
    bin_find: str = "auto"
    # rank-error knob of the mergeable quantile sketch: each sketch
    # keeps O(1/eps) weighted entries per feature; smaller eps = tighter
    # boundaries, bigger summaries.  Tight enough that the summary holds
    # every distinct value, the sketch is EXACT (bitwise the allgather
    # boundaries).
    sketch_eps: float = 0.001
    # row-chunk size of streamed dataset construction
    # (Dataset.from_stream / use_two_round_loading): peak host memory of
    # ingestion scales with this, not with the dataset length.
    stream_chunk_rows: int = 262144
    # Exclusive Feature Bundling: pack mutually-exclusive features into
    # shared histogram columns (docs/Bundling.md).  max_conflict_rate is
    # the tolerated fraction of rows where two bundled features are both
    # non-default (0.0 = only provably exclusive features bundle).
    enable_bundle: bool = True
    max_conflict_rate: float = 0.0
    # sparse binned store (docs/Sparse.md): "csr" packs the store as
    # per-row (column id, bin) nonzero entries — implicit zeros bin to
    # each column's known zero bin and are reconstructed from per-leaf
    # totals, so histogram compute and bytes scale with nnz instead of
    # F x N (the wide one-hot/hashed CTR regime, arXiv:1706.08359's
    # sparse histogram kernel).  "auto" picks csr when the rounds
    # growth schedule is already in play (tree_growth resolves rounds —
    # the TPU default), the store is wide (>= 128 columns), and its
    # estimated zero-bin rate is at least `sparse_threshold`; dense
    # otherwise, so stock CPU configs are unchanged.
    # `is_enable_sparse=false` (the reference's master sparse switch)
    # keeps the AUTO resolution dense; an explicit csr/dense pins the
    # layout outright.
    sparse_store: str = "auto"
    # adaptive per-feature bin budgets (docs/Sparse.md, the Vectorized
    # Adaptive Histograms allocation, arXiv:2603.00326): a GLOBAL bin
    # budget shared by all features, allocated by per-feature
    # distinct-value/mass share (weight sqrt(distinct x nonzero_mass),
    # floor 2, cap 255) so high-cardinality features get resolution
    # where the mass is and one-hot columns stop wasting uniform
    # max_bin slots.  0 = off (uniform max_bin per feature).  Mappers
    # stay ordinary frozen BinMappers, so refbin/serving/binary-cache
    # contracts are untouched.
    bin_budget: int = 0

    # -- objective params (config.h:140-174)
    is_unbalance: bool = False
    sigmoid: float = 1.0
    huber_delta: float = 1.0
    fair_c: float = 1.0
    gaussian_eta: float = 1.0
    poisson_max_delta_step: float = 0.7
    scale_pos_weight: float = 1.0
    max_position: int = 20
    label_gain: Tuple[float, ...] = tuple()

    # -- metric (config.h:160-174)
    metric: Tuple[str, ...] = tuple()
    metric_freq: int = 1
    is_training_metric: bool = False
    ndcg_eval_at: Tuple[int, ...] = (1, 2, 3, 4, 5)

    # -- tree (config.h:177-207)
    num_leaves: int = 31
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    feature_fraction: float = 1.0
    feature_fraction_seed: int = 2
    histogram_pool_size: float = -1.0
    top_k: int = 20
    # gpu params kept for config compatibility (ignored on tpu)
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False

    # -- boosting (config.h:210-242)
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    early_stopping_round: int = 0
    drop_rate: float = 0.1
    skip_drop: float = 0.5
    max_drop: int = 50
    uniform_drop: bool = False
    xgboost_dart_mode: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    tree_learner: str = "serial"
    # TPU extension: growth scheduling. "exact" = one split at a time
    # (reference leaf-wise semantics); "rounds" = batched rounds (all
    # splittable leaves per round, top-gain-capped — the MXU-efficient
    # schedule); "auto" = rounds on TPU, exact elsewhere.
    tree_growth: str = "auto"
    # histogram matmul operand precision: float32 (exact, 3-pass MXU) or
    # bfloat16 (fast).  The reference GPU learner has the same dial as
    # gpu_use_dp (config.h:206, single vs double) with single the default.
    histogram_dtype: str = "float32"
    # row feed of the batched-rounds histogram passes: "masked" streams
    # the full [F, N] bin store every pass; "gathered" keeps a
    # device-resident row partition (the reference's DataPartition +
    # ordered-gradients design, data_partition.hpp) and histograms only
    # the leaf-contiguous segments each round needs — bagged/GOSS-dropped
    # rows never enter the permutation.  "auto" = gathered on TPU
    # (single-device AND data-parallel shard-map — the partition is
    # per-shard local state), masked on the CPU tier.
    hist_rows: str = "auto"
    # data-parallel histogram exchange: "psum" all-reduces the full
    # [K, F, 3, B] histogram onto every device; "psum_scatter"
    # reduce-scatters over the feature axis so each device owns only its
    # F/ndev slice, split-searches that slice, and all_gathers the tiny
    # per-leaf best-split records (the reference's Network::ReduceScatter
    # design, data_parallel_tree_learner.cpp:118-160) — comms volume and
    # split-search work per device both drop ~ndev x.  "auto" =
    # psum_scatter when the per-pass payload is large enough to pay for
    # the extra record exchange, psum for small payloads (the reference's
    # allgather-vs-halving switch).
    hist_exchange: str = "auto"
    # `hist_exchange=auto` switches to psum_scatter only when the
    # per-pass reduced-histogram payload is at least this many bytes
    # (below it the full psum is cheaper than reduce-scatter + the
    # per-leaf record allgather).  -1 = the built-in default (1 MiB, or
    # the LGBT_HIST_EXCHANGE_MIN_BYTES env override for on-chip tuning);
    # >= 0 pins the crossover explicitly.
    hist_exchange_min_bytes: int = -1

    # -- network (config.h:245-252)
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_file: str = ""

    # -- tpu-specific knobs (new in this framework)
    hist_dtype: str = "float32"      # accumulation dtype for histograms
    hist_input_dtype: str = "bfloat16"  # MXU input dtype for one-hot matmul
    fused_tree: bool = False         # force the fused (one-program) tree learner
    mesh_shape: Tuple[int, ...] = tuple()  # override device mesh
    boost_from_average: bool = True

    # prediction
    num_iteration_predict: int = -1
    # ensemble-traversal kernel for device prediction (ops/predict.py):
    # "walk" = per-class vmapped tree walk (the original shape);
    # "tensorized" = every tree of every class in ONE padded SoA, all
    # rows x all trees advance one depth level per step (the Booster
    # accelerator layout, arXiv:2011.02022) — also used for whole-model
    # replay onto validation scores.  "auto" = tensorized.
    predict_kernel: str = "auto"

    # -- online serving (task=serve, lightgbm_tpu/serving/)
    serve_host: str = "127.0.0.1"
    serve_port: int = 8080
    max_batch_rows: int = 4096        # micro-batch coalescing cap
    flush_deadline_ms: float = 5.0    # max wait before a partial flush
    model_poll_seconds: float = 10.0  # hot-swap mtime poll (0 = off)
    min_bucket_rows: int = 16         # smallest padded row bucket
    # serving fleet size: replicate compiled predictors across local
    # devices with least-loaded dispatch.  0 = auto (every local device
    # on accelerator backends, 1 on the CPU tier); N caps at the local
    # device count.
    serve_replicas: int = 0
    # admission control: once this many rows are queued, further
    # requests shed load with HTTP 503 instead of growing an unbounded
    # queue (high-water mark — a single over-cap request on an idle
    # server still admits).  0 = unbounded.
    max_pending_rows: int = 0
    # a /predict request whose batch has not scored within this window
    # answers HTTP 504 (the batch keeps scoring; only the waiter gives
    # up) — the client-visible bound on a wedged or overloaded fleet.
    serve_request_timeout_ms: float = 120000.0
    # replica circuit breaker: after this many CONSECUTIVE dispatch
    # failures a replica stops receiving traffic; a periodic half-open
    # probe readmits it once it answers again (docs/Robustness.md).
    replica_failure_threshold: int = 3
    # request-path feature quantization (docs/serving.md "Binned
    # inference"): "binned" quantizes each request chunk against the
    # model's .refbin frozen-mapper sidecar at ingress and traverses
    # integer bins end-to-end — bit-identical scores to the raw kernel,
    # a 4x smaller device request buffer — refusing to serve/swap when
    # the sidecar is missing, torn, or sha1-mismatched vs the publish
    # meta; "raw" keeps f32 feature traversal; "auto" picks binned
    # whenever a valid sidecar is present and falls back to raw
    # otherwise.
    serve_quantize: str = "auto"
    # multi-tenant catalog (docs/serving.md "Multi-tenant catalog"):
    # `id=path` entries, one independent model per tenant id — requests
    # route by the `model` field/query param/X-Model-Id header, each
    # tenant gets its own registry, batcher (admission budget), replica
    # breakers, and /stats / /metrics accounting.  Empty = single-model
    # serving with `input_model` as the default tenant; with entries,
    # `input_model` (when set) still serves requests that name no model.
    # Also consumed by task=online: one refresh daemon per entry, each
    # filtering the shared traffic log by its tenant id and publishing
    # to its own path.
    serve_models: Tuple[str, ...] = tuple()
    # device-memory budget (MiB) for the catalog's compiled-executable
    # caches across ALL tenants: beyond it, the least-recently-used
    # tenants' executables are evicted (their next request recompiles —
    # serve/cache_evictions counts the churn).  The most recently used
    # tenant is never evicted.  0 = unlimited.
    serve_cache_budget_mb: int = 0
    # cross-model batched serving (docs/serving.md "Cross-model
    # batching"): co-stack catalog tenants that share (num_class,
    # serve_quantize variant, leaf tier) onto ONE padded super-stack
    # scored by ONE compiled executable per (bucket, kind) — a mixed
    # batch of many tenants costs one device launch, bitwise-identical
    # to per-tenant dispatch.  Off = every tenant keeps its own
    # executables (the PR 15 layout).  Tenants opt out individually
    # with a `;costack=off` entry override; a group's replica fleet
    # sizes to the MAX of its members' `;replicas=` overrides.
    serve_costack: bool = True
    # grouped-traversal strategy for co-stacked executables
    # (COSTACK_KERNELS): "stacked" walks all T_total stacked trees per
    # row, "segment" gathers only the row's own tenant's tree segment
    # per depth level — same ONE launch per (bucket, kind), node math
    # back to ~1x.  "auto" picks segment on compute-bound backends
    # (CPU, or very deep stacks on accelerators) and stacked where
    # launch overhead dominates (ops/predict.resolve_costack_kernel).
    costack_kernel: str = "auto"
    # costack_kernel=auto's accelerator switch point: total stacked
    # trees at which even a launch-bound backend goes compute-bound on
    # the walk-all traversal and `auto` picks "segment".  The
    # LIGHTGBM_TPU_COSTACK_SEGMENT_TREES env override (read at resolve
    # time) still wins for fleet-wide emergency retunes without a
    # config rollout.
    costack_segment_trees: int = 4096
    # shadow-canary publishes: with a fraction > 0, a republished model
    # is STAGED as a candidate instead of swapped live — this fraction
    # of requests is double-scored on it (stable still answers the
    # client), per-request divergence is logged, and the candidate is
    # adopted only after `serve_shadow_requests` comparisons (rejected
    # if any divergence exceeds `serve_shadow_max_divergence`, when
    # >= 0; < 0 = log-only, always adopt).  0 = swap immediately (the
    # pre-catalog behavior).
    serve_shadow_fraction: float = 0.0
    serve_shadow_requests: int = 32
    serve_shadow_max_divergence: float = -1.0

    # -- router tier (task=route, lightgbm_tpu/router/, docs/Router.md)
    # the backend fleet the router fronts: bare `host:port` entries are
    # backend serving processes; `model_id=host:port` entries are
    # explicit placement overrides pinning a tenant to one of the
    # listed backends (parse_route_backends is the grammar).  Unpinned
    # tenants place by consistent hash of their model id, so adding or
    # removing one backend moves only that backend's tenants.
    route_backends: Tuple[str, ...] = tuple()
    # listen port of the router's own HTTP front (task=route).
    route_port: int = 8180
    # period of the router's backend health probes (GET /healthz on
    # every backend).  A probe answering readmits an open-breaker
    # backend exactly like a successful proxied request.  0 = no
    # background probing (count-based half-open probes on live traffic
    # still readmit — the chaos-deterministic path).
    route_health_interval_ms: float = 1000.0
    # per-attempt socket timeout for proxied backend requests AND
    # health probes; a timeout counts as a breaker failure.
    route_backend_timeout_ms: float = 30000.0
    # router-wide in-flight request cap: beyond it new requests shed
    # load with HTTP 503 + Retry-After instead of stacking threads on
    # slow backends.  0 = unbounded.
    route_max_inflight: int = 0
    # co-stack-aware placement spread: tenants whose backends report a
    # co-stack group key (serving /healthz "group_keys") hash to
    # backends BY THAT KEY, so same-key tenants land on one backend and
    # actually group.  Values > 1 salt the key with the tenant id into
    # this many shards — a very large same-key cohort spreads over up
    # to `route_group_spread` backends (each shard's tenants still
    # co-locate and group).  1 = strict co-location (the
    # grouping-maximizing default).
    route_group_spread: int = 1

    # -- fault tolerance (task=train checkpoint/resume, docs/Robustness.md)
    # when set, training snapshots (model + iteration + early-stopping +
    # sampler RNG state) to this path every `checkpoint_interval`
    # iterations (atomic tmp + rename), and a rerun pointing at an
    # existing checkpoint resumes mid-run instead of starting over.
    checkpoint_path: str = ""
    checkpoint_interval: int = 0      # iterations between snapshots (0 = off)

    # -- online learning (task=online / task=refit, lightgbm_tpu/online/)
    # leaf-value refit blends the Newton leaf output computed on fresh
    # labeled traffic with the old value: new = decay * old + (1 - decay)
    # * computed (reference refit_decay_rate semantics; 0 = replace,
    # 1 = freeze).
    refit_decay_rate: float = 0.9
    # leaves with fewer fresh rows than this keep their old value (a
    # starved leaf's Newton step is noise); floors at 1 row.
    refit_min_rows: int = 20
    # the OnlineTrainer daemon refreshes the model once this many new
    # labeled rows accumulated in the traffic window.
    online_trigger_rows: int = 4096
    # what a refresh does: "refit" reweights the existing tree
    # structures (cheap — ~one traversal + one scan); "continue" appends
    # num_iterations new trees on the fresh window via continued
    # boosting (reset_training_data replay).
    online_mode: str = "refit"

    # -- observability (lightgbm_tpu/telemetry.py, docs/Observability.md)
    # structured span tracing: when set, every process role appends
    # JSONL span/event records (trace-id/span-id/parent-id, monotonic
    # durations) to this path — the serve→train→serve loop becomes
    # reconstructable from trace ids alone, and
    # `scripts/trace_view.py` converts the file to chrome://tracing
    # JSON.  Empty = tracing off (the hot paths pay one cached check).
    telemetry_path: str = ""
    # standalone Prometheus /metrics listener for process roles without
    # their own HTTP server (trainer, online daemon, batch predict):
    # the profiling counters/reservoirs + process/device gauges in text
    # exposition format.  0 = off.  task=serve always exposes the same
    # payload at its own /metrics endpoint instead.
    metrics_port: int = 0

    # fields that are parsed but unused on TPU (accepted for compat)
    config_file: str = ""
    output_freq: int = 1

    def n_classes_for_trees(self) -> int:
        return self.num_class if self.objective == "multiclass" else max(
            1, self.num_class if self.objective == "multiclassova" else 1)

    @property
    def num_tree_per_iteration(self) -> int:
        if self.objective in ("multiclass", "multiclassova"):
            return max(1, self.num_class)
        return 1

    def with_updates(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(Config)}
_TUPLE_INT_FIELDS = {"ndcg_eval_at", "mesh_shape"}
_TUPLE_FLOAT_FIELDS = {"label_gain"}
_TUPLE_STR_FIELDS = {"valid_data", "metric", "serve_models",
                     "route_backends"}


def apply_aliases(params: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve aliases; explicit canonical keys win (reference config.h:426-434)."""
    out: Dict[str, Any] = {}
    aliased: Dict[str, Any] = {}
    for k, v in params.items():
        k2 = k.strip().lower()
        if k2 in PARAM_ALIASES:
            aliased[PARAM_ALIASES[k2]] = v
        else:
            out[k2] = v
    for k, v in aliased.items():
        out.setdefault(k, v)
    return out


def _coerce(name: str, value: Any) -> Any:
    if name in _TUPLE_INT_FIELDS:
        return _parse_int_list(value)
    if name in _TUPLE_FLOAT_FIELDS:
        if isinstance(value, (list, tuple)):
            return tuple(float(x) for x in value)
        s = str(value).strip()
        return tuple(float(x) for x in s.replace(",", " ").split()) if s else tuple()
    if name in _TUPLE_STR_FIELDS:
        return _parse_str_list(value)
    ftype = str(_FIELD_TYPES[name])
    if "bool" in ftype:
        return _parse_bool(value)
    if "int" in ftype:
        return int(float(str(value)))
    if "float" in ftype:
        return float(value)
    return str(value)


def config_from_params(params: Dict[str, Any], **overrides) -> Config:
    """Build a Config from a LightGBM-style param dict (Python-API entry).

    Unknown keys are ignored with a record in `Config` creation (reference
    behavior: unknown params are silently dropped by ConfigBase::Set).
    """
    merged = dict(params or {})
    merged.update(overrides)
    resolved = apply_aliases(merged)
    # objective aliases
    if "objective" in resolved:
        obj = str(resolved["objective"]).strip().lower()
        resolved["objective"] = OBJECTIVE_ALIASES.get(obj, obj)
    kwargs = {}
    for k, v in resolved.items():
        if k in _FIELD_TYPES:
            kwargs[k] = _coerce(k, v)
    cfg = Config(**kwargs)
    check_param_conflict(cfg)
    # the package-wide log level follows the most recently parsed config
    # (reference: Log verbosity set once from config, log.h:38)
    from . import log
    log.configure(cfg.verbose)
    # span tracing enables at the first config that names a sink, and
    # only enables: a later config without the key must not turn a
    # running daemon's telemetry off
    if cfg.telemetry_path:
        from . import telemetry
        telemetry.configure(cfg.telemetry_path)
    return cfg


def check_param_conflict(cfg: Config) -> None:
    """Sanity checks (reference src/io/config.cpp CheckParamConflict)."""
    if cfg.num_leaves < 2:
        raise ValueError("num_leaves must be >= 2")
    if cfg.max_bin < 2:
        raise ValueError("max_bin must be >= 2")
    if not (0.0 < cfg.feature_fraction <= 1.0):
        raise ValueError("feature_fraction must be in (0, 1]")
    if not (0.0 < cfg.bagging_fraction <= 1.0):
        raise ValueError("bagging_fraction must be in (0, 1]")
    if cfg.objective in ("multiclass", "multiclassova") and cfg.num_class < 2:
        raise ValueError("num_class must be >= 2 for multiclass objectives")
    if cfg.boosting_type == "goss" and cfg.top_rate + cfg.other_rate > 1.0:
        raise ValueError("top_rate + other_rate must be <= 1.0 for GOSS")
    if cfg.tree_learner not in ("serial", "feature", "data", "voting",
                                "data2d"):
        raise ValueError(f"unknown tree_learner: {cfg.tree_learner}")
    if cfg.device_type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device_type: {cfg.device_type} "
                         "(expected cuda or cpu)")
    if cfg.tree_growth not in ("auto", "exact", "rounds"):
        raise ValueError(f"unknown tree_growth: {cfg.tree_growth}")
    if cfg.hist_rows not in ("auto", "gathered", "masked"):
        raise ValueError(f"unknown hist_rows: {cfg.hist_rows}")
    if cfg.hist_exchange not in ("auto", "psum", "psum_scatter"):
        raise ValueError(f"unknown hist_exchange: {cfg.hist_exchange}")
    if cfg.hist_exchange_min_bytes < -1:
        raise ValueError("hist_exchange_min_bytes must be >= 0, or -1 "
                         "for the built-in default")
    if cfg.bin_find not in ("auto", "allgather", "sketch"):
        raise ValueError(f"unknown bin_find: {cfg.bin_find}; "
                         "use auto, allgather or sketch")
    if not (0.0 < cfg.sketch_eps < 0.5):
        raise ValueError("sketch_eps must be in (0, 0.5)")
    if cfg.stream_chunk_rows < 1:
        raise ValueError("stream_chunk_rows must be >= 1")
    if not (0 <= cfg.serve_port <= 65535):
        raise ValueError("serve_port must be in [0, 65535]")
    if cfg.max_batch_rows < 1:
        raise ValueError("max_batch_rows must be >= 1")
    if cfg.min_bucket_rows < 1:
        raise ValueError("min_bucket_rows must be >= 1")
    if cfg.flush_deadline_ms < 0:
        raise ValueError("flush_deadline_ms must be >= 0")
    if cfg.model_poll_seconds < 0:
        raise ValueError("model_poll_seconds must be >= 0")
    if cfg.serve_replicas < 0:
        raise ValueError("serve_replicas must be >= 0 (0 = auto)")
    if cfg.max_pending_rows < 0:
        raise ValueError("max_pending_rows must be >= 0 (0 = unbounded)")
    if cfg.serve_request_timeout_ms <= 0:
        raise ValueError("serve_request_timeout_ms must be > 0")
    if cfg.replica_failure_threshold < 1:
        raise ValueError("replica_failure_threshold must be >= 1")
    if cfg.checkpoint_interval < 0:
        raise ValueError("checkpoint_interval must be >= 0 (0 = off)")
    if cfg.predict_kernel not in PREDICT_KERNELS:
        raise ValueError(f"unknown predict_kernel: {cfg.predict_kernel}")
    if cfg.serve_quantize not in SERVE_QUANTIZE_MODES:
        raise ValueError(f"unknown serve_quantize: {cfg.serve_quantize}; "
                         f"use one of {SERVE_QUANTIZE_MODES}")
    if cfg.costack_kernel not in COSTACK_KERNELS:
        raise ValueError(f"unknown costack_kernel: {cfg.costack_kernel}; "
                         f"use one of {COSTACK_KERNELS}")
    if cfg.costack_segment_trees < 1:
        raise ValueError("costack_segment_trees must be >= 1")
    if cfg.serve_models:
        parse_serve_models(cfg.serve_models)   # id=path shape + id charset
    if cfg.serve_cache_budget_mb < 0:
        raise ValueError("serve_cache_budget_mb must be >= 0 "
                         "(0 = unlimited)")
    if not (0.0 <= cfg.serve_shadow_fraction <= 1.0):
        raise ValueError("serve_shadow_fraction must be in [0, 1]")
    if cfg.serve_shadow_requests < 1:
        raise ValueError("serve_shadow_requests must be >= 1")
    if cfg.route_backends:
        parse_route_backends(cfg.route_backends)  # host:port + override shape
    if not (0 <= cfg.route_port <= 65535):
        raise ValueError("route_port must be in [0, 65535]")
    if cfg.route_health_interval_ms < 0:
        raise ValueError("route_health_interval_ms must be >= 0 (0 = "
                         "probe only on live traffic)")
    if cfg.route_backend_timeout_ms <= 0:
        raise ValueError("route_backend_timeout_ms must be > 0")
    if cfg.route_max_inflight < 0:
        raise ValueError("route_max_inflight must be >= 0 (0 = unbounded)")
    if cfg.route_group_spread < 1:
        raise ValueError("route_group_spread must be >= 1 (1 = strict "
                         "same-key co-location)")
    if not (0.0 <= cfg.refit_decay_rate <= 1.0):
        raise ValueError("refit_decay_rate must be in [0, 1]")
    if cfg.refit_min_rows < 0:
        raise ValueError("refit_min_rows must be >= 0")
    if cfg.online_trigger_rows < 1:
        raise ValueError("online_trigger_rows must be >= 1")
    if cfg.online_mode not in ("refit", "continue"):
        raise ValueError(f"unknown online_mode: {cfg.online_mode}; "
                         "use refit or continue")
    if not (0.0 <= cfg.max_conflict_rate < 1.0):
        raise ValueError("max_conflict_rate must be in [0, 1)")
    if cfg.sparse_store not in SPARSE_STORE_MODES:
        raise ValueError(f"unknown sparse_store: {cfg.sparse_store}; "
                         f"use one of {SPARSE_STORE_MODES}")
    if not (0.0 < cfg.sparse_threshold <= 1.0):
        raise ValueError("sparse_threshold must be in (0, 1]")
    if cfg.bin_budget < 0:
        raise ValueError("bin_budget must be >= 0 (0 = uniform max_bin)")
    if not (0 <= cfg.metrics_port <= 65535):
        raise ValueError("metrics_port must be in [0, 65535] (0 = off)")


def parse_config_file(path: str) -> Dict[str, str]:
    """Parse a LightGBM `key = value` config file (application.cpp:46-102)."""
    params: Dict[str, str] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            params[k.strip()] = v.strip()
    return params


def parse_cli_args(argv: List[str]) -> Dict[str, str]:
    """Parse `key=value` command line tokens (application.cpp:46-70)."""
    params: Dict[str, str] = {}
    for tok in argv:
        if "=" in tok:
            k, v = tok.split("=", 1)
            params[k.strip()] = v.strip()
    resolved = apply_aliases(params)
    if "config_file" in resolved and resolved["config_file"]:
        file_params = parse_config_file(resolved["config_file"])
        for k, v in file_params.items():
            params.setdefault(k, v)
    return params


def default_metric_for_objective(objective: str) -> str:
    return {
        "regression": "l2",
        "regression_l1": "l1",
        "huber": "huber",
        "fair": "fair",
        "poisson": "poisson",
        "binary": "binary_logloss",
        "multiclass": "multi_logloss",
        "multiclassova": "multi_logloss",
        "lambdarank": "ndcg",
    }.get(objective, "l2")
