"""lightgbm_tpu_torch.serving — online prediction on the GPU.

Port of lightgbm_tpu/serving/.  Layers, composed bottom-up:

- `runtime`  — PredictorRuntime: the model replicated across devices
  (least-loaded dispatch), one prepared entry per (replica, model
  generation, row bucket, output kind); power-of-two bucketing and
  padding keep every request on a warm entry; the ensemble traversal is
  the `predict_kernel` dial (tensorized | walk, ops/predict.py).
- `batcher`  — MicroBatcher: continuous batching up to `max_batch_rows`
  or a `flush_deadline_ms` deadline, one flusher per replica, optional
  admission control (`max_pending_rows` → 503).
- `registry` — ModelRegistry: versioned atomic hot-swap (mtime poll or
  SIGHUP) with pre-swap warmup, rollback on a bad model, and optional
  shadow-canary staging.
- `catalog`  — ModelCatalog: N keyed tenants on one fleet, per-model
  routing/SLO accounting/admission budgets, LRU entry eviction under
  `serve_cache_budget_mb`.
- `superstack` — GroupRuntime: tenants sharing (num_class, kernel
  variant, leaf tier) co-stack onto one padded super-stack; mixed
  batches demux bitwise equal to per-tenant dispatch.
- `server`   — PredictionServer: stdlib JSON-lines HTTP endpoint
  (/predict with `model` routing, /healthz, /stats, /metrics).
"""
from .runtime import (OUTPUT_KINDS, PredictorRuntime,
                      resolve_serve_replicas, row_bucket)
from .batcher import MicroBatcher, ServerOverloadedError
from .registry import ModelRegistry
from .catalog import DEFAULT_MODEL_ID, ModelCatalog, UnknownModelError
from .superstack import GroupRuntime, costack_key
from .server import PredictionServer, serve_from_config, server_from_config

__all__ = [
    "OUTPUT_KINDS", "PredictorRuntime", "resolve_serve_replicas",
    "row_bucket", "MicroBatcher", "ServerOverloadedError", "ModelRegistry",
    "DEFAULT_MODEL_ID", "ModelCatalog", "UnknownModelError",
    "GroupRuntime", "costack_key",
    "PredictionServer", "serve_from_config", "server_from_config",
]
