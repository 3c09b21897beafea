"""Online learning: streaming ingestion, leaf refit, continuous publish.

Port of lightgbm_tpu/online/.  Models whose STRUCTURE was trained offline
get their leaf VALUES refreshed from labeled serving traffic, and each
refreshed generation is published atomically to the path the serving
ModelRegistry hot-swaps from.

- `stream` — JSONL labeled-traffic reader and writer (a copy);
- `refit` — the leaf-value refit on the booster's device (reference
  GBDT::RefitTree semantics, `refit_decay_rate` blending,
  `refit_min_rows` starvation guard);
- `trainer` — the refresh daemon (watch traffic, refit or continue
  boosting on trigger, publish generations with their metadata
  sidecar), and `OnlineFleet`, one daemon per catalog tenant.
"""
from .refit import LeafRefitter, refit_gbdt
from .stream import TrafficLog, append_traffic
from .trainer import OnlineTrainer

__all__ = ["LeafRefitter", "refit_gbdt", "TrafficLog", "append_traffic",
           "OnlineTrainer"]
