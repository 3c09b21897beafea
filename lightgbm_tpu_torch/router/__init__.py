"""Router tier: horizontal scale-out across M serving processes.

A copy of lightgbm_tpu/router/: a stdlib-only HTTP router that
spreads /predict traffic over M backend ``task=serve`` processes:
consistent-hash tenant→backend placement (with explicit overrides),
per-backend circuit breakers with count-based half-open probes, and
fleet-aggregated /stats + /metrics.
"""
from .placement import HashRing
from .server import (BackendState, NoHealthyBackendError, RouterServer,
                     route_from_config, router_from_config)

__all__ = [
    "BackendState",
    "HashRing",
    "NoHealthyBackendError",
    "RouterServer",
    "route_from_config",
    "router_from_config",
]
