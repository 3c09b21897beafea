"""Setup helpers of the tree learners.

Port of lightgbm_tpu/learner/common.py (the single-device part).  Device
memory is read with `torch.cuda.mem_get_info` where JAX read
`memory_stats()`; CPU runs use the conservative fallbacks.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import log
from ..config import Config

# device-memory size assumed when it cannot be read (CPU runs)
_FALLBACK_DEVICE_BYTES = 16e9


def make_split_kw(cfg: Config) -> dict:
    """Split hyperparameters for ops.split.best_split (reference
    feature_histogram.hpp:281-300 gain math inputs)."""
    return dict(lambda_l1=float(cfg.lambda_l1), lambda_l2=float(cfg.lambda_l2),
                min_data_in_leaf=int(cfg.min_data_in_leaf),
                min_sum_hessian_in_leaf=float(cfg.min_sum_hessian_in_leaf),
                min_gain_to_split=float(cfg.min_gain_to_split))


def padded_bin_count(max_num_bin: int) -> int:
    """Bin axis padded to a multiple of 128 (the JAX layout, kept so the
    histograms compare like with like)."""
    return max(128, int(128 * math.ceil(max_num_bin / 128)))


def sentinel_bins_feed(dataset) -> np.ndarray:
    """[N+1, C] transpose of the store (one column per used feature, or
    per EFB bundle column) with a sentinel row N of bin 0, so that the
    padded positions of a row-index vector gather branch-free: the exact
    learner's feed of kernel K5.  In the store's own bytes — uint8 when
    every bin fits one (max_num_bin <= 256), else uint16 — 40 B a onehot
    row where the JAX package's int32 `sentinel_bins_t` takes 160."""
    bins_np = dataset.dense_bins(site="bins_t")
    dt = np.uint8 if dataset.max_num_bin <= 256 else np.uint16
    out = np.zeros((bins_np.shape[1] + 1, bins_np.shape[0]), dt)
    out[:-1] = bins_np.T
    return out


def device_memory_bytes(device: torch.device) -> float:
    """Total memory of a CUDA device; the fallback size elsewhere."""
    if device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[1])
    return _FALLBACK_DEVICE_BYTES


def _default_pool_budget(device: torch.device) -> float:
    """Unset histogram_pool_size defaults to a quarter of the device's
    memory (floor 1.5 GB); CPU runs keep 1.5 GB."""
    if device.type == "cuda":
        return max(1.5e9, 0.25 * device_memory_bytes(device))
    return 1.5e9


def gather_scratch_capacity(np_rows: int) -> int:
    """Row capacity of the gathered-histogram scratch for the smaller-
    child passes: the smaller children of one round partition subsets of
    their parents, so they sum to <= ceil(N/2).  128-aligned."""
    cap = (np_rows + 1) // 2
    return max(128, 128 * int(math.ceil(cap / 128)))


def gather_capacity_tiers(cap: int) -> tuple:
    """Ascending capacities for the gathered passes (full, /4, /16 of
    `cap`, deduped); each pass runs at the smallest tier holding its
    live rows."""
    full = max(128, 128 * int(math.ceil(cap / 128)))
    tiers = {full}
    for d in (4, 16):
        tiers.add(max(128, 128 * ((cap // d) // 128)))
    return tuple(sorted(tiers))


def gathered_scratch_fits(num_columns: int, np_rows: int,
                          bins_itemsize: int = 4,
                          limit_bytes: float = 0.0) -> bool:
    """Budget gate for the gathered path's per-pass scratch ([3, cap]
    gathered gradient rows, [cap] row ids and slot ids, plus the bins the
    JAX layout gathered — kept in the estimate so both packages choose
    alike): refuse above ~15% of device memory."""
    cap = gather_scratch_capacity(np_rows)
    scratch = float(cap) * (num_columns * bins_itemsize + 8 * 4)
    if limit_bytes <= 0:
        limit_bytes = _FALLBACK_DEVICE_BYTES
    return scratch <= 0.15 * limit_bytes


def resolve_hist_rows(cfg: Config, *, device: torch.device,
                      num_columns: int, np_rows: int,
                      bins_itemsize: int = 4) -> str:
    """Resolve `hist_rows`: "auto" is gathered on CUDA (the bandwidth-
    bound regime the row partition targets) and masked on the CPU."""
    mode = getattr(cfg, "hist_rows", "auto")
    if mode == "auto":
        mode = "gathered" if device.type == "cuda" else "masked"
    if mode == "gathered" and not gathered_scratch_fits(
            num_columns, np_rows, bins_itemsize,
            limit_bytes=device_memory_bytes(device)):
        log.warning("hist_rows=gathered scratch would not fit the device "
                    "memory budget at this shape; using masked")
        return "masked"
    return mode


def use_parent_hist_cache(cfg: Config, num_features: int,
                          num_bins_padded: int,
                          device: torch.device) -> bool:
    """Keep the [num_leaves, F, 3, B] per-leaf histogram cache for the
    parent-subtraction trick only while it fits the pool budget;
    otherwise both children are histogrammed directly."""
    hist_cache_bytes = 4 * cfg.num_leaves * num_features * 3 * num_bins_padded
    budget = (cfg.histogram_pool_size * 1e6
              if cfg.histogram_pool_size > 0
              else _default_pool_budget(device))
    return hist_cache_bytes <= budget
