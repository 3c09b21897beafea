"""Binned Dataset: the dense [num_used_features, num_rows] bin store.

Port of the dense store of lightgbm_tpu/dataset.py: `Metadata`, and a
`Dataset` that finds BinMappers on the host (binning.py), drops trivial
features, and bins every used feature with `BinMapper.value_to_bin` (the
NumPy path; the JAX package's native bulk binner is not used).
Validation sets are binned with the training set's mappers.

Not in this slice: the sparse CSR/ELL store and Exclusive Feature
Bundling.  Where either would form, construction raises
NotImplementedError naming the ROADMAP item that ports it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from .binning import (BinMapper, BundlePlan, CATEGORICAL, find_bin_mappers,
                      plan_bundles)
from .config import Config

# rows used to estimate pairwise feature conflicts when planning bundles
BUNDLE_PLAN_SAMPLE_CNT = 50_000


@dataclass
class Metadata:
    label: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    weights: Optional[np.ndarray] = None        # fp32 [N]
    init_score: Optional[np.ndarray] = None     # fp64 [N * num_tree_per_iter]

    @property
    def num_data(self) -> int:
        return int(self.label.shape[0])


def _plan_bundles_from_sample(sample: np.ndarray, mappers: List[BinMapper],
                              used: List[int], cfg: Config
                              ) -> Optional[BundlePlan]:
    """Bundle plan from a raw-valued row sample (None when bundling is
    off or nothing bundles) — the JAX package's planner, unchanged."""
    if not cfg.enable_bundle or not used:
        return None
    n = len(sample)
    if n == 0:
        return None
    if n > BUNDLE_PLAN_SAMPLE_CNT:
        rng = np.random.RandomState(cfg.data_random_seed)
        sample = sample[np.sort(rng.choice(n, BUNDLE_PLAN_SAMPLE_CNT,
                                           replace=False))]
    sb = np.stack([mappers[i].value_to_bin(
        np.asarray(sample[:, i], np.float64)) for i in used])
    nb = np.asarray([mappers[i].num_bin for i in used], np.int32)
    db = np.asarray([mappers[i].default_bin for i in used], np.int32)
    return plan_bundles(sb, nb, db, cfg.max_conflict_rate)


def resolve_sparse_store(cfg: Config, mappers: List[BinMapper],
                         used: Sequence[int]) -> bool:
    """Whether the `sparse_store` knob asks for the csr store: "csr"
    always; "auto" when sparse storage is enabled, the rounds learner
    runs (the port's learner for every device), the store has >= 128
    columns and the mean sampled zero-bin rate clears sparse_threshold."""
    mode = getattr(cfg, "sparse_store", "dense")
    if mode == "csr":
        return True
    if mode != "auto" or not cfg.is_enable_sparse or not used:
        return False
    if getattr(cfg, "tree_growth", "auto") == "exact":
        return False
    if len(used) < 128:
        return False
    rates = np.asarray([mappers[i].sparse_rate for i in used])
    return float(np.mean(rates)) >= float(cfg.sparse_threshold)


class Dataset:
    """Binned feature matrix + metadata.

    Attributes
    ----------
    bins : np.ndarray  [num_used_features, num_data] uint8/uint16 bin ids
    num_bins : np.ndarray [num_used_features] int32 per-feature bin counts
    mappers : list[BinMapper], one per RAW feature
    used_features : list[int] raw indices of non-trivial features
    """

    def __init__(self, X: np.ndarray, label: Optional[np.ndarray] = None,
                 config: Optional[Config] = None,
                 reference: Optional["Dataset"] = None,
                 metadata: Optional[Metadata] = None,
                 feature_names: Optional[List[str]] = None,
                 categorical_feature: Sequence[int] = ()):
        cfg = config or Config()
        X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
        if X.ndim != 2:
            raise ValueError("X must be 2-dimensional")
        n, num_raw = X.shape
        self.num_data = n
        self.num_total_features = num_raw
        self.config = cfg
        self.feature_names = (feature_names
                              or [f"Column_{i}" for i in range(num_raw)])
        if reference is not None:
            if num_raw != reference.num_total_features:
                raise ValueError("validation data has different #features")
            self.mappers = reference.mappers
            self.used_features = reference.used_features
        else:
            if cfg.bin_find == "sketch":
                raise NotImplementedError(
                    "bin_find=sketch is not ported yet (ROADMAP.md §A "
                    "item 12)")
            self.mappers = find_bin_mappers(
                X, cfg.max_bin, cfg.min_data_in_bin, cfg.min_data_in_leaf,
                categorical=categorical_feature,
                sample_cnt=cfg.bin_construct_sample_cnt,
                seed=cfg.data_random_seed, bin_budget=cfg.bin_budget)
            self.used_features = [i for i, m in enumerate(self.mappers)
                                  if not m.is_trivial]
            if _plan_bundles_from_sample(X, self.mappers,
                                         self.used_features,
                                         cfg) is not None:
                raise NotImplementedError(
                    "Exclusive Feature Bundling formed a bundle; bundled "
                    "stores are not ported yet (ROADMAP.md §A item 10) — "
                    "pass enable_bundle=false")
            if resolve_sparse_store(cfg, self.mappers, self.used_features):
                raise NotImplementedError(
                    "the sparse (csr) store is not ported yet (ROADMAP.md "
                    "§A item 11) — pass sparse_store=dense")
        used = self.used_features
        self.num_bins = np.array([self.mappers[i].num_bin for i in used],
                                 dtype=np.int32)
        self.is_categorical = np.array(
            [self.mappers[i].bin_type == CATEGORICAL for i in used],
            dtype=bool)
        self.max_num_bin = int(self.num_bins.max()) if len(used) else 1
        dtype = np.uint8 if self.max_num_bin <= 256 else np.uint16
        self.bins = np.empty((len(used), n), dtype=dtype)
        for k, i in enumerate(used):
            self.bins[k] = self.mappers[i].value_to_bin(X[:, i]).astype(dtype)

        md = metadata or Metadata()
        if label is not None:
            md.label = np.asarray(label, dtype=np.float32).reshape(-1)
        if md.label.size == 0:
            md.label = np.zeros(n, dtype=np.float32)
        if md.label.size != n:
            raise ValueError("label length mismatch")
        self.metadata = md

    @property
    def num_features(self) -> int:
        return len(self.used_features)

    def inner_to_real(self, inner: int) -> int:
        return self.used_features[inner]

    def real_to_inner(self, real: int) -> int:
        """Inner (used-feature) index, or -1 when the raw feature was
        filtered as trivial."""
        try:
            return self.used_features.index(real)
        except ValueError:
            return -1

    def feature_infos(self) -> List[str]:
        return [m.feature_info() for m in self.mappers]
