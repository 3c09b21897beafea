"""Binned Dataset: the dense [F, N] bin store and the sparse CSR/ELL store.

Port of lightgbm_tpu/dataset.py: `Metadata` (labels, weights, query
boundaries), and a `Dataset` that finds BinMappers on the host
(binning.py), drops trivial features, and bins every used feature with
`BinMapper.value_to_bin` (the NumPy path; the JAX package's native bulk
binner is not used).  Validation sets are binned with the training set's
mappers.

The sparse store (`SparseStore`, docs/Sparse.md of the JAX package)
keeps, per row, up to R (store column, bin) entries for exactly the cells
whose bin differs from the column's zero bin; the histogram kernels
rebuild each column's zero bin from per-leaf totals.  `sparse_store=csr`
(or `auto` on wide, mostly-zero data) builds it: straight from scipy CSC
columns in `Dataset.from_csc`, or by sparsifying the dense store after
binning.  Valid sets follow their reference's layout.  A consumer without
a sparse path densifies lazily through `Dataset.bins`, and every such
densification is counted in `SPARSE_FALLBACKS`.

Exclusive Feature Bundling (EFB, docs/Bundling.md of the JAX package):
when `enable_bundle` is on, a bundle plan is drawn from a row sample
(`binning.plan_bundles`) and mutually exclusive features share one store
column, bin 0 meaning "every member at its default bin".  The store then
has fewer columns than there are used features; `num_bins` and
`is_categorical` keep the original per-feature view that split search
and trees speak, `store_num_bins` describes the stored columns, and the
learners translate between the two with `bundle_feat_table` and
`unbundle_tables`.  Valid sets inherit their reference's plan.  A sparse
store over bundled columns is not ported: where one would form,
construction raises NotImplementedError.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import log
from .binning import (BinMapper, BundlePlan, CATEGORICAL, find_bin_mappers,
                      plan_bundles)
from .config import Config
from .quantize import bin_column_into, bin_rows_into

# rows used to estimate pairwise feature conflicts when planning bundles
BUNDLE_PLAN_SAMPLE_CNT = 50_000

# densifications of a sparse store, by consumer site (the JAX package's
# tree/sparse_fallbacks counter); a csr run reads 0 here
SPARSE_FALLBACKS: Dict[str, int] = {}


def sparse_fallbacks() -> int:
    return sum(SPARSE_FALLBACKS.values())


def reset_sparse_fallbacks() -> None:
    SPARSE_FALLBACKS.clear()


def nnz_capacity_tier(n: int, base: int = 4) -> int:
    """Smallest power of two >= n (floor `base`): the ELL row width R of
    a sparse store."""
    cap = max(int(base), 1)
    n = max(int(n), 1)
    while cap < n:
        cap <<= 1
    return cap


@dataclass
class SparseStore:
    """CSR/ELL-packed binned store: per row, up to R (store column, bin)
    entries, front-packed in column order, for exactly the cells whose
    bin differs from the column's zero bin (the bin a raw 0.0 maps to).
    `densify()` reproduces the dense store bitwise."""
    cols: np.ndarray      # [N, R] int32 store-column ids; C = empty slot
    bins: np.ndarray      # [N, R] uint8/uint16 bin values
    zero_bin: np.ndarray  # [C] int32 implicit-zero bin per store column
    nnz: int = 0          # stored entries (excluding ELL padding)

    @property
    def num_columns(self) -> int:
        return int(self.zero_bin.shape[0])

    @property
    def nnz_capacity(self) -> int:
        return int(self.cols.shape[1])

    def densify(self, dtype) -> np.ndarray:
        """The dense [C, N] store (the fallback for consumers without a
        sparse path; callers count it)."""
        C = self.num_columns
        n = self.cols.shape[0]
        out = np.repeat(self.zero_bin.astype(dtype)[:, None], n, axis=1)
        ri, sj = np.nonzero(self.cols < C)
        out[self.cols[ri, sj], ri] = self.bins[ri, sj]
        return out


def _pack_ell(rows: np.ndarray, cols: np.ndarray, binvals: np.ndarray,
              n: int, num_columns: int, zero_bin: np.ndarray,
              dtype) -> SparseStore:
    """Row-sorted COO entries -> ELL arrays at the nnz capacity tier."""
    cnt = np.bincount(rows, minlength=n) if rows.size else \
        np.zeros(n, np.int64)
    R = nnz_capacity_tier(int(cnt.max(initial=1)))
    ell_c = np.full((n, R), num_columns, np.int32)
    ell_b = np.zeros((n, R), dtype)
    if rows.size:
        offs = np.concatenate([[0], np.cumsum(cnt)])
        pos = np.arange(rows.size, dtype=np.int64) - offs[rows]
        ell_c[rows, pos] = cols
        ell_b[rows, pos] = binvals
    return SparseStore(cols=ell_c, bins=ell_b,
                       zero_bin=np.asarray(zero_bin, np.int32),
                       nnz=int(rows.size))


def store_zero_bins(mappers: List[BinMapper],
                    used: Sequence[int]) -> np.ndarray:
    """[C] int32 bin an implicit raw zero maps to, per store column: the
    feature's default bin (the no-bundle form: a sparse store over
    bundle columns is not ported)."""
    return np.asarray([mappers[i].default_bin for i in used], np.int32)


@dataclass
class Metadata:
    label: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    weights: Optional[np.ndarray] = None        # fp32 [N]
    query_boundaries: Optional[np.ndarray] = None  # int32 [num_queries+1]
    init_score: Optional[np.ndarray] = None     # fp64 [N * num_tree_per_iter]

    @property
    def num_data(self) -> int:
        return int(self.label.shape[0])

    @property
    def num_queries(self) -> int:
        return (0 if self.query_boundaries is None
                else len(self.query_boundaries) - 1)

    def set_query_from_sizes(self, sizes: np.ndarray) -> None:
        """Group sizes -> query boundaries."""
        sizes = np.asarray(sizes, dtype=np.int64)
        self.query_boundaries = np.concatenate(
            [[0], np.cumsum(sizes)]).astype(np.int32)

    @property
    def query_weights(self) -> Optional[np.ndarray]:
        """Per-query weight = mean row weight over the query's rows, only
        when both row weights and query boundaries exist (NDCG averages
        per-query results by these)."""
        if self.weights is None or self.query_boundaries is None:
            return None
        qb = self.query_boundaries.astype(np.int64)
        sizes = np.diff(qb)
        csum = np.concatenate([[0.0], np.cumsum(
            self.weights.astype(np.float64))])
        sums = csum[qb[1:]] - csum[qb[:-1]]
        return (sums / np.maximum(sizes, 1)).astype(np.float32)


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


def _log_bundle_state(plan: Optional[BundlePlan], num_used: int,
                      cfg: Config) -> None:
    """The one-line construction log of the bundling outcome (the JAX
    package also bumps profiling counters here; those are not ported)."""
    if cfg.verbose < 1:
        return
    if plan is None:
        state = "off" if not cfg.enable_bundle else \
            "inactive (no exclusive features)"
        log.info(f"EFB: bundling {state}; {num_used} features "
                 "histogrammed directly")
        return
    log.info(f"EFB: bundled {num_used} features into {plan.num_columns} "
             f"columns ({plan.num_bundles} bundles holding "
             f"{plan.num_packed} features; sampled conflict rate "
             f"{plan.est_conflict_rate:.4f} summed over bundles, budget "
             f"{cfg.max_conflict_rate:g} each)")


def resolve_sparse_store(cfg: Config, mappers: List[BinMapper],
                         used: Sequence[int],
                         plan: Optional[BundlePlan] = None) -> bool:
    """Whether the `sparse_store` knob asks for the csr store: "csr"
    always; "auto" when sparse storage is enabled, the rounds learner
    runs (the port's `auto` growth on every device), the store has >= 128
    columns and the mean zero-bin rate of the stored columns clears
    sparse_threshold — a bundle column's rate is the complement of its
    members' summed non-default rates."""
    mode = getattr(cfg, "sparse_store", "dense")
    if mode == "csr":
        return True
    if mode != "auto" or not cfg.is_enable_sparse or not used:
        return False
    if getattr(cfg, "tree_growth", "auto") == "exact":
        return False
    C = plan.num_columns if plan is not None else len(used)
    if C < 128:
        return False
    if plan is None:
        rates = np.asarray([mappers[i].sparse_rate for i in used])
    else:
        nd = np.zeros(plan.num_columns)
        for k, i in enumerate(used):
            nd[int(plan.feat_col[k])] += 1.0 - mappers[i].sparse_rate
        rates = 1.0 - np.minimum(nd, 1.0)
    return float(np.mean(rates)) >= float(cfg.sparse_threshold)


def _refuse_sparse_bundles(plan: Optional[BundlePlan]) -> None:
    if plan is not None:
        raise NotImplementedError(
            "a sparse store over EFB-bundled columns is not ported yet "
            "(ROADMAP.md §A item 11) — pass sparse_store=dense or "
            "enable_bundle=false")


def _csc_row_sample(indptr: np.ndarray, indices: np.ndarray,
                    data: np.ndarray, rows: np.ndarray,
                    num_raw: int) -> np.ndarray:
    """Dense [len(rows), num_raw] float64 sample of a CSC matrix's rows
    (sorted `rows`), in column-major order so each column's values are
    contiguous for FindBin.  Entries are written column by column in
    storage order, so a duplicated (row, column) keeps its last value,
    as the JAX package's per-column loop does."""
    sample = np.zeros((len(rows), num_raw), np.float64, order="F")
    if indices.size == 0 or len(rows) == 0:
        return sample
    colj = np.repeat(np.arange(num_raw, dtype=np.int64), np.diff(indptr))
    pos = np.searchsorted(rows, indices)
    hit = pos < len(rows)
    hit[hit] = rows[pos[hit]] == indices[hit]
    sample[pos[hit], colj[hit]] = np.asarray(data, np.float64)[hit]
    return sample


class Dataset:
    """Binned feature matrix + metadata.

    Attributes
    ----------
    bins : np.ndarray  [num_store_columns, num_data] uint8/uint16 bin ids
        (one row per used feature, or per bundle column under a plan; a
        sparse dataset densifies it lazily, counted in SPARSE_FALLBACKS)
    sparse : SparseStore or None — the CSR/ELL store
    bundle_plan : BundlePlan or None — the EFB layout of the store
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
        t0 = time.perf_counter()
        cfg = config or Config()
        X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
        if X.ndim != 2:
            raise ValueError("X must be 2-dimensional")
        n, num_raw = X.shape
        if reference is not None:
            # a valid set takes its reference's mappers and bundle plan,
            # so it shares the training walk and unbundle tables
            if num_raw != reference.num_total_features:
                raise ValueError("validation data has different #features")
            mappers, used = reference.mappers, reference.used_features
            plan = reference.bundle_plan
        else:
            mappers, used, plan = self._find_mappers(X, cfg,
                                                     categorical_feature)
        self._init_store(cfg, mappers, used, n, num_raw, feature_names, plan)
        t1 = time.perf_counter()
        self.bundle_conflict_rows += bin_rows_into(X, mappers, used, plan,
                                                   self._bins, 0)
        self._check_realized_conflicts()
        # training sets by the resolver; valid sets follow their
        # reference's layout (a csr valid set is scored from its ELL rows)
        if ((reference is None or reference.sparse is not None)
                and resolve_sparse_store(cfg, mappers, used, plan)):
            _refuse_sparse_bundles(plan)
            self._sparsify_store()
        # host seconds of the mappers and bundle plan, and of the store
        self.setup_seconds = {"binning": t1 - t0,
                              "store": time.perf_counter() - t1}
        self._set_metadata(metadata, label)

    @staticmethod
    def _find_mappers(sample: np.ndarray, cfg: Config,
                      categorical_feature: Sequence[int]):
        """(mappers, used features, bundle plan or None) from a
        raw-valued row sample; refuses sketch bin finding, which is not
        ported."""
        if cfg.bin_find == "sketch":
            raise NotImplementedError(
                "bin_find=sketch is not ported yet (ROADMAP.md §A item 12)")
        mappers = find_bin_mappers(
            sample, cfg.max_bin, cfg.min_data_in_bin, cfg.min_data_in_leaf,
            categorical=categorical_feature,
            sample_cnt=cfg.bin_construct_sample_cnt,
            seed=cfg.data_random_seed, bin_budget=cfg.bin_budget)
        used = [i for i, m in enumerate(mappers) if not m.is_trivial]
        plan = _plan_bundles_from_sample(sample, mappers, used, cfg)
        _log_bundle_state(plan, len(used), cfg)
        return mappers, used, plan

    def _init_store(self, cfg: Config, mappers: List[BinMapper],
                    used: List[int], n: int, num_raw: int,
                    feature_names: Optional[List[str]],
                    plan: Optional[BundlePlan] = None) -> None:
        """Per-feature metadata derived from the mappers, and the dense
        [C, N] store allocated (zeroed under a plan: a bundle column's
        bin 0 means every member at its default).  `num_bins` and
        `is_categorical` keep the original per-feature view; the stored
        columns are described by `store_num_bins` and `max_num_bin`."""
        self.config = cfg
        self.num_data = n
        self.num_total_features = num_raw
        self.feature_names = (feature_names
                              or [f"Column_{i}" for i in range(num_raw)])
        self.mappers = mappers
        self.used_features = used
        self.num_bins = np.array([mappers[i].num_bin for i in used],
                                 dtype=np.int32)
        self.is_categorical = np.array(
            [mappers[i].bin_type == CATEGORICAL for i in used], dtype=bool)
        self.bundle_plan = plan
        self.bundle_conflict_rows = 0
        self.store_num_bins = (self.num_bins if plan is None
                               else plan.col_num_bins)
        C = len(self.store_num_bins)
        self.max_num_bin = int(self.store_num_bins.max()) if C else 1
        self._store_dtype = np.uint8 if self.max_num_bin <= 256 \
            else np.uint16
        self.sparse: Optional[SparseStore] = None
        self._bins = (np.empty((C, n), self._store_dtype) if plan is None
                      else np.zeros((C, n), self._store_dtype))

    def _set_metadata(self, metadata: Optional[Metadata],
                      label: Optional[np.ndarray]) -> None:
        n = self.num_data
        md = metadata or Metadata()
        if label is not None:
            md.label = np.asarray(label, dtype=np.float32).reshape(-1)
        if md.label.size == 0:
            md.label = np.zeros(n, dtype=np.float32)
        if md.label.size != n:
            raise ValueError("label length mismatch")
        self.metadata = md

    @classmethod
    def from_csc(cls, sp_matrix, label: Optional[np.ndarray],
                 cfg: Config, metadata: Optional[Metadata] = None,
                 feature_names: Optional[List[str]] = None,
                 categorical_feature: Sequence[int] = (),
                 reference: Optional["Dataset"] = None) -> "Dataset":
        """Construct from a scipy sparse matrix: a row sample is densified
        once for BinMapper construction; then, when `sparse_store`
        resolves sparse, the CSR/ELL store is built straight from the CSC
        columns.  Otherwise (and for a valid set, as in the JAX package)
        each column is binned into the dense [C, N] store one at a time.
        Neither route materializes the dense [N, F] float64 matrix.

        `setup_seconds` records the host time of the two steps:
        {"binning": sample + FindBin, "store": the store build}."""
        t0 = time.perf_counter()
        sp = sp_matrix.tocsc()
        n, num_raw = sp.shape
        indptr = np.asarray(sp.indptr, np.int64)
        indices, data = sp.indices, sp.data
        if reference is not None:
            if num_raw != reference.num_total_features:
                raise ValueError("validation data has different #features")
            mappers, used = reference.mappers, reference.used_features
            plan = reference.bundle_plan
        else:
            S = min(int(cfg.bin_construct_sample_cnt), n)
            rng = np.random.RandomState(cfg.data_random_seed)
            rows = (np.sort(rng.choice(n, S, replace=False)) if n > S
                    else np.arange(n))
            sample = _csc_row_sample(indptr, indices, data, rows, num_raw)
            mappers, used, plan = cls._find_mappers(sample, cfg,
                                                    categorical_feature)
            del sample
        ds = cls.__new__(cls)
        sparse = reference is None and resolve_sparse_store(cfg, mappers,
                                                            used, plan)
        if sparse:
            _refuse_sparse_bundles(plan)
        # the sparse build never allocates the dense store
        ds._init_store(cfg, mappers, used, 0 if sparse else n, num_raw,
                       feature_names, plan)
        ds.num_data = n
        t1 = time.perf_counter()
        if sparse:
            ds._build_sparse_from_csc(indptr, indices, data,
                                      bool(sp.has_canonical_format))
        else:
            col = np.empty(n, np.float64)
            for k, i in enumerate(used):
                col[:] = 0.0
                s, e = int(indptr[i]), int(indptr[i + 1])
                col[indices[s:e]] = data[s:e]
                ds.bundle_conflict_rows += bin_column_into(
                    k, col, mappers, used, plan, ds._bins)
            ds._check_realized_conflicts()
        ds.setup_seconds = {"binning": t1 - t0,
                            "store": time.perf_counter() - t1}
        ds._set_metadata(metadata, label)
        return ds

    def _build_sparse_from_csc(self, indptr, indices, data,
                               canonical: bool) -> None:
        """The CSR/ELL store straight from scipy CSC arrays, entry for
        entry the store the JAX package builds (`_build_sparse_from_csc`,
        no-bundle form), without its dense [N] scratch per column:
        value_to_bin is elementwise and a raw 0.0 maps to the column's
        zero bin (its default bin), so a row without a stored value is
        never an entry and only the stored values need binning.  A
        non-canonical matrix keeps each duplicated (row, column)'s last
        value, as the dense scratch write does.  Entries land in each
        row front-packed in column order — the row-stable order of the
        JAX package's sort."""
        n = self.num_data
        used = self.used_features
        zb = store_zero_bins(self.mappers, used)
        C = len(used)
        per_col = []
        cnt = np.zeros(n, np.int64)
        for k, i in enumerate(used):
            s, e = int(indptr[i]), int(indptr[i + 1])
            r = np.asarray(indices[s:e], np.int64)
            v = np.asarray(data[s:e], np.float64)
            if not canonical and r.size:
                o = np.argsort(r, kind="stable")
                r, v = r[o], v[o]
                last = np.concatenate([r[1:] != r[:-1], [True]])
                r, v = r[last], v[last]
            b = self.mappers[i].value_to_bin(v)
            keep = b != zb[k]
            r, b = r[keep], b[keep].astype(self._store_dtype)
            per_col.append((r, b))
            cnt[r] += 1
        nnz = int(cnt.sum())
        R = nnz_capacity_tier(int(cnt.max(initial=1)))
        ell_c = np.full((n, R), C, np.int32)
        ell_b = np.zeros((n, R), self._store_dtype)
        fill = np.zeros(n, np.int64)
        for k, (r, b) in enumerate(per_col):
            if r.size:
                pos = fill[r]
                ell_c[r, pos] = k
                ell_b[r, pos] = b
                fill[r] += 1
        self.sparse = SparseStore(cols=ell_c, bins=ell_b, zero_bin=zb,
                                  nnz=nnz)
        self._bins = None

    def _sparsify_store(self) -> None:
        """Convert the freshly binned dense store to the CSR/ELL layout
        and drop the dense matrix; densify() reproduces it bitwise."""
        zb = store_zero_bins(self.mappers, self.used_features)
        dense = self._bins
        nz = dense != zb[:, None].astype(dense.dtype)
        nzr, nzc = np.nonzero(nz.T)          # row-major entry order
        self.sparse = _pack_ell(nzr, nzc, dense[nzc, nzr], dense.shape[1],
                                dense.shape[0], zb, self._store_dtype)
        self._bins = None

    # -- store access --------------------------------------------------------

    @property
    def bins(self) -> np.ndarray:
        """[C, N] dense binned store; a sparse dataset materializes it on
        first access, counted in SPARSE_FALLBACKS."""
        return self.dense_bins()

    def dense_bins(self, site: str = "unlabeled") -> np.ndarray:
        """`bins` with the densifying consumer named in the count."""
        if self._bins is None and self.sparse is not None:
            SPARSE_FALLBACKS[site] = SPARSE_FALLBACKS.get(site, 0) + 1
            log.warning(
                f"sparse store materialized dense ({self.num_store_columns} x "
                f"{self.num_data} cells) for a consumer without a sparse "
                f"path (site={site})")
            self._bins = self.sparse.densify(self._store_dtype)
        return self._bins

    def sparse_triple(self, device):
        """(cols [N, R] int32, bins [N, R] int32, zero_bin [C] int32) of
        the sparse store as tensors on `device` — the feed of the rounds
        learner's histograms and partition and of the valid-set walk
        (ops/predict.sparse_bin_lookup).  None when dense."""
        if self.sparse is None:
            return None
        import torch
        sp = self.sparse
        return (torch.as_tensor(np.ascontiguousarray(sp.cols, np.int32),
                                device=device),
                torch.as_tensor(sp.bins.astype(np.int32), device=device),
                torch.as_tensor(sp.zero_bin.astype(np.int32),
                                device=device))

    # -- bundle views --------------------------------------------------------

    @property
    def num_store_columns(self) -> int:
        """Stored (histogrammed) columns: num_features, or fewer under
        a bundle plan."""
        return int(len(self.store_num_bins))

    def bundle_feat_table(self) -> Optional[np.ndarray]:
        """[5, F] f32 (column, offset, default, nslots, packed) per
        original feature — the walk and predicate table — or None when
        unbundled."""
        if self.bundle_plan is None:
            return None
        return self.bundle_plan.feat_table()

    def unbundle_tables(self, num_bins_padded: int,
                        num_columns_padded: int = 0):
        """(src [F, B] int32, dmask [F, B] bool) gather tables of
        ops/split.unbundle_hist, or None when the store is the original
        per-feature layout.  num_columns_padded: the column count of the
        histograms to unbundle when a learner pads the store, so that the
        zero sentinel sits past every padded column."""
        if self.bundle_plan is None:
            return None
        return self.bundle_plan.unbundle_tables(
            self.num_bins, num_bins_padded, num_columns_padded)

    def unbundled_bins(self) -> np.ndarray:
        """The original [num_features, N] per-feature store rebuilt from
        the bundle columns (a packed feature out of its slot window sits
        at its default bin)."""
        store = self.dense_bins(site="unbundled_bins")
        plan = self.bundle_plan
        if plan is None:
            return store
        F = len(self.used_features)
        out = np.empty((F, self.num_data), store.dtype)
        for k in range(F):
            col = store[int(plan.feat_col[k])]
            if not plan.feat_packed[k]:
                out[k] = col
                continue
            off = int(plan.feat_offset[k])
            d = int(plan.feat_default[k])
            s = col.astype(np.int32) - off
            in_r = (s >= 0) & (s < int(plan.feat_nslots[k]))
            out[k] = np.where(in_r, s + (s >= d), d).astype(store.dtype)
        return out

    def realized_conflict_rate(self) -> float:
        if self.bundle_plan is None or self.num_data == 0:
            return 0.0
        return float(self.bundle_conflict_rows) / float(self.num_data)

    def _check_realized_conflicts(self) -> None:
        """The plan judged exclusivity on a row sample; binning counted
        conflicts exactly.  Warn when the data conflicts more than the
        budget promised (any conflict under max_conflict_rate=0, which
        is advertised as lossless)."""
        if self.bundle_plan is None or self.bundle_conflict_rows == 0:
            return
        rate = self.realized_conflict_rate()
        budget = float(self.config.max_conflict_rate)
        if budget == 0.0 or rate > budget * max(self.bundle_plan.num_bundles,
                                                1):
            log.warning(
                f"EFB: {self.bundle_conflict_rows} conflicting rows "
                f"(rate {rate:.5f}) exceed what the planning sample "
                f"promised (budget {budget:g}/bundle); conflicting rows "
                "keep only the last-bundled feature's bin. Set "
                "enable_bundle=false (or raise bin_construct_sample_cnt) "
                "for exact training")

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
