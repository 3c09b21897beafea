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
store over bundled columns keeps the bundle columns' entries (a packed
column's zero bin is 0), built by the same two routes; `sparse_entries`
and `unbundled_sparse_entries` are its COO views.

A streaming dataset (`streaming_from`, `from_stream`) bins appended
chunks against frozen mappers into a store that grows along a
power-of-two row-capacity ladder (`row_capacity_tier`); `reset_rows`
empties it and keeps the tier, `compacted` copies its rows out.  The
online trainer's window is one.  `bin_find=sketch` derives the mappers
from mergeable quantile summaries (sharded/sketch.py).

In a pre-partitioned world (`is_pre_partition` and a `torch.distributed`
world of more than one rank) `from_file` keeps only the rank's block of
the file's rows, binned with mappers derived from every rank's sample
(`_load_rank_rows`), and marks it in `rank_rows`.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import log, profiling
from .binning import (BinMapper, BundlePlan, CATEGORICAL, find_bin_mappers,
                      plan_bundles)
from .config import Config
from .quantize import bin_column_into, bin_feature_column, bin_rows_into

# rows used to estimate pairwise feature conflicts when planning bundles
BUNDLE_PLAN_SAMPLE_CNT = 50_000

# smallest row capacity of a streaming (appendable) dataset store; growth
# doubles from here, so the capacities form a power-of-two ladder
STREAM_CAPACITY_BASE = 1024


def row_capacity_tier(n: int, base: int = STREAM_CAPACITY_BASE) -> int:
    """Smallest power-of-two multiple of `base` that is >= n: the row
    capacity of a streaming store holding n rows.  Appends within a tier
    keep the store's array, so the capacity grows O(log rows) times."""
    cap = max(int(base), 1)
    n = max(int(n), 1)
    while cap < n:
        cap <<= 1
    return cap

# densifications of a sparse store, by consumer site; each one also
# counts in the profiling registry's tree/sparse_fallbacks (and its
# site-labeled series), as in the JAX package.  A csr run reads 0 here
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


def store_zero_bins(mappers: List[BinMapper], used: Sequence[int],
                    plan: Optional[BundlePlan] = None) -> np.ndarray:
    """[C] int32 bin an implicit raw zero maps to, per store column: the
    member feature's default bin for a singleton column, 0 ("every
    member at its default") for an EFB-packed column."""
    if plan is None:
        return np.asarray([mappers[i].default_bin for i in used], np.int32)
    zb = np.zeros(plan.num_columns, np.int32)
    for k, i in enumerate(used):
        if not plan.feat_packed[k]:
            zb[int(plan.feat_col[k])] = int(mappers[i].default_bin)
    return zb


# ----------------------------------------------------------------------------
# Text files (the reference's parser.cpp): CSV, TSV and LibSVM
# ----------------------------------------------------------------------------

def _detect_format(line: str) -> str:
    """Probe one data line: 'libsvm' | 'tsv' | 'csv' (a space-separated
    line reads as tsv)."""
    toks = line.strip().split()
    if len(toks) > 1 and ":" in toks[1]:
        return "libsvm"
    if "\t" in line:
        return "tsv"
    if "," in line:
        return "csv"
    return "tsv"


def _header_names(line: str) -> List[str]:
    sep = "\t" if "\t" in line else ("," if "," in line else None)
    return [t.strip() for t in line.strip().split(sep)]


def _parse_libsvm(f) -> Tuple[np.ndarray, np.ndarray]:
    """(X, y) of the LibSVM lines left in the open file `f`."""
    labels: List[float] = []
    rows: List[Dict[int, float]] = []
    max_idx = -1
    for line in f:
        line = line.strip()
        if not line:
            continue
        toks = line.split()
        labels.append(float(toks[0]))
        row: Dict[int, float] = {}
        for t in toks[1:]:
            if ":" not in t:
                continue
            k, v = t.split(":", 1)
            ki = int(k)
            row[ki] = float(v)
            max_idx = max(max_idx, ki)
        rows.append(row)
    X = np.zeros((len(rows), max_idx + 1), dtype=np.float64)
    for i, row in enumerate(rows):
        for k, v in row.items():
            X[i, k] = v
    return X, np.asarray(labels, dtype=np.float64)


def probe_text_file(path: str, has_header: bool
                     ) -> Tuple[str, Optional[List[str]]]:
    """(format, header names or None) of a text file; raises on an empty
    one."""
    with open(path, "r") as f:
        first = f.readline()
        if not first:
            raise ValueError(f"empty data file: {path}")
        names = None
        if has_header:
            names = _header_names(first)
            first = f.readline() or first
    return _detect_format(first), names


def parse_text_file_numpy(path: str, has_header: bool = False,
                          label_idx: int = 0
                          ) -> Tuple[np.ndarray, np.ndarray,
                                     Optional[List[str]]]:
    """`parse_text_file` without the native parser: `np.loadtxt` for
    CSV/TSV (correctly rounded, '#' starts a comment), a line loop for
    LibSVM."""
    fmt, header_names = probe_text_file(path, has_header)
    if fmt == "libsvm":
        with open(path, "r") as f:
            if has_header:
                f.readline()
            X, y = _parse_libsvm(f)
        return X, y, header_names
    raw = np.loadtxt(path, delimiter="," if fmt == "csv" else None,
                     skiprows=1 if has_header else 0, dtype=np.float64,
                     ndmin=2)
    y = raw[:, label_idx].copy()
    return np.delete(raw, label_idx, axis=1), y, header_names


def parse_text_file(path: str, has_header: bool = False, label_idx: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray, Optional[List[str]]]:
    """Parse a CSV/TSV/LibSVM data file into (X, y, feature_names).

    The format is detected from the first data line; the label is column
    `label_idx` for CSV/TSV and the first token for LibSVM.  A file
    without a header goes through the native parser (native.py, a
    correctly rounded `std::from_chars` loop) where g++ could build it,
    else through `parse_text_file_numpy`, with the same values; header
    names are read by the NumPy parser only, as in the JAX package.  An
    empty file raises ValueError on every path."""
    from . import native
    if os.path.getsize(path) == 0:
        raise ValueError(f"empty data file: {path}")
    if not has_header:
        res = native.parse_text_native(path, has_header, label_idx)
        if res is not None:
            native.PARSES["native"] += 1
            return res[0], res[1], None
    native.PARSES["numpy"] += 1
    return parse_text_file_numpy(path, has_header, label_idx)


def iter_text_chunks(path: str, fmt: str, has_header: bool,
                     chunk_rows: int):
    """Yield the rows of a CSV/TSV file as float64 [rows, columns] blocks
    of exactly `chunk_rows` rows (the last one shorter), read by
    `np.loadtxt(max_rows=)` from one open file: the values of the
    one-shot parse, correctly rounded, and the chunk boundaries of
    `pd.read_csv(chunksize=)`, which the two-round sampler draws its
    random numbers by.  Comment and blank lines hold no row."""
    delim = "," if fmt == "csv" else None
    with open(path, "r") as f:
        if has_header:
            f.readline()
        while True:
            with warnings.catch_warnings():
                # the read past the last row finds no data
                warnings.filterwarnings("ignore", "loadtxt: input "
                                        "contained no data")
                arr = np.loadtxt(f, delimiter=delim, max_rows=chunk_rows,
                                 dtype=np.float64, ndmin=2)
            if len(arr) == 0:
                return
            yield arr
            if len(arr) < chunk_rows:
                return


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

    @staticmethod
    def load_side_files(data_path: str, num_data: int) -> "Metadata":
        """`<data>.weight`, `<data>.init` and `<data>.query` beside a data
        file, where present (the reference's metadata.cpp)."""
        md = Metadata()
        wpath = data_path + ".weight"
        if os.path.exists(wpath):
            md.weights = np.loadtxt(wpath, dtype=np.float32).reshape(-1)
        ipath = data_path + ".init"
        if os.path.exists(ipath):
            md.init_score = np.loadtxt(ipath, dtype=np.float64).reshape(-1)
        qpath = data_path + ".query"
        if os.path.exists(qpath):
            md.set_query_from_sizes(
                np.loadtxt(qpath, dtype=np.int64).reshape(-1))
        return md


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
    source : str or None — the data file the rows were read from
    rank_rows : slice or None — in a pre-partitioned world, the rows of
        the file this rank holds (`Dataset.from_file`); None when the
        dataset holds every row
    """

    source: Optional[str] = None
    rank_rows: Optional[slice] = None

    def __init__(self, X: np.ndarray, label: Optional[np.ndarray] = None,
                 config: Optional[Config] = None,
                 reference: Optional["Dataset"] = None,
                 metadata: Optional[Metadata] = None,
                 feature_names: Optional[List[str]] = None,
                 categorical_feature: Sequence[int] = ()):
        with profiling.phase("dataset.binning", force=True) as binning:
            cfg = config or Config()
            X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
            if X.ndim != 2:
                raise ValueError("X must be 2-dimensional")
            n, num_raw = X.shape
            if reference is not None:
                # a valid set takes its reference's mappers and bundle
                # plan, so it shares the training walk and unbundle
                # tables
                if num_raw != reference.num_total_features:
                    raise ValueError(
                        "validation data has different #features")
                mappers, used = reference.mappers, reference.used_features
                plan = reference.bundle_plan
            else:
                mappers, used, plan = self._find_mappers(
                    X, cfg, categorical_feature,
                    sketch=cfg.bin_find == "sketch")
            self._init_store(cfg, mappers, used, n, num_raw, feature_names,
                             plan)
        with profiling.phase("dataset.store", force=True) as store:
            self._bin_rows_into(X, 0)
            self._check_realized_conflicts()
            # training sets by the resolver; valid sets follow their
            # reference's layout (a csr valid set is scored from its ELL
            # rows)
            if ((reference is None or reference.sparse is not None)
                    and resolve_sparse_store(cfg, mappers, used, plan)):
                self._sparsify_store()
        # host seconds of the mappers and bundle plan, and of the store
        self.setup_seconds = {"binning": binning.seconds,
                              "store": store.seconds}
        self._set_metadata(metadata, label)

    @staticmethod
    def _find_mappers(sample: np.ndarray, cfg: Config,
                      categorical_feature: Sequence[int],
                      sketch: bool = False):
        """(mappers, used features, bundle plan or None) from a
        raw-valued row sample.  `sketch` (the dense constructor under
        bin_find=sketch) derives the mappers from mergeable quantile
        summaries over every row of `sample` (sharded/sketch.py), the
        derivation of the streamed construction; exact whenever
        sketch_eps holds every distinct value."""
        if sketch:
            from .sharded.sketch import sketch_columns
            mappers = sketch_columns(
                sample, cfg, categorical=categorical_feature
            ).mappers_from_config(cfg)
        else:
            mappers = find_bin_mappers(
                sample, cfg.max_bin, cfg.min_data_in_bin,
                cfg.min_data_in_leaf, categorical=categorical_feature,
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
        {"binning": sample + FindBin, "store": the store build}, the
        `dataset.binning` and `dataset.store` phases."""
        with profiling.phase("dataset.binning", force=True) as binning:
            sp = sp_matrix.tocsc()
            n, num_raw = sp.shape
            indptr = np.asarray(sp.indptr, np.int64)
            indices, data = sp.indices, sp.data
            if reference is not None:
                if num_raw != reference.num_total_features:
                    raise ValueError(
                        "validation data has different #features")
                mappers, used = reference.mappers, reference.used_features
                plan = reference.bundle_plan
            else:
                S = min(int(cfg.bin_construct_sample_cnt), n)
                rng = np.random.RandomState(cfg.data_random_seed)
                rows = (np.sort(rng.choice(n, S, replace=False)) if n > S
                        else np.arange(n))
                sample = _csc_row_sample(indptr, indices, data, rows,
                                         num_raw)
                mappers, used, plan = cls._find_mappers(sample, cfg,
                                                        categorical_feature)
                del sample
            ds = cls.__new__(cls)
            sparse = reference is None and resolve_sparse_store(
                cfg, mappers, used, plan)
            # the sparse build never allocates the dense store
            ds._init_store(cfg, mappers, used, 0 if sparse else n, num_raw,
                           feature_names, plan)
            ds.num_data = n
        with profiling.phase("dataset.store", force=True) as store:
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
        ds.setup_seconds = {"binning": binning.seconds,
                            "store": store.seconds}
        ds._set_metadata(metadata, label)
        return ds

    def _build_sparse_from_csc(self, indptr, indices, data,
                               canonical: bool) -> None:
        """The CSR/ELL store straight from scipy CSC arrays, entry for
        entry the store the JAX package builds (`_build_sparse_from_csc`),
        column by store column, without the dense [C, N] matrix.  A
        column holding one unpacked feature bins only its stored values:
        value_to_bin is elementwise and a raw 0.0 maps to the column's
        zero bin (the feature's default bin), so a row without a stored
        value is never an entry; a non-canonical matrix keeps each
        duplicated (row, column)'s last value, as the dense scratch write
        does.  An EFB bundle column is binned as the JAX package bins it:
        one dense [N] scratch, its members packed in used order with the
        dense route's last-writer-wins rule (conflicts counted in
        `bundle_conflict_rows`), and the cells off the zero bin kept.
        Entries land in each row front-packed in column order — the
        row-stable order of the JAX package's sort."""
        n = self.num_data
        plan = self.bundle_plan
        used = self.used_features
        zb = store_zero_bins(self.mappers, used, plan)
        C = self.num_store_columns
        members: List[List[int]] = [[] for _ in range(C)]
        for k in range(len(used)):
            members[k if plan is None else int(plan.feat_col[k])].append(k)
        col = scratch = None
        per_col = []
        cnt = np.zeros(n, np.int64)
        for c in range(C):
            ks = members[c]
            if len(ks) == 1 and (plan is None or not plan.feat_packed[ks[0]]):
                i = used[ks[0]]
                s, e = int(indptr[i]), int(indptr[i + 1])
                r = np.asarray(indices[s:e], np.int64)
                v = np.asarray(data[s:e], np.float64)
                if not canonical and r.size:
                    o = np.argsort(r, kind="stable")
                    r, v = r[o], v[o]
                    last = np.concatenate([r[1:] != r[:-1], [True]])
                    r, v = r[last], v[last]
                b = self.mappers[i].value_to_bin(v)
                keep = b != zb[c]
                r, b = r[keep], b[keep].astype(self._store_dtype)
            else:
                if scratch is None:
                    col = np.empty(n, np.float64)
                    scratch = np.zeros(n, self._store_dtype)
                scratch[:] = 0
                for k in ks:
                    i = used[k]
                    col[:] = 0.0
                    s, e = int(indptr[i]), int(indptr[i + 1])
                    col[indices[s:e]] = data[s:e]
                    self.bundle_conflict_rows += bin_feature_column(
                        k, col, self.mappers, used, plan, scratch)
                r = np.flatnonzero(scratch != zb[c]).astype(np.int64)
                b = scratch[r].copy()
            per_col.append((r, b))
            cnt[r] += 1
        nnz = int(cnt.sum())
        R = nnz_capacity_tier(int(cnt.max(initial=1)))
        ell_c = np.full((n, R), C, np.int32)
        ell_b = np.zeros((n, R), self._store_dtype)
        fill = np.zeros(n, np.int64)
        for c, (r, b) in enumerate(per_col):
            if r.size:
                pos = fill[r]
                ell_c[r, pos] = c
                ell_b[r, pos] = b
                fill[r] += 1
        self.sparse = SparseStore(cols=ell_c, bins=ell_b, zero_bin=zb,
                                  nnz=nnz)
        self._bins = None

    def _sparsify_store(self) -> None:
        """Convert the freshly binned dense store (bundle columns under a
        plan) to the CSR/ELL layout and drop the dense matrix; densify()
        reproduces it bitwise."""
        zb = store_zero_bins(self.mappers, self.used_features,
                             self.bundle_plan)
        dense = self._bins
        nz = dense != zb[:, None].astype(dense.dtype)
        nzr, nzc = np.nonzero(nz.T)          # row-major entry order
        self.sparse = _pack_ell(nzr, nzc, dense[nzc, nzr], dense.shape[1],
                                dense.shape[0], zb, self._store_dtype)
        self._bins = None

    def sparse_entries(self):
        """Host COO view of the sparse store: (rows int64, store columns
        int32, bins int32, zero_bin int32) over exactly the stored cells
        in row-major entry order; None for a dense dataset.  Rows past
        num_data are not read."""
        if self.sparse is None:
            return None
        sp = self.sparse
        n = self.num_data
        ri, sj = np.nonzero(sp.cols[:n] < sp.num_columns)
        return (ri.astype(np.int64), sp.cols[ri, sj].astype(np.int32),
                sp.bins[ri, sj].astype(np.int32),
                sp.zero_bin.astype(np.int32))

    def unbundled_sparse_entries(self):
        """COO entries of `unbundled_bins()` without densifying: (rows
        int64, original features int32, bins int32, per-feature default
        bins int32), rows in row-major order.  A stored bundle entry
        decodes to at most one nonzero of an original feature (the slot
        windows are disjoint, and an in-window slot never decodes to its
        member's default bin); entries outside every member's window (a
        conflict's remainder) decode to all-defaults and drop.  Singleton
        columns copy through."""
        ent = self.sparse_entries()
        if ent is None:
            raise ValueError("unbundled_sparse_entries needs a sparse store")
        ri, ci, bi, _ = ent
        zb_f = store_zero_bins(self.mappers, self.used_features)
        plan = self.bundle_plan
        if plan is None:
            return ri, ci, bi, zb_f
        order = np.argsort(ci, kind="stable")
        ri, ci, bi = ri[order], ci[order], bi[order]
        out_r, out_f, out_b = [], [], []
        for k in range(len(self.used_features)):
            c = int(plan.feat_col[k])
            lo = np.searchsorted(ci, c, side="left")
            hi = np.searchsorted(ci, c, side="right")
            if lo == hi:
                continue
            rk, bk = ri[lo:hi], bi[lo:hi]
            if plan.feat_packed[k]:
                s = bk - int(plan.feat_offset[k])
                m = (s >= 0) & (s < int(plan.feat_nslots[k]))
                rk, s = rk[m], s[m]
                bk = s + (s >= int(plan.feat_default[k]))
            out_r.append(rk)
            out_f.append(np.full(rk.size, k, np.int32))
            out_b.append(bk.astype(np.int32))
        if not out_r:
            z = np.zeros(0, np.int64)
            return z, z.astype(np.int32), z.astype(np.int32), zb_f
        rows = np.concatenate(out_r)
        order = np.argsort(rows, kind="stable")
        return (rows[order], np.concatenate(out_f)[order],
                np.concatenate(out_b)[order], zb_f)

    # -- store access --------------------------------------------------------

    @property
    def bins(self) -> np.ndarray:
        """[C, N] dense binned store; a sparse dataset materializes it on
        first access, counted in SPARSE_FALLBACKS."""
        return self.dense_bins()

    def dense_bins(self, site: str = "unlabeled") -> np.ndarray:
        """`bins` with the densifying consumer named in the count."""
        if self._bins is None and self.sparse is not None:
            from . import profiling
            SPARSE_FALLBACKS[site] = SPARSE_FALLBACKS.get(site, 0) + 1
            profiling.count(profiling.SPARSE_FALLBACKS)
            profiling.count(profiling.labeled(profiling.SPARSE_FALLBACKS,
                                              site=site))
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

    # -- streaming append path ---------------------------------------------
    #
    # A streaming dataset shares a reference dataset's FROZEN BinMappers
    # and BundlePlan (incoming chunks are never re-quantized: they bin
    # into the store layout the model's trees were rebinned to) and grows
    # its [C, capacity] host store along the power-of-two capacity ladder.
    # Rows past num_data hold bin 0.

    @property
    def row_capacity(self) -> int:
        """Allocated row slots of the store (num_data except for a
        streaming dataset, whose store grows in capacity tiers)."""
        if self._bins is None and self.sparse is not None:
            return int(self.num_data)
        return int(self._bins.shape[1])

    @classmethod
    def from_stream(cls, chunks, config: Optional[Config] = None,
                    reference: Optional["Dataset"] = None,
                    feature_names: Optional[List[str]] = None,
                    categorical_feature: Sequence[int] = (),
                    capacity: int = 0) -> "Dataset":
        """Out-of-core streamed construction (sharded/ingest.py): a
        sketch pass over the chunk stream derives the bin mappers, then
        each chunk bins straight into the capacity-tiered store; while
        the data fits the sample budget the mappers are bitwise the batch
        construction's.  `chunks` is a callable returning a fresh
        iterator of (X, y, w) tuples, a list of such tuples, or an
        (X, y[, w]) array tuple; `reference` skips the sketch pass and
        bins against its frozen mappers (the online window)."""
        from .sharded.ingest import dataset_from_stream
        return dataset_from_stream(
            chunks, config=config, reference=reference,
            feature_names=feature_names,
            categorical_feature=categorical_feature, capacity=capacity)

    @classmethod
    def streaming_from(cls, reference: "Dataset",
                       config: Optional[Config] = None,
                       capacity: int = STREAM_CAPACITY_BASE) -> "Dataset":
        """An empty appendable Dataset binning against `reference`'s
        frozen mappers and bundle plan; `capacity` seeds the tier."""
        cfg = config or reference.config
        ds = cls._empty_from_mappers(cfg, reference.mappers,
                                     list(reference.used_features),
                                     row_capacity_tier(capacity),
                                     reference.num_total_features,
                                     list(reference.feature_names),
                                     plan=reference.bundle_plan)
        ds._bins[:] = 0
        ds.num_data = 0
        return ds

    def _bin_rows_into(self, X: np.ndarray, row0: int) -> None:
        """Bin raw rows X into store rows [row0, row0 + len(X)) through
        quantize.bin_rows_into (the construction's own mapper
        application); realized bundle conflicts are counted."""
        self.bundle_conflict_rows += bin_rows_into(
            X, self.mappers, self.used_features, self.bundle_plan,
            self._bins, row0)

    def _reserve_rows(self, n: int) -> None:
        """Grow the store to the next capacity tier holding n rows."""
        cap = self.row_capacity
        if n <= cap:
            return
        new_cap = row_capacity_tier(n, base=max(cap, 1) * 2)
        grown = np.zeros((self._bins.shape[0], new_cap), self._bins.dtype)
        grown[:, :cap] = self._bins
        self._bins = grown

    def append_rows(self, X: np.ndarray, label=None, weight=None) -> int:
        """Bin a chunk of raw rows into the store (frozen mappers) and
        append its labels and weights; returns the new row count."""
        X = np.ascontiguousarray(np.asarray(X, np.float64))
        if X.ndim != 2 or X.shape[1] != self.num_total_features:
            raise ValueError(
                f"append_rows expects [rows, {self.num_total_features}] "
                f"features, got {X.shape}")
        n0, add = self.num_data, len(X)
        if add == 0:
            return n0
        self._reserve_rows(n0 + add)
        self._bin_rows_into(X, n0)
        md = self.metadata
        if label is not None:
            lab = np.asarray(label, np.float32).reshape(-1)
            if lab.size != add:
                raise ValueError("label length mismatch")
            if n0 and md.label.size != n0:
                raise ValueError(
                    "cannot append labeled rows to an unlabeled dataset")
            md.label = np.concatenate([md.label, lab]) if n0 else lab
        elif md.label.size:
            raise ValueError(
                "cannot append unlabeled rows to a labeled dataset")
        if weight is not None:
            w = np.asarray(weight, np.float32).reshape(-1)
            if w.size != add:
                raise ValueError("weight length mismatch")
            if md.weights is None:
                md.weights = (np.concatenate(
                    [np.ones(n0, np.float32), w]) if n0 else w)
            else:
                md.weights = np.concatenate([md.weights, w])
        elif md.weights is not None:
            md.weights = np.concatenate(
                [md.weights, np.ones(add, np.float32)])
        self.num_data = n0 + add
        return self.num_data

    def reset_rows(self) -> None:
        """Drop every row but keep the capacity tier (the online
        trainer's window between refreshes)."""
        self._bins[:] = 0
        self.num_data = 0
        self.bundle_conflict_rows = 0
        self.metadata = Metadata()

    def compacted(self) -> "Dataset":
        """A [C, num_data] copy of a streaming dataset (the capacity
        slack dropped), what the learners train on.  The metadata is
        shared (its arrays already have num_data rows)."""
        ds = Dataset._empty_from_mappers(
            self.config, self.mappers, list(self.used_features), 0,
            self.num_total_features, list(self.feature_names),
            plan=self.bundle_plan)
        ds.num_data = self.num_data
        # a copy: at num_data == capacity the slice is the whole array,
        # and reset_rows() would zero an alias in place
        ds._bins = self._bins[:, : self.num_data].copy()
        ds.bundle_conflict_rows = self.bundle_conflict_rows
        ds.metadata = self.metadata
        return ds

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

    # -- binary cache: a magic line + npz (allow_pickle=False on load: a
    #    data file is untrusted input and must never reach pickle).  The
    #    JAX package's format, so each package reads the other's files.

    BINARY_MAGIC = "lightgbm_tpu.dataset.v3"

    @classmethod
    def _empty_from_mappers(cls, cfg: Config, mappers: List[BinMapper],
                            used: List[int], n: int, num_total: int,
                            feature_names: Optional[List[str]],
                            plan: Optional[BundlePlan] = None
                            ) -> "Dataset":
        """A Dataset shell (store + per-feature metadata) from existing
        bin mappers; callers fill the store and the metadata."""
        ds = cls.__new__(cls)
        ds._init_store(cfg, mappers, list(used), n, num_total,
                       feature_names, plan)
        ds.metadata = Metadata()
        return ds

    def save_binary(self, path: str) -> None:
        """Serialize the binned dataset (the dense store, its mappers,
        bundle plan and metadata) so a reload skips parsing and
        binning."""
        md = self.metadata
        arrays = {
            "bins": self.dense_bins(site="binary_cache"),
            "num_data": np.int64(self.num_data),
            "num_total_features": np.int64(self.num_total_features),
            "used_features": np.asarray(self.used_features, np.int64),
            "feature_names": np.asarray(self.feature_names, dtype="U"),
            "label": md.label,
            "max_bin": np.int64(self.config.max_bin),
            "enable_bundle": np.int64(1 if self.config.enable_bundle else 0),
            "bundle_conflict_rows": np.int64(self.bundle_conflict_rows),
        }
        if self.bundle_plan is not None:
            p = self.bundle_plan
            arrays["bundle_feat"] = np.stack([
                p.feat_col, p.feat_offset, p.feat_default, p.feat_nslots,
                p.feat_packed.astype(np.int32)]).astype(np.int64)
            arrays["bundle_col_bins"] = p.col_num_bins.astype(np.int64)
        for opt, name in ((md.weights, "weights"),
                          (md.query_boundaries, "query_boundaries"),
                          (md.init_score, "init_score")):
            if opt is not None:
                arrays[name] = opt
        for i, m in enumerate(self.mappers):
            arrays[f"m{i}_meta"] = np.asarray(
                [m.bin_type, m.num_bin, 1 if m.is_trivial else 0,
                 m.default_bin], np.int64)
            arrays[f"m{i}_fl"] = np.asarray(
                [m.min_val, m.max_val, m.sparse_rate], np.float64)
            arrays[f"m{i}_upper"] = np.asarray(m.bin_upper_bound, np.float64)
            arrays[f"m{i}_cats"] = np.asarray(m.bin_2_categorical, np.int64)
        with open(path, "wb") as f:
            f.write(self.BINARY_MAGIC.encode() + b"\n")
            np.savez_compressed(f, **arrays)

    def save_refbin(self, path: str) -> None:
        """Persist ONLY the frozen mapper set (+ bundle plan + used
        features) as a 0-row binary-dataset shell: the ``.refbin``
        sidecar that ``serve_quantize=binned`` serves a model against.
        Loads back through `quantize.load_refbin` / `from_binary`."""
        shell = Dataset._empty_from_mappers(
            self.config, self.mappers, list(self.used_features), 0,
            self.num_total_features, list(self.feature_names),
            plan=self.bundle_plan)
        shell.save_binary(path)

    @classmethod
    def from_binary(cls, path: str, config: Optional[Config] = None
                    ) -> "Dataset":
        cfg = config or Config()
        with open(path, "rb") as f:
            first = f.readline()
            if first.strip().decode(errors="replace") != cls.BINARY_MAGIC:
                raise ValueError(
                    f"{path} is not a lightgbm_tpu binary dataset")
            npz = np.load(f, allow_pickle=False)
            d = {k: npz[k] for k in npz.files}  # materialize before close
        return cls._from_binary_dict(d, cfg, path)

    @classmethod
    def _from_binary_dict(cls, d: Dict[str, np.ndarray], cfg: Config,
                          path: str) -> "Dataset":
        """Rebuild a Dataset from the parsed npz payload (`path` is for
        error messages only), so `quantize.load_refbin` can hash and
        parse a sidecar's bytes once."""
        if int(d["max_bin"]) != cfg.max_bin:
            raise ValueError(
                f"binary dataset {path} was built with max_bin="
                f"{int(d['max_bin'])}, config wants {cfg.max_bin}; "
                "delete the cache to rebuild")
        cached_eb = bool(int(d.get("enable_bundle", 0)))
        if cached_eb != bool(cfg.enable_bundle):
            raise ValueError(
                f"binary dataset {path} was built with enable_bundle="
                f"{cached_eb}, config wants {cfg.enable_bundle}; "
                "delete the cache to rebuild")
        num_total = int(d["num_total_features"])
        mappers = []
        for i in range(num_total):
            meta = d[f"m{i}_meta"]
            fl = d[f"m{i}_fl"]
            mappers.append(BinMapper(
                bin_type=int(meta[0]), num_bin=int(meta[1]),
                is_trivial=bool(meta[2]), default_bin=int(meta[3]),
                min_val=float(fl[0]), max_val=float(fl[1]),
                sparse_rate=float(fl[2]),
                bin_upper_bound=d[f"m{i}_upper"],
                bin_2_categorical=[int(c) for c in d[f"m{i}_cats"]]))
        plan = None
        if "bundle_feat" in d:
            bf = d["bundle_feat"]
            plan = BundlePlan(
                feat_col=bf[0].astype(np.int32),
                feat_offset=bf[1].astype(np.int32),
                feat_default=bf[2].astype(np.int32),
                feat_nslots=bf[3].astype(np.int32),
                feat_packed=bf[4] > 0,
                col_num_bins=d["bundle_col_bins"].astype(np.int32))
        ds = cls._empty_from_mappers(
            cfg, mappers, [int(i) for i in d["used_features"]],
            int(d["num_data"]), num_total,
            [str(s) for s in d["feature_names"]], plan)
        ds._bins = d["bins"].astype(ds._store_dtype, copy=False)
        ds.bundle_conflict_rows = int(d.get("bundle_conflict_rows", 0))
        ds.metadata = Metadata(
            label=d["label"],
            weights=d["weights"] if "weights" in d else None,
            query_boundaries=(d["query_boundaries"]
                              if "query_boundaries" in d else None),
            init_score=d["init_score"] if "init_score" in d else None)
        # the cache holds the dense layout; re-derive the sparse store
        # when the config resolves csr, so a cache hit trains the path a
        # fresh construction would (0-row refbin shells stay dense)
        if ds.num_data and resolve_sparse_store(cfg, ds.mappers,
                                                ds.used_features, plan):
            ds._sparsify_store()
        return ds

    # -- data files (the reference's dataset_loader.cpp) -------------------

    @staticmethod
    def _is_binary_file(path: str) -> bool:
        try:
            with open(path, "rb") as f:
                head = f.read(len(Dataset.BINARY_MAGIC) + 1)
            return head.startswith(Dataset.BINARY_MAGIC.encode())
        except OSError:
            return False

    @staticmethod
    def from_file(path: str, config: Optional[Config] = None,
                  reference: Optional["Dataset"] = None) -> "Dataset":
        """A Dataset from a data file: a binary dataset (the file itself,
        or a `<path>.bin` cache at least as new as the file), else the
        text file, one-shot or, under `use_two_round_loading`, in two
        streaming passes.  Side files and the in-file column selectors
        (`label_column`, `weight_column`, `group_column`,
        `ignore_column`, `categorical_column`) apply as in the JAX
        package.  `source` names the file the rows came from."""
        cfg = config or Config()
        if cfg.enable_load_from_binary_file:
            bin_path = None
            if Dataset._is_binary_file(path):
                bin_path = path
            elif (Dataset._is_binary_file(path + ".bin")
                  and os.path.getmtime(path + ".bin")
                  >= os.path.getmtime(path)):
                bin_path = path + ".bin"
            if bin_path is not None:
                if cfg.verbose >= 1:
                    log.info(f"loading binary dataset cache {bin_path}")
                ds = Dataset.from_binary(bin_path, cfg)
                # valid-set alignment (the reference's CheckAlign): the
                # cache must hold the training set's bins
                if reference is not None and (
                        ds.num_total_features
                        != reference.num_total_features
                        or any(a.num_bin != b.num_bin for a, b in
                               zip(ds.mappers, reference.mappers))):
                    raise ValueError(
                        f"binary validation data {bin_path} was binned "
                        "differently from the training data")
                ds.source = bin_path
                return ds
        if cfg.use_two_round_loading:
            ds = load_file_two_round(path, cfg, reference)
            ds.source = path
            return ds
        X, y, md, x_names, cats = read_text_file(path, cfg)
        from .distributed import world
        if cfg.is_pre_partition and world()[1] > 1:
            ds = _load_rank_rows(X, y, md, x_names, cats, cfg, reference)
        else:
            ds = Dataset(X, y, cfg, reference=reference, metadata=md,
                         feature_names=x_names, categorical_feature=cats)
        ds.source = path
        return ds


def _load_rank_rows(X: np.ndarray, y: np.ndarray, md: Metadata,
                    x_names: Optional[List[str]], cats: List[int],
                    cfg: Config, reference: Optional[Dataset]) -> Dataset:
    """This rank's rows of a parsed file in a pre-partitioned world (the
    reference's dataset_loader.cpp:554-659 row assignment and :733-833
    distributed bin finding, as the JAX loader does it): the rank keeps
    its contiguous block (`local_row_slice`), binned with mappers and a
    bundle plan every rank derives identically from every rank's sample
    (`bin_construct_sample_cnt // world + 1` rows of its block, drawn and
    sorted with RandomState(data_random_seed)).  A valid set
    (`reference`) keeps its block too, binned with the training set's
    mappers and plan.  Labels, weights and each class's init scores are
    cut to the block; query data is refused (a query would straddle two
    blocks)."""
    from .distributed import (find_bin_mappers_distributed,
                              local_row_slice, world)
    if md.query_boundaries is not None:
        raise NotImplementedError(
            "pre_partition with query data is not supported yet (queries "
            "would straddle row blocks)")
    sl = local_row_slice(len(y))
    n_local = sl.stop - sl.start
    if reference is not None:
        if X.shape[1] != reference.num_total_features:
            raise ValueError("validation data has different #features")
        mappers, plan = reference.mappers, reference.bundle_plan
    else:
        rng = np.random.RandomState(cfg.data_random_seed)
        take = min(cfg.bin_construct_sample_cnt // world()[1] + 1,
                   max(n_local, 1))
        samp = (np.sort(rng.choice(n_local, take, replace=False))
                if n_local > 0 else np.zeros(0, np.int64))
        # the bundle plan from the gathered sample: the same on every
        # rank, so the ranks' stores stay column-aligned
        mappers, gsample = find_bin_mappers_distributed(
            X[sl][samp], cfg, categorical=cats, return_sample=True)
        used0 = [i for i, m in enumerate(mappers) if not m.is_trivial]
        plan = _plan_bundles_from_sample(gsample, mappers, used0, cfg)
        _log_bundle_state(plan, len(used0), cfg)
    used = [i for i, m in enumerate(mappers) if not m.is_trivial]
    ds = Dataset._empty_from_mappers(cfg, mappers, used, n_local,
                                     X.shape[1], x_names, plan=plan)
    ds._bin_rows_into(X[sl], 0)
    ds._check_realized_conflicts()
    init_local = None
    if md.init_score is not None:
        # [K * N] class-major: each class's scores cut to the block
        n_all = len(y)
        if md.init_score.size % n_all:
            raise ValueError("init score size mismatch")
        k = md.init_score.size // n_all
        init_local = md.init_score.reshape(k, n_all)[:, sl].reshape(-1)
    ds.metadata = Metadata(
        label=np.asarray(y[sl], np.float32),
        weights=None if md.weights is None else md.weights[sl],
        init_score=init_local)
    ds.rank_rows = sl
    return ds


def read_text_file(path: str, cfg: Config):
    """(X, y, metadata, feature names or None, categorical columns) of a
    text data file as `Dataset.from_file` reads it: the side files, and
    the in-file column selectors applied (weight and group columns go to
    the metadata; they and the ignored columns leave X).  Columns are
    counted in the file, label included; `name:` selectors need a
    header."""
    label_idx = _label_index(cfg)
    X, y, names = parse_text_file(path, cfg.has_header, label_idx)
    md = Metadata.load_side_files(path, len(y))
    xw, xg, drop = _resolve_column_selectors(cfg, names, label_idx,
                                             X.shape[1])
    if xw is not None:
        if md.weights is not None:
            log.warning("weight_column overrides the .weight side file")
        md.weights = X[:, xw].astype(np.float32)
    if xg is not None:
        if md.query_boundaries is not None:
            log.warning("group_column overrides the .query side file")
        md.query_boundaries = _query_boundaries_from_ids(X[:, xg])
    x_names = None
    if names:
        if len(names) == X.shape[1] + 1:
            x_names = [nm for c, nm in enumerate(names) if c != label_idx]
        elif len(names) == X.shape[1]:
            x_names = list(names)
    if drop:
        keep = [c for c in range(X.shape[1]) if c not in set(drop)]
        X = X[:, keep]
        if x_names is not None:
            x_names = [x_names[c] for c in keep]
    cats = _parse_categorical_column(cfg.categorical_column, x_names,
                                     X.shape[1])
    return X, y, md, x_names, cats


def _label_index(cfg: Config) -> int:
    """The file column of the label (`label_column`, 0 by default); a
    `name:` label is not supported, as in the JAX package."""
    if cfg.label_column.startswith("name:"):
        raise NotImplementedError("label by name requires header support")
    return int(cfg.label_column) if cfg.label_column else 0


def _parse_categorical_column(spec: str, feature_names: Optional[List[str]],
                              num_features: int) -> List[int]:
    """The `categorical_column` selector: an index list, or `name:`
    followed by header names."""
    if not spec:
        return []
    out: List[int] = []
    if spec.startswith("name:"):
        if not feature_names:
            raise ValueError("categorical_column=name: requires a header")
        for w in spec[5:].split(","):
            out.append(feature_names.index(w.strip()))
    else:
        for tok in spec.replace(",", " ").split():
            out.append(int(tok))
    return [i for i in out if 0 <= i < num_features]


def _resolve_column_selectors(cfg: Config, names: Optional[List[str]],
                              label_idx: int, n_xcols: int
                              ) -> Tuple[Optional[int], Optional[int],
                                         List[int]]:
    """`weight_column` / `group_column` / `ignore_column` as X-space
    column indices (file columns with the label removed): (weight column,
    group column, columns to drop, the first two among them).  Indices
    count the file's columns; `name:` selectors need a header."""

    def _resolve(spec: str, what: str) -> Optional[int]:
        spec = spec.strip()
        if not spec:
            return None
        if spec.startswith("name:"):
            if not names:
                raise ValueError(
                    f"{what}={spec} needs has_header=true with a header")
            nm = spec[5:].strip()
            if nm not in names:
                raise ValueError(f"{what}: no column named {nm!r}")
            return names.index(nm)
        return int(spec)

    def _xcol(c: int, what: str) -> int:
        if c == label_idx:
            raise ValueError(f"{what} column {c} is the label column")
        if not 0 <= c <= n_xcols:
            raise ValueError(f"{what} column {c} out of range")
        return c - 1 if c > label_idx else c

    drop: List[int] = []
    xw = xg = None
    wi = _resolve(cfg.weight_column, "weight_column")
    if wi is not None:
        xw = _xcol(wi, "weight_column")
        drop.append(xw)
    gi = _resolve(cfg.group_column, "group_column")
    if gi is not None:
        xg = _xcol(gi, "group_column")
        drop.append(xg)
    ign = cfg.ignore_column.strip()
    if ign.startswith("name:"):
        # `name:` prefixes the whole comma-separated list
        for nm in ign[5:].split(","):
            ci = _resolve(f"name:{nm.strip()}", "ignore_column")
            if ci is not None:
                drop.append(_xcol(ci, "ignore_column"))
    elif ign:
        for tok in ign.replace(",", " ").split():
            drop.append(_xcol(int(tok), "ignore_column"))
    return xw, xg, drop


def _query_boundaries_from_ids(qid: np.ndarray) -> np.ndarray:
    """Per-row query ids -> query boundaries; a query's rows must be
    contiguous."""
    change = np.nonzero(qid[1:] != qid[:-1])[0] + 1
    starts = np.concatenate([[0], change])
    if len(np.unique(qid)) != len(starts):
        raise ValueError("group_column: rows of the same query must be "
                         "contiguous in the data file")
    return np.concatenate([starts, [len(qid)]]).astype(np.int32)


def load_file_two_round(path: str, cfg: Config,
                        reference: Optional[Dataset] = None,
                        chunk_rows: int = 0) -> Dataset:
    """Two streaming passes over a CSV/TSV file (the reference's
    two-round loading): the first reservoir-samples
    `bin_construct_sample_cnt` rows for the bin mappers and keeps the
    label and selector columns, the second bins each chunk straight into
    the store, so the float64 matrix never exists.  Chunks are
    `stream_chunk_rows` rows, the JAX package's `pd.read_csv` chunks, so
    the sample (one `rand` and one `randint` draw a chunk) and with it
    the mappers are the JAX package's; the values are the one-shot
    parse's, correctly rounded.  LibSVM files take the one-shot path."""
    chunk_rows = chunk_rows or int(cfg.stream_chunk_rows)
    label_idx = _label_index(cfg)
    fmt, names = probe_text_file(path, cfg.has_header)
    if fmt == "libsvm":
        raise ValueError("use_two_round_loading supports csv/tsv only")

    def chunks():
        return iter_text_chunks(path, fmt, cfg.has_header, chunk_rows)

    # pass 1: count rows, reservoir-sample, keep the label and selectors
    S = int(cfg.bin_construct_sample_cnt)
    rng = np.random.RandomState(cfg.data_random_seed)
    sample: Optional[np.ndarray] = None
    filled = 0
    labels: List[np.ndarray] = []
    wvals: List[np.ndarray] = []
    gvals: List[np.ndarray] = []
    sel = None                      # (weight, group, kept, file columns)
    n_seen = 0
    for arr in chunks():
        labels.append(arr[:, label_idx].copy())
        if sel is None:
            n_x = arr.shape[1] - 1
            xw, xg, drop = _resolve_column_selectors(cfg, names, label_idx,
                                                     n_x)

            def _fcol(c):           # X-space -> file column
                return c + 1 if c >= label_idx else c
            dropped = set(drop)
            use_cols = [_fcol(c) for c in range(n_x) if c not in dropped]
            keep = ([c for c in range(n_x) if c not in dropped]
                    if drop else None)
            sel = (None if xw is None else _fcol(xw),
                   None if xg is None else _fcol(xg), keep, use_cols)
        wcol, gcol, keep, use_cols = sel
        if wcol is not None:
            wvals.append(arr[:, wcol].copy())
        if gcol is not None:
            gvals.append(arr[:, gcol].copy())
        X = arr[:, use_cols]
        if sample is None:
            sample = np.empty((S, X.shape[1]), np.float64)
        take = min(S - filled, len(X))          # fill
        if take > 0:
            sample[filled:filled + take] = X[:take]
            filled += take
        rest = X[take:]                         # replace
        if len(rest):
            gidx = np.arange(n_seen + take, n_seen + take + len(rest))
            accept = rng.rand(len(rest)) < S / (gidx + 1.0)
            if accept.any():
                slots = rng.randint(0, S, size=int(accept.sum()))
                sample[slots] = rest[accept]
        n_seen += len(X)
    if sel is None or n_seen == 0:
        raise ValueError(f"empty data file: {path}")
    y = np.concatenate(labels)
    n = len(y)
    sample = sample[:filled]
    md = Metadata.load_side_files(path, n)
    md.label = np.asarray(y, np.float32)
    wcol, gcol, keep, use_cols = sel
    if wcol is not None:
        if md.weights is not None:
            log.warning("weight_column overrides the .weight side file")
        md.weights = np.concatenate(wvals).astype(np.float32)
    if gcol is not None:
        if md.query_boundaries is not None:
            log.warning("group_column overrides the .query side file")
        md.query_boundaries = _query_boundaries_from_ids(
            np.concatenate(gvals))
    x_names = None
    if names:
        x_names = [nm for c, nm in enumerate(names) if c != label_idx]
        if keep is not None:
            x_names = [x_names[c] for c in keep]

    cats = _parse_categorical_column(cfg.categorical_column, x_names,
                                     sample.shape[1])
    if reference is not None:
        if sample.shape[1] != reference.num_total_features:
            raise ValueError("validation data has different #features")
        mappers, used = reference.mappers, reference.used_features
        plan = reference.bundle_plan
    else:
        mappers = find_bin_mappers(
            sample, cfg.max_bin, cfg.min_data_in_bin, cfg.min_data_in_leaf,
            categorical=cats, sample_cnt=len(sample),
            seed=cfg.data_random_seed, bin_budget=cfg.bin_budget)
        used = [i for i, m in enumerate(mappers) if not m.is_trivial]
        plan = _plan_bundles_from_sample(sample, mappers, used, cfg)
        _log_bundle_state(plan, len(used), cfg)

    # pass 2: bin straight into the store
    ds = Dataset._empty_from_mappers(cfg, mappers, used, n, sample.shape[1],
                                     x_names, plan=plan)
    row = 0
    for arr in chunks():
        ds._bin_rows_into(arr[:, use_cols], row)
        row += len(arr)
    ds._check_realized_conflicts()
    ds.metadata = md
    return ds
