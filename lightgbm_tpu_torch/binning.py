"""Host-side feature binning (BinMapper).

Behavioral parity with the reference's BinMapper::FindBin
(LightGBM's src/io/bin.cpp:67-240):

- numerical features: distinct-value bins when few distinct values, else
  greedy count-balanced boundaries with "big count" values pinned to their
  own bin; zero is injected as a distinct value with the implied zero count;
  `min_data_in_bin` merging; last upper bound is +inf.
- categorical features: categories sorted by frequency, kept until covering
  98% of samples (and at least max_bin categories when available).
- trivial-feature filtering (NeedFilter, bin.cpp:47-65).

The output is a plain-python BinMapper per feature; the device-side Dataset
packs `value -> bin` results into a [num_features, num_rows] integer array
(see dataset.py).  This replaces the reference's Bin/DenseBin/SparseBin
class zoo: on TPU everything is one dense HBM-resident array.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NUMERICAL = 0
CATEGORICAL = 1


@dataclass
class BinMapper:
    bin_type: int = NUMERICAL
    num_bin: int = 1
    is_trivial: bool = True
    # numerical
    bin_upper_bound: np.ndarray = field(default_factory=lambda: np.array([np.inf]))
    # categorical: bin i holds category bin_2_categorical[i] (the inverse
    # map is the sorted lookup table value_to_bin builds lazily)
    bin_2_categorical: List[int] = field(default_factory=list)
    min_val: float = 0.0
    max_val: float = 0.0
    default_bin: int = 0
    sparse_rate: float = 0.0

    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin (reference bin.h:418-440).  NaN maps to
        value 0 (v2.0-era missing handling; searchsorted would otherwise
        return an out-of-range bin).  Unseen categories map to bin 0."""
        values = np.asarray(values, dtype=np.float64)
        values = np.where(np.isnan(values), 0.0, values)
        if self.bin_type == NUMERICAL:
            return np.searchsorted(self.bin_upper_bound, values, side="left").astype(
                np.int32)
        # categorical: one searchsorted over the sorted category table
        # instead of a Python loop per category (Expo-scale data has
        # hundreds of categories x millions of rows)
        cs = getattr(self, "_cat_sorted", None)
        # rebuild when the category list changed since the table was
        # built; the snapshot tuple compares by VALUE, so in-place
        # element mutation is caught too (not just replacement/append)
        snap = tuple(self.bin_2_categorical)
        if cs is None or cs[2] != snap:
            cats = np.asarray(self.bin_2_categorical, np.int64)
            order = np.argsort(cats)
            cs = (cats[order], np.arange(len(cats), dtype=np.int32)[order],
                  snap)
            self._cat_sorted = cs
        cats_sorted, bins_sorted = cs[0], cs[1]
        iv = values.astype(np.int64)
        pos = np.clip(np.searchsorted(cats_sorted, iv), 0,
                      max(len(cats_sorted) - 1, 0))
        if len(cats_sorted) == 0:
            return np.zeros(values.shape, np.int32)
        return np.where(cats_sorted[pos] == iv, bins_sorted[pos],
                        np.int32(0)).astype(np.int32)

    def bin_to_value(self, b: int) -> float:
        """Real-valued threshold stored in the model text for bin `b`."""
        if self.bin_type == NUMERICAL:
            return float(self.bin_upper_bound[min(b, self.num_bin - 1)])
        return float(self.bin_2_categorical[min(b, len(self.bin_2_categorical) - 1)])

    def feature_info(self) -> str:
        """`feature_infos` model-header entry (gbdt.cpp:715: [min:max] or cat list)."""
        if self.is_trivial:
            return "none"
        if self.bin_type == NUMERICAL:
            return f"[{self.min_val:g}:{self.max_val:g}]"
        return ":".join(str(c) for c in self.bin_2_categorical)


def _distinct_with_zero(sample_values: np.ndarray, total_sample_cnt: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Distinct values + counts with zero injected at the right rank.

    `sample_values` are the NON-ZERO sampled values; zeros are implied
    (reference bin.cpp:70-103 treats zero_cnt = total - num_sampled).
    """
    sample_values = np.asarray(sample_values, dtype=np.float64)
    sample_values = sample_values[~np.isnan(sample_values)]
    zero_cnt = int(total_sample_cnt - sample_values.size)
    if sample_values.size == 0:
        return np.array([0.0]), np.array([max(zero_cnt, 1)], dtype=np.int64)
    vals, counts = np.unique(sample_values, return_counts=True)
    if zero_cnt > 0 and not np.any(vals == 0.0):
        pos = int(np.searchsorted(vals, 0.0))
        vals = np.insert(vals, pos, 0.0)
        counts = np.insert(counts, pos, zero_cnt)
    elif zero_cnt > 0:
        counts[vals == 0.0] += zero_cnt
    return vals, counts.astype(np.int64)


def _numerical_bins(vals: np.ndarray, counts: np.ndarray, total_sample_cnt: int,
                    max_bin: int, min_data_in_bin: int) -> Tuple[np.ndarray, List[int]]:
    """Greedy count-balanced boundaries (reference bin.cpp:109-186)."""
    n_distinct = vals.size
    cnt_in_bin: List[int] = []
    if n_distinct <= max_bin:
        ub: List[float] = []
        cur = 0
        for i in range(n_distinct - 1):
            cur += int(counts[i])
            if cur >= min_data_in_bin:
                ub.append((vals[i] + vals[i + 1]) / 2.0)
                cnt_in_bin.append(cur)
                cur = 0
        cur += int(counts[-1])
        cnt_in_bin.append(cur)
        ub.append(np.inf)
        return np.array(ub), cnt_in_bin

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_sample_cnt // min_data_in_bin))
    mean_bin_size = total_sample_cnt / max_bin
    zero_idx = np.flatnonzero(vals == 0.0)
    zero_cnt = int(counts[zero_idx[0]]) if zero_idx.size else 0
    if zero_cnt > mean_bin_size:
        non_zero_cnt = total_sample_cnt - zero_cnt
        max_bin = min(max_bin, 1 + non_zero_cnt // max(min_data_in_bin, 1))
    max_bin = max(int(max_bin), 1)

    is_big = counts >= mean_bin_size
    rest_bin_cnt = max_bin - int(is_big.sum())
    rest_sample_cnt = total_sample_cnt - int(counts[is_big].sum())
    if rest_bin_cnt > 0:
        mean_bin_size = rest_sample_cnt / rest_bin_cnt

    if not is_big.any():
        # Fast path for the dominant continuous-data case (no value holds
        # >= a mean bin's worth of samples): the greedy scan reduces to
        # "emit a boundary where the count cumsum crosses the adaptive
        # threshold", which is one searchsorted per EMITTED BIN (<= 255)
        # instead of one Python iteration per DISTINCT VALUE (up to the
        # full sample count).  Emission-for-emission identical to the
        # general loop below: cur >= mean_bin_size with
        # mean = remaining_samples / remaining_bins recomputed per bin.
        # float64 cumsum: exact for any realistic count (< 2^53) and avoids
        # an int->float array promotion copy inside every searchsorted
        cumsum = np.cumsum(counts[: n_distinct - 1]).astype(np.float64)
        n_scan = cumsum.size
        upper_i: List[int] = []
        cum_prev = 0
        rest_bins = max_bin
        while len(upper_i) < max_bin - 1 and rest_bins > 0:
            mean = (total_sample_cnt - cum_prev) / rest_bins
            i = int(cumsum.searchsorted(cum_prev + mean, side="left"))
            if i >= n_scan:
                break
            upper_i.append(i)
            cnt_in_bin.append(int(cumsum[i]) - cum_prev)
            cum_prev = int(cumsum[i])
            rest_bins -= 1
        cnt_in_bin.append(total_sample_cnt - cum_prev)
        nb = len(upper_i) + 1
        ub = np.empty(nb)
        for k in range(nb - 1):
            ub[k] = (vals[upper_i[k]] + vals[upper_i[k] + 1]) / 2.0
        ub[nb - 1] = np.inf
        return ub, cnt_in_bin

    upper: List[float] = []
    lower: List[float] = [float(vals[0])]
    cur = 0
    bin_cnt = 0
    for i in range(n_distinct - 1):
        if not is_big[i]:
            rest_sample_cnt -= int(counts[i])
        cur += int(counts[i])
        if (is_big[i] or cur >= mean_bin_size or
                (is_big[i + 1] and cur >= max(1.0, mean_bin_size * 0.5))):
            upper.append(float(vals[i]))
            cnt_in_bin.append(cur)
            bin_cnt += 1
            lower.append(float(vals[i + 1]))
            if bin_cnt >= max_bin - 1:
                break
            cur = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                if rest_bin_cnt > 0:
                    mean_bin_size = rest_sample_cnt / rest_bin_cnt
    # remaining samples go to the last bin
    consumed = sum(cnt_in_bin)
    cnt_in_bin.append(int(total_sample_cnt - consumed))
    bin_cnt += 1
    ub = np.empty(bin_cnt)
    for i in range(bin_cnt - 1):
        ub[i] = (upper[i] + lower[i + 1]) / 2.0
    ub[bin_cnt - 1] = np.inf
    return ub, cnt_in_bin


def _need_filter(cnt_in_bin: Sequence[int], total_cnt: int, filter_cnt: int,
                 bin_type: int) -> bool:
    """A feature is trivial if no split leaves >= filter_cnt on both sides
    (reference bin.cpp:47-65)."""
    if bin_type == NUMERICAL:
        sum_left = 0
        for c in cnt_in_bin[:-1]:
            sum_left += c
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
    else:
        for c in cnt_in_bin[:-1]:
            if c >= filter_cnt and total_cnt - c >= filter_cnt:
                return False
    return True


def find_bin(sample_values: np.ndarray, total_sample_cnt: int, max_bin: int,
             min_data_in_bin: int = 3, min_split_data: int = 20,
             bin_type: int = NUMERICAL) -> BinMapper:
    """Construct a BinMapper from sampled (non-zero) values of one feature.

    Mirrors reference BinMapper::FindBin (bin.cpp:67-240).
    """
    vals, counts = _distinct_with_zero(sample_values, total_sample_cnt)
    return find_bin_from_distinct(vals, counts, total_sample_cnt, max_bin,
                                  min_data_in_bin, min_split_data, bin_type)


def find_bin_from_distinct(vals: np.ndarray, counts: np.ndarray,
                           total_sample_cnt: int, max_bin: int,
                           min_data_in_bin: int = 3, min_split_data: int = 20,
                           bin_type: int = NUMERICAL) -> BinMapper:
    """BinMapper from an already-built distinct-value summary (sorted
    `vals` with per-value `counts`, zero already injected).  The body of
    `find_bin`, exposed so the mergeable quantile sketches
    (sharded/sketch.py) can reuse the exact same greedy boundary logic
    on their weighted summaries — a sketch that still holds every
    distinct value yields the bitwise-identical mapper."""
    m = BinMapper(bin_type=bin_type)
    counts = np.asarray(counts, np.int64)
    m.min_val, m.max_val = float(vals[0]), float(vals[-1])

    if bin_type == NUMERICAL:
        ub, cnt_in_bin = _numerical_bins(vals, counts, total_sample_cnt, max_bin,
                                         min_data_in_bin)
        m.bin_upper_bound = ub
        m.num_bin = int(ub.size)
    else:
        ivals = vals.astype(np.int64)
        # merge duplicates after int cast
        ivals_u, inv = np.unique(ivals, return_inverse=True)
        icounts = np.zeros(ivals_u.size, dtype=np.int64)
        np.add.at(icounts, inv, counts)
        order = np.argsort(-icounts, kind="stable")
        ivals_u, icounts = ivals_u[order], icounts[order]
        cut_cnt = int(total_sample_cnt * 0.98)
        eff_max_bin = min(ivals_u.size, max_bin)
        used_cnt = 0
        nb = 0
        while (used_cnt < cut_cnt or nb < eff_max_bin) and nb < ivals_u.size:
            m.bin_2_categorical.append(int(ivals_u[nb]))
            used_cnt += int(icounts[nb])
            nb += 1
        m.num_bin = nb
        cnt_in_bin = [int(c) for c in icounts[:nb]]
        cnt_in_bin[-1] += int(total_sample_cnt - used_cnt)

    m.is_trivial = m.num_bin <= 1
    if not m.is_trivial and _need_filter(cnt_in_bin, total_sample_cnt,
                                         min_split_data, bin_type):
        m.is_trivial = True
    if not m.is_trivial:
        m.default_bin = int(m.value_to_bin(np.array([0.0]))[0])
        idx = min(m.default_bin, len(cnt_in_bin) - 1)
        m.sparse_rate = cnt_in_bin[idx] / total_sample_cnt
    return m


# ----------------------------------------------------------------------------
# Exclusive Feature Bundling (EFB)
#
# The reference packs mutually-exclusive sparse features into shared
# FeatureGroups (src/io/dataset.cpp FindGroups/FastFeatureBundling); the
# sparse-GPU boosting literature (arXiv:1706.08359, arXiv:1806.11248) shows
# compacting exclusive columns is where dense-histogram accelerators win.
# Here a bundle is ONE stored column: bin 0 means "every member at its
# default bin", and member f's non-default bins occupy the slot range
# [offset_f, offset_f + num_bin_f - 1).  Slot packing removes the default
# bin from the middle of the range but keeps the bin ORDER, so a numerical
# threshold maps to one contiguous slot interval (ops/split.py
# bundle_predicate_params) and histograms unbundle by gather + a
# total-minus-sum reconstruction of the default bin.
# ----------------------------------------------------------------------------

@dataclass
class BundlePlan:
    """Static description of how used features map onto stored columns.

    All per-feature arrays are indexed by the INNER (used-feature) index.
    """
    feat_col: np.ndarray      # [F] int32 stored column holding feature k
    feat_offset: np.ndarray   # [F] int32 first slot of k (0 if not packed)
    feat_default: np.ndarray  # [F] int32 default bin of k
    feat_nslots: np.ndarray   # [F] int32 non-default slot count (nb - 1)
    feat_packed: np.ndarray   # [F] bool  k shares its column
    col_num_bins: np.ndarray  # [C] int32 bins per stored column
    est_conflict_rate: float = 0.0   # sampled estimate used by the planner
    sample_rows: int = 0

    @property
    def num_columns(self) -> int:
        return int(self.col_num_bins.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.feat_col.shape[0])

    @property
    def num_packed(self) -> int:
        return int(self.feat_packed.sum())

    @property
    def num_bundles(self) -> int:
        """Multi-feature bundles (columns holding >= 2 features)."""
        return int(len(set(self.feat_col[self.feat_packed])))

    def feat_table(self) -> np.ndarray:
        """[5, F] float32 (col, offset, default, nslots, packed) — the
        device lookup table ops/split.bundle_predicate_params and the
        score-updater walk consume.  Exact in f32 (all values < 2^24)."""
        return np.stack([
            self.feat_col.astype(np.float32),
            self.feat_offset.astype(np.float32),
            self.feat_default.astype(np.float32),
            self.feat_nslots.astype(np.float32),
            self.feat_packed.astype(np.float32)])

    def unbundle_tables(self, num_bins: np.ndarray, B: int,
                        num_columns_padded: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Gather tables turning a bundled histogram [C, 3, B] into the
        original per-feature histogram [F, 3, B] (ops/split.unbundle_hist).

        Returns (src [F, B] int32 flat indices into the [C*B + 1] padded
        store histogram — index C*B is a zero sentinel — and dmask [F, B]
        bool marking each packed feature's default-bin slot, which is
        reconstructed as leaf_total - sum(other bins)).

        num_columns_padded: the column count of the histograms that will
        be unbundled, when the learner pads the store beyond
        `num_columns` (the rounds learner's int8 layout aligns columns
        to 32) — the zero sentinel must sit past the PADDED columns, or
        it would gather a padded column's bin-0 totals instead of zero."""
        F = self.num_features
        C = max(self.num_columns, int(num_columns_padded))
        sent = C * B
        src = np.full((F, B), sent, np.int32)
        dmask = np.zeros((F, B), bool)
        b = np.arange(B)
        for k in range(F):
            nb = int(num_bins[k])
            col = int(self.feat_col[k])
            if not self.feat_packed[k]:
                valid = b < nb
                src[k, valid] = col * B + b[valid]
                continue
            d = int(self.feat_default[k])
            off = int(self.feat_offset[k])
            valid = (b < nb) & (b != d)
            slot = b - (b > d)
            src[k, valid] = col * B + off + slot[valid]
            if d < nb:
                dmask[k, d] = True
        return src, dmask


def plan_bundles(sample_bins: np.ndarray, num_bins: np.ndarray,
                 default_bins: np.ndarray, max_conflict_rate: float,
                 max_bundle_bins: int = 256, max_probe: int = 128
                 ) -> Optional[BundlePlan]:
    """Greedy conflict-graph bundling over SAMPLED binned columns.

    sample_bins : [F, S] int original bin ids of up to S sampled rows
    num_bins / default_bins : [F] per-used-feature bin count / default bin

    Mirrors the reference's FindGroups greedy first-fit (dataset.cpp):
    features sorted by non-default count descending; a feature joins the
    first bundle whose accumulated conflict count stays within
    `max_conflict_rate * S` and whose bin budget (`max_bundle_bins`, the
    uint8-store / 256-lane kernel ceiling) is not exceeded.  Dense
    features (non-default fraction > 0.5) never enter the conflict graph
    — they become singleton columns immediately, which keeps planning
    O(sparse^2) instead of O(F^2) on dense data.

    Returns None when no bundle would hold >= 2 features (store unchanged).
    """
    F, S = sample_bins.shape
    if F == 0 or S == 0:
        return None
    nd = sample_bins != default_bins[:, None]           # [F, S] non-default
    nd_cnt = nd.sum(axis=1)
    budget = int(max_conflict_rate * S)
    cand = [k for k in range(F)
            if nd_cnt[k] <= 0.5 * S and 2 <= num_bins[k] <= max_bundle_bins]
    cand.sort(key=lambda k: -int(nd_cnt[k]))

    bundles: List[List[int]] = []       # member inner indices
    b_nd: List[np.ndarray] = []         # union non-default mask per bundle
    b_bins: List[int] = []              # 1 + sum(nb - 1)
    b_conf: List[int] = []              # accumulated conflict count
    for k in cand:
        extra = int(num_bins[k]) - 1
        placed = False
        for gi in range(min(len(bundles), max_probe)):
            if b_bins[gi] + extra > max_bundle_bins:
                continue
            c = int(np.count_nonzero(b_nd[gi] & nd[k]))
            if b_conf[gi] + c <= budget:
                bundles[gi].append(k)
                b_nd[gi] |= nd[k]
                b_bins[gi] += extra
                b_conf[gi] += c
                placed = True
                break
        if not placed:
            bundles.append([k])
            b_nd.append(nd[k].copy())
            b_bins.append(1 + extra)
            b_conf.append(0)

    if not any(len(m) > 1 for m in bundles):
        return None

    feat_col = np.zeros(F, np.int32)
    feat_offset = np.zeros(F, np.int32)
    feat_default = np.asarray(default_bins, np.int32).copy()
    feat_nslots = np.asarray(num_bins, np.int32) - 1
    feat_packed = np.zeros(F, bool)
    col_bins: List[int] = []
    in_bundle = set()
    for members, nb_total in zip(bundles, b_bins):
        if len(members) < 2:
            continue
        col = len(col_bins)
        off = 1
        for k in members:
            in_bundle.add(k)
            feat_col[k] = col
            feat_offset[k] = off
            feat_packed[k] = True
            off += int(num_bins[k]) - 1
        col_bins.append(nb_total)
    for k in range(F):
        if k not in in_bundle:
            feat_col[k] = len(col_bins)
            col_bins.append(int(num_bins[k]))
    return BundlePlan(
        feat_col=feat_col, feat_offset=feat_offset,
        feat_default=feat_default, feat_nslots=feat_nslots,
        feat_packed=feat_packed,
        col_num_bins=np.asarray(col_bins, np.int32),
        est_conflict_rate=float(sum(b_conf)) / max(S, 1),
        sample_rows=S)


def pack_bundle_column(b: np.ndarray, default_bin: int, offset: int,
                       out: np.ndarray) -> int:
    """Fold one member feature's original bins `b` into the bundle column
    `out` (in place, last writer wins on conflicts).  Returns the number
    of conflicting rows observed (slots already non-default)."""
    ndm = b != default_bin
    conflicts = int(np.count_nonzero(ndm & (out != 0)))
    slot = b - (b > default_bin)
    np.copyto(out, (offset + slot).astype(out.dtype), where=ndm)
    return conflicts


def allocate_bin_budgets(distinct: np.ndarray, mass: np.ndarray,
                         total_budget: int, min_bin: int = 2,
                         max_bin_cap: int = 255) -> np.ndarray:
    """Split a GLOBAL bin budget across features by distinct-value/mass
    share (the Vectorized Adaptive Histograms allocation rule,
    arXiv:2603.00326): feature f's weight is sqrt(distinct_f * mass_f)
    — mass being the non-default sample count, where split resolution
    actually matters — water-filled into [min(min_bin, distinct),
    min(distinct, max_bin_cap)] so no feature holds more bins than it
    has distinct values and none exceeds the uint8-store cap.  The
    result is a per-feature `max_bin` vector for find_bin;
    deterministic (pure integer numpy) so every rank/run agrees.

    distinct / mass : [F] per-feature distinct-value and non-default
        sample counts (zero injected — a constant feature has 1).
    total_budget : global bin budget (uniform max_bin spends about
        sum(min(distinct, max_bin)) of it).
    """
    d = np.maximum(np.asarray(distinct, np.int64), 1)
    m = np.maximum(np.asarray(mass, np.int64), 1)
    w = np.sqrt(d.astype(np.float64) * m.astype(np.float64))
    cap = np.minimum(d, max_bin_cap)
    lo = np.minimum(cap, min_bin)
    alloc = lo.astype(np.int64).copy()
    total = max(int(total_budget), int(lo.sum()))
    # proportional waterfill; features hitting their cap release budget
    # back to the pool (few rounds suffice: each round either exhausts
    # the remainder or caps at least one feature)
    for _ in range(64):
        rem = total - int(alloc.sum())
        if rem <= 0:
            break
        room = cap - alloc
        open_w = np.where(room > 0, w, 0.0)
        sw = open_w.sum()
        if sw <= 0:
            break
        add = np.minimum(np.floor(rem * open_w / sw).astype(np.int64),
                         room)
        if int(add.sum()) == 0:
            # sub-unit remainder: hand out one bin each down the weight
            # order (stable, so ties resolve by feature index)
            order = np.argsort(-open_w, kind="stable")
            for j in order:
                if rem <= 0:
                    break
                if room[j] > 0:
                    alloc[j] += 1
                    rem -= 1
            break
        alloc += add
    return np.minimum(alloc, cap).astype(np.int32)


def find_bin_mappers(X: np.ndarray, max_bin: int, min_data_in_bin: int,
                     min_split_data: int, categorical: Sequence[int] = (),
                     sample_cnt: int = 200000, seed: int = 1,
                     bin_budget: int = 0) -> List[BinMapper]:
    """Find bin mappers for all columns of a dense matrix.

    Equivalent of DatasetLoader::ConstructBinMappersFromTextData
    (dataset_loader.cpp:661-837) for in-memory data: sample up to
    `sample_cnt` rows, then per-feature FindBin on the non-zero sampled
    values.  ``bin_budget > 0`` replaces the uniform per-feature
    max_bin with the adaptive allocation of `allocate_bin_budgets`
    (the global budget split by distinct-value/mass share, read off
    each column's distinct-value summary — computed ONCE per column
    and shared with the boundary search via find_bin_from_distinct).
    """
    n, f = X.shape
    rng = np.random.RandomState(seed)
    if n > sample_cnt:
        idx = np.sort(rng.choice(n, size=sample_cnt, replace=False))
        sample = X[idx]
        total = sample_cnt
    else:
        sample = X
        total = n
    cats = set(int(c) for c in categorical)
    summaries = []
    for j in range(f):
        col = np.asarray(sample[:, j], dtype=np.float64)
        nonzero = col[col != 0.0]      # NaNs dropped by _distinct_*
        summaries.append(_distinct_with_zero(nonzero, total))
    if bin_budget > 0 and f:
        # distinct incl. the implied zero = vals.size; mass (non-zero
        # sample count) = total minus the zero value's count
        d = np.asarray([v.size for v, _ in summaries], np.int64)
        m = np.asarray(
            [total - int(c[v == 0.0].sum()) for v, c in summaries],
            np.int64)
        budgets = allocate_bin_budgets(d, m, bin_budget)
    else:
        budgets = None
    mappers = []
    for j, (vals, counts) in enumerate(summaries):
        bt = CATEGORICAL if j in cats else NUMERICAL
        mb = int(budgets[j]) if budgets is not None else max_bin
        mappers.append(find_bin_from_distinct(
            vals, counts, total, mb, min_data_in_bin, min_split_data,
            bt))
    return mappers
