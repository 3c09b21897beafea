"""Mergeable quantile sketches for out-of-core bin finding.

A copy of lightgbm_tpu/sharded/sketch.py (numpy only).  Instead of one
row sample binned at once, each stream chunk summarizes every feature
into O(1/eps) weighted entries; the summaries merge associatively, and
bin boundaries come from the merged summary with a rank guarantee (the
mergeable quantile summaries of the GPU boosting literature,
arXiv:1706.08359, arXiv:1806.11248).  The port uses them for
`Dataset.from_stream` (sharded/ingest.py) and `bin_find=sketch`; the
multi-device merge waits for the multi-GPU learners.

Design (GK-style weighted summary, vectorized in numpy):

- A sketch holds sorted distinct `vals` with per-value `counts`.  While
  it has never compacted, it IS the exact distinct-value summary —
  `find_bin_from_distinct` on it is bitwise the exact mapper (the
  "exact small-N mode").
- When entries exceed `capacity` = O(1/eps), the sketch COMPACTS to
  capacity/2 even-weight buckets.  Each retained entry represents the
  value interval back to its predecessor; compaction preserves the
  cumulative counts AT bucket ends exactly, so the only error source is
  interval RESOLUTION: a later value landing inside a compacted
  interval inherits up to that interval's weight of rank uncertainty.
  `res` tracks the widest multi-entry bucket ever formed; the rank of
  any entry is exact to within `res` (the error is inherited from
  exactly one interval, never stacked across generations — bucket ends
  keep their cumsums through every subsequent compaction).
- MERGING two sketches interleaves their entries.  Each side's
  cumulative counts are then additionally uncertain by the other
  side's resolution at the interleaved positions, so the merge adds
  `max(res_a, res_b)` of attribution fuzz.  `err_bound() = fuzz + res`
  is the total rank uncertainty the sketch self-reports — the
  authoritative per-instance bound (tests assert against it).

Guarantees:

- single stream of chunks (out-of-core ingestion): fuzz stays 0 and
  `err_bound() = res <= 2 * eps * total` (measured ~eps * total / 2
  typical at capacity 8/eps);
- W-way host merge: `err_bound() <= ~2 * eps * N_global` (each host
  contributes its resolution plus one merge-fuzz term);
- while every sketch stays exact (entries never exceeded capacity),
  `err_bound() == 0` and the derived mappers are BITWISE the exact
  ones.

Serialization is fixed-width float64 (`pack` / `unpack`), so a
`SketchSet` can travel bit-exactly in one small collective of O(F / eps).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..binning import (BinMapper, CATEGORICAL, NUMERICAL,
                       find_bin_from_distinct)


def sketch_capacity(eps: float) -> int:
    """Entries per feature summary: compaction prunes to capacity/2
    even-weight buckets of ~ eps * total / 4 rows each; the bucket that
    absorbs a previously-compacted entry can reach twice that, so the
    self-reported resolution stays within ~ eps * total / 2 (measured;
    `err_bound()` is always the authoritative per-instance bound)."""
    return max(64, int(math.ceil(8.0 / float(eps))))


class QuantileSketch:
    """Mergeable weighted quantile summary of ONE feature's non-zero,
    non-NaN sample values (zeros are implied by the row count, exactly
    like binning._distinct_with_zero)."""

    __slots__ = ("eps", "capacity", "vals", "counts", "res", "fuzz")

    def __init__(self, eps: float, capacity: int = 0):
        self.eps = float(eps)
        self.capacity = int(capacity) or sketch_capacity(eps)
        self.vals = np.zeros(0, np.float64)
        self.counts = np.zeros(0, np.float64)
        self.res = 0.0    # value-resolution rank error (widest bucket)
        self.fuzz = 0.0   # cross-sketch attribution error

    @property
    def total(self) -> float:
        return float(self.counts.sum())

    @property
    def exact(self) -> bool:
        """True while the summary still holds every distinct value with
        its exact count — mappers derived from it are bitwise the exact
        ones."""
        return self.res == 0.0 and self.fuzz == 0.0

    def err_bound(self) -> float:
        """Self-reported rank uncertainty: any cumulative count read off
        this sketch is within this many rows of the true rank."""
        return self.res + self.fuzz

    def add(self, values: np.ndarray) -> None:
        """Absorb a batch of raw values (NaN filtered here; zero/total
        bookkeeping is the caller's, matching find_bin's contract)."""
        values = np.asarray(values, np.float64)
        values = values[~np.isnan(values)]
        if values.size == 0:
            return
        nv, nc = np.unique(values, return_counts=True)
        self._absorb(nv, nc.astype(np.float64))

    def merge(self, other: "QuantileSketch") -> None:
        """Merge another sketch (disjoint data) into this one."""
        if other.vals.size == 0:
            return
        if self.vals.size == 0:
            self.vals = other.vals.copy()
            self.counts = other.counts.copy()
            self.res, self.fuzz = other.res, other.fuzz
            return
        # each side's cumulative counts are fuzzy at the OTHER side's
        # entry positions by that side's interval resolution
        self.fuzz = self.fuzz + other.fuzz + max(self.res, other.res)
        self.res = max(self.res, other.res)
        self._absorb(other.vals, other.counts)

    def _absorb(self, v2: np.ndarray, c2: np.ndarray) -> None:
        """Merge sorted distinct values `v2` with counts `c2` into the
        summary.  Both sides are sorted runs, so a stable sort of their
        concatenation is a linear merge (a re-sort of the whole summary
        for every chunk made a stream of many chunks quadratic); equal
        values then add their counts (whole numbers, exact in f64)."""
        v = np.concatenate([self.vals, v2])
        c = np.concatenate([self.counts, c2])
        order = np.argsort(v, kind="stable")
        v, c = v[order], c[order]
        first = np.ones(v.size, bool)
        np.not_equal(v[1:], v[:-1], out=first[1:])
        starts = np.flatnonzero(first)
        self.vals, self.counts = v[starts], np.add.reduceat(c, starts)
        if self.vals.size > self.capacity:
            self._compact()

    def _compact(self) -> None:
        """Prune to capacity/2 even-weight buckets.  Each retained entry
        keeps the bucket's LAST value and the bucket's total weight, so
        cumulative counts at retained entries stay exact; min (entry 0)
        and max (last entry, always a bucket end) are preserved."""
        m = max(self.capacity // 2, 2)
        W = np.cumsum(self.counts)
        total = W[-1]
        targets = total * (np.arange(1, m + 1, dtype=np.float64) / m)
        idx = np.searchsorted(W, targets, side="left")
        idx = np.unique(np.minimum(idx, self.vals.size - 1))
        if idx[0] != 0:
            idx = np.concatenate([[0], idx])
        newc = np.diff(np.concatenate([[0.0], W[idx]]))
        starts = np.concatenate([[-1], idx[:-1]])
        multi = (idx - starts) > 1          # buckets that merged entries
        if multi.any():
            self.res = max(self.res, float(newc[multi].max()))
        self.vals = self.vals[idx]
        self.counts = newc

    # -- fixed-width serialization (allgather transport) ----------------

    WIDTH_SCALARS = 4                       # n_entries, total, res, fuzz

    def pack_width(self) -> int:
        return 2 * self.capacity + self.WIDTH_SCALARS

    def pack(self) -> np.ndarray:
        n = self.vals.size
        if n > self.capacity:               # defensive; _absorb compacts
            self._compact()
            n = self.vals.size
        out = np.zeros(self.pack_width(), np.float64)
        out[0] = float(n)
        out[1] = self.total
        out[2] = self.res
        out[3] = self.fuzz
        s = self.WIDTH_SCALARS
        out[s:s + n] = self.vals
        out[s + self.capacity:s + self.capacity + n] = self.counts
        return out

    @classmethod
    def unpack(cls, arr: np.ndarray, eps: float, capacity: int
               ) -> "QuantileSketch":
        sk = cls(eps, capacity)
        n = int(arr[0])
        sk.res = float(arr[2])
        sk.fuzz = float(arr[3])
        s = cls.WIDTH_SCALARS
        sk.vals = np.asarray(arr[s:s + n], np.float64).copy()
        sk.counts = np.asarray(
            arr[s + capacity:s + capacity + n], np.float64).copy()
        return sk


class CategoricalCounter:
    """Exact per-category counts (categories are small int sets; rank
    compaction makes no sense for them).  When cardinality exceeds the
    capacity, the rarest categories are dropped — consistent with the
    reference's 98%-coverage cut (bin.cpp:188-240), which never keeps
    ultra-rare categories anyway."""

    __slots__ = ("capacity", "vals", "counts", "dropped")

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.vals = np.zeros(0, np.float64)
        self.counts = np.zeros(0, np.float64)
        self.dropped = 0.0

    @property
    def total(self) -> float:
        return float(self.counts.sum()) + self.dropped

    @property
    def exact(self) -> bool:
        """False once any category was dropped — the derived mapper may
        then differ from the exact one (the bitwise contract requires
        every counter exact, SketchSet.exact)."""
        return self.dropped == 0.0

    def err_bound(self) -> float:
        """Dropped mass is unattributed count — the categorical analog
        of rank uncertainty."""
        return self.dropped

    def add(self, values: np.ndarray) -> None:
        values = np.asarray(values, np.float64)
        values = values[~np.isnan(values)]
        if values.size == 0:
            return
        nv, nc = np.unique(values, return_counts=True)
        self._absorb(nv, nc.astype(np.float64))

    def merge(self, other: "CategoricalCounter") -> None:
        self.dropped += other.dropped
        if other.vals.size:
            self._absorb(other.vals, other.counts)

    def _absorb(self, v2, c2) -> None:
        v = np.concatenate([self.vals, v2])
        c = np.concatenate([self.counts, c2])
        uv, inv = np.unique(v, return_inverse=True)
        uc = np.zeros(uv.size, np.float64)
        np.add.at(uc, inv, c)
        if uv.size > self.capacity:
            order = np.argsort(-uc, kind="stable")
            keep = np.sort(order[: self.capacity])
            self.dropped += float(uc.sum() - uc[keep].sum())
            uv, uc = uv[keep], uc[keep]
        self.vals, self.counts = uv, uc

    # same wire format as QuantileSketch (res slot carries `dropped`)
    def pack_width(self) -> int:
        return 2 * self.capacity + QuantileSketch.WIDTH_SCALARS

    def pack(self) -> np.ndarray:
        out = np.zeros(self.pack_width(), np.float64)
        n = self.vals.size
        out[0] = float(n)
        out[1] = self.total
        out[2] = self.dropped
        s = QuantileSketch.WIDTH_SCALARS
        out[s:s + n] = self.vals
        out[s + self.capacity:s + self.capacity + n] = self.counts
        return out

    @classmethod
    def unpack(cls, arr: np.ndarray, capacity: int) -> "CategoricalCounter":
        cc = cls(capacity)
        n = int(arr[0])
        cc.dropped = float(arr[2])
        s = QuantileSketch.WIDTH_SCALARS
        cc.vals = np.asarray(arr[s:s + n], np.float64).copy()
        cc.counts = np.asarray(
            arr[s + capacity:s + capacity + n], np.float64).copy()
        return cc


class SketchSet:
    """Per-feature sketches + the shared row count: everything needed to
    derive global BinMappers without the raw sample.

    `min_capacity_rows` raises each numerical sketch's capacity so the
    summary stays EXACT while the data fits the bin-construction sample
    budget — the `bin_find=auto` semantics: exact (bitwise the batch
    mappers) up to `bin_construct_sample_cnt` rows, eps-approximate
    beyond."""

    def __init__(self, num_features: int, eps: float,
                 categorical: Sequence[int] = (),
                 min_capacity_rows: int = 0):
        self.eps = float(eps)
        self.num_features = int(num_features)
        cap = max(sketch_capacity(eps), int(min_capacity_rows))
        self.capacity = cap
        cats = set(int(c) for c in categorical)
        self.categorical = sorted(cats)
        self.sketches = [CategoricalCounter(cap) if j in cats
                         else QuantileSketch(eps, cap)
                         for j in range(num_features)]
        self.n_rows = 0

    def add_chunk(self, X: np.ndarray) -> None:
        X = np.asarray(X)
        if X.ndim != 2 or X.shape[1] != self.num_features:
            raise ValueError(
                f"sketch chunk must be [rows, {self.num_features}], "
                f"got {X.shape}")
        self.n_rows += X.shape[0]
        for j in range(self.num_features):
            col = np.asarray(X[:, j], np.float64)
            self.sketches[j].add(col[col != 0.0])

    def merge(self, other: "SketchSet") -> None:
        if other.num_features != self.num_features:
            raise ValueError("cannot merge sketch sets of different width")
        self.n_rows += other.n_rows
        for a, b in zip(self.sketches, other.sketches):
            a.merge(b)

    @property
    def exact(self) -> bool:
        return all(getattr(s, "exact", True) for s in self.sketches)

    def err_bound(self) -> float:
        """Max rank uncertainty across features (rows; a categorical
        counter's dropped mass counts as its uncertainty)."""
        return max((s.err_bound() for s in self.sketches), default=0.0)

    # -- mappers ---------------------------------------------------------

    def mappers(self, max_bin: int, min_data_in_bin: int,
                min_split_data: int, bin_budget: int = 0
                ) -> List[BinMapper]:
        """Derive the BinMappers — the exact find_bin greedy run on the
        (merged) summaries, zero injected from the row count exactly
        like binning._distinct_with_zero.  ``bin_budget > 0`` applies
        the adaptive per-feature allocation (binning.
        allocate_bin_budgets) with distinct/mass counts read off the
        summaries themselves — the sketch-side analog of the exact
        sample path's column stats."""
        budgets = None
        if bin_budget > 0 and self.sketches:
            from ..binning import allocate_bin_budgets
            total0 = int(self.n_rows)
            d = []
            m = []
            for sk in self.sketches:
                nz = int(np.rint(np.asarray(sk.counts)).sum())
                dd = int(np.asarray(sk.vals).size)
                if nz < total0:
                    dd += 1                       # the implied zero
                d.append(max(dd, 1))
                m.append(nz)
            budgets = allocate_bin_budgets(np.asarray(d, np.int64),
                                           np.asarray(m, np.int64),
                                           bin_budget)
        out = []
        total = int(self.n_rows)
        for j, sk in enumerate(self.sketches):
            bt = CATEGORICAL if isinstance(sk, CategoricalCounter) \
                else NUMERICAL
            vals = sk.vals
            # counts are exact integers carried in f64 (< 2^53)
            counts = np.rint(sk.counts).astype(np.int64)
            nonzero = int(counts.sum())
            zero_cnt = max(total - nonzero - int(round(
                getattr(sk, "dropped", 0.0))), 0)
            if vals.size == 0:
                vals = np.array([0.0])
                counts = np.array([max(zero_cnt, 1)], np.int64)
            elif zero_cnt > 0:
                z = np.flatnonzero(vals == 0.0)
                if z.size:
                    counts = counts.copy()
                    counts[z[0]] += zero_cnt
                else:
                    pos = int(np.searchsorted(vals, 0.0))
                    vals = np.insert(vals, pos, 0.0)
                    counts = np.insert(counts, pos, zero_cnt)
            mb = int(budgets[j]) if budgets is not None else max_bin
            out.append(find_bin_from_distinct(
                vals, counts, total, mb, min_data_in_bin,
                min_split_data, bt))
        return out

    def mappers_from_config(self, cfg) -> List[BinMapper]:
        return self.mappers(cfg.max_bin, cfg.min_data_in_bin,
                            cfg.min_data_in_leaf,
                            bin_budget=int(getattr(cfg, "bin_budget", 0)))

    # -- wire format -----------------------------------------------------

    def pack(self) -> np.ndarray:
        """[F + 1, 2 * capacity + 4] float64: row 0 is the header
        (n_rows, capacity, eps, n_features), rows 1..F the per-feature
        summaries.  Fixed width across ranks, so allgather_f64 carries
        it bit-exactly in one collective."""
        w = 2 * self.capacity + QuantileSketch.WIDTH_SCALARS
        out = np.zeros((self.num_features + 1, w), np.float64)
        out[0, 0] = float(self.n_rows)
        out[0, 1] = float(self.capacity)
        out[0, 2] = self.eps
        out[0, 3] = float(self.num_features)
        for j, sk in enumerate(self.sketches):
            out[j + 1] = sk.pack()
        return out

    @classmethod
    def unpack(cls, arr: np.ndarray, categorical: Sequence[int] = ()
               ) -> "SketchSet":
        arr = np.asarray(arr, np.float64)
        n_rows = int(arr[0, 0])
        capacity = int(arr[0, 1])
        eps = float(arr[0, 2])
        F = int(arr[0, 3])
        ss = cls(F, eps, categorical=categorical, min_capacity_rows=capacity)
        ss.n_rows = n_rows
        cats = set(ss.categorical)
        ss.sketches = [
            CategoricalCounter.unpack(arr[j + 1], capacity) if j in cats
            else QuantileSketch.unpack(arr[j + 1], eps, capacity)
            for j in range(F)]
        return ss

    @classmethod
    def merge_packed(cls, stack: np.ndarray, categorical: Sequence[int] = ()
                     ) -> "SketchSet":
        """Merge a [world, F + 1, W] stack of packed sketch sets in rank
        order — deterministic, so every process that holds the identical
        stack derives the identical merged summary (and mappers)."""
        merged = cls.unpack(stack[0], categorical)
        for r in range(1, stack.shape[0]):
            merged.merge(cls.unpack(stack[r], categorical))
        return merged


def sketch_columns(X: np.ndarray, cfg, categorical: Sequence[int] = (),
                   min_capacity_rows: int = 0) -> SketchSet:
    """SketchSet over an in-memory sample, chunked by
    `cfg.stream_chunk_rows` (the same chunk walk the out-of-core path
    takes, so both produce identical summaries)."""
    X = np.asarray(X)
    ss = SketchSet(X.shape[1], cfg.sketch_eps, categorical=categorical,
                   min_capacity_rows=min_capacity_rows)
    step = max(int(cfg.stream_chunk_rows), 1)
    for r0 in range(0, X.shape[0], step):
        ss.add_chunk(X[r0:r0 + step])
    return ss
