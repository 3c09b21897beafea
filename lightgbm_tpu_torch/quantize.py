"""Raw feature values into bins, against frozen BinMappers.

Port of lightgbm_tpu/quantize.py.  The train policy (`bin_rows_into`,
`bin_column_into`, `bin_feature_column`): every dataset build bins
through here.  With a bundle plan (EFB), a packed
feature folds its non-default bins into its shared store column with
`binning.pack_bundle_column` (last writer wins on conflicting rows), and
each function returns the conflicting rows it saw.  Every column goes
through `BinMapper.value_to_bin`; the JAX package's native bulk binner
gives the same bins and is not ported.

The serve policy (`FeatureQuantizer`): serving ingress under
``serve_quantize=binned`` quantizes each request chunk to the original
per-feature bin ids with a float32 search over the float32-cast bin
upper bounds, so the integer compare of the binned walk is exactly the
raw kernel's ``f32(v) <= f32(t)`` on every input: model thresholds are
bin upper bounds, and ``bin(v) <= bin(t)`` iff ``uppers32[bin(t)] >=
f32(v)`` iff ``f32(v) <= f32(t)``.  NaN and a category absent from the
mapper's table quantize to the MISSING sentinel, one code past every
real bin, so they route right everywhere, as in the raw kernel; +/-inf
land on the last/first real bin.  The JAX package's native bulk binner
is not ported: numeric features bin through an exact integer-keyed grid
(`_NumericGrid`) or a searchsorted.

The `.refbin` sidecar (`load_refbin`) is the frozen mapper set a model
is served against: a 0-row binary dataset (`Dataset.save_refbin`), in
the JAX package's file format, so either package reads the other's.
`rebin_models_for_serving` gives a model's trees in-bin thresholds for
it and refuses a mapper set that cannot route them exactly.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np

from .binning import CATEGORICAL, BinMapper, pack_bundle_column
from .log import LightGBMError


def file_sha1(path: str) -> str:
    """sha1 of a file's bytes — the refbin integrity fingerprint (a
    publish ``.meta.json`` carries it; the serving registry refuses a
    binned swap on mismatch)."""
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def bin_feature_column(k: int, values: np.ndarray,
                       mappers: Sequence[BinMapper],
                       used_features: Sequence[int], plan,
                       out: np.ndarray) -> int:
    """Bin used feature k's raw column into `out`, the [N] row of its
    store column: a copy for an unbundled feature, a pack into the
    bundle column otherwise.  Returns the realized bundle conflicts."""
    b = mappers[used_features[k]].value_to_bin(values)
    if plan is None or not plan.feat_packed[k]:
        out[:] = b.astype(out.dtype)
        return 0
    return pack_bundle_column(
        b, int(plan.feat_default[k]), int(plan.feat_offset[k]), out)


def bin_column_into(k: int, values: np.ndarray,
                    mappers: Sequence[BinMapper],
                    used_features: Sequence[int], plan,
                    store: np.ndarray) -> int:
    """Bin used feature k's full raw column into its store column of
    `store` [C, N].  Returns the realized bundle conflicts."""
    c = k if plan is None else int(plan.feat_col[k])
    return bin_feature_column(k, values, mappers, used_features, plan,
                              store[c])


def bin_rows_into(X: np.ndarray, mappers: Sequence[BinMapper],
                  used_features: Sequence[int], plan, store: np.ndarray,
                  row0: int) -> int:
    """Bin raw rows X into store[:, row0:row0 + len(X)], feature by
    feature in used order (so packed features fold in the JAX package's
    order).  Returns the realized bundle conflicts."""
    sl = slice(row0, row0 + len(X))
    conflicts = 0
    for k in range(len(used_features)):
        c = k if plan is None else int(plan.feat_col[k])
        conflicts += bin_feature_column(k, X[:, used_features[k]], mappers,
                                        used_features, plan, store[c, sl])
    return conflicts


# ----------------------------------------------------------------------
# SERVE policy: request-path ingress quantization
# ----------------------------------------------------------------------

# grid-accelerated numeric binning: cells are uniform in the float32
# TOTAL-ORDER KEY space (integer arithmetic end to end — no rounding
# anywhere), each cell stores the bin of its smallest key, and at most
# _GRID_ADJUST boundaries may fall inside any cell (checked at build;
# the grid refines until the budget holds or the feature falls back to
# searchsorted).  Lookup = shift + clip + one table gather + _GRID_ADJUST
# compare-increment steps — ~5x the throughput of numpy's per-value
# binary search on the serving ingress path.
_GRID_TARGET_BITS = 13          # ~8192 cells to start
_GRID_MAX_CELLS = 1 << 16
_GRID_ADJUST = 2


def _f32_keys(a32: np.ndarray) -> np.ndarray:
    """Monotone int64 keys of float32 values: a <= b in f32 iff
    key(a) <= key(b) for non-NaN values with -0.0 pre-normalized to
    +0.0 (the caller adds +0.0f, which is the identity everywhere
    else)."""
    u = np.asarray(a32, np.float32).view(np.uint32).astype(np.int64)
    return np.where(u >> 31, 0xFFFFFFFF - u, u + 0x80000000)


class _NumericGrid:
    """Per-feature acceleration index over the f32-cast upper bounds."""

    __slots__ = ("key0", "shift", "cells", "base", "fkeys_padded", "ok")

    def __init__(self, ub32: np.ndarray):
        fin = (ub32[:-1] + np.float32(0.0)).astype(np.float32)
        self.ok = False
        if fin.size == 0 or not np.isfinite(fin).all():
            return                        # 1-bin feature / inf bounds:
                                          # searchsorted fallback (rare)
        fkeys = _f32_keys(fin)
        span = int(fkeys[-1] - fkeys[0])
        shift = max(0, span.bit_length() - _GRID_TARGET_BITS)
        while True:
            cells = (span >> shift) + 1
            if cells > _GRID_MAX_CELLS:
                return                    # budget unreachable: fallback
            edges = fkeys[0] + (np.arange(cells + 1,
                                          dtype=np.int64) << shift)
            base = np.searchsorted(fkeys, edges, side="left")
            if np.diff(base).max(initial=0) <= _GRID_ADJUST:
                break
            if shift == 0:
                return
            shift -= 1
        self.key0 = int(fkeys[0])
        self.shift = shift
        self.cells = cells
        self.base = base.astype(np.int64)
        self.fkeys_padded = np.concatenate(
            [fkeys, np.full(_GRID_ADJUST, np.iinfo(np.int64).max)])
        self.ok = True

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """bin(v32) for the column's keys — exact: the cell's base bin
        is <= the true bin, at most _GRID_ADJUST boundaries sit in any
        cell, and each adjustment step advances iff the current bound's
        key is still below the value's (NaN keys yield garbage bins the
        caller overwrites with the MISSING sentinel)."""
        idx = np.clip((keys - self.key0) >> self.shift, 0, self.cells - 1)
        b = self.base[idx]
        for _ in range(_GRID_ADJUST):
            b = b + (self.fkeys_padded[b] < keys)
        return b


class FeatureQuantizer:
    """Frozen-mapper ingress quantizer for the binned serving path.

    ``quantize(X)`` maps raw ``[rows, num_total_features]`` requests to
    a ``[rows, num_columns]`` uint8 (uint16 past 255 bins) buffer of
    ORIGINAL per-feature bin ids over the used features — 4x (resp. 2x)
    smaller than the f32 buffer the raw kernel ships to the device, and
    routing exactly as the raw f32 traversal does (module docstring).
    Bundled (EFB) stores need no remap here: trees speak original
    (feature, bin) space and the request buffer is built in it, so
    ``feat_tbl`` stays None on the request path.
    """

    __slots__ = ("used_features", "num_total_features", "num_columns",
                 "dtype", "missing_bin", "_numeric", "_tables",
                 "_num_ks", "_num_raw", "_grids")

    def __init__(self, mappers: Sequence[BinMapper],
                 used_features: Sequence[int]):
        self.used_features = [int(i) for i in used_features]
        self.num_total_features = len(mappers)
        # at least one buffer column so a stump-only model still has a
        # gatherable [rows, 1] buffer
        self.num_columns = max(len(self.used_features), 1)
        max_nb = max((mappers[i].num_bin for i in self.used_features),
                     default=1)
        # the MISSING sentinel needs one free code past every real bin
        if max_nb <= 0xFF:
            self.dtype = np.uint8
            self.missing_bin = 0xFF
        elif max_nb <= 0xFFFF:
            self.dtype = np.uint16
            self.missing_bin = 0xFFFF
        else:
            raise LightGBMError(
                f"cannot quantize serving requests: a mapper has "
                f"{max_nb} bins (> 65535)")
        self._numeric: List[bool] = []
        self._tables: List = []
        for i in self.used_features:
            m = mappers[i]
            if m.bin_type == CATEGORICAL:
                cats = np.asarray(m.bin_2_categorical, np.int64)
                order = np.argsort(cats)
                self._numeric.append(False)
                self._tables.append(
                    (cats[order],
                     np.arange(len(cats), dtype=np.int64)[order]))
            else:
                # f32 bounds: the compare domain of the raw kernels
                self._numeric.append(True)
                self._tables.append(
                    np.asarray(m.bin_upper_bound, np.float64)
                    .astype(np.float32))
        self._num_ks = [k for k, isn in enumerate(self._numeric) if isn]
        self._num_raw = [self.used_features[k] for k in self._num_ks]
        # integer-keyed grid index per numeric feature (exact, with a
        # per-feature searchsorted fallback when its cell budget fails)
        self._grids = [_NumericGrid(self._tables[k])
                       for k in self._num_ks]

    def quantize(self, X: np.ndarray) -> np.ndarray:
        """[rows, num_total_features] raw → [rows, num_columns] bins."""
        X = np.asarray(X)
        n = X.shape[0]
        out = np.zeros((n, self.num_columns), self.dtype)
        miss = self.missing_bin
        # ---- numeric block: one cast, one key pass --------------------
        if self._num_ks:
            sub32 = X[:, self._num_raw].astype(np.float32)
            nanmask = np.isnan(sub32)
            # +0.0f normalizes -0.0 so keys agree with f32 compares
            keys = _f32_keys(sub32 + np.float32(0.0))
            for j, k in enumerate(self._num_ks):
                g = self._grids[j]
                if g.ok:
                    out[:, k] = g.lookup(keys[:, j])
                else:
                    out[:, k] = np.searchsorted(
                        self._tables[k], sub32[:, j], side="left")
            if nanmask.any():
                out[:, self._num_ks] = np.where(
                    nanmask, self.dtype(miss), out[:, self._num_ks])
        # ---- categorical columns --------------------------------------
        for k, i in enumerate(self.used_features):
            if self._numeric[k]:
                continue
            col = X[:, i].astype(np.float32)
            cats, bins = self._tables[k]
            finite = np.isfinite(col)
            # int truncation behind the finite mask — the raw kernels'
            # categorical compare; the clip only silences the f32→int64
            # overflow warning (clipped magnitudes can match no
            # category either way)
            vi = np.clip(np.where(finite, col, np.float32(-1.0)),
                         -9.2e18, 9.2e18).astype(np.int64)
            if cats.size:
                pos = np.clip(np.searchsorted(cats, vi), 0,
                              cats.size - 1)
                hit = finite & (cats[pos] == vi)
                b = np.where(hit, bins[pos], miss)
            else:
                b = np.full(n, miss, np.int64)
            out[:, k] = b
        return out


# ----------------------------------------------------------------------
# refbin sidecar: the frozen-mapper contract between publisher and fleet
# ----------------------------------------------------------------------

def load_refbin(path: str, expected_sha1: Optional[str] = None):
    """Load a ``.refbin`` frozen-mapper sidecar (binary-dataset format:
    a 0-row `Dataset.save_refbin` shell, or a whole published window
    store).  The stored max_bin / enable_bundle settings are adopted
    from the file itself — a refbin is self-describing, not subject to
    the serving process's config.
    With ``expected_sha1`` (the publish meta's fingerprint), a
    mismatching file is refused before it is parsed.  The file is read
    and parsed ONCE (an online-published sidecar is a whole window
    store, and this runs on the registry's hot-swap path)."""
    import io

    from .config import Config
    from .dataset import Dataset
    with open(path, "rb") as f:
        blob = f.read()
    if expected_sha1:
        actual = hashlib.sha1(blob).hexdigest()
        if actual != expected_sha1:
            raise LightGBMError(
                f"refbin sidecar {path} sha1 {actual[:12]} does not match "
                f"the publish meta's {str(expected_sha1)[:12]} (torn "
                "write or stale sidecar); refusing the binned mapper set")
    bio = io.BytesIO(blob)
    first = bio.readline().strip().decode(errors="replace")
    if first != Dataset.BINARY_MAGIC:
        raise LightGBMError(
            f"{path} is not a lightgbm_tpu refbin sidecar")
    npz = np.load(bio, allow_pickle=False)
    d = {k: npz[k] for k in npz.files}
    # sparse_store pinned dense: a refbin is a mapper-set contract —
    # serving consumers read its mappers/plan, never histogram it
    cfg = Config(max_bin=int(d["max_bin"]),
                 enable_bundle=bool(int(d["enable_bundle"])),
                 sparse_store="dense", verbose=-1)
    return Dataset._from_binary_dict(d, cfg, path)


def _check_thresholds_representable(t, k, refbin, sf: np.ndarray) -> None:
    """Every threshold must BE a bin boundary of the refbin's mappers —
    the condition the bitwise argument actually requires: ``bin(v) <=
    bin(t)`` collapses to the raw ``v <= t`` only when
    ``upper[bin(t)] == t`` exactly (and a categorical threshold must be
    IN the mapper's table, else the rebin maps it to bin 0 and the
    binned walk would match the wrong category).  A sidecar frozen from
    OTHER data — e.g. an online daemon's window mappers when the input
    model trained elsewhere — fails here instead of silently misrouting
    the rows that fall between a model threshold and the sidecar's next
    boundary."""
    thr = np.asarray(t.threshold[:k], np.float64)
    tib = np.asarray(t.threshold_in_bin[:k], np.int64)
    for f in np.unique(sf):
        m = refbin.mappers[int(f)]
        sel = sf == f
        tb = tib[sel]
        if m.bin_type == CATEGORICAL:
            cats = np.asarray(m.bin_2_categorical, np.int64)
            ok = ((tb >= 0) & (tb < cats.size)
                  & (cats[np.clip(tb, 0, max(cats.size - 1, 0))]
                     == thr[sel].astype(np.int64)))
        else:
            ub = np.asarray(m.bin_upper_bound, np.float64)
            ok = ((tb >= 0) & (tb < ub.size)
                  & (ub[np.clip(tb, 0, ub.size - 1)] == thr[sel]))
        if not bool(ok.all()):
            raise LightGBMError(
                "refbin mapper set cannot represent the model's "
                "thresholds exactly (a threshold is not a bin boundary "
                "of the sidecar's mappers); binned serving would "
                "misroute — serve raw, or ship the model's own training "
                "mappers as the sidecar (Dataset.save_refbin)")


def rebin_models_for_serving(models, refbin) -> None:
    """Give every tree in-bin thresholds/inner features for the refbin
    mapper set, refusing combinations that cannot route exactly.

    Loaded trees (the registry path) rebin from their real-valued
    thresholds; trees trained in this process already carry in-bin data
    for their TRAINING mappers, which is verified to agree with the refbin's.
    EVERY tree then passes the threshold-representability check — the
    actual exactness condition (see `_check_thresholds_representable`).
    A model splitting on a feature the refbin filtered as trivial is
    refused outright: the rebin would freeze that node's routing to one
    side while the raw kernel still compares per-row.
    """
    nt = int(refbin.num_total_features)
    inner_map = np.full(nt, -1, np.int64)
    inner_map[np.asarray(refbin.used_features, np.int64)] = np.arange(
        len(refbin.used_features))
    for t in models:
        k = t.num_leaves - 1
        if k <= 0:
            continue
        sf = np.asarray(t.split_feature[:k], np.int64)
        if int(sf.max(initial=-1)) >= nt or bool(np.any(inner_map[sf] < 0)):
            raise LightGBMError(
                "model splits on a feature that is trivial or absent in "
                "the refbin mapper set; binned serving cannot route it "
                "exactly (serve raw instead)")
        if getattr(t, "needs_rebin", False):
            t.rebin_to_dataset(refbin)
        elif not np.array_equal(inner_map[sf],
                                np.asarray(t.split_feature_inner[:k],
                                           np.int64)):
            raise LightGBMError(
                "refbin sidecar does not match the model's training "
                "mappers (used-feature mapping differs)")
        _check_thresholds_representable(t, k, refbin, sf)
