"""Out-of-core streamed dataset construction (`Dataset.from_stream`).

A copy of lightgbm_tpu/sharded/ingest.py (numpy only).  It builds the
binned Dataset from a re-iterable stream of row chunks in two passes,
without the full [N, F] float64 matrix:

- pass 1 feeds every chunk into mergeable quantile sketches
  (sharded/sketch.py) and, when EFB is on, collects a bounded
  bundle-plan sample;
- pass 2 bins chunk by chunk into the capacity-tiered appendable store
  (tiers seeded at the counted row total, so nothing re-allocates).

Bitwise contract: while the data fits `bin_construct_sample_cnt` rows
(`bin_find=auto` keeps the sketches exact up to that budget) and the
bundle-plan sample cap, the streamed store, labels, weights and bundle
plan are identical to batch `Dataset(X, y)` construction, whatever the
chunk sizes.  Past the budget the mappers carry the sketch's eps rank
guarantee.

`Dataset.streaming_from` (frozen-mapper appends) and the
`OnlineTrainer`'s first-window freeze route through this module too.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from .sketch import SketchSet


def array_stream(X, y=None, weight=None, chunk_rows: int = 262_144
                 ) -> Callable[[], Iterable[tuple]]:
    """Chunk factory over in-memory arrays: returns a callable yielding
    (X, y, w) row slices of `chunk_rows` — the adapter that lets
    from_stream's two passes walk an array the same way they would walk
    a file."""
    X = np.asarray(X)
    step = max(int(chunk_rows), 1)

    def chunks():
        for r0 in range(0, X.shape[0], step):
            sl = slice(r0, r0 + step)
            yield (X[sl],
                   None if y is None else np.asarray(y)[sl],
                   None if weight is None else np.asarray(weight)[sl])
    return chunks


def _normalize_chunk(chunk) -> Tuple[np.ndarray, Optional[np.ndarray],
                                     Optional[np.ndarray]]:
    """Accept (X,), (X, y), (X, y, w) tuples or a bare X array."""
    if isinstance(chunk, (tuple, list)):
        X = chunk[0]
        y = chunk[1] if len(chunk) > 1 else None
        w = chunk[2] if len(chunk) > 2 else None
    else:
        X, y, w = chunk, None, None
    return np.asarray(X, np.float64), y, w


def _chunk_factory(chunks, cfg: Config) -> Callable[[], Iterable]:
    """Normalize the `chunks` argument to a re-invokable factory.

    - callable: called once per pass (a file reader re-opens the file);
    - (X, y[, w]) array tuple: chunked by cfg.stream_chunk_rows;
    - list/tuple of chunk tuples: iterated per pass.
    A one-shot generator cannot feed two passes — rejected with a clear
    error instead of a silently empty second pass."""
    if callable(chunks):
        return chunks
    if (isinstance(chunks, tuple) and chunks
            and getattr(chunks[0], "ndim", 0) == 2):
        X, y, w = _normalize_chunk(chunks)
        return array_stream(X, y, w, chunk_rows=cfg.stream_chunk_rows)
    if isinstance(chunks, (list, tuple)):
        seq = list(chunks)
        return lambda: iter(seq)
    raise TypeError(
        "from_stream needs a re-iterable chunk source: a callable "
        "returning a fresh iterator, a list of (X, y, w) chunks, or an "
        "(X, y[, w]) array tuple — a one-shot generator cannot feed "
        "the sketch pass AND the binning pass")


def dataset_from_stream(chunks, config: Optional[Config] = None,
                        reference=None,
                        feature_names: Optional[List[str]] = None,
                        categorical_feature: Sequence[int] = (),
                        capacity: int = 0):
    """Build a binned Dataset from a stream of row chunks — see the
    module docstring.  Returns an APPENDABLE capacity-tiered dataset
    (`row_capacity` >= num_data); training learners consume
    `.compacted()`, and further `append_rows` keep streaming into it.

    reference: bin against an existing dataset's FROZEN mappers +
    bundle plan instead of running the sketch pass (the online-window
    path) — single pass, no sketches.
    capacity: seed the store's capacity tier (defaults to the counted
    row total, so the two-pass path never re-allocates)."""
    from ..dataset import (BUNDLE_PLAN_SAMPLE_CNT, Dataset,
                           _plan_bundles_from_sample, _log_bundle_state,
                           row_capacity_tier)

    cfg = config or (reference.config if reference is not None else Config())
    factory = _chunk_factory(chunks, cfg)

    if reference is not None:
        ds = Dataset.streaming_from(reference, cfg,
                                    capacity=max(int(capacity), 1))
        for chunk in factory():
            X, y, w = _normalize_chunk(chunk)
            ds.append_rows(X, y, w)
        ds._check_realized_conflicts()
        return ds

    # ---- pass 1: sketches (+ bounded bundle-plan sample) ---------------
    mode = getattr(cfg, "bin_find", "auto")
    # auto: exact summaries while the data fits the sample budget — the
    # regime where streamed == batch bitwise; sketch=pure eps summaries
    min_cap = int(cfg.bin_construct_sample_cnt) if mode != "sketch" else 0
    ss: Optional[SketchSet] = None
    plan_rows: List[np.ndarray] = []
    plan_count = 0
    n_rows = 0
    for chunk in factory():
        X, _y, _w = _normalize_chunk(chunk)
        if ss is None:
            ss = SketchSet(X.shape[1], cfg.sketch_eps,
                           categorical=categorical_feature,
                           min_capacity_rows=min_cap)
        ss.add_chunk(X)
        n_rows += len(X)
        if cfg.enable_bundle and plan_count < BUNDLE_PLAN_SAMPLE_CNT:
            take = min(BUNDLE_PLAN_SAMPLE_CNT - plan_count, len(X))
            if take:
                plan_rows.append(X[:take].copy())
                plan_count += take
    if ss is None or n_rows == 0:
        raise ValueError("from_stream: the chunk stream yielded no rows")

    mappers = ss.mappers_from_config(cfg)
    used = [i for i, m in enumerate(mappers) if not m.is_trivial]
    plan = None
    if cfg.enable_bundle and plan_rows:
        plan = _plan_bundles_from_sample(
            np.concatenate(plan_rows), mappers, used, cfg)
    _log_bundle_state(plan, len(used), cfg)
    del plan_rows

    # ---- pass 2: bin chunk-by-chunk into the tiered store --------------
    cap = row_capacity_tier(max(int(capacity), n_rows))
    ds = Dataset._empty_from_mappers(cfg, mappers, used, cap,
                                     ss.num_features, feature_names,
                                     plan=plan)
    ds._bins[:] = 0      # streaming slots past num_data hold bin 0
    ds.num_data = 0
    for chunk in factory():
        X, y, w = _normalize_chunk(chunk)
        ds.append_rows(X, y, w)
    if ds.num_data != n_rows:
        raise ValueError(
            f"from_stream: the chunk source yielded {ds.num_data} rows "
            f"on the binning pass but {n_rows} on the sketch pass — "
            "the source must replay identically (is it a one-shot "
            "iterator wrapped in a callable?)")
    if ds.metadata.label.size == 0:
        ds.metadata.label = np.zeros(ds.num_data, np.float32)
    ds._check_realized_conflicts()
    ds._sketch_err_bound = ss.err_bound()
    ds._sketch_exact = ss.exact
    return ds
