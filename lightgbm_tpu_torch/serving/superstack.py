"""Cross-model co-stacked serving: N tenants on ONE prepared entry.

Port of lightgbm_tpu/serving/superstack.py.  The multi-tenant catalog
(catalog.py) pays for tenant isolation with one entry cache and one
traversal launch sequence PER TENANT; a fleet of many small models
serializes many small walks.  Traversal cost is dominated by launches
and gathers, not node math, so packing more trees into one padded
``[T, nodes]`` walk is nearly free.  This module packs trees across
MODELS:

- `GroupRuntime` concatenates compatible tenants' ensembles into one
  SUPER-STACK (`ops.predict.stack_ensemble_group`) and scores a mixed
  batch in one walk.  The traversal is the ``costack_kernel`` dial:
  ``stacked`` walks every row through every stacked tree, ``segment``
  gathers only the row's own tenant's tree segment each level
  (`predict_ensemble_grouped_segment*`), and ``auto`` resolves per
  device type (`ops.predict.resolve_costack_kernel`).  Either way each
  tenant's sums run over exactly the trees, in the order, of its solo
  stack, so answers are bitwise per-tenant dispatch, and a per-row
  tenant-id gather demuxes them.
- The tenant id rides as ONE extra trailing buffer column (exact in
  f32 below 2^24; fits the uint8/uint16 binned buffer for up to
  ``MAX_GROUP_TENANTS`` members), so the PredictorRuntime machinery —
  row bucketing, padding, replica fleet, circuit breakers, entry cache,
  warmup — is inherited untouched: pad rows carry tenant 0 and are
  sliced off like any other pad row.
- Grouping policy: tenants co-stack when they share ``(num_class,
  serve_quantize variant, leaf-budget tier)`` (`costack_key`).  The
  leaf tier — next power of two of the widest tree — bounds padding
  waste: node records pad to the group's widest tree.
- A member hot swap RESTACKS its group (catalog._restack): a new
  GroupRuntime is built from the members' current runtimes, and when
  the program signature is unchanged (same stack shapes/dtypes, same
  segments, same transforms) the old group's prepared entries carry
  over to the new stacks with no rebuild (an entry takes the stacks at
  each call); otherwise only THIS group warms anew.

Output-kind semantics match solo serving per member: members whose
objective has a device transform get it applied in the program behind a
per-row tenant mask; members without one get raw rows and the host
``convert_output`` after demux.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import profiling, telemetry
from ..log import LightGBMError
from .runtime import (OUTPUT_KINDS, PredictorRuntime, _Replica,
                      _value_signature)

# the tenant-id column must fit the narrowest binned buffer dtype
# (uint8): ids 0..255.  Groups larger than this split into chunks.
MAX_GROUP_TENANTS = 256


def leaf_tier(runtime: PredictorRuntime) -> int:
    """Next power of two >= the widest tree's leaf capacity — the
    padding-waste bound of the grouping policy."""
    widest = 2
    for trees in runtime._trees_by_class:
        for t in trees:
            widest = max(widest, int(t.max_leaves))
    tier = 2
    while tier < widest:
        tier <<= 1
    return tier


def costack_key(runtime: PredictorRuntime) -> Tuple[int, str, int]:
    """The compatibility key of the grouping policy: tenants co-stack
    iff they agree on (num_class, kernel variant, leaf tier)."""
    return (runtime.K, runtime.variant, leaf_tier(runtime))


def group_id_for(key: Tuple[int, str, int], chunk: int = 0) -> str:
    """Stable display id for a group — used as the ``group`` label of
    the ``lgbt_serve_group_*`` series and in /stats.  Starts with
    ``~`` (outside MODEL_ID_RE's charset) so it can never collide with
    a tenant id."""
    k, variant, tier = key
    base = f"~g.k{k}.{variant}.l{tier}"
    return base if chunk == 0 else f"{base}.{chunk}"


def _quantizer_signature(q) -> Optional[tuple]:
    """Content identity of a member's frozen ingress mapper set
    (quantize.FeatureQuantizer): two binned members share ingress
    quantization iff their signatures match — the same-refbin
    condition of the shared ingress quantizer.  Hashes the mapper
    TABLES, not the sidecar path, so two publishes of one refbin (or
    byte-identical copies) still dedup."""
    if q is None:
        return None
    import hashlib
    h = hashlib.sha1()
    h.update(np.asarray(q.used_features, np.int64).tobytes())
    for isnum, tbl in zip(q._numeric, q._tables):
        if isnum:
            h.update(b"n")
            h.update(np.ascontiguousarray(tbl).tobytes())
        else:
            cats, bins = tbl
            h.update(b"c")
            h.update(np.ascontiguousarray(cats).tobytes())
            h.update(np.ascontiguousarray(bins).tobytes())
    return (q.num_total_features, q.num_columns, str(np.dtype(q.dtype)),
            int(q.missing_bin), h.hexdigest())


class GroupRuntime(PredictorRuntime):
    """One prepared entry a (bucket, kind) serving N co-stacked tenants.

    Built FROM the members' solo runtimes (the catalog keeps those for
    shadow scoring and fallback; under co-stacking they are built
    unwarmed, so they hold stacks but no entries).  Inherits the whole
    replica/breaker/cache/warmup machinery from PredictorRuntime and
    overrides only the program body and the prediction entry point
    (`predict_mixed` — `predict` refuses, a group has no single-tenant
    interpretation).
    """

    def __init__(self, member_ids: Sequence[str],
                 runtimes: Sequence[PredictorRuntime], *,
                 group_id: str, generation: int = 1, replicas: int = 0,
                 failure_threshold: int = 3,
                 probe_after: Optional[int] = None,
                 costack_kernel: str = "auto",
                 costack_segment_trees: int = 0):
        from ..ops.predict import (resolve_costack_kernel,
                                   stack_ensemble_group)
        if len(member_ids) != len(runtimes) or not runtimes:
            raise LightGBMError("GroupRuntime needs aligned, non-empty "
                                "member ids and runtimes")
        if len(runtimes) > MAX_GROUP_TENANTS:
            raise LightGBMError(
                f"co-stack group exceeds {MAX_GROUP_TENANTS} tenants "
                "(the tenant-id buffer column is uint8-representable)")
        base = runtimes[0]
        for rt in runtimes[1:]:
            if rt.K != base.K:
                raise LightGBMError("co-stacked tenants must share "
                                    f"num_class ({rt.K} != {base.K})")
            if rt.variant != base.variant:
                raise LightGBMError("co-stacked tenants must share the "
                                    "serve_quantize variant "
                                    f"({rt.variant!r} != {base.variant!r})")
        self.member_ids: List[str] = list(member_ids)
        self.member_index: Dict[str, int] = {
            mid: g for g, mid in enumerate(self.member_ids)}
        self.members: List[PredictorRuntime] = list(runtimes)
        self.model_id = group_id
        self.generation = generation
        self.K = base.K
        self.variant = base.variant
        self.max_batch_rows = base.max_batch_rows
        self.min_bucket_rows = base.min_bucket_rows
        self.predict_kernel = "tensorized"
        self.device_type = base.device_type
        # per-member output handling: the group program has no single
        # objective; members convert on the host after demux when their
        # solo runtime would (predict_mixed)
        self.objective = None
        self._quantizer = None          # per-member quantizers instead
        binned = self.variant == "binned"
        stack, gmeta = stack_ensemble_group(
            [rt._trees_by_class for rt in runtimes], binned=binned)
        self._gmeta = gmeta
        self._meta = None
        # grouped-traversal strategy, resolved ONCE per group build (the
        # dial is fleet-wide; the resolved value is part of the program
        # signature so a transplant can never cross segment<->stacked)
        self.costack_kernel = resolve_costack_kernel(
            costack_kernel, total_trees=int(gmeta.segments[-1][1]),
            segment_trees=int(costack_segment_trees),
            device_type=self.device_type)
        # the shared request buffer: every member's data columns padded
        # to the group-wide max, plus ONE trailing tenant-id column.  A
        # member's trees never gather beyond its own columns, and
        # wrong-tenant trees' gathers are discarded by the segment
        # demux, so zero-padding is routing-neutral.
        if binned:
            self._data_cols = max(rt._buf_cols for rt in runtimes)
            self._buf_dtype = (np.uint16 if any(
                np.dtype(rt._buf_dtype) == np.uint16 for rt in runtimes)
                else np.uint8)
        else:
            self._data_cols = max(rt.num_features for rt in runtimes)
            self._buf_dtype = np.float32
        self._buf_cols = self._data_cols + 1
        self.num_features = self._data_cols
        self._member_values = [rt._device_value for rt in runtimes]
        # non-None iff ANY member fuses a device transform — drives the
        # inherited _run_kind: with none, "value" shares the raw program
        # and every member converts on the host, exactly like solo
        self._device_value = next(
            (v for v in self._member_values if v is not None), None)
        # shared ingress quantizer: when every binned
        # member froze the SAME mapper set (same-refbin publish) with
        # the same feature-count contract, a mixed batch quantizes ONCE
        # against it instead of once per member job
        # (serve/group_quantize_shared counts the deduped rows)
        self._shared_quantizer = None
        if binned and len({rt.num_features for rt in runtimes}) == 1:
            sigs = {_quantizer_signature(rt._quantizer)
                    for rt in runtimes}
            if len(sigs) == 1 and None not in sigs:
                self._shared_quantizer = runtimes[0]._quantizer
        # hashable program identity for entry transplants across
        # restacks (adopt_cache_from)
        self._signature = (
            self.variant, self.costack_kernel,
            str(np.dtype(self._buf_dtype)), self._buf_cols,
            self._gmeta, tuple(_value_signature(rt) for rt in runtimes),
            self.K, self.min_bucket_rows, self.max_batch_rows,
            tuple((tuple(a.shape), str(a.dtype)) for a in stack),
        )
        self._init_fleet(stack, replicas, failure_threshold, probe_after)

    # -- program ---------------------------------------------------------

    def _program(self, kind: str):
        import torch

        from ..ops.predict import (
            predict_ensemble_grouped, predict_ensemble_grouped_binned,
            predict_ensemble_grouped_segment,
            predict_ensemble_grouped_segment_binned)
        meta = self._gmeta
        binned = self.variant == "binned"
        if self.costack_kernel == "segment":
            kernel = (predict_ensemble_grouped_segment_binned if binned
                      else predict_ensemble_grouped_segment)
        else:
            kernel = (predict_ensemble_grouped_binned if binned
                      else predict_ensemble_grouped)
        transforms = ([(g, v) for g, v in enumerate(self._member_values)
                       if v is not None] if kind == "value" else [])

        def fn(stacks, Xt):
            X = Xt[:, :-1]
            tids = Xt[:, -1].to(torch.int64)
            raw = kernel(stacks, X, tids, meta=meta)
            if transforms:
                # per-member transforms behind a row mask: the transform
                # is elementwise, so the selected rows carry exactly the
                # values the member's solo program computes
                out = raw
                for g, tf in transforms:
                    out = torch.where((tids == g)[None, :], tf(raw), out)
                return out
            return raw
        return fn

    def _build(self, replica: _Replica, bucket: int, kind: str):
        compiled = super()._build(replica, bucket, kind)
        profiling.count(profiling.SERVE_GROUP_COMPILES)
        profiling.count(profiling.labeled(profiling.SERVE_GROUP_COMPILES,
                                          group=self.model_id))
        return compiled

    # -- restack transplant ----------------------------------------------

    def program_signature(self):
        return self._signature

    # -- prediction ------------------------------------------------------

    def predict(self, X, kind: str = "value"):
        raise LightGBMError(
            "GroupRuntime serves mixed batches via predict_mixed(jobs); "
            "single-tenant predict has no tenant id to route by")

    def _validate_member_rows(self, g: int, X: np.ndarray) -> np.ndarray:
        """One member's request rows validated against the MEMBER's
        width contract (solo semantics: wider trims, narrower errors)
        — float64, 2-D, contiguous; quantization not yet applied."""
        rt = self.members[g]
        X = np.ascontiguousarray(np.asarray(X, np.float64))
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.shape[1] > rt.num_features:
            X = np.ascontiguousarray(X[:, :rt.num_features])
        elif X.shape[1] < rt.num_features:
            raise LightGBMError(
                f"request has {X.shape[1]} features, model "
                f"{self.member_ids[g]!r} expects {rt.num_features}")
        return X

    def _prep_member_rows(self, g: int, X: np.ndarray) -> np.ndarray:
        """One member's request rows → group-buffer rows: validate the
        width, quantize with the member's OWN quantizer under the
        binned variant (the mixed-mapper path — same-refbin groups
        quantize once in `_mux_jobs` instead), zero-pad to the group
        data columns, stamp the tenant id into the trailing column."""
        rt = self.members[g]
        X = self._validate_member_rows(g, X)
        if rt._quantizer is not None:
            X = rt._quantizer.quantize(X)
            profiling.count(profiling.SERVE_QUANTIZE_BYTES_IN, X.nbytes)
        buf = np.zeros((X.shape[0], self._buf_cols), self._buf_dtype)
        buf[:, :X.shape[1]] = X
        buf[:, -1] = g
        return buf

    def _mux_jobs(self, jobs: Sequence[Tuple[int, np.ndarray]]
                  ) -> Tuple[Optional[np.ndarray], List[int]]:
        """Mixed jobs → (the [total, buf_cols] group buffer, per-job row
        counts); the buffer is None on an all-empty batch.  With a
        shared ingress quantizer (same-refbin binned group) the WHOLE
        mixed batch quantizes in ONE pass against the common mapper set
        instead of once per member job — pure host-CPU dedup, the bin
        ids are identical by construction (one quantizer, same rows)."""
        if self._shared_quantizer is None:
            bufs = [self._prep_member_rows(g, X) for g, X in jobs]
            counts = [b.shape[0] for b in bufs]
            if sum(counts) == 0:
                return None, counts
            return (bufs[0] if len(bufs) == 1
                    else np.concatenate(bufs, axis=0)), counts
        raws = [self._validate_member_rows(g, X) for g, X in jobs]
        counts = [r.shape[0] for r in raws]
        total = int(sum(counts))
        if total == 0:
            return None, counts
        Xcat = raws[0] if len(raws) == 1 else np.concatenate(raws, axis=0)
        q = self._shared_quantizer.quantize(Xcat)
        profiling.count(profiling.SERVE_QUANTIZE_BYTES_IN, q.nbytes)
        profiling.count(profiling.SERVE_GROUP_QUANTIZE_SHARED, total)
        profiling.count(profiling.labeled(
            profiling.SERVE_GROUP_QUANTIZE_SHARED,
            group=self.model_id), total)
        Xt = np.zeros((total, self._buf_cols), self._buf_dtype)
        Xt[:, :q.shape[1]] = q
        off = 0
        for (g, _X), n in zip(jobs, counts):
            Xt[off:off + n, -1] = g
            off += n
        return Xt, counts

    def predict_mixed(self, jobs: Sequence[Tuple[int, np.ndarray]],
                      kind: str = "value") -> List[np.ndarray]:
        """Score a mixed batch — ``jobs`` is ``[(member index, X)]``,
        one entry per request — in as few launches as the row count
        needs (one, below ``max_batch_rows``).  Returns one array per
        job in Booster.predict shapes, bitwise-identical to routing
        each job through its tenant's solo runtime."""
        if kind not in OUTPUT_KINDS:
            raise ValueError(
                f"unknown output kind {kind!r}; use one of {OUTPUT_KINDS}")
        Xt, counts = self._mux_jobs(jobs)
        total = int(sum(counts))
        if Xt is None:
            empty = np.zeros(0) if self.K == 1 else np.zeros((0, self.K))
            return [empty.copy() for _ in jobs]
        if self.variant == "binned":
            profiling.count(profiling.SERVE_BINNED_REQUESTS)
        run_kind = self._run_kind(kind)
        starts = range(0, total, self.max_batch_rows)
        with profiling.phase("serve/execute", force=True):
            if len(starts) == 1 or self._fanout is None:
                parts = [self._predict_chunk(Xt[a:a + self.max_batch_rows],
                                             run_kind)
                         for a in starts]
            else:
                ctx = telemetry.current()
                parts = list(self._fanout.map(
                    lambda a: telemetry.call_in_context(
                        ctx, self._predict_chunk,
                        Xt[a:a + self.max_batch_rows], run_kind),
                    starts))
        raw = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
        outs: List[np.ndarray] = []
        off = 0
        for (g, _X), n in zip(jobs, counts):
            seg = raw[:, off:off + n]
            off += n
            out = seg[0] if self.K == 1 else seg.T
            rt = self.members[g]
            if (kind == "value" and self._member_values[g] is None
                    and rt.objective is not None):
                # this member's rows came out of the program raw (no
                # fused transform) — the solo host-side conversion
                out = rt.objective.convert_output(out)
            outs.append(out)
        profiling.count("serve.rows", total)
        # per-group demux row accounting by RESOLVED traversal kernel
        # (/stats groups block, /metrics, bench_serve_mt's A/B proof)
        rows_name = (profiling.SERVE_GROUP_SEGMENT_ROWS
                     if self.costack_kernel == "segment"
                     else profiling.SERVE_GROUP_STACKED_ROWS)
        profiling.count(rows_name, total)
        profiling.count(profiling.labeled(rows_name, group=self.model_id),
                        total)
        return outs
