"""Keyed model catalog: N independent tenants on one serving fleet.

Port of lightgbm_tpu/serving/catalog.py (unchanged apart from the
imports; "executable" there is the runtime's prepared entry here).  The
reference C API serves any number of independent Booster handles
per process (``LGBM_BoosterCreate`` — one handle per model); a
single-model server holds ONE hot-swapped model generation.  Production
is neither: dozens of models (per country, per surface, A/B arms) share a
fleet, each with its own SLO, publish cadence, and failure domain.  The
catalog generalizes `ModelRegistry`/`PredictorRuntime` from one
generation to N tenants:

- **Keyed routing** — every tenant id maps to its own `ModelRegistry`
  (atomic hot-swap, shadow canary, replica breakers) and an admission
  queue.  `/predict` routes by the ``model`` body field / query param /
  ``X-Model-Id`` header; requests that name no model go to the DEFAULT
  tenant, which preserves the single-model contract bitwise.
- **Cross-model co-stacking** (serving/superstack.py) — tenants that
  share ``(num_class, serve_quantize variant, leaf tier)`` are packed
  into ONE super-stack scored by ONE compiled executable per (bucket,
  kind): a mixed batch of many tenants' requests costs one launch
  instead of one per tenant, bitwise-identical to per-tenant dispatch.
  Groups share a MicroBatcher (admission and accounting stay per
  tenant); incompatible tenants, per-tenant ``replicas``/
  ``costack=off`` overrides, and tenants with no same-key peer serve
  solo exactly as before.  A member hot swap RESTACKS only its group —
  same-shape republishes transplant the compiled executables with zero
  rebuilds, and other groups' warm caches are never touched.
- **Isolation by construction** — per-tenant registries, admission
  budgets, breakers, and (per group or solo tenant) executable caches
  mean a torn publish or a broken replica on tenant A cannot change a
  single bit of tenant B's answers, nor put a compile on B's request
  path (tests/test_catalog.py chaos suite, tests/test_costack.py).
- **LRU executable budget** (``serve_cache_budget_mb``) — compiled
  executables are the device-memory cost that scales with tenants x
  buckets x kinds; the catalog sums estimated executable bytes per
  EVICTION UNIT (a co-stack group, or a solo tenant) and, beyond the
  budget, evicts the least-recently-used units' caches (never the
  most recently used one).  A group evicts COHERENTLY — its one
  shared cache serves every member, so per-member eviction would be
  meaningless.  An evicted unit keeps serving — its next request
  rebuilds, counted as churn through ``serve/cache_evictions``.
  0 = unlimited, and the single-tenant path never evicts.
- **Per-model accounting** — requests/rows/rejections/latency
  percentiles/queue depth per tenant ride the `profiling.labeled`
  series (``lgbt_serve_requests_total{model="..."}`` at /metrics) and
  the server's ``/stats`` ``models`` block — co-stacked batches are
  demuxed back to the ORIGINATING tenant before any series is
  charged.  Groups get their own ``lgbt_serve_group_*`` series.

One `OnlineTrainer` per tenant (online/trainer.py `OnlineFleet`)
shares the labeled-traffic tail — rows are keyed by the same model
ids, each daemon publishes to its tenant's model path, and the
catalog's per-tenant polls pick the publishes up — so trace ids still
reconstruct any single tenant's serve→train→serve loop.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Tuple

from .. import log, profiling
from ..config import MODEL_ID_RE
from ..diagnostics import locksan
from ..log import LightGBMError
from .batcher import MicroBatcher
from .registry import ModelRegistry
from .runtime import OUTPUT_KINDS
from .superstack import (MAX_GROUP_TENANTS, GroupRuntime, costack_key,
                         group_id_for)

DEFAULT_MODEL_ID = "default"


class UnknownModelError(LightGBMError):
    """Request named a model id the catalog does not serve (HTTP 404)."""


class _Tenant:
    """One tenant's serving column: registry + batcher + LRU tick.
    ``batcher`` is the tenant's OWN MicroBatcher when solo, or its
    GROUP's shared one when co-stacked (``group`` is then set)."""
    __slots__ = ("model_id", "registry", "batcher", "last_used", "group")

    def __init__(self, model_id: str, registry: ModelRegistry,
                 batcher: Optional[MicroBatcher] = None):
        self.model_id = model_id
        self.registry = registry
        self.batcher = batcher
        self.last_used = 0
        self.group: Optional[_Group] = None


class _Group:
    """One co-stack group: the shared GroupRuntime + MicroBatcher and
    the member bookkeeping the restack path needs.  Doubles as the
    batcher's runtime source (`current`) and per-member shadow relay
    (`shadow_member`)."""
    __slots__ = ("group_id", "key", "member_ids", "registries",
                 "runtime", "batcher", "gen_vector", "restacks")

    def __init__(self, group_id: str, key, member_ids: List[str],
                 registries: Dict[str, ModelRegistry],
                 runtime: GroupRuntime):
        self.group_id = group_id
        self.key = key
        self.member_ids = list(member_ids)
        self.registries = dict(registries)
        self.runtime = runtime
        self.batcher: Optional[MicroBatcher] = None
        self.gen_vector: Tuple[int, ...] = tuple(
            registries[mid].generation for mid in member_ids)
        self.restacks = 0

    def current(self) -> GroupRuntime:
        """The batcher's runtime pin — one atomic reference read, same
        contract as ModelRegistry.current()."""
        return self.runtime

    def shadow_member(self, model_id: str, X, kind: str, preds,
                      requests: int = 1) -> None:
        """Relay one member's demuxed rows to ITS registry's shadow
        canary — each tenant's candidate only ever sees (and is judged
        on) its own traffic."""
        reg = self.registries.get(model_id)
        if reg is not None:
            reg.maybe_shadow(X, kind, preds, requests=requests)

    def cache_bytes(self) -> int:
        """The group UNIT's executable bytes: the shared super-stack
        cache plus every member's staged shadow candidate (members'
        stable solo runtimes hold no executables under co-stacking,
        and registry.cache_bytes counts both)."""
        return (self.runtime.cache_bytes()
                + sum(reg.cache_bytes() for reg in self.registries.values()))

    def evict_executables(self) -> int:
        """Coherent whole-group eviction (the catalog's LRU): the one
        shared cache serves every member, so the group evicts as a
        unit — plus any members' staged candidates."""
        n = self.runtime.evict_executables()
        for reg in self.registries.values():
            n += reg.evict_executables()
        return n


class ModelCatalog:
    """Keyed (model id → registry/batcher) serving catalog.

    ``models`` is an ordered ``{id: model path}`` or ``{id: (path,
    overrides)}`` mapping (config.parse_serve_models output).  Registry
    and batcher knobs are fleet-wide unless a tenant's entry overrides
    ``replicas``, ``serve_quantize``, ``max_pending_rows``, or
    ``costack`` (docs/serving.md "Cross-model batching");
    ``max_pending_rows`` always applies PER TENANT (it is an admission
    budget, so a hot tenant sheds its own load), and a co-stack group's
    replica fleet sizes to the MAX of its members' ``replicas``
    overrides (`_group_replicas`).
    """

    def __init__(self, models: Dict[str, object],
                 params: Optional[dict] = None, *,
                 default_id: Optional[str] = None,
                 cache_budget_mb: int = 0,
                 num_iteration: int = -1, max_batch_rows: int = 4096,
                 min_bucket_rows: int = 16,
                 flush_deadline_ms: float = 5.0,
                 max_pending_rows: int = 0,
                 predict_kernel: Optional[str] = None, replicas: int = 0,
                 failure_threshold: int = 3,
                 serve_quantize: str = "auto",
                 shadow_fraction: float = 0.0,
                 shadow_requests: int = 32,
                 shadow_max_divergence: float = -1.0,
                 warmup_buckets=(1,),
                 costack: bool = True,
                 costack_kernel: str = "auto",
                 costack_segment_trees: int = 0):
        if not models:
            raise LightGBMError("ModelCatalog needs at least one "
                                "model id=path entry")
        entries = {mid: _normalize_entry(mid, spec)
                   for mid, spec in models.items()}
        for mid in entries:
            if not MODEL_ID_RE.match(str(mid)):
                raise LightGBMError(
                    f"model id {mid!r} must match [A-Za-z0-9._-]{{1,64}}")
        default_id = (default_id if default_id is not None
                      else next(iter(entries)))
        if default_id not in entries:
            raise LightGBMError(
                f"default model id {default_id!r} is not in the "
                f"catalog ({sorted(entries)})")
        self._init_base(default_id, cache_budget_mb)
        self._replicas = replicas
        self._failure_threshold = failure_threshold
        self._max_batch_rows = max_batch_rows
        self._flush_deadline_ms = flush_deadline_ms
        self._max_pending_rows = max_pending_rows
        self._warmup_buckets = tuple(warmup_buckets)
        self._costack = bool(costack)
        self._costack_kernel = str(costack_kernel)
        self._costack_segment_trees = int(costack_segment_trees or 0)
        solo_forced: Dict[str, bool] = {}
        caps: Dict[str, int] = {}
        for mid, (path, ov) in entries.items():
            # per-tenant overrides: costack=off opts out of grouping; a
            # replicas override rides its group (the group fleet sizes
            # to the members' max — _group_replicas) AND sizes the
            # tenant's solo runtime for fallback
            t_replicas = int(ov.get("replicas", replicas))
            if "replicas" in ov:
                self._replica_ov[mid] = t_replicas
            solo_forced[mid] = not ov.get("costack", True)
            caps[mid] = int(ov.get("max_pending_rows", max_pending_rows))
            registry = ModelRegistry(
                path, params=params, num_iteration=num_iteration,
                max_batch_rows=max_batch_rows,
                min_bucket_rows=min_bucket_rows,
                predict_kernel=predict_kernel, replicas=t_replicas,
                failure_threshold=failure_threshold,
                serve_quantize=str(ov.get("serve_quantize",
                                          serve_quantize)),
                model_id=mid,
                shadow_fraction=shadow_fraction,
                shadow_requests=shadow_requests,
                shadow_max_divergence=shadow_max_divergence,
                warmup_buckets=warmup_buckets,
                # warm NOTHING yet: grouped tenants must never compile
                # solo executables (the group warms instead), and which
                # tenants group is only known once every model is
                # loaded — solo tenants warm explicitly below
                warm_initial=False)
            self._tenants[mid] = _Tenant(mid, registry)
        self._caps = caps
        self._form_groups(solo_forced)
        for tenant in self._tenants.values():
            if tenant.group is not None:
                continue
            rt = tenant.registry.current()
            rt.warmup(self._warmup_buckets, tenant.registry.warmup_kinds)
            tenant.batcher = MicroBatcher(
                tenant.registry, max_batch_rows=max_batch_rows,
                flush_deadline_ms=flush_deadline_ms,
                workers=getattr(rt, "replica_count", 1),
                max_pending_rows=caps[tenant.model_id],
                model_id=tenant.model_id)
        log.info(f"model catalog serving {len(self._tenants)} tenants "
                 f"({', '.join(self._tenants)}; default "
                 f"{self.default_id!r}"
                 + (f"; {len(self._groups)} co-stack groups"
                    if self._groups else "")
                 + (f", cache budget {self.cache_budget_mb} MiB"
                    if self.cache_budget_mb else "") + ")")
        self.enforce_budget()                # construction already warms

    def _init_base(self, default_id: str, cache_budget_mb: int) -> None:
        """Every non-tenant attribute of a catalog, in ONE place —
        `__init__` and the `from_registry` shim both build on this, so
        an attribute added here can never be missing on the shim
        path."""
        self.default_id = default_id
        self.cache_budget_mb = max(0, int(cache_budget_mb))
        self._lock = locksan.lock("serve.catalog")   # LRU ticks + eviction scan
        self._tick = itertools.count(1)
        self._miss_mark = -1                 # submit-path dirty check
        self._tenants: Dict[str, _Tenant] = {}
        self._groups: Dict[str, _Group] = {}
        self._costack = False                # overridden by __init__;
        self._costack_kernel = "auto"        # shim defaults otherwise
        self._costack_segment_trees = 0
        self._costack_opt_out: set = set()
        self._replica_ov: Dict[str, int] = {}

    # -- co-stack grouping ----------------------------------------------

    def _form_groups(self, solo_forced: Dict[str, bool]) -> None:
        """Partition tenants into co-stack groups by compatibility key
        (superstack.costack_key); singletons and opted-out tenants stay
        solo.  Runs once at construction — membership is stable until a
        member republish breaks compatibility (_restack drops it)."""
        self._costack_opt_out = {mid for mid, forced in solo_forced.items()
                                 if forced}
        if not self._costack:
            return
        by_key: Dict[tuple, List[str]] = {}
        for mid, tenant in self._tenants.items():
            if solo_forced.get(mid):
                continue
            key = costack_key(tenant.registry.current())
            by_key.setdefault(key, []).append(mid)
        for key, mids in by_key.items():
            if len(mids) < 2:
                continue
            for chunk_no, at in enumerate(range(0, len(mids),
                                                MAX_GROUP_TENANTS)):
                members = mids[at:at + MAX_GROUP_TENANTS]
                if len(members) < 2:
                    break                    # a trailing singleton: solo
                self._build_group(key, members, chunk_no)

    def _group_replicas(self, member_ids: List[str]) -> int:
        """A group's replica fleet size: the MAX of its members'
        per-tenant ``replicas`` overrides (the hottest member sizes the
        shared fleet — every member rides it), the fleet-wide
        ``serve_replicas`` when no member overrides."""
        ov = [self._replica_ov[mid] for mid in member_ids
              if mid in self._replica_ov]
        return max(ov) if ov else self._replicas

    def _build_group(self, key, member_ids: List[str],
                     chunk_no: int = 0) -> None:
        gid = group_id_for(key, chunk_no)
        registries = {mid: self._tenants[mid].registry
                      for mid in member_ids}
        runtime = GroupRuntime(
            member_ids,
            [registries[mid].current() for mid in member_ids],
            group_id=gid, replicas=self._group_replicas(member_ids),
            failure_threshold=self._failure_threshold,
            costack_kernel=self._costack_kernel,
            costack_segment_trees=self._costack_segment_trees)
        runtime.warmup(self._warmup_buckets, OUTPUT_KINDS)
        group = _Group(gid, key, member_ids, registries, runtime)
        group.batcher = MicroBatcher(
            group, max_batch_rows=self._max_batch_rows,
            flush_deadline_ms=self._flush_deadline_ms,
            workers=getattr(runtime, "replica_count", 1),
            max_pending_rows=self._max_pending_rows,
            pending_caps={mid: self._caps.get(mid, self._max_pending_rows)
                          for mid in member_ids})
        self._groups[gid] = group
        for mid in member_ids:
            tenant = self._tenants[mid]
            tenant.group = group
            tenant.batcher = group.batcher
            tenant.registry.costacked = True
        log.info(f"co-stacked {len(member_ids)} tenants onto one "
                 f"executable group {gid} "
                 f"({', '.join(member_ids)})")

    @classmethod
    def from_registry(cls, registry: ModelRegistry, *,
                      model_id: str = DEFAULT_MODEL_ID,
                      max_batch_rows: int = 4096,
                      flush_deadline_ms: float = 5.0,
                      max_pending_rows: int = 0,
                      cache_budget_mb: int = 0) -> "ModelCatalog":
        """Wrap an ALREADY-BUILT registry as a one-tenant catalog — the
        back-compat shim behind ``PredictionServer(registry)``.  The
        single-model server keeps its pre-catalog behavior: same
        routing (everything lands on the one tenant), no eviction
        unless a budget is set, no co-stacking (a one-tenant group is
        pointless); the per-model labeled series simply ride along
        under the default id."""
        self = cls.__new__(cls)
        self._init_base(model_id, cache_budget_mb)
        if registry.model_id is None:
            registry.model_id = model_id
            rt = registry.current()
            if getattr(rt, "model_id", None) is None:
                rt.model_id = model_id
        batcher = MicroBatcher(
            registry, max_batch_rows=max_batch_rows,
            flush_deadline_ms=flush_deadline_ms,
            workers=getattr(registry.current(), "replica_count", 1),
            max_pending_rows=max_pending_rows,
            model_id=registry.model_id)
        self._tenants[model_id] = _Tenant(model_id, registry, batcher)
        return self

    # -- lookup / routing ----------------------------------------------

    def ids(self) -> List[str]:
        return list(self._tenants)

    def get(self, model_id: Optional[str] = None) -> _Tenant:
        """The tenant for a request's model id (None = default)."""
        mid = self.default_id if model_id is None else model_id
        tenant = self._tenants.get(mid)
        if tenant is None:
            raise UnknownModelError(
                f"unknown model {mid!r}; this catalog serves "
                f"{sorted(self._tenants)}")
        return tenant

    def default(self) -> _Tenant:
        return self._tenants[self.default_id]

    def submit(self, X, kind: str = "value",
               model_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               parent_id: Optional[str] = None):
        """Route one request: touch the tenant's LRU tick, enqueue on
        its (own or group-shared) batcher, keep the executable budget
        honored.  Returns the (tenant, future) pair — the caller reads
        the scoring generation off the future like before."""
        tenant = self.get(model_id)
        with self._lock:
            tenant.last_used = next(self._tick)
        if tenant.group is not None:
            fut = tenant.batcher.submit(X, kind=kind, trace_id=trace_id,
                                        parent_id=parent_id,
                                        model_id=tenant.model_id)
        else:
            fut = tenant.batcher.submit(X, kind=kind, trace_id=trace_id,
                                        parent_id=parent_id)
        if self.cache_budget_mb:
            # cheap dirty check on the hot path: cache totals only
            # move when something COMPILED, so the O(units) byte
            # scan (one lock per runtime) runs only after a cache
            # miss somewhere, not on every request
            marks = sum(rt.cache_misses for rt in self._scoring_runtimes())
            if marks != self._miss_mark:
                self._miss_mark = marks
                self.enforce_budget()
        return tenant, fut

    def _scoring_runtimes(self) -> List:
        """Every runtime that can COMPILE on the request path: group
        runtimes plus solo tenants' current runtimes."""
        out: List = [g.runtime for g in self._groups.values()]
        out.extend(t.registry.current() for t in self._tenants.values()
                   if t.group is None)
        return out

    # -- LRU executable budget -----------------------------------------

    def _units(self) -> List[tuple]:
        """(last_used, name, unit) eviction units: each co-stack group
        (coherent — one shared cache serves every member) and each solo
        tenant.  A group's recency is its most recently used member's."""
        units: List[tuple] = []
        grouped = set()
        for gid, group in self._groups.items():
            last = max((self._tenants[mid].last_used
                        for mid in group.member_ids), default=0)
            units.append((last, gid, group))
            grouped.update(group.member_ids)
        for mid, tenant in self._tenants.items():
            if mid not in grouped:
                units.append((tenant.last_used, mid, tenant.registry))
        return units

    def cache_bytes(self) -> Dict[str, int]:
        """Estimated executable bytes per eviction unit (group id or
        solo tenant id; stable runtime plus any staged shadow
        candidates)."""
        return {name: unit.cache_bytes()
                for _last, name, unit in self._units()}

    def enforce_budget(self) -> int:
        """Evict least-recently-used units' executable caches until
        the total fits ``serve_cache_budget_mb``.  The most recently
        used unit is NEVER evicted (a budget smaller than one unit's
        working set degrades to single-unit residency, not
        thrash-to-zero).  Co-stack groups evict whole (their one cache
        serves every member); staged shadow candidates count toward —
        and evict with — their unit.  Returns executables evicted."""
        if not self.cache_budget_mb:
            return 0
        budget = self.cache_budget_mb << 20
        with self._lock:
            order = sorted(self._units(), key=lambda u: u[0])  # LRU first
        total = sum(unit.cache_bytes() for _l, _n, unit in order)
        evicted = 0
        for _last, _name, unit in order[:-1]:  # MRU unit is protected
            if total <= budget:
                break
            if unit.cache_bytes() <= 0:
                continue
            evicted += unit.evict_executables()
            # recompute rather than subtract an estimate: eviction
            # frees exactly what the caches now report as gone
            total = sum(u.cache_bytes() for _l, _n, u in order)
        if total > budget and evicted:
            log.info(f"serve cache budget: still {total >> 20} MiB "
                     f"after eviction (budget {self.cache_budget_mb} "
                     "MiB covers less than the hottest unit)")
        return evicted

    # -- polling / swap -------------------------------------------------

    def poll_once(self) -> int:
        """Poll every tenant's model path; returns swaps landed.  A
        swap (or a shadow adoption since the last tick) on a co-stacked
        tenant shows up as a generation-vector change on its group and
        triggers a RESTACK of that group only.  Runs budget enforcement
        afterwards — a freshly warmed generation is exactly when totals
        can jump."""
        swaps = 0
        for tenant in self._tenants.values():
            try:
                if tenant.registry.poll_once():
                    swaps += 1
            except Exception as e:   # one tenant's poll failure must
                # not starve the others' reloads
                log.warning(f"model poll failed for "
                            f"{tenant.model_id}: {e}")
        for group in list(self._groups.values()):
            vector = tuple(group.registries[mid].generation
                           for mid in group.member_ids)
            if vector != group.gen_vector:
                try:
                    self._restack(group)
                except Exception as e:
                    log.warning(f"co-stack restack failed for "
                                f"{group.group_id}: {e}; the previous "
                                "super-stack keeps serving")
        if self.cache_budget_mb:
            self.enforce_budget()
        return swaps

    def _drop_to_solo(self, model_id: str) -> None:
        """Demote one tenant from its group to a solo serving column
        (its republish broke group compatibility): warm its solo
        runtime and give it its own batcher.  In-flight group requests
        for it fail fast with a retryable error."""
        tenant = self._tenants[model_id]
        reg = tenant.registry
        reg.costacked = False
        tenant.group = None
        rt = reg.current()
        rt.warmup(self._warmup_buckets, reg.warmup_kinds)
        tenant.batcher = MicroBatcher(
            reg, max_batch_rows=self._max_batch_rows,
            flush_deadline_ms=self._flush_deadline_ms,
            workers=getattr(rt, "replica_count", 1),
            max_pending_rows=self._caps.get(model_id,
                                            self._max_pending_rows),
            model_id=model_id)
        log.info(f"tenant {model_id} left its co-stack group "
                 "(republish changed its compatibility key); now solo")

    def _restack(self, group: _Group) -> None:
        """Rebuild one group's super-stack from its members' CURRENT
        runtimes after a member hot swap.  Members whose republish
        broke the compatibility key (num_class or kernel variant
        changed) drop to solo; the rest restack.  When the program
        signature is unchanged (the common refit republish) the old
        executables transplant — zero compiles; otherwise only THIS
        group warms.  Other groups are never touched."""
        stay: List[str] = []
        for mid in group.member_ids:
            rt = group.registries[mid].current()
            if rt.K == group.key[0] and rt.variant == group.key[1]:
                stay.append(mid)
            else:
                self._drop_to_solo(mid)
        old = group.runtime
        if len(stay) < 2:
            # the group dissolved: remaining members go solo too
            for mid in stay:
                self._drop_to_solo(mid)
            del self._groups[group.group_id]
            batcher = group.batcher
            if batcher is not None:
                threading.Thread(target=batcher.close, daemon=True,
                                 name="lgbt-serve-group-drain").start()
            log.info(f"co-stack group {group.group_id} dissolved")
            return
        group.member_ids = stay
        group.registries = {mid: self._tenants[mid].registry
                            for mid in stay}
        runtime = GroupRuntime(
            stay, [group.registries[mid].current() for mid in stay],
            group_id=group.group_id, generation=old.generation + 1,
            replicas=self._group_replicas(stay),
            failure_threshold=self._failure_threshold,
            costack_kernel=self._costack_kernel,
            costack_segment_trees=self._costack_segment_trees)
        if not runtime.adopt_cache_from(old):
            # program changed (tree shapes, transforms, membership):
            # warm every bucket/kind the outgoing group served before
            # going live, so no member's request compiles on the
            # request path
            buckets = ({b for b, _k in old.buckets_compiled()}
                       or set(self._warmup_buckets))
            kinds = ({k for _b, k in old.buckets_compiled()}
                     | set(OUTPUT_KINDS))
            runtime.warmup(sorted(buckets), sorted(kinds))
        group.runtime = runtime              # the atomic swap
        group.gen_vector = tuple(group.registries[mid].generation
                                 for mid in stay)
        group.restacks += 1
        if group.batcher is not None:
            group.batcher.pending_caps = {
                mid: self._caps.get(mid, self._max_pending_rows)
                for mid in stay}
        profiling.count(profiling.SERVE_GROUP_RESTACKS)
        profiling.count(profiling.labeled(profiling.SERVE_GROUP_RESTACKS,
                                          group=group.group_id))
        log.info(f"restacked co-stack group {group.group_id} "
                 f"({len(stay)} tenants, generation "
                 f"{runtime.generation})")

    def _mark_hup_all(self) -> None:
        for tenant in self._tenants.values():
            tenant.registry._hup_pending = True

    def force_reload_all(self) -> None:
        """SIGHUP semantics across the catalog: force-reload every
        tenant on this call (bypassing any pending shadow canaries —
        the registries' forced-reload escape hatch)."""
        self._mark_hup_all()
        self.poll_once()

    def install_sighup(self) -> bool:
        """SIGHUP → force-reload EVERY tenant (the shared serving
        SIGHUP convention — registry.install_sighup_handler).  Main
        thread only."""
        from .registry import install_sighup_handler
        return install_sighup_handler(self._mark_hup_all, self.poll_once)

    # -- stats ----------------------------------------------------------

    def tenant_stats(self) -> Dict[str, dict]:
        """The /stats ``models`` block: per-tenant SLO + fleet view."""
        out: Dict[str, dict] = {}
        for mid, t in self._tenants.items():
            reg = t.registry
            # the runtime actually SERVING this tenant's traffic: the
            # group's shared one when co-stacked, its solo one otherwise
            rt = t.group.runtime if t.group is not None else reg.current()
            labels = {"model": mid}
            grouped = t.group is not None
            out[mid] = {
                "generation": reg.generation,
                "model_path": reg.model_path,
                "default": mid == self.default_id,
                "group": t.group.group_id if grouped else None,
                "requests": profiling.counter_value(
                    profiling.labeled("serve.requests", **labels)),
                "rows": profiling.counter_value(
                    profiling.labeled("serve.rows", **labels)),
                "rejected": profiling.counter_value(
                    profiling.labeled("serve.rejected", **labels)),
                "latency_ms": profiling.summary(
                    profiling.labeled("serve.latency_ms", **labels)),
                "queue_depth": (t.batcher.pending_rows_for(mid) if grouped
                                else t.batcher.queue_depth),
                "pending_rows_cap": (t.batcher.cap_for(mid) if grouped
                                     else t.batcher.max_pending_rows),
                "batch_workers": t.batcher.workers,
                "swaps": reg.swaps,
                "swap_failures": reg.swap_failures,
                "last_swap_error": reg.last_swap_error,
                "shadow": reg.shadow_state(),
                "cache_bytes": (t.group.cache_bytes() if grouped
                                else reg.cache_bytes()),
                "evictions": profiling.counter_value(
                    profiling.labeled(profiling.SERVE_CACHE_EVICTIONS,
                                      **labels)),
                "replicas": {
                    "count": getattr(rt, "replica_count", 1),
                    "healthy": (rt.healthy_count()
                                if hasattr(rt, "healthy_count") else 1),
                },
                "serve_quantize": getattr(rt, "variant", "raw"),
            }
        return out

    def group_keys(self) -> Dict[str, str]:
        """Per-tenant co-stack compatibility key (the group-id base
        string) for every tenant that may group — the payload serving
        /healthz hands the router tier so its placement can co-locate
        same-key tenants onto one backend (co-stack-aware placement,
        docs/Router.md).  Tenants that opted out (``costack=off``) are
        omitted — they place by tenant id as before — as is everything
        when fleet-wide co-stacking is off."""
        out: Dict[str, str] = {}
        if not self._costack:
            return out
        for mid, t in self._tenants.items():
            if mid in self._costack_opt_out:
                continue
            out[mid] = group_id_for(costack_key(t.registry.current()))
        return out

    def group_stats(self) -> Dict[str, dict]:
        """The /stats ``groups`` block: per-group co-stack view."""
        out: Dict[str, dict] = {}
        for gid, group in self._groups.items():
            rt = group.runtime
            out[gid] = {
                "members": list(group.member_ids),
                "tenants": len(group.member_ids),
                "generation": rt.generation,
                "restacks": group.restacks,
                "compiles": profiling.counter_value(profiling.labeled(
                    profiling.SERVE_GROUP_COMPILES, group=gid)),
                "trees": int(rt._gmeta.segments[-1][1]),
                "depth": rt._gmeta.depth,
                "num_class": rt.K,
                "variant": rt.variant,
                "costack_kernel": rt.costack_kernel,
                "segment_rows": profiling.counter_value(profiling.labeled(
                    profiling.SERVE_GROUP_SEGMENT_ROWS, group=gid)),
                "stacked_rows": profiling.counter_value(profiling.labeled(
                    profiling.SERVE_GROUP_STACKED_ROWS, group=gid)),
                "quantize_shared_rows": profiling.counter_value(
                    profiling.labeled(
                        profiling.SERVE_GROUP_QUANTIZE_SHARED, group=gid)),
                "shared_quantizer": rt._shared_quantizer is not None,
                "cache_bytes": group.cache_bytes(),
                "queue_depth": (group.batcher.queue_depth
                                if group.batcher is not None else 0),
                "replicas": {
                    "count": rt.replica_count,
                    "healthy": rt.healthy_count(),
                },
            }
        return out

    def gauges(self) -> Dict[str, float]:
        """Per-model live gauges for /metrics (labeled series)."""
        g: Dict[str, float] = {}
        for mid, t in self._tenants.items():
            grouped = t.group is not None
            rt = t.group.runtime if grouped else t.registry.current()
            g[profiling.labeled("serve.model_generation", model=mid)] = (
                t.registry.generation)
            g[profiling.labeled("serve.queue_depth", model=mid)] = (
                t.batcher.pending_rows_for(mid) if grouped
                else t.batcher.queue_depth)
            g[profiling.labeled("serve.healthy_replicas", model=mid)] = (
                rt.healthy_count() if hasattr(rt, "healthy_count") else 1)
            g[profiling.labeled("serve.cache_bytes", model=mid)] = (
                t.group.cache_bytes() if grouped
                else t.registry.cache_bytes())
        for gid, group in self._groups.items():
            g[profiling.labeled("serve.group_tenants", group=gid)] = (
                len(group.member_ids))
            g[profiling.labeled("serve.group_cache_bytes", group=gid)] = (
                group.cache_bytes())
        g["serve.models"] = len(self._tenants)
        g["serve.groups"] = len(self._groups)
        g["serve.cache_budget_mb"] = self.cache_budget_mb
        return g

    # -- lifecycle ------------------------------------------------------

    def close(self) -> None:
        closed = set()
        for tenant in self._tenants.values():
            if tenant.batcher is not None and id(tenant.batcher) not in closed:
                closed.add(id(tenant.batcher))
                tenant.batcher.close()


def _normalize_entry(mid: str, spec) -> Tuple[str, dict]:
    """One catalog entry → (path, overrides).  Accepts a bare path
    string (the pre-override shape every existing caller passes), a
    (path, overrides) pair, or a config.ServeModelEntry."""
    # the overrides check must precede the plain-str one: a parsed
    # config.ServeModelEntry IS a str (the path) carrying overrides
    if hasattr(spec, "path") and hasattr(spec, "overrides"):
        return spec.path, dict(spec.overrides)
    if isinstance(spec, str):
        return spec, {}
    try:
        path, overrides = spec
        return str(path), dict(overrides)
    except (TypeError, ValueError):
        raise LightGBMError(
            f"catalog entry for {mid!r} must be a path or "
            f"(path, overrides), got {spec!r}")
