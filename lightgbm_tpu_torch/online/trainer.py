"""The online refresh daemon (the JAX package's `task=online`).

Port of lightgbm_tpu/online/trainer.py; the refits and the continued
boosting run on the booster's device.  It watches a labeled-traffic
JSONL file (the serving `/predict` log joined with labels — see
stream.py), bins each new chunk against FROZEN bin mappers into a
capacity-tiered streaming window, and when `online_trigger_rows` fresh
rows have accumulated, refreshes the model:

- ``online_mode=refit`` (default): reweight the existing tree
  structures' leaves on the window (refit.LeafRefitter, its rows routed
  on their raw values as they arrive);
- ``online_mode=continue``: continued boosting — reset_training_data
  replays the model onto the window's scores and `num_iterations` fresh
  trees are appended, through the training kernels.

Each refresh PUBLISHES a new model generation atomically (tmp +
os.replace) to `output_model` — the path a serving ModelRegistry polls
— plus a ``<output_model>.meta.json`` sidecar (generation, mode, rows,
timestamps) that the server surfaces at `/stats` as the `online` block.
The serving fleet hot-swaps the refreshed generation with its buckets
warmed off the request path: leaf values changed, shapes did not.

Bin mappers freeze at the FIRST trigger window (or from an explicit
`reference` dataset): every later chunk re-uses them, so no chunk is
ever re-quantized and the stores stay aligned with the trees' rebinned
thresholds.

Crash safety: the daemon persists a state sidecar
(``<output_model>.state.json``, tmp + os.replace like `_publish`)
holding the traffic byte offset covered by the latest publish, the
generation/refresh counters, the frozen-mapper fingerprint, the traffic
reader's data-loss counters, and the last refresh outcome.  A restarted
daemon resumes from that offset — rows already inside a published
generation are never re-processed, rows of the in-flight window are
re-read from the log and land in exactly one future publish.  Publishes
are guarded by a WRITE-AHEAD INTENT in the sidecar, flushed after the
model is staged but before anything touches the publish path: on
restart, the intent's generation vs the published ``.meta.json`` — and,
for a crash BETWEEN the model and meta renames, the staged model's
recorded sha1 vs what sits at the publish path — decide adopt
(completing the publish from the intent's recorded meta) vs redo.
The frozen bin mappers persist as a binary dataset sidecar
(``<output_model>.refbin``) so a restart bins against BITWISE the same
mappers instead of re-freezing from whatever window happens to be
pending.  SIGTERM drains the current
poll and flushes state before exit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from .. import log, telemetry
from ..boosting.gbdt import resolve_device
from ..config import Config, config_from_params
from ..dataset import Dataset as RawDataset
from ..diagnostics import faults
from ..log import LightGBMError
from .refit import LeafRefitter
from .stream import TrafficDemux, TrafficLog

STATE_VERSION = 1


def _file_sha1(path: str) -> str:
    from ..quantize import file_sha1
    return file_sha1(path)


def _booster_params(cfg: Config) -> dict:
    """Config -> Booster params dict (file/task routing keys dropped so
    the loaded booster cannot accidentally re-trigger IO)."""
    p = dataclasses.asdict(cfg)
    for k in ("task", "data", "input_model", "output_model", "valid_data",
              "output_result", "is_save_binary_file", "config_file"):
        p.pop(k, None)
    return p


class OnlineTrainer:
    """Traffic-watching refresh daemon (see module docstring)."""

    def __init__(self, booster, traffic_path: str, publish_path: str, *,
                 config: Optional[Config] = None, reference=None,
                 resume: bool = True, model_id: Optional[str] = None,
                 match_unkeyed: Optional[bool] = None, traffic=None):
        cfg = config or config_from_params(booster.params)
        if not booster._gbdt.models:
            raise LightGBMError("task=online needs a trained input model")
        # the refits run on the booster's device: a GPU must be visible
        # for device_type=cuda
        resolve_device(cfg)
        self.cfg = cfg
        self.booster = booster
        # catalog tenant id (multi-tenant serving): keys this daemon to
        # its own rows of a SHARED traffic tail and stamps the publish
        # sidecar, so the serving catalog's per-tenant poll picks up
        # exactly this tenant's refreshes.  None = the unkeyed
        # single-tenant daemon.
        self.model_id = model_id
        # pin the traffic row width to the model's feature count so a
        # single malformed-width line can never become the yardstick
        # that rejects the valid rows behind it.  `traffic=` injects a
        # pre-built reader (an OnlineFleet hands each tenant a
        # TrafficDemux view so the shared tail is parsed once).
        if traffic is not None:
            self.traffic = traffic
        else:
            self.traffic = TrafficLog(traffic_path,
                                      expected_features=booster.num_feature(),
                                      model_filter=model_id,
                                      match_unkeyed=match_unkeyed)
        self.publish_path = publish_path
        self.state_path = publish_path + ".state.json"
        self.refbin_path = publish_path + ".refbin"
        self.mode = cfg.online_mode
        self.trigger = int(cfg.online_trigger_rows)
        self.generation = 0
        self.refreshes = 0
        self.rows_seen = 0
        # crash-safety bookkeeping: the byte offset covered by the
        # latest publish (where a restarted daemon resumes reading),
        # the frozen-mapper fingerprint, and the last refresh outcome
        self._published_offset = 0
        self._mapper_fp: Optional[str] = None
        self._last_refresh: Optional[dict] = None
        # window state: raw chunks buffer until the first trigger
        # freezes the bin mappers, then a streaming Dataset takes over
        self._window: Optional[RawDataset] = None
        self._buffer: List[Tuple[np.ndarray, np.ndarray,
                                 Optional[np.ndarray]]] = []
        self._buffered_rows = 0
        self._refitter: Optional[LeafRefitter] = None
        # refit mode routes each ingested chunk through the EXACT
        # raw-feature leaf router while the raw values are still in
        # hand (upstream pred_leaf refit parity — the window's binned
        # store quantizes thresholds that fall inside its bins);
        # structures are frozen in refit mode, so routing never stales
        self._leaf_chunks: List[np.ndarray] = []
        # serve→train trace propagation: trace ids stamped into the
        # traffic log by the serving side accumulate per window (capped
        # — provenance, not a ledger) and ride into the publish sidecar
        # as `origin_trace_ids`, independent of whether THIS process
        # has span tracing on
        self._window_traces: set = set()
        self._WINDOW_TRACES_CAP = 1024
        # adaptive bin budgets (bin_budget > 0): each window's raw rows
        # ride in a ring so the post-refresh drift check can recompute
        # the per-feature allocation and refreeze the mappers when the
        # traffic distribution has moved; the baseline allocation
        # re-derives from the first window after every (re)start
        self._rebudget = int(getattr(cfg, "bin_budget", 0) or 0) > 0
        self._raw_ring: List[Tuple[np.ndarray, np.ndarray,
                                   Optional[np.ndarray]]] = []
        self._raw_rows = 0
        self._budget_alloc: Optional[np.ndarray] = None
        if reference is not None:
            self._window = RawDataset.streaming_from(
                reference, cfg, capacity=self.trigger)
        if resume:
            self._try_resume()
        if self._window is None:
            self._adopt_input_refbin()

    @classmethod
    def from_config(cls, cfg: Config) -> "OnlineTrainer":
        from ..basic import Booster
        if not cfg.input_model:
            raise LightGBMError("task=online needs input_model=<file>")
        if not cfg.data:
            raise LightGBMError(
                "task=online needs data=<labeled traffic .jsonl>")
        if not cfg.output_model:
            raise LightGBMError("task=online needs output_model=<registry "
                                "path the serving fleet polls>")
        booster = Booster(params=_booster_params(cfg),
                          model_file=cfg.input_model)
        return cls(booster, cfg.data, cfg.output_model, config=cfg)

    # -- crash-safe state ------------------------------------------------

    def _state_dict(self, intent: Optional[dict] = None) -> dict:
        st = {
            "version": STATE_VERSION,
            "generation": self.generation,
            "refreshes": self.refreshes,
            "rows_seen": int(self.rows_seen),
            "published_offset": int(self._published_offset),
            "pending_rows": int(self.pending_rows()),
            "mode": self.mode,
            "trigger_rows": self.trigger,
            "mapper_fingerprint": self._mapper_fp,
            "traffic": self.traffic.counters(),
            "last_refresh": self._last_refresh,
            "updated_unix": round(time.time(), 3),
        }
        if intent is not None:
            st["publish_intent"] = intent
        return st

    def _flush_state(self, intent: Optional[dict] = None) -> None:
        """Persist the daemon state sidecar (tmp + os.replace — the
        same atomicity discipline as `_publish`)."""
        payload = json.dumps(self._state_dict(intent))
        faults.torn_write("online.state_write", self.state_path, payload)
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, self.state_path)

    def _try_resume(self) -> None:
        """Adopt a previous daemon's persisted state: traffic offset,
        generation counters, published model, frozen bin mappers.  A
        torn/unreadable sidecar logs a warning and starts fresh — a
        crash artifact must never wedge the restart."""
        try:
            with open(self.state_path) as f:
                st = json.load(f)
        except FileNotFoundError:
            return                        # first run: no sidecar yet
        except OSError as e:
            # an existing-but-unreadable sidecar (EACCES/EIO) silently
            # treated as a first run would reset the traffic offset to 0
            # and double-process every published row
            log.warning(f"online: could not read state sidecar "
                        f"{self.state_path} ({type(e).__name__}: {e}); "
                        "starting fresh (traffic re-reads from offset 0)")
            return
        except ValueError as e:
            log.warning(f"online: ignoring unreadable state sidecar "
                        f"{self.state_path} ({type(e).__name__}: {e}); "
                        "starting fresh (traffic re-reads from offset 0)")
            return
        if not isinstance(st, dict) or st.get("version") != STATE_VERSION:
            log.warning(f"online: ignoring incompatible state sidecar "
                        f"{self.state_path}; starting fresh")
            return
        offset = int(st.get("published_offset", 0))
        self.generation = int(st.get("generation", 0))
        self.refreshes = int(st.get("refreshes", 0))
        self.rows_seen = int(st.get("rows_seen", 0))
        self._last_refresh = st.get("last_refresh")
        # publish-intent recovery: a crash BETWEEN the model rename and
        # the state flush left the sidecar one publish behind.  The
        # published .meta.json tells which side of the rename the crash
        # fell on: landed -> adopt the intent (those rows are in the
        # model; re-processing them would double-refit), not landed ->
        # redo the window from the pre-intent offset.
        intent = st.get("publish_intent")
        if intent:
            meta = self._read_meta()
            landed = (meta is not None and
                      meta.get("generation") == intent.get("generation"))
            if not landed:
                # the meta rename is the SECOND rename — the model may
                # already have landed (crash between the two).  The
                # intent's staged-model sha1 decides: if that is what
                # sits at publish_path, COMPLETE the publish by staging
                # the meta recorded in the intent; re-refitting the
                # window would double-apply its rows to the new model.
                sha = intent.get("model_sha1")
                try:
                    if (sha and os.path.exists(self.publish_path)
                            and _file_sha1(self.publish_path) == sha):
                        if intent.get("meta") is not None:
                            mtmp = self.publish_path + ".meta.json.tmp"
                            with open(mtmp, "w") as f:
                                json.dump(intent["meta"], f)
                            os.replace(mtmp,
                                       self.publish_path + ".meta.json")
                        landed = True
                        log.info("online: completed interrupted publish "
                                 f"generation {intent.get('generation')} "
                                 "(crash fell between the model and "
                                 "meta renames)")
                except OSError as e:
                    log.warning("online: could not verify an interrupted "
                                f"publish ({type(e).__name__}: {e}); "
                                "redoing the window")
            if landed:
                self.generation = int(intent["generation"])
                self.refreshes = int(intent.get("refreshes",
                                                self.refreshes + 1))
                self.rows_seen = int(intent.get("rows_seen",
                                                self.rows_seen))
                offset = int(intent.get("offset", offset))
                log.info(f"online: adopted in-flight publish generation "
                         f"{self.generation} (crash fell after the model "
                         "rename, before the state flush)")
            else:
                log.info("online: discarding unfinished publish intent "
                         f"(generation {intent.get('generation')} never "
                         "landed); its window re-reads from the log")
        self._published_offset = offset
        # counters ride along: the sidecar's bad_lines/overcap_skips are
        # the operator's silent-data-loss evidence and must survive the
        # restart, not reset to 0
        self.traffic.seek(offset, st.get("traffic"))
        # continue refreshing the PUBLISHED model (the one the fleet is
        # serving), not the stale input model
        if self.generation > 0 and os.path.exists(self.publish_path):
            from ..basic import Booster
            try:
                self.booster = Booster(params=_booster_params(self.cfg),
                                       model_file=self.publish_path)
            except Exception as e:
                log.warning(f"online: could not reload published model "
                            f"{self.publish_path} ({type(e).__name__}: "
                            f"{e}); continuing from the input model")
        # frozen mappers: rebuild the streaming window from the refbin
        # sidecar so restarted binning is bitwise the original run's
        if self._window is None and os.path.exists(self.refbin_path):
            fp = st.get("mapper_fingerprint")
            try:
                actual = _file_sha1(self.refbin_path)
                if fp is not None and actual != fp:
                    raise ValueError(
                        f"fingerprint {actual[:12]} != recorded "
                        f"{str(fp)[:12]} (torn write?)")
                ref = RawDataset.from_binary(self.refbin_path, self.cfg)
                self._window = RawDataset.streaming_from(
                    ref, self.cfg, capacity=self.trigger)
                self._mapper_fp = actual
            except Exception as e:
                log.warning(f"online: could not restore frozen mappers "
                            f"from {self.refbin_path} ({type(e).__name__}"
                            f": {e}); re-freezing from the next window")
        log.info(f"online: resumed from {self.state_path} — generation "
                 f"{self.generation}, traffic offset {offset}, "
                 f"{self.rows_seen} rows seen")

    def _read_meta(self) -> Optional[dict]:
        try:
            with open(self.publish_path + ".meta.json") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _save_refbin(self, base: RawDataset) -> None:
        """Persist the frozen-mapper reference (atomic), so a restarted
        daemon bins against the SAME mappers instead of re-freezing."""
        tmp = self.refbin_path + ".tmp"
        base.save_binary(tmp)
        os.replace(tmp, self.refbin_path)
        self._mapper_fp = _file_sha1(self.refbin_path)

    def _adopt_input_refbin(self) -> None:
        """Freeze the INPUT model's own training mappers when it ships
        a ``.refbin`` sidecar (Dataset.save_refbin at train time).
        Ingestion then bins against the exact mapper set the model's
        thresholds live in, so the published ``<output>.refbin`` stays
        SERVING-exact across refit generations — the binned request
        path (serve_quantize=binned) requires thresholds to BE bin
        boundaries of the sidecar's mappers — and the binned refit
        router becomes exact as a bonus.  Without a sidecar the first
        full window freezes its own mappers, as before (such
        generations serve raw under serve_quantize=auto: the serving
        registry's representability check refuses them)."""
        ip = str(getattr(self.cfg, "input_model", "") or "")
        if not ip or not os.path.exists(ip + ".refbin"):
            return
        from ..quantize import load_refbin
        try:
            ref = load_refbin(ip + ".refbin")
            if ref.num_total_features != self.booster.num_feature():
                raise LightGBMError(
                    f"sidecar covers {ref.num_total_features} features, "
                    f"model has {self.booster.num_feature()}")
            self._window = RawDataset.streaming_from(
                ref, self.cfg, capacity=self.trigger)
            self._save_refbin(ref)
            log.info(f"online: adopted frozen mappers from {ip}.refbin "
                     f"({ref.num_features} used features) — published "
                     "generations stay binned-serving exact")
        except Exception as e:
            self._window = None
            log.warning(f"online: could not adopt {ip}.refbin "
                        f"({type(e).__name__}: {e}); the first "
                        f"{self.trigger}-row window will freeze its own "
                        "mappers")

    # -- ingestion ------------------------------------------------------

    def pending_rows(self) -> int:
        return (self._window.num_data if self._window is not None
                else self._buffered_rows)

    def _ingest(self, X: np.ndarray, y: np.ndarray,
                w: Optional[np.ndarray]) -> None:
        self.rows_seen += len(X)
        if self._rebudget:
            # raw-row ring for the adaptive-budget drift check; capped
            # at 4 windows so a poll backlog cannot grow it unbounded
            self._raw_ring.append((X, y, w))
            self._raw_rows += len(X)
            while (len(self._raw_ring) > 1
                   and self._raw_rows - len(self._raw_ring[0][0])
                   >= 4 * self.trigger):
                self._raw_rows -= len(self._raw_ring.pop(0)[0])
        if self._window is not None:
            self._window.append_rows(X, y, w)
            if self.mode == "refit":
                self._leaf_chunks.append(
                    self.booster._gbdt.predict_leaf_index(X))
            return
        self._buffer.append((X, y, w))
        self._buffered_rows += len(X)
        if self._buffered_rows < self.trigger:
            return
        # first full window: freeze the bin mappers + bundle plan here;
        # every later chunk bins against them (no re-quantization).
        # Construction routes through Dataset.from_stream — the shared
        # out-of-core ingestion path (sharded/ingest.py): a sketch pass
        # over the buffered chunks derives the mappers (exact at window
        # sizes, bitwise what batch construction would freeze), then
        # each chunk bins straight into the capacity-tiered window —
        # the buffer is never concatenated into one monolithic raw
        # matrix.
        rows = self._buffered_rows
        self._window = RawDataset.from_stream(
            list(self._buffer), self.cfg,
            capacity=max(self.trigger, rows))
        if self.mode == "refit":
            # exact raw-feature routing per buffered chunk, while the
            # raw values are still in hand
            for bx, _by, _bw in self._buffer:
                self._leaf_chunks.append(
                    self.booster._gbdt.predict_leaf_index(bx))
        self._buffer = []
        self._buffered_rows = 0
        # the frozen mappers outlive this process: a restarted daemon
        # restores them from the sidecar instead of re-freezing from
        # whatever window happens to be pending at restart time
        try:
            self._save_refbin(self._window.compacted())
        except OSError as e:
            log.warning(f"online: could not persist frozen mappers to "
                        f"{self.refbin_path} ({type(e).__name__}: {e}); "
                        "a restart would re-freeze from its first window")
        log.info(f"online: froze bin mappers from the first "
                 f"{rows}-row window "
                 f"({self._window.num_features} used features, "
                 f"store capacity {self._window.row_capacity})")

    # -- the loop -------------------------------------------------------

    def poll_once(self) -> bool:
        """Ingest any new traffic; refresh + publish when the trigger
        fires.  Returns True iff a new generation was published."""
        got = self.traffic.read_new()
        if got is not None:
            # originating trace ids of the rows just ingested (the
            # serving side stamped them into the log) become window
            # provenance for the next publish.  The cap is enforced
            # per-id: one backlog poll can carry hundreds of thousands
            # of distinct ids, and the whole set lands in the meta
            # sidecar AND the write-ahead intent — provenance, not a
            # ledger, so the first CAP ids win
            for t in self.traffic.last_trace_ids:
                if len(self._window_traces) >= self._WINDOW_TRACES_CAP:
                    break
                if t is not None:
                    self._window_traces.add(t)
            self._ingest(*got)
        if self._window is None or self._window.num_data < self.trigger:
            return False
        return self.refresh()

    def refresh(self) -> bool:
        """Refresh the model on the current window (regardless of the
        trigger), publish the new generation, reset the window."""
        window = self._window
        if window is None or window.num_data == 0:
            return False
        # ONE trace id spans the whole refresh — refit/continue,
        # publish, and (via the meta sidecar) the serving registry's
        # hot-swap adopt it, so the train half of the serve→train→serve
        # loop is a single grep (per tenant: the model attr keys it)
        with telemetry.span("online.refresh", mode=self.mode,
                            rows=int(window.num_data),
                            generation=self.generation + 1,
                            origin_traces=len(self._window_traces),
                            **({"model": self.model_id}
                               if self.model_id is not None else {})):
            t0 = time.perf_counter()
            if self.mode == "continue":
                with telemetry.span("online.continue"):
                    stats = self._continue_boosting(window)
            else:
                if self._refitter is None:
                    self._refitter = LeafRefitter(self.booster._gbdt,
                                                  window)
                # exact raw-feature routing accumulated at ingestion;
                # the binned router only backstops a count mismatch
                # (e.g. rows appended to the window behind the
                # trainer's back)
                leaf = (np.concatenate(self._leaf_chunks)
                        if self._leaf_chunks else None)
                if leaf is not None and len(leaf) != window.num_data:
                    leaf = None
                with telemetry.span("online.refit",
                                    rows=int(window.num_data)):
                    stats = self._refitter.refit(leaf_idx=leaf)
            stats["refresh_seconds"] = round(time.perf_counter() - t0, 4)
            self._publish(stats)
        window.reset_rows()
        self._maybe_rebudget()
        self._leaf_chunks = []
        self._window_traces = set()
        self._published_offset = int(self.traffic.offset)
        self._record_refresh(ok=True, rows=stats.get("rows", 0))
        self._flush_state()
        return True

    def _window_budget_alloc(self) -> Optional[np.ndarray]:
        """Per-raw-feature adaptive bin allocation over the ring's raw
        rows — the same distinct/mass rule find_bin_mappers applies
        under ``bin_budget`` (binning.allocate_bin_budgets), so two
        windows from the same distribution produce the same vector and
        drift is measured allocation-vs-allocation, not against the
        mappers' realized bin counts (which find_bin may leave under
        budget on low-cardinality features)."""
        if not self._raw_ring:
            return None
        from ..binning import allocate_bin_budgets
        X = np.concatenate([c[0] for c in self._raw_ring])
        d = np.empty(X.shape[1], np.int64)
        m = np.empty(X.shape[1], np.int64)
        for j in range(X.shape[1]):
            col = X[:, j]
            nz = col[(col != 0.0) & ~np.isnan(col)]
            d[j] = np.unique(nz).size + 1     # + the implied zero
            m[j] = nz.size
        return allocate_bin_budgets(d, m, int(self.cfg.bin_budget))

    def _maybe_rebudget(self) -> None:
        """Adaptive bin budgets under drift (``bin_budget > 0``): after
        each refresh, recompute the per-feature allocation over the
        window just consumed; when it drifts from the baseline
        allocation by more than LIGHTGBM_TPU_ONLINE_REBUDGET_DRIFT
        (L1 share, default 0.25), refreeze the mappers from the ring's
        raw rows through the existing refbin handshake — the sidecar
        sha1 updates, the next publish meta carries it, and
        serve_quantize=auto re-resolves binned vs raw against the new
        boundaries (a registry serving the old generation keeps its old
        refbin until the hot-swap)."""
        if not self._rebudget:
            return
        want = self._window_budget_alloc()
        if want is None:
            return
        base = self._budget_alloc
        if base is None or want.size != base.size:
            self._budget_alloc = want
            self._raw_ring, self._raw_rows = [], 0
            return
        drift = (float(np.abs(want.astype(np.int64)
                              - base.astype(np.int64)).sum())
                 / max(int(base.sum()), 1))
        thresh = float(os.environ.get(
            "LIGHTGBM_TPU_ONLINE_REBUDGET_DRIFT", "0.25"))
        if drift > thresh:
            X = np.concatenate([c[0] for c in self._raw_ring])
            y = np.concatenate([c[1] for c in self._raw_ring])
            try:
                newref = RawDataset(X, y, config=self.cfg)
                self._window = RawDataset.streaming_from(
                    newref, self.cfg, capacity=self.trigger)
                self._save_refbin(newref)
                self._refitter = None     # window dataset changed
                self._budget_alloc = want
                log.info(
                    f"online: bin-budget drift {drift:.3f} > {thresh:g}"
                    f" — refroze adaptive mappers from the last "
                    f"{len(X)}-row window (refbin "
                    f"{str(self._mapper_fp)[:12]})")
            except Exception as e:
                log.warning(
                    f"online: bin-budget refreeze failed "
                    f"({type(e).__name__}: {e}); keeping the frozen "
                    "mappers")
        self._raw_ring, self._raw_rows = [], 0

    def _record_refresh(self, ok: bool, rows: int = 0,
                        error: Optional[str] = None) -> None:
        self._last_refresh = {"ok": bool(ok), "rows": int(rows),
                              "generation": self.generation,
                              "unix": round(time.time(), 3)}
        if error:
            self._last_refresh["error"] = error

    def _continue_boosting(self, window: RawDataset) -> dict:
        """Append num_iterations fresh trees on the window: the
        continued-training machinery — reset_training_data replays the
        model onto the window's scores, then ordinary boosting
        iterations grow new trees."""
        g = self.booster._gbdt
        inner = window.compacted()
        before = len(g.models)
        g.reset_training_data(inner, g.objective)
        for _ in range(self.cfg.num_iterations):
            if g.train_one_iter(None, None, False):
                break
        self._refitter = None      # structure changed
        return {"mode": "continue", "rows": int(inner.num_data),
                "trees_before": before, "trees_after": len(g.models)}

    def _publish(self, stats: dict) -> None:
        """Atomically publish the refreshed model + metadata sidecar.
        os.replace is atomic on one filesystem, so the registry's
        (mtime, size) poll can never observe a half-written model."""
        # the in-memory counters advance only once the publish LANDS:
        # until then the sidecar's top-level state must keep describing
        # the previous generation (a discarded intent on restart adopts
        # the top-level values verbatim)
        gen = self.generation + 1
        tmp = f"{self.publish_path}.g{gen}.tmp"
        self.booster.save_model(tmp)
        meta = {"generation": gen, "mode": self.mode,
                # catalog tenant provenance: which tenant's daemon
                # published this generation (None outside the catalog)
                "model_id": self.model_id,
                "refreshes": self.refreshes + 1,
                "rows_seen": int(self.rows_seen),
                "trigger_rows": self.trigger,
                # silent-data-loss visibility: the traffic reader's
                # skip counters ride into /stats' `online` block
                "traffic": self.traffic.counters(),
                # trace propagation: the refresh's own trace id (the
                # serving registry's hot-swap span adopts it) plus the
                # originating serve-request ids this window was built
                # from — the sidecar is the cross-process hop of the
                # serve→train→serve loop
                "trace_id": telemetry.current_trace_id(),
                "origin_trace_ids": sorted(self._window_traces),
                # frozen-mapper fingerprint: the serving registry
                # refuses a binned hot-swap whose .refbin sidecar does
                # not hash to this
                "refbin_sha1": self._mapper_fp,
                "published_unix": round(time.time(), 3), **stats}
        # write-ahead intent BEFORE anything touches publish_path: a
        # crash anywhere in the rename window is resolved on restart.
        # The staged model's sha1 disambiguates a crash BETWEEN the two
        # renames (model landed, meta did not — the .meta.json generation
        # alone cannot tell that apart from "nothing landed"), and the
        # full meta payload rides along so restart can COMPLETE such an
        # interrupted publish instead of double-refitting the window.
        self._flush_state(intent={
            "generation": gen,
            "refreshes": self.refreshes + 1,
            "rows_seen": int(self.rows_seen),
            "offset": int(self.traffic.offset),
            "model_sha1": _file_sha1(tmp),
            "meta": meta})
        with telemetry.span("online.publish", generation=gen,
                            path=self.publish_path):
            # chaos seams: crash before anything lands / model file
            # torn mid-write at the FINAL path (the no-tmp-discipline
            # failure the registry's poll must survive)
            faults.check("online.before_publish")
            faults.torn_copy("online.publish_model", tmp,
                             self.publish_path)
            mtmp = f"{self.publish_path}.meta.json.tmp"
            with open(mtmp, "w") as f:
                json.dump(meta, f)
            # both files staged before either lands: the model/sidecar
            # inconsistency window a /stats poll can observe is two
            # back-to-back renames, not a model save + json dump
            os.replace(tmp, self.publish_path)
            # chaos seam: crash with the model landed but the meta not
            # — the case only the intent's model sha1 can disambiguate
            faults.check("online.between_renames")
            os.replace(mtmp, self.publish_path + ".meta.json")
        self.generation = gen
        self.refreshes += 1
        faults.check("online.after_publish")
        log.info(f"online: published generation {self.generation} "
                 f"({self.mode}, {stats.get('rows', 0)} rows) to "
                 f"{self.publish_path}")

    def _guarded_poll(self) -> None:
        """One poll that can never kill the daemon on a bad window —
        except an injected CRASH, which is a crash (no drain, no state
        flush: chaos runs must exercise the cold restart)."""
        try:
            self.poll_once()
        except faults.InjectedFault:
            raise
        except Exception as e:      # never kill the daemon on one window
            self._record_refresh(ok=False,
                                 error=f"{type(e).__name__}: {e}")
            log.warning(f"online refresh failed: {e}")
            try:
                self._flush_state()   # the failure is /stats-visible
            except OSError:
                pass

    def run_forever(self, poll_seconds: Optional[float] = None,
                    stop: Optional[threading.Event] = None) -> None:
        """Blocking poll loop; `stop` lets tests (and signal handlers)
        end it cleanly.  SIGTERM drains: the current poll finishes, one
        final poll ingests whatever already reached the log, and the
        state sidecar flushes so the NEXT daemon resumes exactly here."""
        period = (self.cfg.model_poll_seconds if poll_seconds is None
                  else float(poll_seconds)) or 1.0
        log.info(f"online: watching {self.traffic.path} every "
                 f"{period:g}s (mode={self.mode}, trigger="
                 f"{self.trigger} rows, publishing to "
                 f"{self.publish_path})")

        def flush_all():
            try:
                self._flush_state()
            except OSError as e:
                log.warning(f"online: final state flush failed: {e}")

        _run_daemon_loop(period, stop, self._guarded_poll, flush_all,
                         "online: stopped (state flushed to "
                         f"{self.state_path})")


def _run_daemon_loop(period: float, stop: Optional[threading.Event],
                     poll, flush_all, stopped_msg: str) -> None:
    """The poll/drain/flush lifecycle shared by the single daemon and
    the fleet: SIGTERM (main thread only; tests pass `stop`) ends the
    loop, ONE final drain poll ingests whatever already reached the
    log — an InjectedFault during it propagates WITHOUT the final
    flush (chaos runs exercise the cold restart) — then every state
    sidecar flushes so the next daemon resumes exactly here."""
    stop = stop or threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    except (ValueError, OSError):
        pass
    while not stop.wait(period):
        poll()
    try:                            # drain: SIGTERM/stop arrived
        poll()
    except faults.InjectedFault:
        raise
    flush_all()
    log.info(stopped_msg)


class OnlineFleet:
    """One `OnlineTrainer` per catalog tenant, sharing ONE traffic tail.

    `serve_models` (the same ``id=path`` entries the serving catalog
    uses) drives ``task=online`` into fleet mode: each tenant's daemon
    tails the SAME labeled-traffic file but ingests only its own keyed
    rows (TrafficLog ``model_filter``; unkeyed rows feed the
    ``default`` entry, or the first entry when none is named
    ``default``), refreshes the model AT its tenant's path, and
    publishes back to that path — which is exactly what the serving
    catalog polls per tenant.  State/refbin sidecars key off each
    publish path, so crash-safe resume stays per-tenant.  One tenant's
    refresh failure never stalls the others.

    The shared tail is read and parsed ONCE per poll cycle: the fleet
    builds a single `TrafficDemux` over the traffic file and hands each
    tenant's daemon a per-tenant view (same TrafficLog surface, so
    crash-safe offset resume is unchanged).  Poll cost scales with log
    bytes, not tenants x log bytes.
    """

    def __init__(self, trainers: List[OnlineTrainer]):
        if not trainers:
            raise LightGBMError("OnlineFleet needs at least one trainer")
        self.trainers = list(trainers)

    @classmethod
    def from_config(cls, cfg: Config) -> "OnlineFleet":
        from ..basic import Booster
        from ..serving.server import catalog_models_from_config
        if not cfg.data:
            raise LightGBMError(
                "task=online needs data=<labeled traffic .jsonl>")
        # the SAME id→path map the serving catalog builds — including
        # `input_model` as the `default` tenant: the serving side keys
        # unnamed requests (and their traffic rows) "default", so a
        # fleet without that daemon would silently filter every
        # default-keyed row and let the default model go stale
        models = catalog_models_from_config(cfg)
        unkeyed_owner = ("default" if "default" in models
                         else next(iter(models)))
        # ONE tailer for the whole fleet: each tenant gets a demux view
        # instead of an independent TrafficLog, so the shared file is
        # read and JSON-parsed once per poll cycle
        demux = TrafficDemux(cfg.data)
        trainers = []
        for mid, path in models.items():
            # each tenant's model path is both the daemon's input and
            # its publish target: the daemon refreshes the published
            # file in place (atomic os.replace), the catalog's
            # per-tenant poll picks it up
            tcfg = cfg.with_updates(input_model=path, output_model=path)
            booster = Booster(params=_booster_params(tcfg),
                              model_file=path)
            trainers.append(OnlineTrainer(
                booster, cfg.data, path, config=tcfg, model_id=mid,
                match_unkeyed=(mid == unkeyed_owner),
                traffic=demux.view(
                    model_filter=mid,
                    match_unkeyed=(mid == unkeyed_owner),
                    expected_features=booster.num_feature())))
        log.info(f"online fleet: {len(trainers)} tenant daemons "
                 f"({', '.join(models)}) sharing {cfg.data}")
        return cls(trainers)

    def pending_rows(self) -> int:
        return sum(t.pending_rows() for t in self.trainers)

    def poll_once(self) -> int:
        """Poll every tenant once; returns generations published."""
        published = 0
        for t in self.trainers:
            try:
                if t.poll_once():
                    published += 1
            except faults.InjectedFault:
                raise               # chaos runs exercise the cold restart
            except Exception as e:  # isolate: tenant A's bad window
                # must not stall tenant B's refreshes
                t._record_refresh(ok=False,
                                  error=f"{type(e).__name__}: {e}")
                log.warning(f"online refresh failed for "
                            f"{t.model_id}: {e}")
                try:
                    t._flush_state()
                except OSError:
                    pass
        return published

    def run_forever(self, poll_seconds: Optional[float] = None,
                    stop: Optional[threading.Event] = None) -> None:
        """Blocking fleet loop — the multi-tenant ``task=online``
        entry; SIGTERM drains every tenant and flushes every state
        sidecar (the same `_run_daemon_loop` discipline as the single
        daemon; per-tenant failures are already isolated in
        poll_once)."""
        period = (self.cfg_poll if poll_seconds is None
                  else float(poll_seconds)) or 1.0

        def flush_all():
            for t in self.trainers:
                try:
                    t._flush_state()
                except OSError as e:
                    log.warning(f"online fleet: state flush failed for "
                                f"{t.model_id}: {e}")

        _run_daemon_loop(period, stop, self.poll_once, flush_all,
                         "online fleet: stopped")

    @property
    def cfg_poll(self) -> float:
        return self.trainers[0].cfg.model_poll_seconds
