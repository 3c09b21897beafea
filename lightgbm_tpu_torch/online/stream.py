"""Labeled-traffic ingestion: JSON-lines reader for logged /predict
traffic joined with labels.

A copy of lightgbm_tpu/online/stream.py (standard library and numpy).

Line format (one example per line):

    {"features": [f0, f1, ...], "label": y}
    {"features": [f0, f1, ...], "label": y, "weight": w}
    {"features": [...], "label": y, "model": "de"}   # catalog tenant
    [y, f0, f1, ...]                      # plain-array shorthand

which is exactly the serving request body's row shape
(serving/server.py `_parse_predict_body`) plus the joined label — a log
pipeline can append the label to each served row and feed the file
straight back into the trainer.

`TrafficLog` tails a GROWING file: it remembers its byte offset and
only consumes complete lines, so a writer appending mid-poll never
feeds the reader a torn record (the partial tail is re-read on the next
poll once its newline lands).

`TrafficDemux` is the multi-tenant reader: ONE tailer reads and
JSON-parses the shared file once, and per-tenant views replay the
parsed records through their own tenant filter and width check — poll
cost scales with log bytes, not tenants × log bytes, while each view
keeps the exact `TrafficLog` surface (offset, counters, seek, read_new)
so `OnlineTrainer` and its crash-safe resume work unchanged on top.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..diagnostics import locksan


def append_traffic(path: str, X: np.ndarray, y: np.ndarray,
                   weight: Optional[np.ndarray] = None,
                   trace_ids=None, model_id: Optional[str] = None) -> int:
    """Append labeled rows to a traffic log (the writer half — what a
    serving-side label joiner produces); returns rows written.

    ``trace_ids`` (one per row, or one string for all rows; None
    entries allowed) stamps each record with the serving-side trace id
    of the /predict request that scored it — the hop that lets the
    online daemon's publish sidecar name the originating requests.
    ``model_id`` keys each record with the catalog tenant that served
    it, so N per-tenant daemons can share ONE traffic tail (each reads
    only its own rows — TrafficLog ``model_filter``); None keeps the
    unkeyed single-tenant record shape."""
    from ..diagnostics import faults
    X = np.asarray(X, np.float64)
    if X.ndim == 1:
        X = X.reshape(1, -1)
    y = np.asarray(y, np.float64).reshape(-1)
    if len(y) != len(X):
        raise ValueError("label length mismatch")
    if isinstance(trace_ids, str):
        trace_ids = [trace_ids] * len(X)
    if trace_ids is not None and len(trace_ids) != len(X):
        raise ValueError("trace_ids length mismatch")
    with open(path, "a") as f:
        for i in range(len(X)):
            rec = {"features": [float(v) for v in X[i]],
                   "label": float(y[i])}
            if model_id is not None:
                rec["model"] = str(model_id)
            if weight is not None:
                rec["weight"] = float(np.asarray(weight).reshape(-1)[i])
            if trace_ids is not None and trace_ids[i]:
                rec["trace_id"] = str(trace_ids[i])
            line = json.dumps(rec) + "\n"
            # chaos seam: a writer dying mid-append leaves a torn tail —
            # exactly what the reader's complete-lines-only contract
            # must absorb
            if faults.fire("traffic.append"):
                f.write(line[: max(1, len(line) // 2)])
                f.flush()
                raise faults.InjectedFault("traffic.append", 0)
            f.write(line)
    return len(X)


class TrafficLog:
    """Incremental reader over a labeled-traffic JSONL file.

    `expected_features` pins the row width (the model's feature count);
    without it the width locks to the first well-formed line EVER read.
    Either way the reference persists across polls, so one short-but-
    parseable line can only lose itself — never become the yardstick
    that rejects every valid row behind it.

    `model_filter` keys the reader to ONE catalog tenant of a shared
    multi-tenant log: rows whose ``model`` field names another tenant
    are skipped (counted in ``filtered_rows`` — they are another
    daemon's data, not loss); rows with NO model field match only when
    `match_unkeyed` is true (the default tenant's daemon sets it, so
    pre-catalog writers keep feeding it).  No filter = read everything,
    the single-tenant behavior.
    """

    def __init__(self, path: str, expected_features: Optional[int] = None,
                 max_poll_bytes: int = 64 << 20,
                 model_filter: Optional[str] = None,
                 match_unkeyed: Optional[bool] = None):
        self.path = path
        self.offset = 0           # byte offset of the first unread line
        self.rows_read = 0
        self.bad_lines = 0
        self.overcap_skips = 0    # single lines larger than max_poll_bytes
        self.filtered_rows = 0    # other tenants' rows (not data loss)
        self._model_filter = (str(model_filter)
                              if model_filter is not None else None)
        # unfiltered readers take every row incl. unkeyed ones; a
        # keyed reader skips unkeyed rows unless told otherwise
        self._match_unkeyed = (model_filter is None
                               if match_unkeyed is None
                               else bool(match_unkeyed))
        self._width = (int(expected_features)
                       if expected_features else None)
        # per-poll read cap: a daemon (re)started against a multi-GB
        # backlog must drain it in bounded slices, not one giant blob
        self._max_poll = int(max_poll_bytes)
        # trace ids of the rows the LAST read_new() returned (aligned
        # with its X; None where the record carried none) — the
        # serve→train trace-propagation hop the online trainer folds
        # into its window provenance
        self.last_trace_ids: list = []

    def counters(self) -> dict:
        """Silent-data-loss evidence for /stats:
        rows consumed, malformed lines skipped, over-cap lines skipped,
        other-tenant rows filtered, and the current byte offset."""
        return {"offset": int(self.offset), "rows_read": int(self.rows_read),
                "bad_lines": int(self.bad_lines),
                "overcap_skips": int(self.overcap_skips),
                "filtered_rows": int(self.filtered_rows)}

    def seek(self, offset: int, counters: Optional[dict] = None) -> None:
        """Restore a persisted read position (daemon restart): the next
        read_new() continues from `offset` instead of byte 0."""
        self.offset = max(0, int(offset))
        if counters:
            self.rows_read = int(counters.get("rows_read", self.rows_read))
            self.bad_lines = int(counters.get("bad_lines", self.bad_lines))
            self.overcap_skips = int(counters.get("overcap_skips",
                                                  self.overcap_skips))
            self.filtered_rows = int(counters.get("filtered_rows",
                                                  self.filtered_rows))

    def read_new(self) -> Optional[Tuple[np.ndarray, np.ndarray,
                                         Optional[np.ndarray]]]:
        """Consume every COMPLETE line past the last offset.

        Returns (X, y, weights-or-None), or None when nothing new is
        readable.  A file that shrank (rotation/truncation) restarts
        from the top.  Malformed lines are counted and skipped — one
        bad record must not wedge the ingestion loop.
        """
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return None
        if size < self.offset:      # rotated/truncated: start over
            self.offset = 0
        if size == self.offset:
            return None
        capped = size - self.offset > self._max_poll
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            blob = f.read(min(size - self.offset, self._max_poll))
        last_nl = blob.rfind(b"\n")
        if last_nl < 0:
            if capped:              # a single over-cap line: skip it
                # (its remainder parses as one more bad line later)
                self.offset += len(blob)
                self.bad_lines += 1
                self.overcap_skips += 1
            return None             # else: only a torn tail so far
        consumed = blob[: last_nl + 1]
        self.offset += len(consumed)
        feats, labels, weights, traces = [], [], [], []
        any_weight = False
        for line in consumed.decode("utf-8", errors="replace").splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                item = json.loads(line)
                if isinstance(item, dict):
                    rec_model = item.get("model")
                    row = [float(v) for v in item["features"]]
                    lab = float(item["label"])
                    w = item.get("weight")
                    tr = item.get("trace_id")
                else:               # [label, f0, f1, ...] shorthand
                    rec_model = None
                    lab = float(item[0])
                    row = [float(v) for v in item[1:]]
                    w = None
                    tr = None
            except (ValueError, TypeError, KeyError, IndexError):
                self.bad_lines += 1
                continue
            # tenant keying: another tenant's (well-formed) row is
            # filtered, not "bad" — it is some other daemon's data
            if rec_model is None:
                if not self._match_unkeyed:
                    self.filtered_rows += 1
                    continue
            elif (self._model_filter is not None
                    and str(rec_model) != self._model_filter):
                self.filtered_rows += 1
                continue
            if self._width is None:
                self._width = len(row)
            if len(row) != self._width:
                self.bad_lines += 1
                continue
            feats.append(row)
            labels.append(lab)
            weights.append(1.0 if w is None else float(w))
            traces.append(str(tr) if tr is not None else None)
            any_weight = any_weight or w is not None
        if not feats:
            return None
        self.last_trace_ids = traces
        self.rows_read += len(feats)
        X = np.asarray(feats, np.float64)
        y = np.asarray(labels, np.float64)
        w = np.asarray(weights, np.float32) if any_weight else None
        return X, y, w


class _DemuxRecord:
    """One parsed line of the shared log, held in the demux window.

    ``start``/``end`` are the line's byte span in the file — the replay
    cursor every view compares its own offset against.  ``kind`` is
    "row" (parsed fields attached), "bad" (unparseable — charged to
    every view, exactly as N independent readers would each have
    charged it), or "overcap" (a single line larger than the poll cap).
    """

    __slots__ = ("start", "end", "kind", "model", "row", "label",
                 "weight", "trace")

    def __init__(self, start: int, end: int, kind: str,
                 model: Optional[str] = None, row: Optional[list] = None,
                 label: float = 0.0, weight: Optional[float] = None,
                 trace: Optional[str] = None):
        self.start = start
        self.end = end
        self.kind = kind
        self.model = model
        self.row = row
        self.label = label
        self.weight = weight
        self.trace = trace


class TrafficDemux:
    """ONE tailer over a shared multi-tenant traffic log, fanned out to
    per-tenant views.

    The pre-demux fleet ran N independent `TrafficLog` readers over the
    same file: every poll cycle read and JSON-parsed the full append
    window N times, once per tenant.  The demux reads and parses each
    byte ONCE into a window of `_DemuxRecord`s; each `view()` replays
    the records past its own byte offset through its own tenant filter
    and width check.  Poll cost scales with log bytes, not
    tenants x log bytes.

    Contract: every view must be polled regularly (the fleet polls all
    daemons each cycle).  The window is pruned to the slowest view's
    offset, so a view that stops reading pins records in memory.
    Views may resume at different persisted offsets — the parse cursor
    starts at the MINIMUM view offset, and a view seeking backward
    below the window rewinds the shared cursor (other views skip the
    re-parsed span via their own offsets).  All entry points take one
    lock, so views are safe to poll from different threads too.
    """

    def __init__(self, path: str, max_poll_bytes: int = 64 << 20):
        self.path = path
        self._max_poll = int(max_poll_bytes)
        self._lock = locksan.lock("online.stream")
        self._views: List["TrafficDemuxView"] = []
        self._records: deque = deque()
        self._pos: Optional[int] = None   # parse cursor; lazy until the
        #                                   first poll so views can seek
        #                                   persisted offsets first

    def view(self, model_filter: Optional[str] = None,
             match_unkeyed: Optional[bool] = None,
             expected_features: Optional[int] = None) -> "TrafficDemuxView":
        """Create a per-tenant view (same keying semantics as
        `TrafficLog`: model_filter / match_unkeyed / width pin)."""
        v = TrafficDemuxView(self, model_filter=model_filter,
                             match_unkeyed=match_unkeyed,
                             expected_features=expected_features)
        with self._lock:
            self._views.append(v)
        return v

    # -- internal: called by views under self._lock ------------------

    def _advance(self) -> Optional[int]:
        """Parse newly appended bytes once; returns the current file
        size, or None when the file is not statable."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return None
        # per-view rotation semantics, identical to TrafficLog: only a
        # view whose offset points past the shrunken file restarts
        for v in self._views:
            if size < v.offset:
                v.offset = 0
        lo = min((v.offset for v in self._views), default=0)
        window_start = (self._records[0].start if self._records
                        else self._pos)
        if (self._pos is None or lo < (window_start or 0)
                or size < self._pos):
            # first poll, a backward seek below the window, or rotation:
            # restart the parse at the slowest view
            self._records.clear()
            self._pos = lo
        if size == self._pos:
            return size
        capped = size - self._pos > self._max_poll
        with open(self.path, "rb") as f:
            f.seek(self._pos)
            blob = f.read(min(size - self._pos, self._max_poll))
        last_nl = blob.rfind(b"\n")
        if last_nl < 0:
            if capped:              # one over-cap line: record the skip
                self._records.append(_DemuxRecord(
                    self._pos, self._pos + len(blob), "overcap"))
                self._pos += len(blob)
            return size             # else: only a torn tail so far
        consumed = blob[: last_nl + 1]
        off = self._pos
        for raw in consumed[:-1].split(b"\n"):
            start, end = off, off + len(raw) + 1
            off = end
            line = raw.decode("utf-8", errors="replace").strip()
            if not line:
                continue
            try:
                item = json.loads(line)
                if isinstance(item, dict):
                    model = (str(item["model"])
                             if item.get("model") is not None else None)
                    row = [float(v) for v in item["features"]]
                    lab = float(item["label"])
                    w = (float(item["weight"])
                         if item.get("weight") is not None else None)
                    tr = item.get("trace_id")
                else:               # [label, f0, f1, ...] shorthand
                    model = None
                    lab = float(item[0])
                    row = [float(v) for v in item[1:]]
                    w = None
                    tr = None
            except (ValueError, TypeError, KeyError, IndexError):
                self._records.append(_DemuxRecord(start, end, "bad"))
                continue
            self._records.append(_DemuxRecord(
                start, end, "row", model=model, row=row, label=lab,
                weight=w, trace=str(tr) if tr is not None else None))
        self._pos = off
        return size

    def _prune(self) -> None:
        """Drop records every view has replayed past."""
        lo = min((v.offset for v in self._views), default=0)
        while self._records and self._records[0].end <= lo:
            self._records.popleft()


class TrafficDemuxView:
    """One tenant's replay cursor over a `TrafficDemux` window.

    Exposes the full `TrafficLog` surface — path / offset / counters /
    seek / read_new / last_trace_ids — so `OnlineTrainer` (including
    its crash-safe offset resume) runs on a view unchanged.  Counter
    semantics match an independent `TrafficLog` with the same filter:
    bad and over-cap lines charge EVERY view (each of the old N readers
    parsed and skipped them itself), other-tenant rows land in this
    view's ``filtered_rows``, and the width pin is per-view.
    """

    def __init__(self, demux: TrafficDemux,
                 model_filter: Optional[str] = None,
                 match_unkeyed: Optional[bool] = None,
                 expected_features: Optional[int] = None):
        self._demux = demux
        self.offset = 0
        self.rows_read = 0
        self.bad_lines = 0
        self.overcap_skips = 0
        self.filtered_rows = 0
        self._model_filter = (str(model_filter)
                              if model_filter is not None else None)
        self._match_unkeyed = (model_filter is None
                               if match_unkeyed is None
                               else bool(match_unkeyed))
        self._width = (int(expected_features)
                       if expected_features else None)
        self.last_trace_ids: list = []

    @property
    def path(self) -> str:
        return self._demux.path

    counters = TrafficLog.counters
    seek = TrafficLog.seek

    def read_new(self) -> Optional[Tuple[np.ndarray, np.ndarray,
                                         Optional[np.ndarray]]]:
        """Advance the shared tailer, then replay every window record
        past this view's offset through its tenant filter.  Same return
        contract as `TrafficLog.read_new`."""
        with self._demux._lock:
            if self._demux._advance() is None:
                return None
            feats, labels, weights, traces = [], [], [], []
            any_weight = False
            for rec in self._demux._records:
                if rec.start < self.offset:
                    continue
                if rec.kind == "overcap":
                    self.bad_lines += 1
                    self.overcap_skips += 1
                    continue
                if rec.kind == "bad":
                    self.bad_lines += 1
                    continue
                if rec.model is None:
                    if not self._match_unkeyed:
                        self.filtered_rows += 1
                        continue
                elif (self._model_filter is not None
                        and rec.model != self._model_filter):
                    self.filtered_rows += 1
                    continue
                if self._width is None:
                    self._width = len(rec.row)
                if len(rec.row) != self._width:
                    self.bad_lines += 1
                    continue
                feats.append(rec.row)
                labels.append(rec.label)
                weights.append(1.0 if rec.weight is None else rec.weight)
                traces.append(rec.trace)
                any_weight = any_weight or rec.weight is not None
            self.offset = int(self._demux._pos or 0)
            self._demux._prune()
        if not feats:
            return None
        self.last_trace_ids = traces
        self.rows_read += len(feats)
        X = np.asarray(feats, np.float64)
        y = np.asarray(labels, np.float64)
        w = np.asarray(weights, np.float32) if any_weight else None
        return X, y, w
