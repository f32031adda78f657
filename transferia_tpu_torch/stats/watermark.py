"""End-to-end freshness watermarks (the SLO plane's time axis; the
port's copy of ``transferia_tpu/stats/watermark.py``).

A replication batch is born at some source event time — the broker
write timestamp a queue poll observes (`Message.write_time_ns`), or the
transaction commit time a CDC batch carries (`ChangeItem.commit_time_ns`
/ `ColumnBatch.commit_times`).  Everything the pipeline does after that
point (parse, transform, buffer, publish) is LAG.  This module tracks
two monotone watermarks per transfer:

- **poll watermarks** (`~poll/<topic>:<partition>` keys) — the newest
  source event time a fetch loop has seen, advanced by the queue source
  pump before the batch enters the parsequeue;
- **publish watermarks** (per table) — the newest event time that has
  durably reached the sink, advanced by the Statistician middleware
  after a successful push.  When the batch itself carries no event time
  (non-CDC parsers without system columns), the transfer's poll
  watermark stands in; when there is no poll watermark either (snapshot
  sources that never stamped event time), the publish wall clock is
  recorded with `origin="publish"` so liveness is still visible — but
  no lag is fabricated.

The per-(transfer, table) publish lag lands in the mergeable HDR
histograms (stats/hdr.py) under stage ``replication_lag``, so the fleet
observability plane exports it inside obs segments and any process can
read cluster p50/p99/p999 lag.  The watermark map itself rides obs
segments as a ``watermarks`` payload; `merge_maps` folds N processes'
maps field-wise-MAX per (transfer, table) — max-merge is idempotent and
commutative, so replayed or reordered segments can never regress a
published watermark (the chaos `fleet_distributed` mode asserts this
across a worker kill).

Cardinality is bounded per transfer (a 10k-table transfer must not grow
the obs segment unboundedly): past ``TRANSFERIA_TPU_WATERMARK_TABLES``
entries the oldest per-table entry folds into a ``~overflow`` key — the
same eviction convention as the resource ledger, preserving the max so
the transfer-level freshness rollup stays exact.

Advancing a watermark is bookkeeping, never data plane: the
``watermark.advance`` failpoint fires inside `advance` and any injected
fault is absorbed (counted, watermark unchanged) — a freshness fault
must not fail the batch it rode on.  Worker-kill faults still kill.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from transferia_tpu_torch.abstract.errors import is_worker_kill
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.runtime import knobs
from transferia_tpu_torch.stats import hdr, trace

OVERFLOW = "~overflow"
POLL_PREFIX = "~poll/"
STAGE_LAG = "replication_lag"   # hdr stage the publish lag lands in

ENV_MAX_TABLES = "TRANSFERIA_TPU_WATERMARK_TABLES"
DEFAULT_MAX_TABLES = 256

_ENTRY_FIELDS = ("event_ns", "lsn", "publish_unix")


def _max_tables(environ=os.environ) -> int:
    return max(2, knobs.env_int(ENV_MAX_TABLES, DEFAULT_MAX_TABLES,
                                environ=environ))


def batch_event_ns(batch) -> int:
    """Newest source event time (epoch ns) a batch carries, 0 when it
    carries none.  Carriers, in order: CDC commit times on a columnar
    block, the generic parser's ``_timestamp`` system column (epoch
    microseconds), per-row ChangeItem commit times."""
    from transferia_tpu_torch.abstract.interfaces import is_columnar

    if is_columnar(batch):
        if batch.commit_times is not None and len(batch.commit_times):
            return int(batch.commit_times.max())
        col = batch.columns.get("_timestamp")
        if col is not None:
            try:
                data = col.data
                if data is not None and len(data):
                    return int(data.max()) * 1000
            except (TypeError, ValueError):
                return 0
        return 0
    best = 0
    for it in batch:
        if it.is_row_event() and it.commit_time_ns > best:
            best = it.commit_time_ns
    return best


class WatermarkMap:
    """Process-global monotone watermark registry (singleton
    WATERMARKS).  Keys are (transfer_id, table); poll watermarks use
    ``~poll/<topic>:<partition>`` table keys so they merge and export
    through the same machinery without colliding with real tables."""

    def __init__(self, max_tables: Optional[int] = None):
        self._lock = threading.Lock()
        # transfer -> {table -> {event_ns, lsn, publish_unix, origin}}
        # (insertion-ordered: eviction folds the oldest entry first)
        self._marks: dict[str, dict[str, dict]] = {}
        self._max_tables = max_tables
        self.advances = 0
        self.regressions_skipped = 0
        self.folded_entries = 0
        self.faults_absorbed = 0

    def advance(self, transfer_id: str, table: str, event_ns: int = 0,
                lsn: int = 0, origin: str = "event",
                now: Optional[float] = None) -> bool:
        """Advance the (transfer, table) watermark to max(current, new).
        Returns whether anything moved forward.  Injected faults at the
        ``watermark.advance`` site are absorbed — freshness bookkeeping
        never fails the data plane (worker kills still propagate)."""
        if not transfer_id or not table:
            return False
        try:
            failpoint("watermark.advance")
        except BaseException as e:
            if is_worker_kill(e):
                raise
            with self._lock:
                self.faults_absorbed += 1
            return False
        now = time.time() if now is None else now
        with self._lock:
            tables = self._marks.get(transfer_id)
            if tables is None:
                tables = self._marks[transfer_id] = {}
            entry = tables.get(table)
            if entry is None:
                self._evict_locked(tables)
                entry = tables[table] = {
                    "event_ns": 0, "lsn": 0, "publish_unix": 0.0,
                    "origin": origin}
            moved = False
            if int(event_ns) > entry["event_ns"]:
                entry["event_ns"] = int(event_ns)
                entry["origin"] = origin
                moved = True
            if int(lsn) > entry["lsn"]:
                entry["lsn"] = int(lsn)
                moved = True
            if now > entry["publish_unix"]:
                entry["publish_unix"] = round(float(now), 6)
                moved = moved or entry["event_ns"] == 0
            if moved:
                self.advances += 1
            else:
                self.regressions_skipped += 1
        if moved:
            trace.instant("watermark_advance", transfer_id=transfer_id,
                          table=table, origin=origin)
        return moved

    def _evict_locked(self, tables: dict) -> None:
        """Fold oldest entries into ``~overflow`` (field-wise max) when
        a transfer's table map is full — the ledger's eviction
        convention, max-preserving so rollups stay exact."""
        limit = self._max_tables if self._max_tables is not None \
            else _max_tables()
        while len(tables) >= limit:
            victim = next((t for t in tables if t != OVERFLOW), None)
            if victim is None:
                return
            old = tables.pop(victim)
            sink = tables.get(OVERFLOW)
            if sink is None:
                old["origin"] = "overflow"
                tables[OVERFLOW] = old
            else:
                for f in _ENTRY_FIELDS:
                    sink[f] = max(sink[f], old[f])
            self.folded_entries += 1

    def observe_publish(self, transfer_id: str, batch,
                        now_ns: Optional[int] = None) -> Optional[float]:
        """Sink-publish hook (Statistician): record end-to-end lag into
        the ``replication_lag`` histogram and advance the publish
        watermark.  Returns the lag in seconds, or None when the batch
        (and the transfer's poll watermark) carry no event time."""
        from transferia_tpu_torch.abstract.interfaces import is_columnar

        if not transfer_id:
            return None
        now_ns = time.time_ns() if now_ns is None else now_ns
        event_ns = batch_event_ns(batch)
        origin = "event"
        if not event_ns:
            event_ns = self.poll_event_ns(transfer_id)
            origin = "poll"
        if is_columnar(batch):
            table = str(batch.table_id)
            lsn = int(batch.lsns.max()) if batch.lsns is not None \
                and len(batch.lsns) else 0
        else:
            table = next((str(it.table_id) for it in batch
                          if it.is_row_event()), "")
            lsn = max((it.lsn for it in batch if it.is_row_event()),
                      default=0)
        if not table:
            return None
        if not event_ns:
            self.advance(transfer_id, table, 0, lsn, origin="publish",
                         now=now_ns / 1e9)
            return None
        lag = max(0.0, (now_ns - event_ns) / 1e9)
        self.advance(transfer_id, table, event_ns, lsn, origin=origin,
                     now=now_ns / 1e9)
        hdr.observe(STAGE_LAG, lag)
        return lag

    def poll_event_ns(self, transfer_id: str) -> int:
        """Newest poll-watermark event time for a transfer (0 = none)."""
        with self._lock:
            tables = self._marks.get(transfer_id)
            if not tables:
                return 0
            return max((e["event_ns"] for t, e in tables.items()
                        if t.startswith(POLL_PREFIX)), default=0)

    def snapshot(self) -> dict:
        """The obs-segment ``watermarks`` payload:
        {transfer: {table: {event_ns, lsn, publish_unix, origin}}}."""
        with self._lock:
            return {tid: {t: dict(e) for t, e in tables.items()}
                    for tid, tables in sorted(self._marks.items())}

    def reset(self) -> None:
        with self._lock:
            self._marks.clear()
            self.advances = 0
            self.regressions_skipped = 0
            self.folded_entries = 0
            self.faults_absorbed = 0


WATERMARKS = WatermarkMap()


def _clean_entry(raw) -> Optional[dict]:
    if not isinstance(raw, dict):
        return None
    out = {"event_ns": 0, "lsn": 0, "publish_unix": 0.0,
           "origin": str(raw.get("origin", "event"))}
    try:
        out["event_ns"] = max(0, int(raw.get("event_ns", 0) or 0))
        out["lsn"] = max(0, int(raw.get("lsn", 0) or 0))
        out["publish_unix"] = max(0.0, float(raw.get("publish_unix",
                                                     0.0) or 0.0))
    except (TypeError, ValueError):
        return None
    return out


def merge_maps(maps: list) -> dict:
    """Fold N processes' watermark payloads field-wise MAX per
    (transfer, table).  Commutative and idempotent — segment order,
    replays and overlapping export windows cannot regress a published
    watermark.  Junk-tolerant: torn entries contribute nothing."""
    out: dict[str, dict[str, dict]] = {}
    for m in maps:
        if not isinstance(m, dict):
            continue
        for tid, tables in m.items():
            if not isinstance(tables, dict):
                continue
            dst = out.setdefault(str(tid), {})
            for table, raw in tables.items():
                entry = _clean_entry(raw)
                if entry is None:
                    continue
                cur = dst.get(str(table))
                if cur is None:
                    dst[str(table)] = entry
                    continue
                for f in _ENTRY_FIELDS:
                    if entry[f] > cur[f]:
                        cur[f] = entry[f]
                        if f == "event_ns":
                            cur["origin"] = entry["origin"]
    return {tid: dict(sorted(tables.items()))
            for tid, tables in sorted(out.items())}


def summarize(merged: dict, now: Optional[float] = None) -> dict:
    """Per-transfer freshness rollup for the fleet pane: table count,
    the max-lag (oldest) published event watermark, and its lag vs
    `now`.  Poll/overflow keys inform liveness but only real published
    tables define the freshness floor; transfers with no event-time
    watermark report lag_ms=None (unknown, not zero)."""
    now = time.time() if now is None else now
    out: dict[str, dict] = {}
    for tid, tables in merged.items():
        published = {t: e for t, e in tables.items()
                     if not t.startswith(POLL_PREFIX)}
        event_marks = [e["event_ns"] for e in published.values()
                       if e["event_ns"] > 0]
        floor_ns = min(event_marks) if event_marks else 0
        last_pub = max((e["publish_unix"] for e in tables.values()),
                       default=0.0)
        out[tid] = {
            "tables": len(published),
            "watermark_unix": round(floor_ns / 1e9, 6) if floor_ns
            else 0.0,
            "lag_ms": round(max(0.0, now - floor_ns / 1e9) * 1000.0, 3)
            if floor_ns else None,
            "last_publish_unix": round(last_pub, 6),
        }
    return out
