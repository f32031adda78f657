"""Per-transfer resource ledger: who spent what, attributed causally
(the port's copy of ``transferia_tpu/stats/ledger.py``).

`DeviceTelemetry` (stats/trace.py) answers "what did the process
spend"; with many concurrent transfers from N tenants on one
process, that's telemetry soup — "which tenant burned the link" and
"where did transfer X's 2 seconds go" have no answer in global
counters.  This module is the attribution plane: a contextvar carries
the active `(transfer_id, tenant, part)` scope, and every resource
event recorded while that scope is active lands in that scope's ledger
entry.  The fleet lane sets (transfer_id, tenant) around a ticket run;
the snapshot engine narrows to the part; worker threads adopt the
submitting scope exactly like trace contexts (stats/trace.py adopted).

Conservation is the design invariant: the process-global
`DeviceTelemetry` counters route THROUGH `LEDGER.add` (see the
record_* methods in stats/trace.py), so for the shared fields

    sum over all ledger entries (incl. the unattributed bucket)
        == the global DeviceTelemetry counter

holds by construction, and the `/debug/ledger` payload carries the
reconciliation so drift (a resource event recorded outside the ledger
hook) is visible immediately.  Work with no scope set — module
warmups, stray background threads — lands in the `(-, -, -)`
unattributed entry rather than vanishing.

Cardinality is bounded in two tiers (the fleet runs 100k+ transfers
through one process over its lifetime):

- at most `TRANSFERIA_TPU_LEDGER_ENTRIES` (default 4096) live
  (transfer, tenant, part) entries; overflow folds into a per-tenant
  `~overflow` entry (totals stay conserved, per-transfer detail is
  shed oldest-first);
- the prometheus fold (`fold_into`) publishes aggregate ledger_*
  counters plus per-TENANT counters for at most `MAX_PROM_TENANTS`
  tenants (name-mangled, REST fold into `ledger_tenant_other_*`) —
  per-transfer series never reach /metrics.
"""

from __future__ import annotations

import contextvars
import os
import re
import threading
import time
import weakref
from typing import NamedTuple, Optional

from transferia_tpu_torch.runtime import knobs, lockwatch

UNATTRIBUTED = "-"


def _telemetry_snapshot() -> dict:
    """Lazy import: trace.py imports this module back for the
    record-through-ledger hooks."""
    from transferia_tpu_torch.stats.trace import TELEMETRY

    return TELEMETRY.snapshot()

# every accountable resource dimension; append-only (snapshot shape is
# a wire format for /debug/ledger and `trtpu top`)
FIELDS = (
    "rows_in", "rows_out", "bytes_in", "bytes_out",
    "h2d_bytes", "d2h_bytes",
    "h2d_encoded_bytes", "h2d_raw_equiv_bytes",
    "launches", "compiles", "compile_seconds", "kernel_seconds",
    "decode_wait_seconds", "queue_wait_seconds",
    "retries", "lease_steals", "chaos_fires",
    # staged two-phase sink commits (abstract/commit.py): granted
    # publish decisions, fenced (stale-epoch) attempts, and rows the
    # staging dedup window dropped before publish
    "commits", "commit_fences", "dedup_rows_dropped",
    # pool-once encoded Arrow wire (interchange/convert
    # EncodedWireState): dict pool bytes shipped (once per stream) vs
    # codes-only batch bytes
    "pool_bytes_shipped", "codes_bytes_shipped",
)

_INT_FIELDS = frozenset(f for f in FIELDS if not f.endswith("_seconds"))

MAX_PROM_TENANTS = 32
# the per-tenant prometheus surface: bounded to the dimensions an
# operator alerts on (full detail lives on /debug/ledger)
_PROM_TENANT_FIELDS = ("rows_out", "bytes_out", "h2d_bytes",
                       "launches", "retries", "chaos_fires")


class LedgerKey(NamedTuple):
    transfer_id: str
    tenant: str
    part: str


_scope: "contextvars.ContextVar[Optional[LedgerKey]]" = \
    contextvars.ContextVar("trtpu_ledger_scope", default=None)


def _sanitize(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", name) or "_"


class _Entry:
    __slots__ = ("values", "first_seen", "last_seen")

    def __init__(self):
        self.values = dict.fromkeys(FIELDS, 0)
        self.first_seen = time.time()
        self.last_seen = self.first_seen


class ResourceLedger:
    """The process-wide attribution table (module singleton `LEDGER`).

    `add(**fields)` attributes to the ambient scope; `add_for(...)`
    attributes to an explicit key (callers that know the identity but
    run outside the scope, e.g. the fleet scheduler rebalancing a
    ticket under its own lock).  Both are cheap enough for per-batch
    call sites: one contextvar read + one dict update under a lock."""

    def __init__(self, max_entries: Optional[int] = None):
        if max_entries is None:
            max_entries = knobs.env_int(
                "TRANSFERIA_TPU_LEDGER_ENTRIES", 4096)
        self.max_entries = max(8, max_entries)
        self._lock = lockwatch.named_lock("ledger.records")
        # serializes fold_into: concurrent folds into one target would
        # both read the same baseline and double-publish the delta
        # (DeviceTelemetry.fold_into holds its lock for the same
        # reason).  Separate from _lock so folds never stall record_*.
        self._fold_lock = lockwatch.named_lock("ledger.fold")
        self._entries: dict[LedgerKey, _Entry] = {}
        # insertion order for evictions; a dict for O(1) removal
        self._order: dict[LedgerKey, None] = {}
        self._folded_entries = 0  # entries shed into ~overflow
        # per-target fold baselines (same pattern as DeviceTelemetry):
        # weak keys so a discarded Metrics registry frees its baseline
        # instead of leaking it — and, worse, a reused id() would hand
        # a FRESH registry a dead registry's baselines, silently
        # suppressing its counter deltas
        self._prev_folds: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()

    # -- scope ---------------------------------------------------------------
    def context(self, transfer_id: Optional[str] = None,
                tenant: Optional[str] = None,
                part: Optional[str] = None) -> "_Scope":
        """Enter an attribution scope; unset fields INHERIT from the
        ambient scope (the fleet lane sets transfer+tenant, the part
        uploader narrows to the part without knowing the tenant)."""
        return _Scope(transfer_id, tenant, part)

    @staticmethod
    def current_key() -> Optional[LedgerKey]:
        """The ambient scope — capture before a thread hop, re-enter
        on the worker with `adopted()`."""
        return _scope.get()

    @staticmethod
    def adopted(key: Optional[LedgerKey]) -> "_Adopted":
        return _Adopted(key)

    # -- recording -----------------------------------------------------------
    def add(self, **fields) -> None:
        key = _scope.get()
        if key is None:
            key = LedgerKey(UNATTRIBUTED, UNATTRIBUTED, UNATTRIBUTED)
        self._add(key, fields)

    def add_for(self, transfer_id: str, tenant: str = UNATTRIBUTED,
                part: str = UNATTRIBUTED, **fields) -> None:
        self._add(LedgerKey(transfer_id, tenant, part), fields)

    def _add(self, key: LedgerKey, fields: dict) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                if len(self._entries) >= self.max_entries:
                    key = self._evict_locked(key)
                    e = self._entries.get(key)
                if e is None:
                    e = self._entries[key] = _Entry()
                    self._order[key] = None
            vals = e.values
            for name, v in fields.items():
                vals[name] += v
            e.last_seen = time.time()

    def _evict_locked(self, incoming: LedgerKey) -> LedgerKey:
        """At the cardinality bound: fold the OLDEST per-part entry of
        some transfer into its tenant's `~overflow` entry and route the
        incoming key there too when no room frees up.  Totals (and so
        conservation) are preserved exactly — only per-transfer detail
        degrades."""
        # iterate a copy: the body removes `old` and may append the
        # `~overflow` sink, either of which would skew a live iterator
        # off the oldest-first order this method promises
        for old in list(self._order):
            if old.transfer_id in (UNATTRIBUTED, "~overflow"):
                continue
            dst = LedgerKey("~overflow", old.tenant, UNATTRIBUTED)
            src = self._entries.pop(old)
            del self._order[old]
            sink = self._entries.get(dst)
            if sink is None:
                sink = self._entries[dst] = _Entry()
                self._order[dst] = None
            for name, v in src.values.items():
                sink.values[name] += v
            self._folded_entries += 1
            if len(self._entries) < self.max_entries:
                return incoming
        return LedgerKey("~overflow", incoming.tenant, UNATTRIBUTED)

    # -- reading -------------------------------------------------------------
    def snapshot(self) -> dict:
        """The `/debug/ledger` payload: per-transfer entries (parts
        aggregated + listed), per-tenant rollups, grand totals, and the
        conservation reconciliation against DeviceTelemetry."""
        # telemetry is read BEFORE the entries (and telemetry records
        # route through the ledger first), so at this point the ledger
        # can only lead the counters, never trail them — see
        # conservation() for what each drift sign means
        tel = _telemetry_snapshot()
        with self._lock:
            items = [(k, dict(e.values), e.first_seen, e.last_seen)
                     for k, e in self._entries.items()]
            folded = self._folded_entries
        transfers: dict[str, dict] = {}
        tenants: dict[str, dict] = {}
        totals = dict.fromkeys(FIELDS, 0)
        for key, vals, first, last in items:
            tr = transfers.setdefault(key.transfer_id, {
                "tenant": key.tenant, "parts": 0,
                **dict.fromkeys(FIELDS, 0)})
            if tr["tenant"] != key.tenant:
                # the ~overflow row aggregates entries from several
                # tenants; don't attribute them all to the first one
                # (per-tenant rollups below stay exact)
                tr["tenant"] = "~multiple"
            tr["parts"] += 1 if key.part != UNATTRIBUTED else 0
            tn = tenants.setdefault(key.tenant, {
                "transfers": set(), **dict.fromkeys(FIELDS, 0)})
            tn["transfers"].add(key.transfer_id)
            for name, v in vals.items():
                tr[name] += v
                tn[name] += v
                totals[name] += v
        for tn in tenants.values():
            tn["transfers"] = len(tn["transfers"])
        for agg in (totals, *transfers.values(), *tenants.values()):
            for name in FIELDS:
                if name not in _INT_FIELDS:
                    agg[name] = round(agg[name], 6)
        return {
            "entries": len(items),
            "max_entries": self.max_entries,
            "overflow_folded": folded,
            "transfers": dict(sorted(transfers.items())),
            "tenants": dict(sorted(tenants.items())),
            "totals": totals,
            "conservation": self.conservation(totals, tel=tel),
        }

    def conservation(self, totals: Optional[dict] = None,
                     tel: Optional[dict] = None) -> dict:
        """Reconcile ledger totals against the global DeviceTelemetry
        counters for the fields that route through the ledger hooks.

        drift == 0 for every field is the quiescent invariant the
        tests pin.  On a live poll the ledger may transiently LEAD the
        counters (records bill the ledger first, and telemetry is read
        first here), so negative drift is in-flight activity and still
        `ok`; positive drift — a telemetry increment the attribution
        hooks never saw — is the violation this check exists to catch.
        """
        if tel is None:
            tel = _telemetry_snapshot()
        if totals is None:
            totals = self.snapshot()["totals"]
        out = {}
        for lf, tf in (("h2d_bytes", "h2d_bytes"),
                       ("d2h_bytes", "d2h_bytes"),
                       ("h2d_encoded_bytes", "h2d_encoded_bytes"),
                       ("h2d_raw_equiv_bytes", "h2d_raw_equiv_bytes"),
                       ("launches", "device_launches"),
                       ("compiles", "compile_events")):
            drift = tel[tf] - totals[lf]
            out[lf] = {"ledger": totals[lf], "telemetry": tel[tf],
                       "drift": drift}
        out["ok"] = all(v["drift"] <= 0 for v in out.values()
                        if isinstance(v, dict))
        return out

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._order.clear()
            self._folded_entries = 0
            self._prev_folds.clear()

    # -- prometheus ----------------------------------------------------------
    def _rollups(self) -> tuple[dict, dict, int, int]:
        """(totals, per-tenant sums, entries, overflow_folded) — the
        fold_into subset of snapshot(): no per-transfer aggregation, no
        sorting of transfers, no telemetry reconciliation read.  This
        runs on every part completion and heartbeat; the full snapshot
        is the /debug/ledger surface only."""
        with self._lock:
            items = [(k.tenant, dict(e.values))
                     for k, e in self._entries.items()]
            folded = self._folded_entries
        totals = dict.fromkeys(FIELDS, 0)
        tenants: dict[str, dict] = {}
        for tenant, vals in items:
            tn = tenants.setdefault(tenant, dict.fromkeys(FIELDS, 0))
            for name, v in vals.items():
                tn[name] += v
                totals[name] += v
        return totals, tenants, len(items), folded

    def fold_into(self, metrics) -> None:
        """Delta-fold into a Metrics registry: aggregate ledger_*
        counters + bounded per-tenant counters (see module doc).
        Idempotent per target, like DeviceTelemetry.fold_into, and
        serialized under _fold_lock — two part-completion threads
        folding into the same registry would otherwise read one
        baseline and each publish the full delta."""
        with self._fold_lock:
            totals, tenants, entries, folded = self._rollups()
            prev = self._prev_folds.setdefault(metrics, {})
            for name in FIELDS:
                self._fold_counter(metrics, f"ledger_{name}",
                                   totals[name], prev)
            ranked = [(t, v) for t, v in tenants.items()
                      if t != UNATTRIBUTED]
            ranked.sort(key=lambda kv: -kv[1]["bytes_out"])
            # bounded per-tenant series: top MAX_PROM_TENANTS by
            # bytes_out get named counters; the rest stay on
            # /debug/ledger only (the aggregate ledger_* counters
            # above still include them)
            for tenant, vals in ranked[:MAX_PROM_TENANTS]:
                label = _sanitize(tenant)
                for name in _PROM_TENANT_FIELDS:
                    self._fold_counter(
                        metrics, f"ledger_tenant_{label}_{name}",
                        vals[name], prev)
            metrics.gauge("ledger_entries").set(entries)
            metrics.gauge("ledger_overflow_folded").set(folded)

    @staticmethod
    def _fold_counter(metrics, name: str, value, prev: dict) -> None:
        delta = value - prev.get(name, 0)
        if delta > 0:
            metrics.counter(name).inc(delta)
        prev[name] = max(prev.get(name, 0), value)


class _Scope:
    __slots__ = ("_fields", "_token")

    def __init__(self, transfer_id, tenant, part):
        self._fields = (transfer_id, tenant, part)
        self._token = None

    def __enter__(self):
        base = _scope.get()
        transfer_id, tenant, part = self._fields
        key = LedgerKey(
            transfer_id if transfer_id is not None
            else (base.transfer_id if base else UNATTRIBUTED),
            tenant if tenant is not None
            else (base.tenant if base else UNATTRIBUTED),
            part if part is not None
            else (base.part if base else UNATTRIBUTED),
        )
        self._token = _scope.set(key)
        return key

    def __exit__(self, *exc):
        if self._token is not None:
            _scope.reset(self._token)
            self._token = None
        return False


class _Adopted:
    __slots__ = ("_key", "_token")

    def __init__(self, key: Optional[LedgerKey]):
        self._key = key
        self._token = None

    def __enter__(self):
        if self._key is not None:
            self._token = _scope.set(self._key)
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            _scope.reset(self._token)
            self._token = None
        return False


LEDGER = ResourceLedger()


# -- `trtpu top` rendering ---------------------------------------------------

_TOP_COLS = (
    ("transfer", 22), ("tenant", 10), ("rows_in", 9), ("rows_out", 9),
    ("mb_in", 8), ("mb_out", 8), ("h2d_mb", 8), ("launch", 7),
    ("wait_s", 7), ("retry", 6), ("steal", 6), ("fires", 6),
    ("commit", 7), ("fence", 6), ("dedup", 6),
)


def format_top(snapshot: dict, limit: int = 20) -> str:
    """Render one `trtpu top` frame from a /debug/ledger snapshot."""
    lines = []
    tot = snapshot["totals"]
    cons = snapshot.get("conservation", {})
    lines.append(
        f"ledger: {snapshot['entries']} entries "
        f"({snapshot['overflow_folded']} folded)  "
        f"rows {tot['rows_in']}→{tot['rows_out']}  "
        f"h2d {tot['h2d_bytes'] / 1e6:.1f}MB  "
        f"launches {tot['launches']}  "
        f"commits {tot.get('commits', 0)} "
        f"({tot.get('commit_fences', 0)} fenced, "
        f"{tot.get('dedup_rows_dropped', 0)} deduped)  "
        f"conservation {'OK' if cons.get('ok') else 'DRIFT'}")
    tenants = snapshot.get("tenants", {})
    if tenants:
        roll = "  ".join(
            f"{t}[{v['transfers']}tx "
            f"{v['bytes_out'] / 1e6:.1f}MB out]"
            for t, v in sorted(
                tenants.items(),
                key=lambda kv: -kv[1]["bytes_out"])[:8])
        lines.append(f"tenants: {roll}")
    slo_view = snapshot.get("slo")
    if isinstance(slo_view, dict) and slo_view.get("objectives"):
        burning = slo_view.get("burning", []) or []
        lags = [row.get("lag_ms") for row in
                (slo_view.get("watermarks", {}) or {}).values()
                if isinstance(row.get("lag_ms"), (int, float))]
        lines.append(
            f"slo: {'BURNING ' + ','.join(burning) if burning else 'OK'}"
            f" ({len(slo_view['objectives'])} objectives)"
            + (f"  max lag {max(lags):.0f}ms" if lags else ""))
    header = " ".join(f"{name:>{w}}" for name, w in _TOP_COLS)
    lines.append(header)
    rows = sorted(snapshot.get("transfers", {}).items(),
                  key=lambda kv: -(kv[1]["bytes_out"]
                                   + kv[1]["bytes_in"]))
    for transfer_id, v in rows[:limit]:
        wait = v["decode_wait_seconds"] + v["queue_wait_seconds"]
        cells = (transfer_id[:22], v["tenant"][:10], v["rows_in"],
                 v["rows_out"], f"{v['bytes_in'] / 1e6:.1f}",
                 f"{v['bytes_out'] / 1e6:.1f}",
                 f"{v['h2d_bytes'] / 1e6:.1f}", v["launches"],
                 f"{wait:.2f}", v["retries"], v["lease_steals"],
                 v["chaos_fires"], v.get("commits", 0),
                 v.get("commit_fences", 0),
                 v.get("dedup_rows_dropped", 0))
        lines.append(" ".join(
            f"{c:>{w}}" for c, (_n, w) in zip(cells, _TOP_COLS)))
    if len(rows) > limit:
        lines.append(f"... {len(rows) - limit} more transfers")
    return "\n".join(lines)
