"""Fleet-wide observability plane: durable cross-process export + merge
(the port's copy of ``transferia_tpu/stats/fleetobs.py``).

The tracer, the ledger and the device counters give one PROCESS a
complete causal story — a linked Perfetto timeline, a
conservation-checked resource ledger, always-on device counters.  The
distributed fleet makes that insufficient: a
`trtpu worker` process's spans, ledger, and DeviceStats die with the
process, so a 10-worker transfer has no single pane and a SIGKILLed
worker takes its last minutes of observability to the grave.

This module is the durable half:

- **ObsExporter** — each worker process periodically (heartbeat
  cadence, plus part completion, ticket completion, and a final flush
  on drain) serializes a SEGMENT through the coordinator
  (`put_obs_segment` on memory / filestore / s3 — same trio and
  retention conventions as fleet tickets): a bounded DELTA of the
  trace ring, plus the CUMULATIVE resource-ledger snapshot, device
  telemetry counters, and per-stage latency histograms (stats/hdr.py).
  Export is strictly best-effort: a failed export never fails the part
  or ticket it rode on (`obs.export` failpoint pins that), and a
  SIGKILL loses at most one export interval.

- **merge_segments** — any reader (the scheduler/leader, `trtpu top
  --fleet`, `GET /debug/fleet/obs`) folds N processes' segments into
  one fleet view.  Merge rules: cumulative payloads (ledger /
  telemetry / histograms) take the LATEST segment per PROCESS (pid)
  and sum across processes — re-reading an old segment can never
  double-count; span deltas UNION across all segments with
  (pid, span) dedup; worker liveness is the newest segment age per
  worker label.  The cross-process conservation check — merged ledger
  totals == Σ per-process totals, field by field — is recomputed from
  two independent aggregations so a merge bug or torn segment shows as
  DRIFT instead of silently lying.  Torn/truncated segments are
  skipped and counted (`obs.merge` failpoint pins that).

- **export_fleet_chrome_trace** — `trtpu trace --fleet <transfer>`:
  stitches span deltas from N processes into ONE Perfetto timeline.
  Each process's spans are shifted onto the shared wall-clock axis via
  its exported capture epoch, each process renders as its own pid lane,
  and the already-propagated trace ids (Flight metadata, shm framing,
  fleet tickets) make the cross-process parent links render as flow
  arrows.

Export semantics are AT-LEAST-ONCE, deliberately: segments are
idempotent ((worker, seq) re-put replaces; cumulative payloads merge
by latest-per-pid), so a retried export or a replayed read changes
nothing — exactly-once machinery would buy no additional correctness
for monotone counters and would couple the data plane's commit path to
the observability plane's availability.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import socket
import threading
import time
import weakref
from typing import Optional

from transferia_tpu_torch.abstract.errors import is_worker_kill
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.runtime import knobs, lockwatch
from transferia_tpu_torch.stats import hdr, trace, watermark
# _INT_FIELDS is the ledger's own exact-vs-rounded field split — the
# merge's conservation check must agree with it, so share the set
from transferia_tpu_torch.stats.ledger import FIELDS, LEDGER, _INT_FIELDS

logger = logging.getLogger(__name__)

DEFAULT_SCOPE = "fleet"
ENV_SCOPE = "TRANSFERIA_TPU_OBS_SCOPE"
ENV_EXPORT = "TRANSFERIA_TPU_OBS_EXPORT"        # "0" = kill switch
ENV_MAX_SPANS = "TRANSFERIA_TPU_OBS_MAX_SPANS"  # per segment
ENV_MIN_INTERVAL = "TRANSFERIA_TPU_OBS_INTERVAL"
DEFAULT_MAX_SPANS = 4_000
# part completions can be ms apart; exports coalesce to this cadence
# (final flushes always go through)
DEFAULT_MIN_INTERVAL = 1.0
SEGMENT_VERSION = 1


def default_scope(environ=os.environ) -> str:
    return knobs.env_str(ENV_SCOPE, "", environ=environ) or DEFAULT_SCOPE


def export_enabled(environ=os.environ) -> bool:
    return knobs.env_str(ENV_EXPORT, "1",
                         environ=environ) not in ("0", "false", "no")


# -- exporter -----------------------------------------------------------------

class ObsExporter:
    """One process-side export stream to one (coordinator, scope).

    Shared by everything in the process that exports to the same pair
    (see `exporter_for`): the fleet worker and the SnapshotLoaders it
    runs write ONE seq stream, so segments never clobber each other
    and the span delta mark advances once per export.  All state
    mutates under one lock; the put itself happens inside the lock too
    — exports are heartbeat-cadence rare, and serializing them keeps
    the (seq, span-mark) pair atomic with the segment that carries it.
    """

    def __init__(self, coordinator, worker: str,
                 scope: Optional[str] = None):
        # weak coordinator reference: exporters live in a process-wide
        # registry keyed by coordinator (exporter_for) — a strong ref
        # here would keep every coordinator ever exported to (and all
        # its retained state) alive for the process lifetime
        try:
            self._cpref = weakref.ref(coordinator)
        except TypeError:  # unweakrefable test double: hold it
            self._cpref = (lambda obj: (lambda: obj))(coordinator)
        self.worker = worker
        self.scope = scope or default_scope()
        self.enabled = export_enabled() and \
            bool(getattr(coordinator, "supports_obs_segments",
                         lambda: False)())
        self._lock = lockwatch.named_lock("obs.exporter")
        self._seq = 0
        self._span_mark = 0
        self._last_attempt = 0.0
        self.exports = 0
        self.export_failures = 0

    @property
    def cp(self):
        return self._cpref()

    def _build(self, kind: str, seq: int) -> tuple[dict, int]:
        """Assemble one segment (caller holds the lock).  Returns the
        segment and the new span mark to commit on a successful put."""
        max_spans = int(knobs.env_float(ENV_MAX_SPANS,
                                        DEFAULT_MAX_SPANS))
        # one lock hold for (count, ring): reading them separately
        # would let concurrent appends displace the oldest records of
        # this window out of the tail slice uncounted
        total, ring = trace.spans_with_count()
        new = total - self._span_mark
        recorded: list = []
        dropped = 0
        if new > 0:
            tail = ring[-new:]
            dropped = max(0, new - len(tail))      # evicted by the ring
            if len(tail) > max_spans:
                dropped += len(tail) - max_spans
                tail = tail[-max_spans:]
            for rec in tail:
                args = rec[7]
                if args is not None:
                    args = {k: trace._jsonable(v) for k, v in args.items()}
                recorded.append([rec[0], rec[1], rec[2], rec[3], rec[4],
                                 rec[5], rec[6], args, rec[8], rec[9],
                                 rec[10]])
        ledger_snap = LEDGER.snapshot()
        seg = {
            "v": SEGMENT_VERSION,
            "worker": self.worker,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "seq": seq,
            "ts": time.time(),
            "kind": kind,
            "epoch_unix": trace.epoch_unix(),
            "spans": recorded,
            "spans_dropped": dropped,
            "ledger": {
                "totals": ledger_snap["totals"],
                "transfers": ledger_snap["transfers"],
                "tenants": ledger_snap["tenants"],
                "conservation_ok":
                    bool(ledger_snap["conservation"].get("ok")),
            },
            "telemetry": trace.TELEMETRY.snapshot(),
            "hists": hdr.STAGES.snapshot(),
            "watermarks": watermark.WATERMARKS.snapshot(),
        }
        watch = lockwatch.active()
        if watch is not None:
            # cumulative per process, merged latest-per-pid like the
            # ledger: the fleet pane's "zero inversions" assertion must
            # survive worker restarts and coalesced exports
            seg["lockwatch"] = watch.snapshot()
        return seg, total

    def export(self, kind: str = "periodic") -> bool:
        """Serialize and durably put one segment.  Best-effort: every
        failure is swallowed (logged + counted) except worker kills —
        chaos kill semantics must keep killing whatever they hit.
        Non-final exports coalesce to TRANSFERIA_TPU_OBS_INTERVAL."""
        cp = self.cp
        if not self.enabled or cp is None:
            return False
        final = kind == "final"
        # non-final exports never WAIT: if another export holds the
        # lock (e.g. the heartbeat thread stuck in a slow coordinator
        # put), a part-completion export must coalesce into it, not
        # stall the data-plane thread behind a best-effort write
        if not self._lock.acquire(blocking=final):
            return False
        try:
            now = time.monotonic()
            if not final and now - self._last_attempt < \
                    knobs.env_float(ENV_MIN_INTERVAL,
                                    DEFAULT_MIN_INTERVAL):
                return False
            self._last_attempt = now
            seq = self._seq + 1
            seg, new_mark = self._build(kind, seq)
            try:
                sp = trace.span("obs_export", worker=self.worker,
                                seq=seq, kind=kind)
                with sp:
                    failpoint("obs.export")
                    cp.put_obs_segment(self.scope, seg)
                    if sp:
                        sp.add(spans=len(seg["spans"]))
            except Exception as e:
                if is_worker_kill(e):
                    raise
                # seq and span mark stay: the next export RE-SENDS the
                # same window under the same seq (idempotent replace) —
                # at most one export interval is ever lost
                self.export_failures += 1
                logger.warning(
                    "obs export %s seq %d failed (best-effort; next "
                    "beat retries the window): %s", self.worker, seq, e)
                return False
            self._seq = seq
            self._span_mark = new_mark
            self.exports += 1
        finally:
            self._lock.release()
        if final or seq % 16 == 0:
            try:
                cp.gc_obs_segments(self.scope)
            except Exception as e:  # GC is advisory
                logger.debug("obs gc failed: %s", e)
        return True


# One exporter per (coordinator, scope, worker) per process — a fleet
# worker and the loaders it runs share one stream (the ambient
# contextvar carries the worker's exporter into the loader), while
# thread-mode supervisors running N workers in one process keep one
# stream each.
_reg_lock = threading.Lock()
_registry: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_ambient: "contextvars.ContextVar[Optional[ObsExporter]]" = \
    contextvars.ContextVar("trtpu_obs_exporter", default=None)


class ambient_exporter:
    """Install an exporter as the ambient one for the calling context
    (the fleet worker wraps each ticket run so the SnapshotLoader it
    constructs joins the worker's export stream)."""

    __slots__ = ("_exp", "_token")

    def __init__(self, exp: Optional[ObsExporter]):
        self._exp = exp
        self._token = None

    def __enter__(self):
        if self._exp is not None:
            self._token = _ambient.set(self._exp)
        return self._exp

    def __exit__(self, *exc):
        if self._token is not None:
            _ambient.reset(self._token)
            self._token = None
        return False


def exporter_for(coordinator, worker: str,
                 scope: Optional[str] = None) -> ObsExporter:
    """The process-wide exporter for (coordinator, scope, worker) — or
    the AMBIENT one when the caller runs inside a fleet worker's ticket
    context against the same coordinator (one process, one stream)."""
    amb = _ambient.get()
    if amb is not None and amb.cp is coordinator:
        return amb
    scope = scope or default_scope()
    with _reg_lock:
        try:
            per = _registry.setdefault(coordinator, {})
        except TypeError:        # unweakrefable test double
            return ObsExporter(coordinator, worker, scope)
        exp = per.get((scope, worker))
        if exp is None:
            exp = per[(scope, worker)] = ObsExporter(
                coordinator, worker, scope)
        return exp


# -- merge --------------------------------------------------------------------

def _proc_key(seg: dict) -> tuple:
    """Process identity across the FLEET: (host, pid).  Bare pids
    collide across hosts (every containerized worker is pid 1) — a
    pid-keyed merge would silently drop one host's cumulative state."""
    return (str(seg.get("host", "")), int(seg.get("pid", 0) or 0))


def _latest_per(segments: list[dict], key_fn) -> dict:
    """Newest segment per `key_fn(seg)`, by (ts, seq) — the
    cumulative-merge rule."""
    out: dict = {}
    for seg in segments:
        k = key_fn(seg)
        cur = out.get(k)
        mark = (seg.get("ts", 0.0) or 0.0, seg.get("seq", 0) or 0)
        if cur is None or mark >= (cur.get("ts", 0.0) or 0.0,
                                   cur.get("seq", 0) or 0):
            out[k] = seg
    return out


def _sum_fields(target: dict, values: dict) -> None:
    for name in FIELDS:
        v = values.get(name, 0)
        if isinstance(v, (int, float)):
            target[name] = target.get(name, 0) + v


def _parse_segments(raw: list) -> tuple[list[dict], int]:
    """Validate/normalize raw segments; torn or truncated ones are
    skipped and counted, never raised (the `obs.merge` failpoint lands
    here: an injected fault IS a torn segment)."""
    good: list[dict] = []
    corrupt = 0
    sp = trace.span("obs_parse_segments", segments=len(raw or []))
    with sp:
        for seg in raw or []:
            try:
                failpoint("obs.merge")
                if not isinstance(seg, dict) or "worker" not in seg:
                    raise ValueError("not a segment")
                int(seg.get("pid", 0))
                int(seg.get("seq", 0))
                float(seg.get("ts", 0.0))
                if not isinstance(seg.get("ledger", {}), dict) or \
                        not isinstance(seg.get("hists", {}), dict) or \
                        not isinstance(seg.get("spans", []), list):
                    raise ValueError("torn segment payload")
                good.append(seg)
            except Exception:
                corrupt += 1
        if sp:
            sp.add(corrupt=corrupt)
    return good, corrupt


def merge_segments(raw_segments: list,
                   now: Optional[float] = None) -> dict:
    """Fold segments into the fleet view (`/debug/fleet/obs` payload):
    per-worker liveness, per-(transfer, tenant) merged ledger rows,
    fleet totals, merged per-stage latency histograms, and the
    cross-process conservation check."""
    now = time.time() if now is None else now
    with trace.span("obs_merge", segments=len(raw_segments or [])):
        segments, corrupt = _parse_segments(raw_segments)
        by_pid = _latest_per(segments, _proc_key)
        # liveness per (worker label, host): two pid-1 containers with
        # the same worker index produce the same LABEL on different
        # hosts — they are different workers
        by_worker = _latest_per(
            segments, lambda s: (str(s.get("worker", "")),
                                 str(s.get("host", ""))))
        label_hosts: dict[str, set] = {}
        for (label, host) in by_worker:
            label_hosts.setdefault(label, set()).add(host)

        workers: dict[str, dict] = {}
        for (label, host), seg in sorted(by_worker.items()):
            ts = float(seg.get("ts", 0.0) or 0.0)
            shown = label if len(label_hosts[label]) == 1 \
                else f"{label}@{host}"
            workers[shown] = {
                "pid": seg.get("pid", 0),
                "host": seg.get("host", ""),
                "seq": seg.get("seq", 0),
                "kind": seg.get("kind", ""),
                "age_seconds": round(max(0.0, now - ts), 3),
                "conservation_ok": bool(
                    seg.get("ledger", {}).get("conservation_ok", True)),
                "spans_dropped": seg.get("spans_dropped", 0),
            }

        # cumulative payloads: latest per PROCESS, summed across
        # processes (two exporters in one process — a fleet worker and
        # a bare loader — both carry the same process-global ledger;
        # per-pid latest keeps that from double-counting)
        totals = dict.fromkeys(FIELDS, 0)
        per_pid_totals: dict = {}
        transfer_rows = 0      # per-process ledger rows contributing
        transfers: dict[str, dict] = {}
        tenants: dict[str, dict] = {}
        telemetry: dict = {}
        lockwatch_counters: dict = {}
        lockwatch_findings: list = []
        worker_conservation_ok = True
        for proc, seg in by_pid.items():
            led = seg.get("ledger", {})
            if not led.get("conservation_ok", True):
                worker_conservation_ok = False
            pt = dict.fromkeys(FIELDS, 0)
            _sum_fields(pt, led.get("totals", {})
                        if isinstance(led.get("totals"), dict) else {})
            per_pid_totals[proc] = pt
            _sum_fields(totals, pt)
            trs = led.get("transfers", {})
            if isinstance(trs, dict):
                transfer_rows += len(trs)
                for tid, vals in trs.items():
                    if not isinstance(vals, dict):
                        continue
                    row = transfers.setdefault(tid, {
                        "tenant": vals.get("tenant", "-"),
                        "workers": [],
                        **dict.fromkeys(FIELDS, 0)})
                    if row["tenant"] != vals.get("tenant", "-"):
                        row["tenant"] = "~multiple"
                    label = str(seg.get("worker", proc[1]))
                    if label not in row["workers"]:
                        row["workers"].append(label)
                    _sum_fields(row, vals)
            tns = led.get("tenants", {})
            if isinstance(tns, dict):
                for name, vals in tns.items():
                    if not isinstance(vals, dict):
                        continue
                    row = tenants.setdefault(
                        name, dict.fromkeys(FIELDS, 0))
                    _sum_fields(row, vals)
            tel = seg.get("telemetry", {})
            if isinstance(tel, dict):
                for name, v in tel.items():
                    if isinstance(v, (int, float)):
                        telemetry[name] = telemetry.get(name, 0) + v
            lw = seg.get("lockwatch", {})
            if isinstance(lw, dict):
                for name, v in (lw.get("counters") or {}).items():
                    if isinstance(v, (int, float)):
                        lockwatch_counters[name] = \
                            lockwatch_counters.get(name, 0) + v
                for f in (lw.get("findings") or [])[:8]:
                    if isinstance(f, dict) and \
                            len(lockwatch_findings) < 64:
                        lockwatch_findings.append(
                            dict(f, worker=str(seg.get("worker", ""))))

        # cross-process conservation: the per-transfer aggregation and
        # the per-process totals are INDEPENDENT sums of the same
        # events — field-wise equality is the merge's self-check
        # (fences/retries were billed by the stealing worker's process,
        # so both sums see them exactly once)
        from_transfers = dict.fromkeys(FIELDS, 0)
        for row in transfers.values():
            _sum_fields(from_transfers, row)
        drift = {}
        ok = worker_conservation_ok
        for name in FIELDS:
            d = totals[name] - from_transfers[name]
            # integer fields must balance exactly; *_seconds fields
            # carry per-aggregate rounding from each process's ledger
            # snapshot (6 decimals on the totals AND on every
            # per-transfer row), so the worst-case benign difference
            # scales with processes + contributing rows
            tol = 0.0 if name in _INT_FIELDS \
                else 1e-6 * max(2, len(by_pid) + transfer_rows)
            if abs(d) > tol:
                drift[name] = round(d, 6)
                ok = False
        conservation = {
            "ok": ok,
            "workers_ok": worker_conservation_ok,
            "drift": drift,
            "per_process_totals": {
                f"{host}:{pid}": vals for (host, pid), vals in
                sorted(per_pid_totals.items())
            },
        }

        hists = hdr.merge_stage_maps(
            [seg.get("hists", {}) for seg in by_pid.values()])
        # watermarks merge over ALL segments, not latest-per-pid:
        # max-merge is idempotent, and a SIGKILLed worker's lost final
        # segment must not regress what its earlier segments published
        merged_wm = watermark.merge_maps(
            [seg.get("watermarks") for seg in segments])
        span_count = sum(len(seg.get("spans", [])) for seg in segments)
        return {
            "segments": len(segments),
            "corrupt_segments": corrupt,
            "processes": len(by_pid),
            "span_records": span_count,
            "workers": workers,
            "transfers": dict(sorted(transfers.items())),
            "tenants": dict(sorted(tenants.items())),
            "totals": totals,
            "telemetry": telemetry,
            "hists": {name: h.summary()
                      for name, h in sorted(hists.items())},
            "watermarks": merged_wm,
            "freshness": watermark.summarize(merged_wm, now=now),
            "conservation": conservation,
            "lockwatch": {"counters": lockwatch_counters,
                          "findings": lockwatch_findings},
        }


# -- merged Perfetto export ---------------------------------------------------

def _segment_trace_ids(segments: list[dict],
                       transfer_id: str) -> set:
    """Trace ids belonging to `transfer_id`: any span whose args name
    it roots the membership (snapshot_op / part carry `transfer_id`,
    fleet spans carry `transfer_id`/`transfer`)."""
    ids: set = set()
    for seg in segments:
        for rec in seg.get("spans", []):
            try:
                args, trace_id = rec[7], rec[8]
            except (IndexError, TypeError):
                continue
            if not trace_id or not isinstance(args, dict):
                continue
            if transfer_id in (args.get("transfer_id"),
                               args.get("transfer"),
                               args.get("ticket_id")):
                ids.add(trace_id)
    return ids


def export_fleet_chrome_trace(raw_segments: list,
                              transfer_id: str = "") -> dict:
    """ONE Chrome trace-event doc out of N processes' span deltas.

    Each process renders as its own Perfetto pid lane (named by its
    worker label); spans shift onto the shared wall-clock axis via the
    per-segment capture epoch; cross-process/thread parent links
    (trace ids propagated over the Flight wire, shm framing, and fleet
    tickets) render as flow arrows.  `transfer_id` filters to the
    traces that touch one transfer — `trtpu trace --fleet <id>`."""
    segments, corrupt = _parse_segments(raw_segments)
    keep_ids = _segment_trace_ids(segments, transfer_id) \
        if transfer_id else None
    epochs = [float(s.get("epoch_unix", 0.0) or 0.0) for s in segments
              if s.get("spans")]
    epoch0 = min(epochs) if epochs else 0.0

    events: list[dict] = []
    located: dict[int, tuple] = {}      # span_id -> (lane, tid, ts)
    pending_links: list[tuple] = []     # (lane, tid, ts, parent, span_id)
    pid_names: dict[int, str] = {}
    thread_names: dict[tuple, str] = {}
    seen: set = set()
    # Perfetto lane per PROCESS — keyed (host, pid), because bare pids
    # collide across hosts (pid-1 containers).  The real pid is kept
    # as the lane id when it is unique; a cross-host collision bumps
    # the later host onto an offset lane.
    lanes: dict[tuple, int] = {}
    used_lanes: set = set()
    hosts = {str(s.get("host", "")) for s in segments}

    def _lane(proc: tuple) -> int:
        lane = lanes.get(proc)
        if lane is None:
            lane = proc[1]
            while lane in used_lanes:
                lane += 1_000_000
            lanes[proc] = lane
            used_lanes.add(lane)
        return lane

    for seg in segments:
        proc = _proc_key(seg)
        pid = _lane(proc)
        shift = float(seg.get("epoch_unix", epoch0) or epoch0) - epoch0
        label = str(seg.get("worker", proc[1]))
        if len(hosts) > 1 and proc[0]:
            label = f"{label}@{proc[0]}"
        for rec in seg.get("spans", []):
            try:
                (name, tid, tname, t0, dur, _self_s, depth, args,
                 trace_id, span_id, parent_id) = rec[:11]
            except (ValueError, TypeError):
                continue
            if keep_ids is not None and trace_id not in keep_ids:
                continue
            key = (proc, trace_id, span_id) if span_id else \
                (proc, tid, name, round(float(t0), 9), parent_id)
            if key in seen:     # overlapping export windows re-send
                continue
            seen.add(key)
            pid_names.setdefault(pid, label)
            thread_names.setdefault((pid, tid), tname)
            ts = round((float(t0) + shift) * 1e6, 1)
            ev = {"name": name, "cat": "pipeline", "pid": pid,
                  "tid": tid, "ts": ts}
            if depth is not None and depth < 0:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = round(float(dur) * 1e6, 1)
                if span_id:
                    located[span_id] = (pid, tid, ts)
            if args:
                ev["args"] = dict(args)
            if trace_id:
                ids = ev.setdefault("args", {})
                ids["trace_id"] = trace_id
                if span_id:
                    ids["span_id"] = span_id
                if parent_id:
                    ids["parent_id"] = parent_id
            events.append(ev)
            if parent_id and span_id:
                pending_links.append((pid, tid, ts, parent_id, span_id))
    flows: list[dict] = []
    for pid, tid, ts, parent_id, span_id in pending_links:
        src = located.get(parent_id)
        if src is None or (src[0], src[1]) == (pid, tid):
            continue            # same-lane nesting needs no arrow
        flows.append({"name": "causal", "cat": "flow", "ph": "s",
                      "id": span_id, "pid": src[0], "tid": src[1],
                      "ts": src[2]})
        flows.append({"name": "causal", "cat": "flow", "ph": "f",
                      "bp": "e", "id": span_id, "pid": pid, "tid": tid,
                      "ts": ts})
    meta: list[dict] = []
    for pid, label in sorted(pid_names.items()):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": f"trtpu {label}"}})
    for (pid, tid), tname in sorted(thread_names.items()):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": tname}})
    return {
        "traceEvents": meta + events + flows,
        "displayTimeUnit": "ms",
        "otherData": {
            "segments": len(segments),
            "corrupt_segments": corrupt,
            "processes": len(pid_names),
            "transfer_filter": transfer_id,
        },
    }


# -- panes --------------------------------------------------------------------

_FLEET_TOP_COLS = (
    ("transfer", 22), ("tenant", 10), ("wrk", 4), ("rows_in", 9),
    ("rows_out", 9), ("mb_in", 8), ("mb_out", 8), ("h2d_mb", 8),
    ("launch", 7), ("retry", 6), ("steal", 6), ("fires", 6),
    ("commit", 7), ("fence", 6), ("lag_ms", 8),
)


def format_fleet_top(view: dict, limit: int = 20) -> str:
    """Render one `trtpu top --fleet` frame from a merged view."""
    lines = []
    tot = view.get("totals", {})
    cons = view.get("conservation", {})
    lines.append(
        f"fleet obs: {view.get('segments', 0)} segment(s) from "
        f"{view.get('processes', 0)} process(es)"
        + (f" ({view['corrupt_segments']} torn)"
           if view.get("corrupt_segments") else "")
        + f"  rows {tot.get('rows_in', 0)}→{tot.get('rows_out', 0)}"
        f"  h2d {tot.get('h2d_bytes', 0) / 1e6:.1f}MB"
        f"  launches {tot.get('launches', 0)}"
        f"  conservation {'OK' if cons.get('ok') else 'DRIFT'}")
    workers = view.get("workers", {})
    if workers:
        roll = "  ".join(
            f"{label}[{w['age_seconds']:.1f}s ago, {w.get('kind', '?')}]"
            for label, w in sorted(
                workers.items(),
                key=lambda kv: kv[1]["age_seconds"])[:8])
        lines.append(f"workers: {roll}")
    hists = view.get("hists", {})
    if hists:
        ranked = sorted(hists.items(),
                        key=lambda kv: -kv[1].get("count", 0))[:6]
        lines.append("latency: " + "  ".join(
            f"{name}[p50={h.get('p50_ms', 0)} p99={h.get('p99_ms', 0)} "
            f"p999={h.get('p999_ms', 0)}ms n={h.get('count', 0)}]"
            for name, h in ranked))
    lag = hists.get(watermark.STAGE_LAG) if hists else None
    if lag and lag.get("count"):
        lines.append(
            f"replication lag: p50={lag.get('p50_ms', 0)} "
            f"p99={lag.get('p99_ms', 0)} p999={lag.get('p999_ms', 0)}ms "
            f"n={lag.get('count', 0)}")
    lines.append(" ".join(f"{name:>{w}}"
                          for name, w in _FLEET_TOP_COLS))
    rows = sorted(view.get("transfers", {}).items(),
                  key=lambda kv: -(kv[1].get("bytes_out", 0)
                                   + kv[1].get("bytes_in", 0)))
    fresh = view.get("freshness", {})
    for tid, v in rows[:limit]:
        lag_ms = fresh.get(tid, {}).get("lag_ms")
        cells = (tid[:22], str(v.get("tenant", "-"))[:10],
                 len(v.get("workers", [])), v.get("rows_in", 0),
                 v.get("rows_out", 0),
                 f"{v.get('bytes_in', 0) / 1e6:.1f}",
                 f"{v.get('bytes_out', 0) / 1e6:.1f}",
                 f"{v.get('h2d_bytes', 0) / 1e6:.1f}",
                 v.get("launches", 0), v.get("retries", 0),
                 v.get("lease_steals", 0), v.get("chaos_fires", 0),
                 v.get("commits", 0), v.get("commit_fences", 0),
                 "-" if lag_ms is None else f"{lag_ms:.0f}")
        lines.append(" ".join(
            f"{c:>{w}}" for c, (_n, w) in zip(cells, _FLEET_TOP_COLS)))
    if len(rows) > limit:
        lines.append(f"... {len(rows) - limit} more transfers")
    return "\n".join(lines)


# -- runtime registration (the /debug surfaces) -------------------------------

_runtime_lock = threading.Lock()
_RUNTIME: Optional[dict] = None


def register_runtime(coordinator, scope: Optional[str] = None,
                     health_scope: str = "") -> None:
    """Give this process's health port a coordinator to read the fleet
    panes from (`trtpu worker` registers on startup; tests register
    explicitly).  `health_scope` is the operation_health scope the
    fleet workers heartbeat into (`fleet:<queue>`) — the liveness
    source for `/debug/fleet`."""
    global _RUNTIME
    with _runtime_lock:
        _RUNTIME = {"cp": coordinator,
                    "scope": scope or default_scope(),
                    "health_scope": health_scope}


def unregister_runtime() -> None:
    global _RUNTIME
    with _runtime_lock:
        _RUNTIME = None


def _runtime() -> Optional[dict]:
    with _runtime_lock:
        return dict(_RUNTIME) if _RUNTIME else None


def debug_fleet_obs() -> Optional[dict]:
    """The `GET /debug/fleet/obs` payload: the merged fleet view read
    through the registered coordinator (None = nothing registered)."""
    rt = _runtime()
    if rt is None:
        return None
    try:
        segments = rt["cp"].list_obs_segments(rt["scope"])
    except Exception as e:
        return {"error": f"obs segment listing failed: {e}"}
    view = merge_segments(segments)
    view["scope"] = rt["scope"]
    return view


def worker_liveness() -> Optional[dict]:
    """Per-worker heartbeat liveness ages from the coordinator's
    `get_operation_health` (the `/debug/fleet` satellite: a stale
    worker is visible here long before its lease expires)."""
    rt = _runtime()
    if rt is None or not rt.get("health_scope"):
        return None
    try:
        health = rt["cp"].get_operation_health(rt["health_scope"])
    except Exception as e:
        return {"error": f"health read failed: {e}"}
    now = time.time()
    out = {}
    for widx, rep in sorted(health.items(), key=lambda kv: str(kv[0])):
        ts = rep.get("ts")
        payload = rep.get("payload") or {}
        out[str(widx)] = {
            "age_seconds": round(max(0.0, now - ts), 3)
            if isinstance(ts, (int, float)) else None,
            "state": payload.get("state", ""),
            "ticket": payload.get("ticket", ""),
            "tickets_run": payload.get("tickets_run", 0),
        }
    return {"scope": rt["health_scope"], "workers": out}


def read_view(coordinator, scope: Optional[str] = None) -> dict:
    """One-shot read+merge for CLI panes (`trtpu top --fleet`)."""
    scope = scope or default_scope()
    view = merge_segments(coordinator.list_obs_segments(scope))
    view["scope"] = scope
    return view


def _json_default(v):
    return str(v)


def dumps_view(view: dict) -> str:
    return json.dumps(view, default=_json_default)
