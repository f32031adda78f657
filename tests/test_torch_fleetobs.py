"""The fleet observability plane (the port's `stats/fleetobs.py`,
`stats/slo.py` and `stats/critpath.py`, the segment export of the
snapshot loader and the fleet worker) against the JAX package's, on the
CPU.

Held equal, exactly:

- segments: each package's `ObsExporter` writes a segment from the same
  spans (recorded with fixed start times and durations) and the same
  ledger rows; the two segments agree once span ids and the capture
  epoch are renamed to their order of appearance, and each package's
  `merge_segments`, `format_fleet_top` and `export_fleet_chrome_trace`
  gives the same view, frame and events on either package's segments
  and on a fixed series built here;
- `slo.evaluate`'s verdicts on a fixed cumulative segment series (and
  `format_verdicts`, `fold_verdicts`, the alert hook's actions);
- `critpath.explain`'s stages and levers on a fixed span tree across
  two processes;
- the engine's own export: a fleet worker running a `sample_snapshot`
  ticket with tracing on leaves segments whose merged ledger rows and
  span names equal the reference's (the JAX package's `xla_compile`
  instants, its jit's compiles, have no counterpart in the port; the
  heartbeat and export spans count beats, so both are left out).

Every clock the comparison sees is fixed (`now=`, segment `ts`).
"""

import importlib
import json
import random
from types import SimpleNamespace

import pytest

from tests.torch_quiescent import ledger_quiescent  # noqa: F401

NOW = 100_000.0


def pkg(name: str) -> SimpleNamespace:
    root = "transferia_tpu" if name == "jax" else "transferia_tpu_torch"

    def m(path):
        return importlib.import_module(f"{root}.{path}")

    return SimpleNamespace(
        name=name, obs=m("stats.fleetobs"), slo=m("stats.slo"),
        crit=m("stats.critpath"), hdr=m("stats.hdr"), trace=m("stats.trace"),
        ledger=m("stats.ledger"), wm=m("stats.watermark"),
        registry=m("stats.registry"), memory=m("coordinator.memory"),
        worker=m("fleet.worker"), ticket=m("abstract.ticket"),
        mem=m("providers.memory"), bp=m("fleet.backpressure"),
        kw={"device": "cpu"} if name == "port" else {})


PORT, JAX = pkg("port"), pkg("jax")


def both(fn):
    got, want = fn(PORT), fn(JAX)
    assert got == want
    return got


def _fields(p):
    return p.ledger.FIELDS


def make_segment(p, worker, pid, seq, ts, totals=None, transfers=None,
                 hists=None, spans=None, epoch=1000.0, host="h",
                 watermarks=None, kind="periodic"):
    base = dict.fromkeys(_fields(p), 0)
    base.update(totals or {})
    return {"v": 1, "worker": worker, "pid": pid, "seq": seq, "ts": ts,
            "kind": kind, "host": host, "epoch_unix": epoch,
            "spans": spans or [], "spans_dropped": 0,
            "ledger": {"totals": base, "transfers": transfers or {},
                       "tenants": {}, "conservation_ok": True},
            "telemetry": {"device_launches": seq},
            "hists": hists or {}, "watermarks": watermarks or {}}


def _span_rec(name, tid, t0, dur, args, trace_id, span_id, parent_id,
              depth=0):
    return [name, tid, f"T{tid}", t0, dur, dur, depth, args, trace_id,
            span_id, parent_id]


def _entry(p, tenant, **vals):
    e = dict.fromkeys(_fields(p), 0)
    e.update(tenant=tenant, **vals)
    return e


def fixed_series(p) -> list:
    """Three processes (two on one pid, different hosts), a replaced
    seq, a torn segment, histograms with an exemplar, a cross-process
    span link."""
    h1, h2 = p.hdr.LogHistogram(), p.hdr.LogHistogram()
    for v in (0.01, 0.02, 0.003):
        h1.observe(v)
    h2.observe(0.5, trace_id=77)
    tr_a = {"t1": _entry(p, "ta", parts=2, rows_in=30, rows_out=20)}
    tr_b = {"t1": _entry(p, "ta", parts=1, rows_in=12, rows_out=12),
            "t2": _entry(p, "tb", parts=1, rows_in=5, rows_out=5)}
    segs = [
        make_segment(p, "sched", 100, 1, NOW - 30, epoch=1000.0, spans=[
            _span_rec("fleet_dist_admit", 1, 0.5, 0.01,
                      {"ticket_id": "tk-0"}, 9, 1, 0)]),
        make_segment(p, "fleet.w1", 1, 1, NOW - 20,
                     totals={"rows_in": 10, "rows_out": 10, "parts": 1},
                     transfers={"t1": _entry(p, "ta", parts=1, rows_in=10,
                                             rows_out=10)}),
        make_segment(p, "fleet.w1", 1, 2, NOW - 10, epoch=1002.0,
                     totals={"rows_in": 30, "rows_out": 20, "parts": 2},
                     transfers=tr_a, hists={"part_upload": h1.to_json()},
                     spans=[_span_rec("fleet_ticket_run", 7, 0.25, 1.0,
                                      {"transfer_id": "t1"}, 9, 2, 1),
                            _span_rec("part", 7, 0.3, 0.9,
                                      {"transfer_id": "t1"}, 9, 3, 2, 1)]),
        make_segment(p, "fleet.w2", 1, 4, NOW - 5, host="h2", kind="final",
                     totals={"rows_in": 17, "rows_out": 17, "parts": 2},
                     transfers=tr_b, hists={"part_upload": h2.to_json()},
                     spans=[_span_rec("part", 3, 0.1, 0.2,
                                      {"transfer_id": "t2"}, 11, 5, 0)]),
        {"worker": "torn", "seq": "x", "ts": "y", "pid": "z"},
    ]
    return segs


def merged(p, segs) -> list:
    view = p.obs.merge_segments(json.loads(json.dumps(segs)), now=NOW)
    doc = p.obs.export_fleet_chrome_trace(json.loads(json.dumps(segs)))
    one = p.obs.export_fleet_chrome_trace(json.loads(json.dumps(segs)),
                                          transfer_id="t1")
    return [json.loads(p.obs.dumps_view(view)),
            p.obs.format_fleet_top(view, limit=5), doc, one]


def test_merge_views_equal_jax_on_a_fixed_series():
    got = both(lambda p: merged(p, fixed_series(p)))
    view = got[0]
    assert view["totals"]["rows_in"] == 47 and view["conservation"]["ok"]
    assert view["corrupt_segments"] == 1 and view["processes"] == 3
    assert "conservation OK" in got[1]


def _record(p, ops):
    """Reset each package's process state, then record `ops` (spans
    with fixed start times and durations, ledger rows, histogram
    observations) and export one segment through an ObsExporter."""
    p.trace.reset()
    p.ledger.LEDGER.reset()
    p.hdr.STAGES.reset()
    p.wm.WATERMARKS.reset()
    p.trace.enable(True)
    try:
        for op in ops:
            if op[0] == "span":
                _, name, t0, dur, parent, args = op
                ctx = None if parent is None else parent
                p.trace.complete(name, t0, dur, parent=ctx, **args)
            elif op[0] == "ledger":
                _, tid, tenant, vals = op
                p.ledger.LEDGER.add_for(tid, tenant=tenant, **vals)
            elif op[0] == "hist":
                _, stage, v = op
                p.hdr.observe(stage, v)
    finally:
        p.trace.enable(False)
    cp = p.memory.MemoryCoordinator()
    exp = p.obs.ObsExporter(cp, worker="w-test", scope="s")
    assert exp.export("final")
    return cp.list_obs_segments("s")


# names no other code records, so that a thread another test left running
# cannot add to what is compared
OPS = [
    ("span", "obs_test_part", 10.0, 2.0, None, {"transfer_id": "tr-a"}),
    ("span", "obs_test_decode", 10.0, 0.5, None, {}),
    ("span", "obs_test_dispatch", 10.5, 1.0, None, {"rows": 4}),
    ("span", "obs_test_sink", 11.5, 0.5, None, {}),
    ("ledger", "tr-a", "ten-1", {"rows_in": 100, "rows_out": 60,
                                 "bytes_in": 4096, "launches": 2}),
    ("ledger", "tr-b", "ten-2", {"rows_in": 7, "rows_out": 7,
                                 "retries": 1}),
    ("hist", "obs_test_stage", 0.02), ("hist", "obs_test_stage", 0.7),
]


SPAN_NAMES = {op[1] for op in OPS if op[0] == "span"}


def _normalized(seg: dict) -> dict:
    """What `OPS` recorded in a segment: its spans (the process's random
    ids renamed to their order of appearance, start times relative to
    the first), the two transfers' and tenants' ledger rows and the
    test's histogram.  The rest is process-wide state that other
    threads of a test process may touch (the totals, the clocks, the
    telemetry, the watermarks)."""
    seg = json.loads(json.dumps(seg))
    ids = {0: 0}

    def rn(i):
        return ids.setdefault(i, len(ids))

    spans = [r for r in seg["spans"] if r[0] in SPAN_NAMES]
    t_first = min((r[3] for r in spans), default=0.0)
    hist = dict(seg["hists"].get("obs_test_stage", {}))
    hist.pop("max_trace", None)
    return {
        "head": [seg[k] for k in ("v", "worker", "seq", "kind")],
        "spans": [[r[0], r[6], r[7], round(r[3] - t_first, 9), r[4],
                   rn(r[8]), rn(r[9]), rn(r[10])] for r in spans],
        "transfers": {t: seg["ledger"]["transfers"].get(t)
                      for t in ("tr-a", "tr-b")},
        "tenants": {t: seg["ledger"]["tenants"].get(t)
                    for t in ("ten-1", "ten-2")},
        "hist": hist,
    }


def test_exporter_segments_equal_jax():
    """The same spans, ledger rows and histogram samples recorded in
    each package: equal segments (ids and clocks renamed), and every
    merge of them equal across the packages."""
    segs = {p.name: _record(p, OPS) for p in (PORT, JAX)}
    assert len(segs["port"]) == len(segs["jax"]) == 1
    got, want = (_normalized(segs[n][0]) for n in ("port", "jax"))
    for key in want:
        assert got[key] == want[key], key
    assert len(got["spans"]) == 4 and got["hist"]["count"] == 2
    for name in ("port", "jax"):
        mine = segs[name]
        got = merged(PORT, mine)
        want = merged(JAX, mine)
        assert got == want
        assert got[0]["transfers"]["tr-a"]["rows_out"] == 60


def _hist(p, good=0, bad=0):
    h = p.hdr.LogHistogram()
    for _ in range(good):
        h.observe(0.1)
    for _ in range(bad):
        h.observe(50.0)
    return h.to_json()


def slo_series(p):
    lag = p.wm.STAGE_LAG
    return [
        make_segment(p, "w1", 1, 1, NOW - 4000,
                     hists={lag: _hist(p, good=100)},
                     totals={"commits": 10}),
        make_segment(p, "w1", 1, 2, NOW,
                     hists={lag: _hist(p, good=150, bad=50),
                            "part_upload": _hist(p, good=9, bad=1)},
                     totals={"commits": 20, "commit_fences": 1}),
        make_segment(p, "w2", 2, 1, NOW - 1000,
                     hists={lag: _hist(p, good=30)},
                     watermarks={"t1": {"a": {
                         "event_ns": 5, "lsn": 1, "publish_unix": 9.0,
                         "origin": "event"}}}),
        make_segment(p, "w2", 2, 2, NOW - 10,
                     hists={lag: _hist(p, good=60, bad=3)},
                     watermarks={"t1": {"a": {
                         "event_ns": 9, "lsn": 2, "publish_unix": 19.0,
                         "origin": "event"}}}),
    ]


@pytest.mark.parametrize("shuffle_seed", [0, 1, 2])
def test_slo_verdicts_equal_jax(shuffle_seed):
    """Default objectives and a custom set over a fixed series in a
    shuffled order: the same verdicts, frame and folded gauges."""
    def run(p):
        segs = slo_series(p)
        random.Random(shuffle_seed).shuffle(segs)
        custom = (p.slo.SloObjective("lag", stage=p.wm.STAGE_LAG,
                                     threshold_ms=5000.0, target=0.99),
                  p.slo.SloObjective("upload", stage="part_upload",
                                     threshold_ms=1000.0, target=0.95))
        views = [p.slo.evaluate(segs), p.slo.evaluate(segs, objectives=custom)]
        for v in views:
            v["scope"] = "test"
        out = [json.loads(json.dumps(v, sort_keys=True, default=str))
               for v in views]
        out += [p.slo.format_verdicts(v) for v in views]
        m = p.registry.Metrics()
        p.slo.fold_verdicts(m, views[1])
        out.append([m.value(k) for k in (
            "slo_objectives", "slo_burning", "slo_worst_burn_fast",
            "slo_worst_burn_slow", "slo_evaluations")])
        return out

    got = both(run)
    assert got[1]["burning"] == ["lag", "upload"] and not got[1]["ok"]


def test_slo_alert_hook_equal_jax():
    """The alert hook's latch and clear on a backpressure controller."""
    def run(p):
        bp = p.bp.BackpressureController(signals=(), probe=lambda n: 0.0)
        hook = p.slo.SloAlertHook(backpressure=bp)
        burning = {"ok": False, "burning": ["lag"], "objectives": {
            "lag": {"burning": True, "burn_fast": 20.0, "burn_slow": 15.0}}}
        calm = {"ok": True, "burning": [], "objectives": {
            "lag": {"burning": False, "burn_fast": 0.0, "burn_slow": 0.0}}}
        out = []
        for view in (burning, burning, calm):
            out.append((hook.apply(view), bp.overloaded(),
                        bp.latched_signals()))
        return out

    both(run)


def _cspan(name, t0, dur, trace_id, span_id, parent_id, tid=1, args=None):
    return [name, tid, "T", t0, dur, dur, 0, args, trace_id, span_id,
            parent_id]


def crit_series(p):
    args = {"transfer_id": "tx"}
    seg_a = make_segment(p, "wa", 1, 1, NOW, epoch=1000.0, spans=[
        _cspan("part", 0.0, 10.0, 9, 1, 0, args=args),
        _cspan("source_decode", 0.0, 3.0, 9, 2, 1),
        _cspan("device_dispatch", 3.0, 4.0, 9, 3, 1),
        _cspan("part", 11.0, 4.0, 9, 6, 0, args=args),
        _cspan("sink", 11.5, 2.0, 9, 7, 6),
        _cspan("part", 0.0, 4.0, 5, 10, 0, args={"transfer_id": "other"}),
    ])
    seg_b = make_segment(p, "wb", 2, 1, NOW, host="h2", epoch=1002.0, spans=[
        _cspan("flight_do_put", 3.0, 2.0, 9, 4, 3),
        _cspan("mvcc_compact", 12.0, 1.0, 9, 8, 6),
    ])
    return [seg_a, seg_b]


@pytest.mark.parametrize("transfer", ["tx", "other", ""])
def test_critpath_levers_equal_jax(transfer):
    def run(p):
        records = p.crit.records_from_segments(crit_series(p))
        report = p.crit.explain(records, transfer_id=transfer)
        return (json.loads(json.dumps(report, default=str)),
                p.crit.format_report(report),
                [p.crit.stage_of(n) for n in (
                    "part", "source_decode", "device_dispatch", "sink",
                    "fleet_ticket_run", "mvcc_compact", "unknown_x")])

    got = both(run)
    assert len(got[0]["levers"]) == 3 if transfer == "tx" else True


def test_engine_export_equal_jax():
    """A fleet worker runs one `sample_snapshot` ticket (mask + filter)
    with tracing on over a memory coordinator: the merged segments'
    ledger rows and parts, the workers that exported, and the span
    names of the run equal the reference's."""
    def run(p):
        p.trace.reset()
        p.ledger.LEDGER.reset()
        p.mem.get_store("obs-e2e").clear()
        cp = p.memory.MemoryCoordinator()
        cp.enqueue_ticket("q", p.ticket.FleetTicket(
            ticket_id="e2e", transfer_id="tr-e2e", tenant="ten",
            payload={"kind": "sample_snapshot", "rows": 800,
                     "preset": "users", "table": "users", "shard_parts": 4,
                     "sink_id": "obs-e2e", "operation_id": "op-e2e",
                     "transformation": {"transformers": [
                         {"mask_field": {"columns": ["email"],
                                         "salt": "s"}},
                         {"filter_rows": {"filter": "age >= 21"}}]}}))
        p.trace.enable(True)
        try:
            w = p.worker.FleetWorker(cp, queue="q", worker_index=0,
                                     max_tickets=1, heartbeat_interval=0.05,
                                     idle_exit_seconds=20.0, **p.kw)
            w.run()
        finally:
            p.trace.enable(False)
        delivered = p.mem.get_store("obs-e2e").row_count()
        p.mem.get_store("obs-e2e").clear()
        segs = cp.list_obs_segments(p.obs.default_scope())
        view = p.obs.merge_segments(segs, now=NOW)
        tr = view["transfers"]["tr-e2e"]
        # the spans of the ticket's traces (another test's thread may
        # record spans of its own while tracing is on)
        doc = p.obs.export_fleet_chrome_trace(segs, transfer_id="tr-e2e")
        names = sorted({e["name"] for e in doc["traceEvents"]
                        if e.get("ph") in ("X", "i")} - {
                            "obs_export", "worker_heartbeat", "lease_renew",
                            "xla_compile"})
        return (delivered, {k: tr.get(k) for k in ("tenant", "rows_in",
                                                   "rows_out", "parts",
                                                   "commits")},
                sorted(view["workers"]), names,
                doc["otherData"]["processes"], view["conservation"]["ok"])

    got = both(run)
    assert got[1]["rows_out"] == got[0] > 0
