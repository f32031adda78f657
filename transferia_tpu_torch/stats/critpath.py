"""Trace-derived critical-path attribution (`trtpu explain`; the port's
copy of ``transferia_tpu/stats/critpath.py``).

The causal trace records *what ran when* (parent/child spans on each
thread, plus cross-thread/cross-process links carried over parsequeue
handoffs, fleet tickets, the Flight wire and shm framing).  This module
answers *why the wall clock went where it went*: a backward walk over
the span forest attributes every second of end-to-end wall time to a
named pipeline stage.

Algorithm (backward sweep)
--------------------------
Wall time is the window [min t0, max end] over the kept spans.  A
cursor starts at the global end and sweeps backward through the root
spans (newest end first):

- the gap between the cursor and the next root below it is time no
  traced span covers — scheduler/queue air, attributed to
  ``orchestration``;
- inside a span, children are visited newest-end-first; the gap
  between the cursor and a child's end is the span's own time
  (attributed to the span's stage), then the walk descends into the
  child and the cursor jumps to the child's start.

Every interval lands in exactly one stage, so attribution sums to the
wall window by construction (clock skew across processes is clamped,
which is the only loss).  Cross-process parent links make a child in
worker B extend the critical path of a span in worker A — the flow
links ARE the multi-worker critical path.

Stage mapping is by span name (`stage_of`): decode, transform,
device dispatch, queue wait, wire, publish, commit, orchestration.
Unknown names inherit their nearest mapped ancestor's flavor by
falling back to ``orchestration`` — the walk never drops time on the
floor because a new span name appeared.
"""

from __future__ import annotations

from typing import Optional

from transferia_tpu_torch.stats import trace

# Stage buckets, in render order.  Exact-name rules first, then prefix
# rules; first hit wins.
STAGES_ORDER = ("decode", "transform", "device dispatch", "queue wait",
                "wire", "publish", "commit", "orchestration")

_EXACT = {
    "source_decode": "decode",
    "decode_readahead": "decode",
    "native_rowgroup_decode": "decode",
    "pivot": "decode",
    "batch": "decode",
    "transform": "transform",
    "device_dispatch": "device dispatch",
    "device_wait": "device dispatch",
    "device_decode": "device dispatch",
    "pack": "device dispatch",
    "fused_run": "device dispatch",
    "host_post": "device dispatch",
    "host_mask": "device dispatch",
    "pool_upload": "device dispatch",
    "dict_adopt": "device dispatch",
    "rowhash_pool_accs": "device dispatch",
    "sink_wait": "queue wait",
    "fleet_queue_wait": "queue wait",
    "replication_pump": "queue wait",
    "serialize": "wire",
    "shm_map": "wire",
    "shm_attach": "wire",
    "kafka_roundtrip": "wire",
    "s3_request": "wire",
    "sink": "publish",
    "sink_push": "publish",
    "sink_stage": "publish",
    "sink_publish": "publish",
    "bufferer_flush": "publish",
    "s3_publish_copy": "publish",
    "ch_publish_partition": "publish",
    "coord_commit_part": "commit",
}

_PREFIX = (
    ("flight_", "wire"),
    ("file_part", "decode"),
    ("snapshot_", "orchestration"),
    ("fleet_", "orchestration"),
    ("coord_", "commit"),
    ("lease_", "orchestration"),
    ("replication_", "orchestration"),
    ("obs_", "orchestration"),
    ("slo_", "orchestration"),
)

_PUBLISH_SUFFIXES = ("_publish_txn", "_publish")


def stage_of(name: str) -> str:
    s = _EXACT.get(name)
    if s:
        return s
    for prefix, stage in _PREFIX:
        if name.startswith(prefix):
            return stage
    for suffix in _PUBLISH_SUFFIXES:
        if name.endswith(suffix):
            return "publish"
    return "orchestration"


# -- record normalization -----------------------------------------------------

def _clean_record(rec, shift: float, proc) -> Optional[dict]:
    try:
        (name, tid, _tname, t0, dur, _self_s, depth, args,
         trace_id, span_id, parent_id) = rec[:11]
    except (ValueError, TypeError):
        return None
    if depth is not None and depth < 0:
        return None                    # instants carry no duration
    try:
        t0 = float(t0) + shift
        dur = max(0.0, float(dur))
    except (TypeError, ValueError):
        return None
    return {
        "name": str(name), "proc": proc, "tid": tid,
        "t0": t0, "end": t0 + dur, "dur": dur,
        "args": args if isinstance(args, dict) else {},
        "trace_id": int(trace_id or 0),
        "span_id": int(span_id or 0),
        "parent_id": int(parent_id or 0),
    }


def records_from_segments(raw_segments: list) -> list[dict]:
    """Flatten N obs segments onto one wall-clock axis (the same
    epoch-shift + (proc, trace, span) dedup the fleet Chrome export
    uses — overlapping export windows re-send spans)."""
    from transferia_tpu_torch.stats.fleetobs import _parse_segments, _proc_key

    segments, _ = _parse_segments(raw_segments)
    epochs = [float(s.get("epoch_unix", 0.0) or 0.0) for s in segments
              if s.get("spans")]
    epoch0 = min(epochs) if epochs else 0.0
    out: list[dict] = []
    seen: set = set()
    for seg in segments:
        proc = _proc_key(seg)
        shift = float(seg.get("epoch_unix", epoch0) or epoch0) - epoch0
        for rec in seg.get("spans", []):
            r = _clean_record(rec, shift, proc)
            if r is None:
                continue
            key = (proc, r["trace_id"], r["span_id"]) if r["span_id"] \
                else (proc, r["tid"], r["name"], round(r["t0"], 9))
            if key in seen:
                continue
            seen.add(key)
            out.append(r)
    return out


def records_from_local() -> list[dict]:
    """This process's span ring as explain records (demo mode)."""
    out = []
    for rec in trace.spans():
        r = _clean_record(rec, 0.0, ("local", 0))
        if r is not None:
            out.append(r)
    return out


# -- the walk -----------------------------------------------------------------

def _trace_ids_for(records: list[dict], transfer_id: str) -> set:
    ids = set()
    for r in records:
        a = r["args"]
        if r["trace_id"] and transfer_id in (
                a.get("transfer_id"), a.get("transfer"),
                a.get("ticket_id")):
            ids.add(r["trace_id"])
    return ids


def _walk(span: dict, cursor: float, children: dict,
          stages: dict, path: set) -> None:
    """Attribute [span.t0, cursor] — the span's own time minus the
    intervals its children cover, with each child recursed into.
    `path` guards against corrupt parent links forming a cycle."""
    if span["span_id"] in path:
        return
    path.add(span["span_id"])
    own = stage_of(span["name"])
    t = cursor
    floor = max(span["t0"], 0.0)
    kids = sorted(children.get(span["span_id"], []),
                  key=lambda c: c["end"], reverse=True)
    for child in kids:
        if t <= floor:
            break
        if child["t0"] >= t:
            continue
        c_end = min(child["end"], t)
        if t - c_end > 0:
            stages[own] = stages.get(own, 0.0) + (t - c_end)
        _walk(child, c_end, children, stages, path)
        t = max(floor, min(t, child["t0"]))
    if t > floor:
        stages[own] = stages.get(own, 0.0) + (t - floor)
    path.discard(span["span_id"])


def _sweep(spans: list[dict], children: dict, start: float,
           end: float) -> dict:
    """Backward sweep over root spans: every second of [start, end]
    lands in exactly one stage."""
    stages: dict[str, float] = {}
    cursor = end
    for root in sorted(spans, key=lambda r: r["end"], reverse=True):
        if cursor <= start:
            break
        seg_end = min(root["end"], cursor)
        if seg_end <= max(root["t0"], start):
            continue
        if cursor - seg_end > 0:
            stages["orchestration"] = stages.get(
                "orchestration", 0.0) + (cursor - seg_end)
        _walk(root, seg_end, children, stages, set())
        cursor = max(start, min(cursor, root["t0"]))
    if cursor > start:
        stages["orchestration"] = stages.get(
            "orchestration", 0.0) + (cursor - start)
    return stages


_LEVER_HINTS = {
    "decode": "decode-bound: raise source/parser parallelism or use "
              "the native rowgroup path",
    "transform": "transform-bound: vectorize or prune transformer "
                 "chain",
    "device dispatch": "device-bound: bigger pivots, donated buffers, "
                       "check compile cache hits",
    "queue wait": "backpressure: downstream slower than source — "
                  "raise sink parallelism or bufferer flush size",
    "wire": "transport-bound: more Flight streams / larger frames / "
            "shm for co-located hops",
    "publish": "sink-bound: batch the publish path or raise sink "
               "parallelism",
    "commit": "coordinator-bound: commit round-trips dominate — batch "
              "part commits",
    "orchestration": "scheduler air: gaps between parts — raise "
                     "worker slots or reduce part granularity",
}


def explain(records: list[dict], transfer_id: str = "") -> dict:
    """Critical-path report over explain records.  `transfer_id`
    narrows to the traces that touch one transfer (falls back to every
    record when nothing matches — a demo trace has exactly one
    transfer anyway)."""
    kept = records
    if transfer_id:
        ids = _trace_ids_for(records, transfer_id)
        narrowed = [r for r in records if r["trace_id"] in ids]
        if narrowed:
            kept = narrowed
    kept = [r for r in kept if r["dur"] > 0 or r["span_id"]]
    if not kept:
        return {"transfer": transfer_id, "wall_s": 0.0,
                "attributed_pct": 0.0, "spans": 0, "stages": {},
                "levers": [], "parts": []}
    index = {r["span_id"]: r for r in kept if r["span_id"]}
    children: dict[int, list] = {}
    roots: list[dict] = []
    for r in kept:
        if r["parent_id"] and r["parent_id"] in index \
                and r["parent_id"] != r["span_id"]:
            children.setdefault(r["parent_id"], []).append(r)
        else:
            roots.append(r)
    start = min(r["t0"] for r in kept)
    end = max(r["end"] for r in kept)
    wall = max(0.0, end - start)
    stages = _sweep(roots, children, start, end)
    attributed = sum(stages.values())

    # per-part critical paths: each "part" span re-walked in isolation
    parts = []
    for r in kept:
        if r["name"] == "part" and r["dur"] > 0:
            pstages: dict[str, float] = {}
            _walk(r, r["end"], children, pstages, set())
            top = max(pstages.items(), key=lambda kv: kv[1])[0] \
                if pstages else "-"
            label = r["args"].get("path") or r["args"].get("name") \
                or r["args"].get("part") or r["span_id"]
            parts.append({"part": str(label),
                          "wall_s": round(r["dur"], 6),
                          "top_stage": top})
    parts.sort(key=lambda p: -p["wall_s"])

    ordered = {
        s: {"seconds": round(stages[s], 6),
            "pct": round(100.0 * stages[s] / wall, 2) if wall else 0.0}
        for s in STAGES_ORDER if stages.get(s, 0.0) > 0}
    levers = [
        {"stage": s, "pct": ordered[s]["pct"],
         "hint": _LEVER_HINTS.get(s, "")}
        for s in sorted(ordered, key=lambda s: -ordered[s]["seconds"])
    ][:3]
    return {
        "transfer": transfer_id,
        "wall_s": round(wall, 6),
        "spans": len(kept),
        "processes": len({r["proc"] for r in kept}),
        "attributed_pct": round(100.0 * attributed / wall, 2)
        if wall else 0.0,
        "stages": ordered,
        "levers": levers,
        "parts": parts[:5],
    }


def format_report(report: dict) -> str:
    """Render one `trtpu explain` frame."""
    lines = [
        f"critical path: transfer={report.get('transfer') or '-'}  "
        f"wall={report.get('wall_s', 0.0):.3f}s  "
        f"spans={report.get('spans', 0)} "
        f"({report.get('processes', 0)} process(es))  "
        f"attributed={report.get('attributed_pct', 0.0):.1f}%"]
    stages = report.get("stages", {})
    if stages:
        lines.append(f"{'stage':<18} {'seconds':>10} {'pct':>7}")
        for s, row in stages.items():
            lines.append(f"{s:<18} {row['seconds']:>10.3f} "
                         f"{row['pct']:>6.1f}%")
    levers = report.get("levers", [])
    if levers:
        lines.append("top levers:")
        for i, lv in enumerate(levers, 1):
            lines.append(f"  {i}. [{lv['stage']} {lv['pct']:.1f}%] "
                         f"{lv['hint']}")
    parts = report.get("parts", [])
    if parts:
        lines.append("slowest parts:")
        for p in parts:
            lines.append(f"  {p['part']:<40} {p['wall_s']:>9.3f}s  "
                         f"top={p['top_stage']}")
    return "\n".join(lines)
