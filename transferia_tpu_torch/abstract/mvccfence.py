"""Shared MVCC staging-store fence semantics in dict form (the port's copy
of ``transferia_tpu/abstract/mvccfence.py``).

The MVCC staging store (mvcc/) keeps its columnar layer DATA in process
memory; what must survive crashes and arbitrate races is the CONTROL
state: which delta layers were admitted and whether the
snapshot->replication cutover has been sealed.  That state is one JSON
document per scope stored through the coordinator.  The reference has
three backends (memory, flock'd file, S3 conditional writes) around
these helpers; the port has the memory one, and any later backend runs
the same decision code around its own atomicity primitive.

Document shape::

    {"layers": [ {worker, seq, table, lsn_min, lsn_max, rows,
                  content_key, admitted_at,
                  locator, offsets}, ... ],              # admission order
     "bases": {"<table>/<part>": {table, part, epoch, rows,
                                  content_key, locator,
                                  recorded_at}, ...},    # spill manifest
     "cutover": null | {"watermark": W, "epoch": E, "sealed_at": ts,
                        "offsets": {"topic:partition": O, ...}}}

Rules (mirroring abstract/ticket.py's in-place helpers):

* Layer admission is idempotent under the obs-segment ``(worker, seq)``
  replace convention: re-admitting the same key REPLACES the stored
  metadata in place (same admission position — merge order is stable
  across a worker's retry of a faulted admission RPC).
* The cutover is a single first-wins fence: the first seal wins
  atomically; an identical retry (same watermark AND epoch) is granted
  idempotently; anything else is fenced and handed the sealed decision.
* After the seal, NEW layer admissions are fenced — a zombie snapshot
  worker that wakes up and publishes after the cutover cannot slip rows
  into a decision that already happened.  Re-admitting an
  already-admitted key stays an idempotent ack (the data it refers to
  was part of the decision).
* The SPILL MANIFEST rides the same doc: a layer record's ``locator``
  names the coordinator-addressable blob its encoded batches spilled
  to (the reference's mvcc/spill.py, not ported), ``offsets`` the
  per-source-partition high offsets its rows covered, and ``bases`` maps each landed base
  version to its blob under the put_base epoch fence (an older-epoch
  re-record is a zombie and is fenced).  A restarted worker rebuilds
  the whole scope byte-identically from nothing but this doc plus the
  blobs it names.
* The replication SOURCE OFFSET commits inside the cutover decision:
  the seal stores the per-partition offsets the delta layers covered,
  and every response (grant, idempotent retry, fence) hands them back
  — a zombie pump adopts the sealed offsets instead of re-deciding,
  so it can neither double-deliver nor skip a window.
"""

from __future__ import annotations

import time
from typing import Any, Optional

# admission statuses (mvcc_admit_layer result["status"])
ADMITTED = "admitted"      # new (worker, seq) appended pre-cutover
REPLACED = "replaced"      # same (worker, seq) re-put pre-cutover
DUPLICATE = "duplicate"    # same (worker, seq) re-put post-cutover: ack,
#                            no mutation — the layer was in the decision
FENCED = "fenced"          # new (worker, seq) post-cutover: rejected

# base-record statuses (mvcc_record_base result["status"])
RECORDED = "recorded"      # new (table, part) manifest entry
#                            (REPLACED = equal/newer epoch re-record,
#                             FENCED = older-epoch zombie re-record)


def new_mvcc_doc() -> dict:
    return {"layers": [], "bases": {}, "cutover": None}


def layer_key(layer: dict) -> tuple[str, int]:
    """Identity of a delta layer: the obs-segment (worker, seq) pair."""
    return (str(layer.get("worker", "")), int(layer.get("seq", -1)))


def normalize_layer(layer: dict,
                    now: Optional[float] = None) -> dict:
    """JSON-plain metadata record for one admitted layer.  Only control
    fields cross the coordinator — columnar data stays in process (or
    in the spilled blob the ``locator`` names)."""
    rec = {
        "worker": str(layer.get("worker", "")),
        "seq": int(layer.get("seq", -1)),
        "table": str(layer.get("table", "")),
        "lsn_min": int(layer.get("lsn_min", 0)),
        "lsn_max": int(layer.get("lsn_max", 0)),
        "rows": int(layer.get("rows", 0)),
        "content_key": str(layer.get("content_key", "")),
        "admitted_at": (time.time() if now is None else now),
    }
    # spill manifest fields (absent pre-spill / in unspilled mode)
    if layer.get("locator"):
        rec["locator"] = str(layer["locator"])
    if layer.get("offsets"):
        rec["offsets"] = {str(k): int(v)
                          for k, v in dict(layer["offsets"]).items()}
    return rec


def admit_layer_in_place(doc: dict, layer: dict,
                         now: Optional[float] = None) -> dict:
    """Mutate the scope doc with one layer admission; returns the
    decision dict the backends hand back verbatim."""
    key = layer_key(layer)
    layers = doc.setdefault("layers", [])
    idx = next((i for i, d in enumerate(layers)
                if layer_key(d) == key), None)
    sealed = doc.get("cutover")
    if sealed is not None:
        if idx is not None:
            return {"status": DUPLICATE, "cutover": dict(sealed)}
        return {"status": FENCED, "cutover": dict(sealed)}
    rec = normalize_layer(layer, now)
    if idx is not None:
        layers[idx] = rec
        return {"status": REPLACED, "layers": len(layers)}
    layers.append(rec)
    return {"status": ADMITTED, "layers": len(layers)}


def base_key(base: dict) -> str:
    """Identity of a base version in the spill manifest."""
    return f"{base.get('table', '')}/{base.get('part', '')}"


def record_base_in_place(doc: dict, base: dict,
                         now: Optional[float] = None) -> dict:
    """Record one spilled base version in the scope's manifest, under
    the same epoch rule as the store's in-process fence: an older
    epoch than the recorded one is a zombie re-put and is fenced; an
    equal/newer epoch replaces (idempotent part retry).

    A base with ``exclusive: true`` (the compaction fold — one
    compacted base that supersedes EVERY part of its table) also
    EVICTS the table's other manifest records; the decision returns
    their blob locators under ``evicted`` so the caller can GC the
    blobs.  Without the eviction a rebuild would re-land the
    pre-compaction parts next to the compacted image and resurrect
    rows the folded delete layers removed."""
    bases = doc.setdefault("bases", {})
    rec = dict(base)
    exclusive = bool(rec.pop("exclusive", False))
    key = base_key(rec)
    prev = bases.get(key)
    epoch = int(rec.get("epoch", 1))
    if prev is not None and epoch < int(prev.get("epoch", 1)):
        return {"status": FENCED, "epoch": int(prev.get("epoch", 1))}
    bases[key] = {
        "table": str(rec.get("table", "")),
        "part": str(rec.get("part", "")),
        "epoch": epoch,
        "rows": int(rec.get("rows", 0)),
        "content_key": str(rec.get("content_key", "")),
        "locator": str(rec.get("locator", "")),
        "recorded_at": (time.time() if now is None else now),
    }
    res = {"status": REPLACED if prev is not None else RECORDED,
           "epoch": epoch}
    if exclusive:
        evicted = []
        for k in [k for k in bases if k != key
                  and bases[k].get("table") == rec.get("table")]:
            loc = bases[k].get("locator")
            if loc:
                evicted.append(str(loc))
            del bases[k]
        res["evicted"] = evicted
    return res


def cutover_in_place(doc: dict, watermark: int, epoch: int,
                     now: Optional[float] = None,
                     offsets: Optional[dict] = None) -> dict:
    """Seal (or re-acknowledge, or fence) the cutover decision.  The
    seal stores `offsets` — the per-source-partition high offsets the
    admitted layers covered — and every response carries the SEALED
    offsets back: the replication pump commits exactly those to its
    source, inside this fence's decision, never its own local view."""
    sealed = doc.get("cutover")
    if sealed is None:
        doc["cutover"] = {"watermark": int(watermark),
                          "epoch": int(epoch),
                          "sealed_at": (time.time() if now is None
                                        else now),
                          "offsets": {str(k): int(v) for k, v
                                      in (offsets or {}).items()}}
        return {"granted": True, "first": True,
                "watermark": int(watermark), "epoch": int(epoch),
                "offsets": dict(doc["cutover"]["offsets"])}
    same = (int(sealed.get("watermark", -1)) == int(watermark)
            and int(sealed.get("epoch", -1)) == int(epoch))
    return {"granted": same, "first": False,
            "watermark": int(sealed.get("watermark", -1)),
            "epoch": int(sealed.get("epoch", -1)),
            "offsets": dict(sealed.get("offsets") or {})}


def prune_layers_in_place(doc: dict, keys: list) -> int:
    """Drop layer records by (worker, seq) key — compaction folded them
    into a new base version.  Idempotent: missing keys prune nothing."""
    want = {(str(k[0]), int(k[1])) for k in keys}
    layers = doc.setdefault("layers", [])
    kept = [d for d in layers if layer_key(d) not in want]
    pruned = len(layers) - len(kept)
    doc["layers"] = kept
    return pruned


def doc_watermark(doc: dict) -> int:
    """Delta LSN high-watermark over every admitted layer (-1 = none).
    The cutover driver seals THIS value: the highest LSN any admitted
    layer carries is exactly where the replication lane must resume."""
    layers = doc.get("layers") or []
    if not layers:
        return -1
    return max(int(d.get("lsn_max", 0)) for d in layers)


def state_view(doc: Optional[dict]) -> dict:
    """Read-only JSON-plain snapshot of a scope doc (missing = empty)."""
    if not doc:
        doc = new_mvcc_doc()
    return {
        "layers": [dict(d) for d in (doc.get("layers") or [])],
        "bases": {k: dict(v)
                  for k, v in (doc.get("bases") or {}).items()},
        "cutover": (dict(doc["cutover"])
                    if doc.get("cutover") else None),
        "watermark": doc_watermark(doc),
    }


def doc_offsets(doc: Optional[dict]) -> dict:
    """Per-source-partition high offsets over every admitted layer —
    what the cutover seals, and where a resuming pump's positions
    start.  Max-merged across layers: workers chunk one partition's
    feed into many layers."""
    out: dict[str, int] = {}
    for d in ((doc or {}).get("layers") or []):
        for part, off in (d.get("offsets") or {}).items():
            cur = out.get(str(part))
            if cur is None or int(off) > cur:
                out[str(part)] = int(off)
    return out
