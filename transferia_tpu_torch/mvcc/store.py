"""Delta-versioned columnar staging store with a consistent cutover (the
port's copy of ``transferia_tpu/mvcc/store.py``).

The store holds two kinds of layers per table, both kept ENCODED (dict
columns stay shared-pool codes; the merge never concatenates across
pools):

* **Base versions**: snapshot parts, immutable, addressed by
  ``(table, part, epoch)``.  An older-epoch re-put is a zombie snapshot
  worker and raises through the `providers/staging.EpochFence` rule the
  staged sinks use.
* **Delta layers**: replication batches that arrived DURING the
  snapshot, LSN-ordered, keyed by `(worker, seq)` (a retried append
  replaces), content-keyed by `ops/rowhash.batch_row_keys`.  Admission is
  arbitrated by the coordinator control doc (abstract/mvccfence.py): once
  the cutover seals, NEW layers are fenced.

**Merge-on-read** resolves row visibility at an LSN watermark with one
vectorized latest-wins pass over the per-row sort key
``(pk_key, lsn, layer, source, position)``; base rows carry ``lsn = -1``
(every delta beats the snapshot image of its row) and PK identity is
`batch_row_keys` over the key columns.  The winner decides: DELETE hides
the row, INSERT/UPDATE shows the winning image.  The result is a LIST of
per-source `take()` batches.

PK keys and content keys run on the store's `device`: kernel K10 in keys
mode on a card (one launch a source batch), its plain version with
`device="cpu"`.  The sort itself is numpy on the host, as in the
reference.  The reference spills landings through pyarrow when it can
(`spilling()`); the port takes its no-pyarrow route, so layers live in
process and a lost process loses its scope (`rebuild_store` raises).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from transferia_tpu_torch.abstract import mvccfence
from transferia_tpu_torch.abstract.kinds import KIND_CODES, Kind
from transferia_tpu_torch.abstract.schema import TableSchema
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.ops.rowhash import batch_row_keys
from transferia_tpu_torch.providers.staging import EpochFence
from transferia_tpu_torch.runtime import knobs
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.stats.registry import Metrics, MvccStats

DELETE_CODE = KIND_CODES[Kind.DELETE]

# delta layers worth folding before a compaction ticket is enqueued:
# below this, merge-on-read is cheaper than rewriting a base version
DEFAULT_COMPACT_MIN_LAYERS = 4
ENV_COMPACT_MIN_LAYERS = "TRANSFERIA_TPU_MVCC_COMPACT_MIN_LAYERS"

# one delta layer's row cap: appends above it are rejected so a layer
# stays a bounded unit of admission/replay (callers chunk the feed)
DEFAULT_MAX_LAYER_ROWS = 1 << 18
ENV_MAX_LAYER_ROWS = "TRANSFERIA_TPU_MVCC_MAX_LAYER_ROWS"

SPILL_LEFT_OUT = ("the MVCC spill (mvcc/spill.py: layers as Arrow IPC "
                  "blobs, rebuilt after a crash) needs pyarrow, which "
                  "transferia_tpu_torch does not import (ROADMAP.md A7, "
                  "blocked)")


def compact_min_layers(environ=os.environ) -> int:
    return max(1, knobs.env_int(ENV_COMPACT_MIN_LAYERS,
                                DEFAULT_COMPACT_MIN_LAYERS,
                                environ=environ))


def max_layer_rows(environ=os.environ) -> int:
    return max(1, knobs.env_int(ENV_MAX_LAYER_ROWS,
                                DEFAULT_MAX_LAYER_ROWS,
                                environ=environ))


class OversizeLayerError(ValueError):
    """A single delta append exceeded TRANSFERIA_TPU_MVCC_MAX_LAYER_ROWS."""


# Process-local scope -> store registry: columnar layer data lives in
# process, so a compaction runner resolves the scope here.
_STORES: dict[str, "MvccStore"] = {}
_STORES_LOCK = threading.Lock()


def register_store(store: "MvccStore") -> "MvccStore":
    """Publish a store for in-process runners (latest wins)."""
    with _STORES_LOCK:
        _STORES[store.scope] = store
    return store


def resolve_store(scope: str, coordinator=None,
                  metrics=None) -> Optional["MvccStore"]:
    """The registered store of `scope`, or None.  The reference rebuilds
    a miss from its spill manifest when pyarrow is importable; without
    pyarrow, as always in the port, a miss stays a miss."""
    with _STORES_LOCK:
        return _STORES.get(scope)


def unregister_store(scope: str) -> None:
    with _STORES_LOCK:
        _STORES.pop(scope, None)


def rebuild_store(scope: str, coordinator, metrics=None):
    """The reference's crash rebuild from spilled blobs: not in the port."""
    raise NotImplementedError(
        f"rebuild of {scope!r}: {SPILL_LEFT_OUT}")


def pk_column_names(schema) -> list[str]:
    """Row identity for the merge: the PK columns (full row content
    changes on every update).  Key-less tables fall back to whole-row
    identity: updates and deletes cannot be matched there."""
    names = [c.name for c in schema.key_columns()]
    return names or schema.names()


def _project(batch: ColumnBatch, names: list[str]) -> ColumnBatch:
    return ColumnBatch(batch.table_id,
                       TableSchema([batch.schema.find(n) for n in names]),
                       {n: batch.columns[n] for n in names})


def pk_keys(batch: ColumnBatch, device: DeviceLike = None) -> np.ndarray:
    names = pk_column_names(batch.schema)
    if len(names) < len(batch.schema.names()):
        return batch_row_keys(_project(batch, names), device=device)
    return batch_row_keys(batch, device=device)


def content_key(batches: list[ColumnBatch],
                device: DeviceLike = None) -> str:
    """Order-independent content key over full-row keys: the idempotence
    witness stored with a layer's admission record."""
    x = np.uint64(0)
    s = np.uint64(0)
    n = 0
    for b in batches:
        if b.n_rows == 0:
            continue
        keys = batch_row_keys(b, device=device)
        x ^= np.bitwise_xor.reduce(keys)
        s = np.uint64((int(s) + int(keys.sum(dtype=np.uint64)))
                      & 0xFFFFFFFFFFFFFFFF)
        n += len(keys)
    return f"{int(x):016x}{int(s):016x}-{n}"


@dataclass
class BaseVersion:
    """One immutable snapshot part: (table, part, epoch) -> batches."""

    table: str
    part: str
    epoch: int
    batches: list = field(default_factory=list)

    @property
    def rows(self) -> int:
        return sum(b.n_rows for b in self.batches)


@dataclass
class DeltaLayer:
    """One admitted replication layer (LSN-ordered rows with kinds).
    `offsets` are the per-source-partition high offsets the rows
    covered; they ride the admission record into the control doc (the
    reference's spilled-blob `locator` has no place in the port)."""

    table: str
    worker: str
    seq: int
    batches: list = field(default_factory=list)
    lsn_min: int = 0
    lsn_max: int = 0
    content_key: str = ""
    offsets: dict = field(default_factory=dict)

    @property
    def rows(self) -> int:
        return sum(b.n_rows for b in self.batches)

    def meta(self) -> dict:
        """The JSON-plain admission record (abstract/mvccfence.py)."""
        m = {"worker": self.worker, "seq": self.seq,
             "table": self.table, "lsn_min": self.lsn_min,
             "lsn_max": self.lsn_max, "rows": self.rows,
             "content_key": self.content_key}
        if self.offsets:
            m["offsets"] = dict(self.offsets)
        return m


class MvccStore:
    """One transfer's staging store.  Columnar data lives in process; the
    admission/cutover control doc lives in the coordinator when one with
    MVCC support is given (an unfenced local doc otherwise: single-process
    tests only).  Keys run on `device` (CUDA unless the caller passes
    "cpu"; without a card that raises here)."""

    def __init__(self, scope: str, coordinator=None,
                 metrics: Optional[Metrics] = None,
                 device: DeviceLike = None):
        self.scope = scope
        self.cp = coordinator if (
            coordinator is not None
            and getattr(coordinator, "supports_mvcc",
                        lambda: False)()) else None
        self.device = resolve_device(device)
        self.stats = MvccStats(metrics)
        self._lock = threading.Lock()
        self._fence = EpochFence()
        # table -> part -> latest BaseVersion
        self._bases: dict[str, dict[str, BaseVersion]] = {}
        # (worker, seq) -> DeltaLayer, admission-ordered via _order
        self._layers: dict[tuple[str, int], DeltaLayer] = {}
        self._order: list[tuple[str, int]] = []
        # unfenced mode keeps the control doc locally so both modes run
        # the exact same mvccfence decision code
        self._doc = mvccfence.new_mvcc_doc()
        self._sealed: Optional[tuple[int, int]] = None

    def spilling(self) -> bool:
        """Whether landings spill: the reference's no-pyarrow answer."""
        return False

    # -- base versions ------------------------------------------------------
    def put_base(self, table: str, part: str, epoch: int,
                 batches: list[ColumnBatch]) -> BaseVersion:
        """Land one snapshot part as an immutable base layer.  The
        per-(table, part) epoch fence rejects zombie re-puts from before
        a reclaim; an equal or newer epoch REPLACES (idempotent part
        retry)."""
        sp = trace.span("mvcc_put_base", table=table, part=part,
                        epoch=epoch)
        with sp:
            self._fence.check_and_advance(f"{table}/{part}", epoch)
            bv = BaseVersion(table=table, part=part, epoch=epoch,
                             batches=list(batches))
            with self._lock:
                self._bases.setdefault(table, {})[part] = bv
            self.stats.base_versions.inc()
            self.stats.base_rows.inc(bv.rows)
            if sp:
                sp.add(rows=bv.rows)
            return bv

    # -- delta layers -------------------------------------------------------
    def append_delta(self, table: str, worker: str, seq: int,
                     batches: list[ColumnBatch],
                     offsets: Optional[dict] = None) -> dict:
        """Append one LSN-ordered delta layer.  Returns the admission
        decision dict; status "fenced" means the cutover already sealed
        and the layer was DISCARDED (zombie publish): callers must not
        treat the rows as delivered.  Re-appending the same (worker, seq)
        replaces.  `offsets` (the pump's per-source-partition high
        offsets for the rows) rides the admission record."""
        failpoint("mvcc.append")
        sp = trace.span("mvcc_append", table=table, worker=worker,
                        seq=seq)
        with sp:
            layer = self._build_layer(table, worker, seq, batches)
            if offsets:
                layer.offsets = {str(k): int(v)
                                 for k, v in offsets.items()}
            if self.cp is not None:
                decision = self.cp.mvcc_admit_layer(self.scope,
                                                    layer.meta())
            else:
                with self._lock:
                    decision = mvccfence.admit_layer_in_place(
                        self._doc, layer.meta())
            status = decision.get("status")
            if status == mvccfence.FENCED:
                self.stats.layers_fenced.inc()
                if sp:
                    sp.add(status=status)
                return decision
            if status != mvccfence.DUPLICATE:
                key = (worker, seq)
                with self._lock:
                    if key not in self._layers:
                        self._order.append(key)
                    self._layers[key] = layer
                if status == mvccfence.REPLACED:
                    self.stats.layers_replaced.inc()
                else:
                    self.stats.delta_layers.inc()
                    self.stats.delta_rows.inc(layer.rows)
            with self._lock:
                self.stats.live_layers.set(len(self._layers))
            if sp:
                sp.add(status=status, rows=layer.rows,
                       lsn_max=layer.lsn_max)
            return decision

    def _build_layer(self, table: str, worker: str, seq: int,
                     batches: list[ColumnBatch]) -> DeltaLayer:
        rows = sum(b.n_rows for b in batches)
        cap = max_layer_rows()
        if rows > cap:
            raise OversizeLayerError(
                f"delta layer ({worker}, {seq}) carries {rows} rows > "
                f"{ENV_MAX_LAYER_ROWS}={cap}; chunk the feed")
        lsn_lo, lsn_hi = None, None
        for b in batches:
            if b.n_rows == 0:
                continue
            lsns = (np.asarray(b.lsns, dtype=np.int64)
                    if b.lsns is not None
                    else np.zeros(b.n_rows, dtype=np.int64))
            lo, hi = int(lsns.min()), int(lsns.max())
            lsn_lo = lo if lsn_lo is None else min(lsn_lo, lo)
            lsn_hi = hi if lsn_hi is None else max(lsn_hi, hi)
        return DeltaLayer(
            table=table, worker=worker, seq=seq, batches=list(batches),
            lsn_min=lsn_lo or 0, lsn_max=lsn_hi or 0,
            content_key=content_key(batches, self.device))

    # -- control views ------------------------------------------------------
    def tables(self) -> list[str]:
        with self._lock:
            out = set(self._bases)
            out.update(layer.table for layer in self._layers.values())
        return sorted(out)

    def layer_count(self, table: Optional[str] = None) -> int:
        with self._lock:
            if table is None:
                return len(self._layers)
            return sum(1 for la in self._layers.values()
                       if la.table == table)

    def watermark(self) -> int:
        """Local delta LSN high-watermark (-1 = no deltas): the value the
        cutover driver seals."""
        with self._lock:
            if not self._layers:
                return -1
            return max(la.lsn_max for la in self._layers.values())

    def control_state(self) -> dict:
        """JSON-plain view of the scope's control doc: the coordinator's
        when fenced, the local one otherwise (same shape)."""
        return (self.cp.mvcc_state(self.scope) if self.cp is not None
                else mvccfence.state_view(self._doc))

    def sealed(self) -> Optional[tuple[int, int]]:
        """(watermark, epoch) of the sealed cutover, None before it."""
        if self._sealed is not None:
            return self._sealed
        cut = self.control_state().get("cutover")
        if cut:
            self._sealed = (int(cut["watermark"]), int(cut["epoch"]))
        return self._sealed

    def local_offsets(self) -> dict:
        """Per-source-partition high offsets over the layers THIS store
        holds, max-merged: the value the cutover seals."""
        out: dict[str, int] = {}
        with self._lock:
            for la in self._layers.values():
                for part, off in la.offsets.items():
                    cur = out.get(part)
                    if cur is None or int(off) > cur:
                        out[part] = int(off)
        return out

    def sealed_offsets(self) -> Optional[dict]:
        """The source offsets sealed inside the cutover decision, None
        before a seal.  These, never a pump's local view, are what
        commits to the replication source."""
        cut = self.control_state().get("cutover")
        if not cut:
            return None
        return {str(k): int(v)
                for k, v in (cut.get("offsets") or {}).items()}

    # -- cutover ------------------------------------------------------------
    def cutover(self, epoch: int, watermark: Optional[int] = None,
                offsets: Optional[dict] = None) -> dict:
        """Seal the snapshot->replication handoff: the delta LSN
        high-watermark, the staged-commit epoch AND the replication
        source offsets become one atomic coordinator decision.  A retry
        of the same decision is granted; a different (watermark, epoch)
        after the seal is fenced and receives the sealed values."""
        failpoint("mvcc.cutover")
        sp = trace.span("mvcc_cutover", scope=self.scope, epoch=epoch)
        with sp:
            w = self.watermark() if watermark is None else int(watermark)
            offs = self.local_offsets() if offsets is None else offsets
            if self.cp is not None:
                decision = self.cp.mvcc_cutover(self.scope, w, epoch,
                                                offsets=offs)
            else:
                with self._lock:
                    decision = mvccfence.cutover_in_place(
                        self._doc, w, epoch, offsets=offs)
            if decision.get("granted"):
                self._sealed = (int(decision["watermark"]),
                                int(decision["epoch"]))
                if decision.get("first"):
                    self.stats.cutovers.inc()
            else:
                self.stats.cutover_fenced.inc()
            self.stats.watermark_lag.set(
                max(0, self.watermark()
                    - int(decision.get("watermark", -1))))
            if sp:
                sp.add(granted=bool(decision.get("granted")),
                       watermark=int(decision.get("watermark", -1)))
            return decision

    # -- merge-on-read ------------------------------------------------------
    def read_at(self, table: str,
                watermark: Optional[int] = None) -> list[ColumnBatch]:
        """Point-in-time read: base + deltas with ``lsn <= watermark``
        merged latest-wins.  ``watermark=None`` reads at the sealed
        cutover watermark when there is one, else at the local delta
        high-watermark.  Returns per-source batches, encodings intact."""
        if watermark is None:
            sealed = self.sealed()
            watermark = sealed[0] if sealed is not None \
                else self.watermark()
        sp = trace.span("mvcc_read_at", table=table, watermark=watermark)
        with sp:
            out = self._merge(table, int(watermark))
            rows = sum(b.n_rows for b in out)
            self.stats.merged_reads.inc()
            self.stats.merged_rows.inc(rows)
            if sp:
                sp.add(rows=rows, sources=len(out))
            return out

    def _merge(self, table: str, watermark: int) -> list[ColumnBatch]:
        with self._lock:
            bases = sorted(self._bases.get(table, {}).values(),
                           key=lambda bv: bv.part)
            layers = [self._layers[k] for k in self._order
                      if self._layers[k].table == table]
        # sources: (batch, layer order); base rows rank below every delta
        # (lsn -1), deltas rank by per-row lsn then admission
        srcs: list[tuple[ColumnBatch, int]] = []
        for bv in bases:
            srcs.extend((b, -1) for b in bv.batches)
        for oi, layer in enumerate(layers):
            srcs.extend((b, oi) for b in layer.batches)
        cols = {"keys": [], "lsn": [], "layer": [], "src": [],
                "row": [], "kind": []}
        for si, (b, oi) in enumerate(srcs):
            n = b.n_rows
            if n == 0:
                continue
            if oi < 0:
                lsn = np.full(n, -1, dtype=np.int64)
                idx = np.arange(n, dtype=np.int64)
            else:
                lsn = (np.asarray(b.lsns, dtype=np.int64)
                       if b.lsns is not None
                       else np.zeros(n, dtype=np.int64))
                idx = np.nonzero(lsn <= watermark)[0].astype(np.int64)
                if len(idx) == 0:
                    continue
            cols["keys"].append(pk_keys(b, self.device)[idx])
            cols["lsn"].append(lsn[idx])
            cols["layer"].append(np.full(len(idx), oi, dtype=np.int64))
            cols["src"].append(np.full(len(idx), si, dtype=np.int64))
            cols["row"].append(idx)
            cols["kind"].append(
                b.kinds[idx].astype(np.int64) if b.kinds is not None
                else np.zeros(len(idx), dtype=np.int64))
        if not cols["keys"]:
            return []
        keys = np.concatenate(cols["keys"])
        lsn = np.concatenate(cols["lsn"])
        layer = np.concatenate(cols["layer"])
        src = np.concatenate(cols["src"])
        row = np.concatenate(cols["row"])
        kind = np.concatenate(cols["kind"])
        # latest-wins: sort (pk, lsn, layer, src, row); the LAST entry of
        # each pk group is the winning version
        order = np.lexsort((row, src, layer, lsn, keys))
        sk = keys[order]
        group_last = np.nonzero(np.append(sk[1:] != sk[:-1], True))[0]
        winners = order[group_last]
        visible = winners[kind[winners] != DELETE_CODE]
        out: list[ColumnBatch] = []
        for si in np.unique(src[visible]):
            take_rows = np.sort(row[visible[src[visible] == si]])
            out.append(srcs[int(si)][0].take(take_rows))
        return out

    # -- compaction install (mvcc/compact.py drives the merge) --------------
    def install_compacted(self, table: str, watermark: int,
                          merged: list[ColumnBatch]) -> list[tuple]:
        """Atomically replace the table's bases and fully-folded delta
        layers with one compacted base version at the next epoch.  Layers
        with rows ABOVE the watermark stay.  Returns the pruned
        (worker, seq) keys, which the caller prunes from the coordinator
        doc (idempotent)."""
        with self._lock:
            parts = self._bases.get(table, {})
            next_epoch = 1 + max(
                (bv.epoch for bv in parts.values()), default=0)
            folded = [k for k in self._order
                      if self._layers[k].table == table
                      and self._layers[k].lsn_max <= watermark]
            bv = BaseVersion(table=table, part="__compacted__",
                             epoch=next_epoch, batches=list(merged))
            self._bases[table] = {bv.part: bv}
            for k in folded:
                del self._layers[k]
            self._order = [k for k in self._order if k in self._layers]
            self.stats.live_layers.set(len(self._layers))
        self.stats.compactions.inc()
        self.stats.compacted_rows.inc(sum(b.n_rows for b in merged))
        return folded
