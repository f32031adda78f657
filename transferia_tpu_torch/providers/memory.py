"""In-memory provider (the port's copy of the snapshot half of
``transferia_tpu/providers/memory.py``): a sink that captures every
push for assertions, staged-commit capable, a storage made of
pre-loaded batches, and the sink's read-back storage
(`MemoryStoreStorage`, what the checksum task reads as the target).
The storage also keeps incremental cursors, so cursor-based snapshots run
without a database.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from transferia_tpu_torch.abstract.change_item import ChangeItem
from transferia_tpu_torch.abstract.commit import StagedSinker
from transferia_tpu_torch.abstract.interfaces import (
    Batch,
    IncrementalStorage,
    Pusher,
    Sinker,
    Storage,
    TableInfo,
    is_columnar,
)
from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.models.endpoint import (
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.providers.registry import (
    Provider,
    register_provider,
)
from transferia_tpu_torch.providers.staging import (
    EpochFence,
    PartStage,
    publish_guard,
)
from transferia_tpu_torch.runtime.device import DeviceLike

# sink_id -> captured store; source_id -> seeded batches
_STORES: dict[str, "MemoryStore"] = {}
_STORES_LOCK = threading.Lock()
_SOURCES: dict[str, list[ColumnBatch]] = {}


class MemoryStore:
    """Captured pushes, with row-level views for assertions.

    Staged commits: `begin_stage`/`stage` buffer a part's batches
    invisibly; `publish_stage` makes them visible at once, replacing the
    batches an earlier publish of the same part key landed, behind a
    sink-side epoch fence."""

    def __init__(self):
        self.lock = threading.Lock()
        self.batches: list[Batch] = []
        # (part key, epoch) -> PartStage: a zombie and the survivor that
        # reclaimed its part never share a staging area
        self._staged: dict[tuple[str, int], PartStage] = {}
        self._published_by_part: dict[str, list[Batch]] = {}
        self._fence = EpochFence()

    def push(self, batch: Batch) -> None:
        with self.lock:
            self.batches.append(batch)

    # -- staged two-phase commit -------------------------------------------
    def begin_stage(self, key: str, epoch: int,
                    device: DeviceLike = None) -> None:
        with self.lock:
            # begin replaces: a part retry restages from scratch
            self._staged[(key, epoch)] = PartStage(key, epoch,
                                                   device=device)

    def stage(self, key: str, epoch: int, batch: Batch) -> None:
        with self.lock:
            stage = self._staged.get((key, epoch))
        if stage is None:
            raise RuntimeError(f"memory sink: no open stage for {key!r}")
        # outside the store lock: each stage's pushes are serialized by
        # its own part's sink pipeline
        stage.stage(batch)

    def publish_stage(self, key: str, epoch: int) -> tuple[int, int]:
        """Returns (rows published, dedup-window rows dropped)."""
        with publish_guard(key, epoch), self.lock:
            stage = self._staged.get((key, epoch))
            if stage is None:
                raise RuntimeError(
                    f"memory sink: nothing staged for {key!r}")
            self._fence.check_and_advance(key, epoch)
            # replace-on-republish: drop what an earlier publish of this
            # part landed (by identity: assertions hold batch objects)
            prev = self._published_by_part.pop(key, None)
            if prev:
                prev_ids = {id(b) for b in prev}
                self.batches = [b for b in self.batches
                                if id(b) not in prev_ids]
            self.batches.extend(stage.batches)
            self._published_by_part[key] = list(stage.batches)
            del self._staged[(key, epoch)]
            return stage.rows, stage.dedup_dropped

    def arm_replay(self, key: str, epoch: int) -> None:
        """The next staged push for this part may replay a torn prefix."""
        with self.lock:
            stage = self._staged.get((key, epoch))
        if stage is not None:
            stage.note_push_retry()

    def abort_stage(self, key: str, epoch: Optional[int] = None) -> None:
        with self.lock:
            if epoch is not None:
                self._staged.pop((key, epoch), None)
            else:
                for k in [k for k in self._staged if k[0] == key]:
                    self._staged.pop(k, None)

    # -- assertion helpers --------------------------------------------------
    def rows(self, table: Optional[TableID] = None) -> list[ChangeItem]:
        out = []
        with self.lock:
            for b in self.batches:
                items = b.to_rows() if is_columnar(b) else list(b)
                for it in items:
                    if it.is_row_event() and \
                            (table is None or it.table_id == table):
                        out.append(it)
        return out

    def control_events(self) -> list[ChangeItem]:
        out = []
        with self.lock:
            for b in self.batches:
                if not is_columnar(b):
                    out.extend(it for it in b if not it.is_row_event())
        return out

    def row_count(self, table: Optional[TableID] = None) -> int:
        n = 0
        with self.lock:
            for b in self.batches:
                if is_columnar(b):
                    if table is None or b.table_id == table:
                        n += b.n_rows
                else:
                    n += sum(
                        1 for it in b
                        if it.is_row_event()
                        and (table is None or it.table_id == table)
                    )
        return n

    def clear(self) -> None:
        with self.lock:
            self.batches.clear()
            self._staged.clear()
            self._published_by_part.clear()
            self._fence = EpochFence()


def get_store(sink_id: str) -> MemoryStore:
    with _STORES_LOCK:
        store = _STORES.get(sink_id)
        if store is None:
            store = _STORES[sink_id] = MemoryStore()
        return store


def seed_source(source_id: str, batches: list[ColumnBatch]) -> None:
    """Pre-load batches for a MemorySourceParams storage."""
    _SOURCES[source_id] = batches


@register_endpoint
@dataclass
class MemoryTargetParams(EndpointParams):
    PROVIDER = "memory"
    IS_TARGET = True

    sink_id: str = "default"
    fail_pushes: int = 0       # fail the first N pushes (retry testing)
    bufferer: Optional[dict] = None

    def bufferer_config(self):
        return self.bufferer


@register_endpoint
@dataclass
class MemorySourceParams(EndpointParams):
    PROVIDER = "memory"
    IS_SOURCE = True

    source_id: str = "default"


class MemorySinker(Sinker, StagedSinker):
    """Capture sink; staged-commit capable (the engine opens the stage →
    publish lifecycle with begin_part, otherwise pushes land directly —
    the at-least-once path).  Staged pushes key their rows on `device`
    for the dedup window."""

    def __init__(self, params: MemoryTargetParams,
                 device: DeviceLike = None):
        self.params = params
        self.device = device
        self.store = get_store(params.sink_id)
        self._fails_left = params.fail_pushes
        self._stage_key: str = ""
        self._stage_epoch: int = 0

    def push(self, batch: Batch) -> None:
        if self._fails_left > 0:
            self._fails_left -= 1
            raise ConnectionError(
                f"injected failure ({self._fails_left} left)"
            )
        if self._stage_key:
            self.store.stage(self._stage_key, self._stage_epoch, batch)
        else:
            self.store.push(batch)

    def begin_part(self, key: str, epoch: int) -> None:
        self.store.begin_stage(key, epoch, self.device)
        self._stage_key = key
        self._stage_epoch = epoch

    def publish_part(self, key: str, epoch: int) -> int:
        rows, self.last_dedup_dropped = self.store.publish_stage(
            key, epoch)
        if self._stage_key == key:
            # back to direct-push mode: the stage is gone (published)
            self._stage_key = ""
        return rows

    def abort_part(self, key: str) -> None:
        self.store.abort_stage(key, self._stage_epoch
                               if self._stage_key == key else None)
        if self._stage_key == key:
            self._stage_key = ""

    def note_push_retry(self) -> None:
        if self._stage_key:
            self.store.arm_replay(self._stage_key, self._stage_epoch)


class MemoryStorage(Storage, IncrementalStorage):
    """Storage over seeded batches; a table description's filter is a
    predicate the scan applies."""

    def __init__(self, params: MemorySourceParams):
        self.batches = _SOURCES.get(params.source_id, [])

    def _by_table(self) -> dict[TableID, list[ColumnBatch]]:
        out: dict[TableID, list[ColumnBatch]] = {}
        for b in self.batches:
            out.setdefault(b.table_id, []).append(b)
        return out

    def table_list(self, include=None):
        out = {}
        for tid, batches in self._by_table().items():
            if include and not any(tid.include_matches(p) for p in include):
                continue
            out[tid] = TableInfo(
                eta_rows=sum(b.n_rows for b in batches),
                schema=batches[0].schema,
            )
        return out

    def table_schema(self, table: TableID) -> TableSchema:
        return self._by_table()[table][0].schema

    def load_table(self, table: TableDescription, pusher: Pusher) -> None:
        mask_fn = None
        if table.filter:
            from transferia_tpu_torch.predicate import compile_mask, parse

            mask_fn = compile_mask(parse(table.filter))
        for b in self._by_table().get(table.id, []):
            if mask_fn is not None:
                b = b.filter(mask_fn(b))
                if b.n_rows == 0:
                    continue
            pusher(b)

    # -- IncrementalStorage -------------------------------------------------
    def get_increment_state(self, tables, state):
        out = []
        for t in tables:
            cursor = state.get(str(t.table), t.initial_state or None)
            if cursor is None or cursor == "":
                out.append(TableDescription(id=t.table))
            else:
                lit = cursor if isinstance(cursor, (int, float)) \
                    else f"'{cursor}'"
                out.append(TableDescription(
                    id=t.table, filter=f"{t.cursor_field} > {lit}"
                ))
        return out

    def next_increment_state(self, tables):
        out = {}
        for t in tables:
            best = None
            for b in self._by_table().get(t.table, []):
                if t.cursor_field in b.columns:
                    for v in b.columns[t.cursor_field].to_pylist():
                        if v is not None and (best is None or v > best):
                            best = v
            if best is not None:
                out[str(t.table)] = best
        return out


class MemoryStoreStorage(Storage):
    """Storage view over a sink's captured pushes (the TARGET side).  The
    seed space (`seed_source`) and the capture space (`get_store`) are
    distinct: a checksum against the target must read the latter."""

    def __init__(self, sink_id: str):
        self._store = get_store(sink_id)

    def _by_table(self) -> dict[TableID, list]:
        out: dict[TableID, list] = {}
        for it in self._store.rows():
            out.setdefault(it.table_id, []).append(it)
        return out

    def table_list(self, include=None):
        out = {}
        for tid, items in self._by_table().items():
            if include and not any(tid.include_matches(p)
                                   for p in include):
                continue
            out[tid] = TableInfo(eta_rows=len(items),
                                 schema=items[0].table_schema)
        return out

    def table_schema(self, table: TableID) -> TableSchema:
        return self._by_table()[table][0].table_schema

    def load_table(self, table: TableDescription, pusher: Pusher) -> None:
        items = self._by_table().get(table.id, [])
        mask_fn = None
        if table.filter:
            from transferia_tpu_torch.predicate import compile_mask, parse

            mask_fn = compile_mask(parse(table.filter))
        for lo in range(0, len(items), 4096):
            b = ColumnBatch.from_rows(items[lo:lo + 4096])
            if mask_fn is not None:
                b = b.filter(mask_fn(b))
            if b.n_rows:
                pusher(b)


@register_provider
class MemoryProvider(Provider):
    NAME = "memory"

    def storage(self):
        if isinstance(self.transfer.src, MemorySourceParams):
            return MemoryStorage(self.transfer.src)
        return None

    def destination_storage(self):
        """What the sink captured (the checksum reads the target)."""
        if isinstance(self.transfer.dst, MemoryTargetParams):
            return MemoryStoreStorage(self.transfer.dst.sink_id)
        return None

    def sinker(self):
        if isinstance(self.transfer.dst, MemoryTargetParams):
            return MemorySinker(self.transfer.dst, self.device)
        return None
