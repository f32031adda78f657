"""Row-level change event (the port's copy of
``transferia_tpu/abstract/change_item.py``).

`ChangeItem` is the row view used by control events and row-oriented
sources and sinks; bulk data lives in `columnar.batch.ColumnBatch` and
pivots to rows only at the row-oriented edges (`ColumnBatch.to_rows`).
Both views share TableSchema.  `to_json` serves the native queue
serializer; the JSON read side (`from_json`) is not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Sequence

from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import TableID, TableSchema


@dataclass(frozen=True)
class OldKeys:
    """Pre-update/delete key values."""

    key_names: tuple[str, ...] = ()
    key_values: tuple[Any, ...] = ()

    def as_dict(self) -> dict[str, Any]:
        return dict(zip(self.key_names, self.key_values))


@dataclass(frozen=True)
class ChangeItem:
    """Universal row event.

    Parallel arrays ``column_names``/``column_values``; ``table_schema``
    is shared across items of a batch (never copied per row).  ``lsn`` is
    the provider-specific monotonic position; ``commit_time_ns`` is the
    transaction commit time in epoch nanoseconds.
    """

    kind: Kind
    schema: str = ""          # namespace (db schema)
    table: str = ""
    column_names: tuple[str, ...] = ()
    column_values: tuple[Any, ...] = ()
    table_schema: Optional[TableSchema] = None
    old_keys: OldKeys = field(default_factory=OldKeys)
    lsn: int = 0
    commit_time_ns: int = 0
    txn_id: str = ""
    counter: int = 0
    part_id: str = ""         # sharded-load part id
    size_bytes: int = 0       # read bytes attributed to this item
    queue_meta: Optional[dict] = None  # topic/partition/offset for mirror mode

    @property
    def table_id(self) -> TableID:
        return TableID(self.schema, self.table)

    def is_row_event(self) -> bool:
        return self.kind.is_row

    def as_dict(self) -> dict[str, Any]:
        return dict(zip(self.column_names, self.column_values))

    def value(self, column: str) -> Any:
        try:
            return self.column_values[self.column_names.index(column)]
        except ValueError:
            return None

    def key_values(self) -> tuple[Any, ...]:
        """Current primary-key values according to table_schema."""
        if self.table_schema is None:
            return ()
        vals = self.as_dict()
        return tuple(vals.get(c.name)
                     for c in self.table_schema.key_columns())

    def effective_key(self) -> tuple[Any, ...]:
        """Key identifying the row *before* this event (for collapse
        order): for updates/deletes with old_keys present, the old key
        wins."""
        if self.kind in (Kind.UPDATE, Kind.DELETE) and self.old_keys.key_names:
            if self.table_schema is not None:
                ok = self.old_keys.as_dict()
                return tuple(
                    ok.get(c.name) for c in self.table_schema.key_columns()
                )
            return tuple(self.old_keys.key_values)
        return self.key_values()

    def keys_changed(self) -> bool:
        if self.kind != Kind.UPDATE or not self.old_keys.key_names:
            return False
        return self.effective_key() != self.key_values()

    def with_values(self, names: Sequence[str],
                    values: Sequence[Any]) -> "ChangeItem":
        return replace(
            self, column_names=tuple(names), column_values=tuple(values)
        )

    def to_json(self) -> dict[str, Any]:
        out = {
            "kind": self.kind.value,
            "schema": self.schema,
            "table": self.table,
            "columnnames": list(self.column_names),
            "columnvalues": list(self.column_values),
            "lsn": self.lsn,
            "commit_time": self.commit_time_ns,
            "id": self.counter,
            "txn_id": self.txn_id,
        }
        if self.old_keys.key_names:
            out["oldkeys"] = {
                "keynames": list(self.old_keys.key_names),
                "keyvalues": list(self.old_keys.key_values),
            }
        if self.table_schema is not None:
            out["table_schema"] = self.table_schema.to_json()
        return out


# -- control-event constructors ----------------------------------------------

def _control(kind: Kind, table_id: TableID, schema: Optional[TableSchema],
             part_id: str = "") -> ChangeItem:
    return ChangeItem(
        kind=kind,
        schema=table_id.namespace,
        table=table_id.name,
        table_schema=schema,
        part_id=part_id,
        commit_time_ns=time.time_ns(),
    )


def init_table_load(table_id: TableID, schema: Optional[TableSchema] = None,
                    part_id: str = "") -> ChangeItem:
    return _control(Kind.INIT_TABLE_LOAD, table_id, schema, part_id)


def done_table_load(table_id: TableID, schema: Optional[TableSchema] = None,
                    part_id: str = "") -> ChangeItem:
    return _control(Kind.DONE_TABLE_LOAD, table_id, schema, part_id)


def init_sharded_table_load(table_id: TableID,
                            schema: Optional[TableSchema] = None
                            ) -> ChangeItem:
    return _control(Kind.INIT_SHARDED_TABLE_LOAD, table_id, schema)


def done_sharded_table_load(table_id: TableID,
                            schema: Optional[TableSchema] = None
                            ) -> ChangeItem:
    return _control(Kind.DONE_SHARDED_TABLE_LOAD, table_id, schema)


# -- batch utilities ----------------------------------------------------------

def split_by_table_id(items: Sequence[ChangeItem]
                      ) -> dict[TableID, list[ChangeItem]]:
    out: dict[TableID, list[ChangeItem]] = {}
    for it in items:
        out.setdefault(it.table_id, []).append(it)
    return out


def collapse(items: Sequence[ChangeItem]) -> list[ChangeItem]:
    """Collapse multiple events per primary key into at most one.

    Within one push batch, insert+update chains fold into a single
    insert/update carrying the final values; a trailing delete folds to
    a single delete (or nothing if the row was inserted inside the
    batch).  Items without schema/keys pass through untouched in order;
    updates that change the primary key are not collapsed.
    """
    for it in items:
        if not it.is_row_event():
            return list(items)
        if it.table_schema is None or not it.table_schema.has_primary_key():
            return list(items)
        if it.keys_changed():
            return list(items)

    order: list[tuple] = []
    state: dict[tuple, Optional[ChangeItem]] = {}
    # True only while the key's entire in-batch history is a fresh insert
    # chain (insert [+updates]); then insert+delete folds to nothing.  A
    # key first seen via update/delete may pre-exist in the target, so a
    # trailing delete must survive.
    fresh_insert: dict[tuple, bool] = {}

    for it in items:
        key = (it.table_id, it.effective_key())
        if key not in state:
            order.append(key)
            state[key] = None
            fresh_insert[key] = it.kind == Kind.INSERT
        prev = state[key]
        if it.kind == Kind.INSERT:
            state[key] = it
        elif it.kind == Kind.UPDATE:
            if prev is not None and prev.kind in (Kind.INSERT, Kind.UPDATE):
                merged = dict(zip(prev.column_names, prev.column_values))
                merged.update(zip(it.column_names, it.column_values))
                names = tuple(merged.keys())
                state[key] = replace(
                    prev if prev.kind == Kind.INSERT else it,
                    column_names=names,
                    column_values=tuple(merged[n] for n in names),
                    lsn=it.lsn,
                    commit_time_ns=it.commit_time_ns,
                )
            else:
                state[key] = it
        elif it.kind == Kind.DELETE:
            state[key] = None if fresh_insert[key] else it

    return [state[k] for k in order if state[k] is not None]
