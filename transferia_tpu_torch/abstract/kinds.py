"""Row-event kinds and control events (the port's copy of
``transferia_tpu/abstract/kinds.py``).

Row kinds (insert/update/delete), DDL-ish kinds, and the control kinds
that bracket snapshot table loads (InitTableLoad/DoneTableLoad/
InitShardedTableLoad/DoneShardedTableLoad) plus the Synchronize barrier.
Control events travel as standalone items through the same serialized
push path as the columnar blocks of their part, so they are never
reordered relative to them.
"""

from __future__ import annotations

import enum


class Kind(str, enum.Enum):
    # Row kinds
    INSERT = "insert"
    UPDATE = "update"
    DELETE = "delete"

    # Schema/DDL kinds
    DDL = "ddl"
    PG_DDL = "pg:DDL"
    MONGO_CREATE = "mongo:create"
    MONGO_DROP = "mongo:drop"
    MONGO_RENAME = "mongo:rename"
    MONGO_DROP_DATABASE = "mongo:dropDatabase"
    MONGO_NOOP = "mongo:noop"
    TRUNCATE = "truncate"
    DROP = "drop"

    # Snapshot control kinds
    INIT_TABLE_LOAD = "init_load_table"
    DONE_TABLE_LOAD = "done_load_table"
    INIT_SHARDED_TABLE_LOAD = "init_sharded_table_load"
    DONE_SHARDED_TABLE_LOAD = "done_sharded_table_load"

    # Barrier used by async sinks to force a flush and confirm delivery
    SYNCHRONIZE = "synchronize"

    @property
    def is_row(self) -> bool:
        return self in _ROW_KINDS

    @property
    def is_control(self) -> bool:
        return self in _CONTROL_KINDS


_ROW_KINDS = frozenset({Kind.INSERT, Kind.UPDATE, Kind.DELETE})
_CONTROL_KINDS = frozenset({
    Kind.INIT_TABLE_LOAD,
    Kind.DONE_TABLE_LOAD,
    Kind.INIT_SHARDED_TABLE_LOAD,
    Kind.DONE_SHARDED_TABLE_LOAD,
    Kind.SYNCHRONIZE,
})

# Stable int8 codes for the columnar representation (ColumnBatch.kinds).
# Only row kinds appear inside columnar blocks; control events are standalone.
KIND_CODES = {Kind.INSERT: 0, Kind.UPDATE: 1, Kind.DELETE: 2}
CODE_KINDS = {v: k for k, v in KIND_CODES.items()}
