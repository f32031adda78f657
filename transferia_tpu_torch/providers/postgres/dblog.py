"""DBLog incremental snapshot wired into the PG provider (the port's
copy of ``transferia_tpu/providers/postgres/dblog.py``).

A chunked, watermark-fenced snapshot interleaving with the LIVE wal2json
stream, so huge tables snapshot without a long-held consistent read
while replication keeps flowing.  The engine (watermark window, touched-
key dedup, inline chunk emission at the HIGH watermark's stream
position) lives in transferia_tpu_torch/dblog/core.py; this module
supplies the PG pieces:

  - signal table: ``public.__transferia_signal`` on the source; every
    watermark is an INSERT whose wal2json echo fences the chunk window
  - chunk iterator: keyset-paged ``SELECT ... WHERE pk > cursor ORDER BY
    pk LIMIT n`` through the COPY path (PGStorage._copy_select and the
    port's CSV decoder, copycsv.py), its blocks concatenated columnar
  - runner: drives one table at a time, exposes filter() for the
    replication source to pass every CDC batch through, and marks
    completion in transfer state so resume never re-snapshots
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.dblog.core import (
    DBLogSnapshot,
    PagedChunkIterator,
    StorageSignalTable,
)

logger = logging.getLogger(__name__)

SIGNAL_TID = TableID("public", "__transferia_signal")


class PGDBLogRunner:
    """Drives DBLog snapshots for a PG source next to live replication.

    The replication source calls ``filter(batch)`` on every batch it is
    about to push (watermark rows are consumed there; pending chunks are
    emitted inline), and ``start()`` once streaming is up.  Completion is
    recorded under STATE_KEY in the transfer state."""

    STATE_KEY = "pg_dblog_done"

    def __init__(self, params, transfer_id: str, coordinator,
                 chunk_rows: int = 10_000,
                 tables: Optional[list[str]] = None,
                 chunk_timeout: float = 30.0):
        from transferia_tpu_torch.providers.postgres.provider import (
            PGStorage,
        )

        self.params = params
        self.transfer_id = transfer_id
        self.cp = coordinator
        self.chunk_rows = chunk_rows
        self.tables = tables
        self.chunk_timeout = chunk_timeout
        self.storage = PGStorage(params)
        self._active: Optional[DBLogSnapshot] = None
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()

    # -- replication-side hook ----------------------------------------------
    def filter(self, batch):
        """Pass a CDC batch through the active snapshot's watermark
        filter.  Signal-table rows NEVER pass — watermark echoes landing
        between snapshots (the SUCCESS marker, residual slot replays
        after completion) must not reach the target."""
        snap = self._active
        if snap is not None:
            batch = snap.filter_cdc(batch)
        if isinstance(batch, ColumnBatch):
            if batch.table_id == SIGNAL_TID:
                return []
            return batch
        return [it for it in batch
                if getattr(it, "table_id", None) != SIGNAL_TID]

    # -- lifecycle -----------------------------------------------------------
    def already_done(self) -> bool:
        if self.cp is None:
            return False
        state = self.cp.get_transfer_state(self.transfer_id)
        return bool(state.get(self.STATE_KEY))

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run_all, name="pg-dblog", daemon=True)
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    # -- internals ------------------------------------------------------------
    def _write_conn(self):
        from transferia_tpu_torch.providers.postgres.provider import (
            _conn,
        )

        return _conn(self.params)

    def _ensure_signal_table(self, conn) -> None:
        conn.query(
            f'CREATE TABLE IF NOT EXISTS '
            f'"{SIGNAL_TID.namespace}"."{SIGNAL_TID.name}" '
            f'(mark_id text, kind text, PRIMARY KEY (mark_id))'
        )

    def _table_ids(self) -> list[TableID]:
        if self.tables:
            return [TableID.parse(t) for t in self.tables]
        return [tid for tid in self.storage.table_list()
                if tid != SIGNAL_TID]

    def _chunk_loader(self, tid: TableID, schema, key: str):
        from transferia_tpu_torch.providers.postgres.provider import (
            _pg_literal,
        )

        cols = ", ".join(f'"{c.name}"' for c in schema)

        def load(cursor, limit: int) -> Optional[ColumnBatch]:
            where = (f' WHERE "{key}" > {_pg_literal(cursor)}'
                     if cursor is not None else "")
            sql = (f'SELECT {cols} FROM {tid.fqtn()}{where} '
                   f'ORDER BY "{key}" LIMIT {int(limit)}')
            got: list[ColumnBatch] = []
            self.storage._copy_select(sql, tid, schema, got.append)
            if not got:
                return None
            # one columnar chunk (the reference pivots the COPY blocks
            # through ChangeItems: the same rows)
            return got[0] if len(got) == 1 else ColumnBatch.concat(got)

        return load

    def _run_all(self) -> None:
        try:
            conn = self._write_conn()
            try:
                self._ensure_signal_table(conn)

                def write_watermark(mark_id: str, kind: str) -> None:
                    conn.query(
                        f'INSERT INTO "{SIGNAL_TID.namespace}".'
                        f'"{SIGNAL_TID.name}" (mark_id, kind) '
                        f"VALUES ('{mark_id}', '{kind}')"
                    )

                signal = StorageSignalTable(write_watermark,
                                            table=SIGNAL_TID)
                total = 0
                for tid in self._table_ids():
                    schema = self.storage.table_schema(tid)
                    keys = [c.name for c in schema.key_columns()]
                    if len(keys) != 1:
                        logger.warning(
                            "dblog: %s needs a single-column primary key "
                            "(has %d) — skipping (use the regular "
                            "snapshot path for it)", tid, len(keys))
                        continue
                    snap = DBLogSnapshot(
                        signal,
                        PagedChunkIterator(
                            self._chunk_loader(tid, schema, keys[0]),
                            keys[0], self.chunk_rows),
                        keys,
                    )
                    self._active = snap
                    try:
                        rows = snap.run(chunk_timeout=self.chunk_timeout)
                    finally:
                        self._active = None
                    logger.info("dblog snapshot of %s: %d rows", tid,
                                rows)
                    total += rows
                if self.cp is not None:
                    state = self.cp.get_transfer_state(self.transfer_id)
                    state[self.STATE_KEY] = True
                    self.cp.set_transfer_state(self.transfer_id, state)
                logger.info("dblog snapshot complete: %d rows total",
                            total)
            finally:
                conn.close()
        except BaseException as e:  # surfaced by the replication loop
            logger.exception("dblog snapshot failed")
            self.error = e
        finally:
            self.done.set()
