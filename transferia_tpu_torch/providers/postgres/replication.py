"""PostgreSQL logical replication source, CDC (the port's copy of
``transferia_tpu/providers/postgres/replication.py``): slot-based
replication, the wal2json decoder, the slot lifecycle and runaway-slot
protection.

Protocol: a `replication=database` connection runs CREATE_REPLICATION_SLOT
/ START_REPLICATION; the server switches to CopyBoth and streams XLogData
('w') and keepalive ('k') CopyData messages; the client answers with
standby status updates ('r') advancing the flushed LSN only after the sink
confirms delivery — the at-least-once checkpoint contract.

Decode: wal2json format-version 2 (one JSON object per message:
action I/U/D/B/C/T with columns/identity arrays).

Left out, raising NotImplementedError naming its ROADMAP.md item: the
DBLog incremental snapshot interleaved with the stream
(`dblog_snapshot`, A10).
"""

from __future__ import annotations

import json
import logging
import struct
import threading
import time
from typing import Iterator, Optional

from transferia_tpu_torch.abstract.change_item import ChangeItem, OldKeys
from transferia_tpu_torch.abstract.errors import FatalError
from transferia_tpu_torch.abstract.interfaces import AsyncSink, Source
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import (
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator.interface import Coordinator
from transferia_tpu_torch.providers.postgres.wire import PGConnection, PGError
from transferia_tpu_torch.typesystem.rules import map_source_type

logger = logging.getLogger(__name__)


def lsn_to_int(lsn: str) -> int:
    hi, lo = lsn.split("/")
    return (int(hi, 16) << 32) | int(lo, 16)


def int_to_lsn(v: int) -> str:
    return f"{v >> 32:X}/{v & 0xFFFFFFFF:X}"


class ReplicationConnection(PGConnection):
    """PGConnection extension for the streaming-replication sub-protocol."""

    def identify_system(self) -> dict:
        rows = self.query("IDENTIFY_SYSTEM")
        return rows[0] if rows else {}

    def create_slot(self, slot: str, plugin: str = "wal2json") -> dict:
        rows = self.query(
            f"CREATE_REPLICATION_SLOT {slot} LOGICAL {plugin}"
        )
        return rows[0] if rows else {}

    def drop_slot(self, slot: str) -> None:
        self.query(f"DROP_REPLICATION_SLOT {slot}")

    def start_replication(self, slot: str, lsn: str,
                          options: Optional[dict] = None) -> None:
        opts = options or {"format-version": "2",
                           "include-transaction": "true"}
        opt_s = ", ".join(f'"{k}" \'{v}\'' for k, v in opts.items())
        sql = f"START_REPLICATION SLOT {slot} LOGICAL {lsn} ({opt_s})"
        self._send(b"Q", sql.encode() + b"\x00")
        t, payload = self._recv_message()
        if t != b"W":
            raise PGError(
                f"expected CopyBothResponse for START_REPLICATION, got {t!r}"
            )

    def stream(self, timeout: float = 1.0
               ) -> Iterator[tuple[str, int, bytes]]:
        """Yield ('xlog', wal_end, payload) / ('keepalive', wal_end,
        reply_requested) until no data is readable for `timeout` (caller
        loops).

        Framing safety: readability is probed with select BEFORE touching
        the socket; once a header byte exists the full message is read
        under the connection's long timeout — a short-timeout abort
        mid-frame would desync the protocol permanently.  Connection errors
        propagate (the replication retry loop restarts the worker); they
        are never swallowed.
        """
        import select

        while True:
            # BufferedSock may have whole messages already buffered in
            # userspace (a 256KiB refill can pull several replication
            # frames at once); select on the raw fd would block past them
            # and stall CDC delivery / keepalive replies until fresh wire
            # bytes arrive.  Drain the buffer before probing the kernel.
            if self.sock.pending() == 0:
                readable, _, _ = select.select([self.sock], [], [], timeout)
                if not readable:
                    return
            t, payload = self._recv_message()
            if t != b"d":
                if t == b"Z":
                    return
                continue
            kind = payload[:1]
            if kind == b"w":
                start, end, ts = struct.unpack("!QQQ", payload[1:25])
                yield ("xlog", end, payload[25:])
            elif kind == b"k":
                end, ts, reply = struct.unpack("!QQB", payload[1:18])
                yield ("keepalive", end, bytes([reply]))

    def send_standby_status(self, flushed_lsn: int,
                            reply_requested: bool = False) -> None:
        # PG epoch (2000-01-01) microseconds
        ts = int((time.time() - 946_684_800) * 1_000_000)
        msg = b"r" + struct.pack(
            "!QQQQB", flushed_lsn + 1, flushed_lsn + 1, flushed_lsn + 1,
            ts, 1 if reply_requested else 0,
        )
        self._send(b"d", msg)


class Wal2JsonDecoder:
    """wal2json v2 messages -> ChangeItems."""

    def __init__(self):
        self._schemas: dict[str, TableSchema] = {}

    def _schema_for(self, obj: dict) -> TableSchema:
        cols = obj.get("columns") or obj.get("identity") or []
        key = json.dumps(
            [obj.get("schema"), obj.get("table"),
             [(c.get("name"), c.get("type")) for c in cols],
             [c.get("name") for c in (obj.get("pk") or [])]],
            sort_keys=True,
        )
        cached = self._schemas.get(key)
        if cached is not None:
            return cached
        pk_names = {c.get("name") for c in (obj.get("pk") or [])}
        if not pk_names and obj.get("identity"):
            pk_names = {c.get("name") for c in obj["identity"]}
        schema = TableSchema([
            ColSchema(
                name=c["name"],
                data_type=map_source_type("pg", (c.get("type") or "")
                                          .lower()),
                primary_key=c["name"] in pk_names,
                original_type=f"pg:{c.get('type', '')}",
            )
            for c in cols
        ])
        self._schemas[key] = schema
        return schema

    @staticmethod
    def _coerce(cs: ColSchema, v):
        if v is None:
            return None
        t = cs.data_type
        if t.is_integer:
            try:
                return int(v)
            except (TypeError, ValueError):
                return v
        if t.is_float:
            try:
                return float(v)
            except (TypeError, ValueError):
                return v
        return v

    def decode(self, payload: bytes, lsn: int,
               txn_id: str = "") -> Optional[ChangeItem]:
        obj = json.loads(payload)
        action = obj.get("action")
        if action in ("B", "C"):  # txn begin/commit markers
            return None
        if action == "M":  # logical message
            return None
        kind = {"I": Kind.INSERT, "U": Kind.UPDATE,
                "D": Kind.DELETE, "T": Kind.TRUNCATE}.get(action)
        if kind is None:
            raise ValueError(f"wal2json: unknown action {action!r}")
        tid = TableID(obj.get("schema", ""), obj.get("table", ""))
        if kind == Kind.TRUNCATE:
            return ChangeItem(kind=kind, schema=tid.namespace,
                              table=tid.name, lsn=lsn, txn_id=txn_id)
        schema = self._schema_for(obj)
        names, values = (), ()
        if kind != Kind.DELETE:
            cols = obj.get("columns") or []
            names = tuple(c["name"] for c in cols)
            values = tuple(
                self._coerce(schema.find(c["name"]), c.get("value"))
                for c in cols
            )
        old_keys = OldKeys()
        identity = obj.get("identity") or []
        if identity:
            old_keys = OldKeys(
                tuple(c["name"] for c in identity),
                tuple(
                    self._coerce(schema.find(c["name"]), c.get("value"))
                    for c in identity
                ),
            )
        return ChangeItem(
            kind=kind, schema=tid.namespace, table=tid.name,
            column_names=names, column_values=values,
            table_schema=schema, old_keys=old_keys,
            lsn=lsn, txn_id=txn_id,
            commit_time_ns=time.time_ns(),
        )


class PGReplicationSource(Source):
    """Slot-based CDC source with post-push LSN checkpointing."""

    STATE_KEY = "pg_wal_lsn"

    def __init__(self, params, transfer_id: str,
                 coordinator: Optional[Coordinator] = None,
                 batch_rows: int = 1024,
                 flush_interval: float = 1.0):
        self.params = params
        self.transfer_id = transfer_id
        self.cp = coordinator
        self.batch_rows = batch_rows
        self.flush_interval = flush_interval
        self.decoder = Wal2JsonDecoder()
        self._stop = threading.Event()
        self.slot = params.slot_name or f"transferia_{transfer_id}" \
            .replace("-", "_")
        if getattr(params, "dblog_snapshot", False):
            raise NotImplementedError(
                "the DBLog incremental snapshot (dblog_snapshot) is not "
                "ported to transferia_tpu_torch yet (ROADMAP.md A10)")

    def _connect(self) -> ReplicationConnection:
        return ReplicationConnection(
            host=self.params.host, port=self.params.port,
            database=self.params.database, user=self.params.user,
            password=self.params.password, replication=True,
        ).connect()

    def ensure_slot(self, conn: ReplicationConnection) -> str:
        """Create the slot if missing; returns the start LSN."""
        try:
            info = conn.create_slot(self.slot)
            lsn = info.get("consistent_point") or "0/0"
            logger.info("created replication slot %s at %s", self.slot, lsn)
            return lsn
        except PGError as e:
            if e.sqlstate == "42710":  # duplicate_object: slot exists
                return "0/0"
            raise

    def run(self, sink: AsyncSink) -> None:
        conn = self._connect()
        try:
            start_lsn = "0/0"
            if self.cp is not None:
                state = self.cp.get_transfer_state(self.transfer_id)
                if state.get(self.STATE_KEY):
                    start_lsn = state[self.STATE_KEY]
            if start_lsn == "0/0":
                start_lsn = self.ensure_slot(conn) or "0/0"
            conn.start_replication(self.slot, start_lsn)
            items: list[ChangeItem] = []
            futures: list = []
            flushed = lsn_to_int(start_lsn) if start_lsn != "0/0" else 0
            pending_lsn = flushed
            last_flush = time.monotonic()

            def flush_items():
                nonlocal items
                if not items:
                    return
                for run in _split_homogeneous(items):
                    batch: object
                    if run[0].is_row_event() and run[0].table_schema:
                        batch = ColumnBatch.from_rows(run)
                    else:
                        batch = run
                    futures.append(sink.async_push(batch))
                items = []

            def confirm():
                nonlocal flushed
                for f in futures:
                    f.result()
                futures.clear()
                if pending_lsn > flushed:
                    flushed = pending_lsn
                    if self.cp is not None:
                        self.cp.set_transfer_state(
                            self.transfer_id,
                            {self.STATE_KEY: int_to_lsn(flushed)},
                        )
                    conn.send_standby_status(flushed)

            while not self._stop.is_set():
                for kind, wal_end, payload in conn.stream(timeout=0.2):
                    if kind == "keepalive":
                        flush_items()
                        confirm()
                        if payload == b"\x01":
                            conn.send_standby_status(flushed, True)
                        # a server that keeps sending keepalives keeps
                        # the stream open: the stop must be seen here
                        if self._stop.is_set():
                            break
                        continue
                    item = self.decoder.decode(payload, wal_end)
                    pending_lsn = max(pending_lsn, wal_end)
                    if item is not None:
                        items.append(item)
                    if len(items) >= self.batch_rows:
                        flush_items()
                    if self._stop.is_set():
                        break
                if time.monotonic() - last_flush >= self.flush_interval:
                    flush_items()
                    confirm()
                    last_flush = time.monotonic()
            flush_items()
            confirm()
        finally:
            conn.close()

    def stop(self) -> None:
        self._stop.set()


def _split_homogeneous(items: list[ChangeItem]) -> list[list[ChangeItem]]:
    out: list[list[ChangeItem]] = []
    key = None
    for it in items:
        k = (it.table_id, it.table_schema.fingerprint()
             if it.table_schema else None, it.is_row_event())
        if not out or k != key:
            out.append([])
            key = k
        out[-1].append(it)
    return out


class SlotMonitor:
    """Watches slot lag and kills runaway slots."""

    def __init__(self, params, slot: str,
                 max_lag_bytes: int = 50 << 30,
                 interval: float = 60.0):
        self.params = params
        self.slot = slot
        self.max_lag = max_lag_bytes
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check_once(self) -> int:
        """Returns current slot lag in bytes; raises FatalError past limit."""
        conn = PGConnection(
            host=self.params.host, port=self.params.port,
            database=self.params.database, user=self.params.user,
            password=self.params.password,
        ).connect()
        try:
            lag = conn.scalar(
                "SELECT pg_wal_lsn_diff(pg_current_wal_lsn(), "
                f"restart_lsn) FROM pg_replication_slots "
                f"WHERE slot_name = '{self.slot}'"
            )
            lag = int(lag or 0)
            if lag > self.max_lag:
                raise FatalError(
                    f"replication slot {self.slot} lag {lag} bytes exceeds "
                    f"limit {self.max_lag}; dropping to protect the source"
                )
            return lag
        finally:
            conn.close()

    def start(self, on_fatal) -> None:
        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.check_once()
                except FatalError as e:
                    on_fatal(e)
                    return
                except PGError as e:
                    logger.warning("slot monitor check failed: %s", e)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="slot-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
