"""MySQL binlog replication source, ROW format (the port's copy of
``transferia_tpu/providers/mysql/binlog.py``): binlog tailing with
file+position and executed-GTID checkpoints after confirmed pushes.

Protocol: COM_BINLOG_DUMP (no replica registration — the server streams
to any authenticated connection); events arrive as OK-prefixed packets
(v4 framing: timestamp(4) type(1) server_id(4) event_size(4) log_pos(4)
flags(2) + body, plus a CRC32 trailer when binlog_checksum is on, which
is negotiated and stripped).  Decoded events:
FORMAT_DESCRIPTION, ROTATE, TABLE_MAP, WRITE/UPDATE/DELETE_ROWS v1/v2,
QUERY (DDL passthrough), XID.  Row images decode per the TABLE_MAP column
types; schemas come from the catalog (information_schema) since binlog
carries no column names.  Runs of one table go to the sink as
`ColumnBatch.from_rows`, mixed kinds in one batch; the chain then runs
on the replication's device like any other batch's.
"""

from __future__ import annotations

import logging
import struct
import threading
import time
from typing import Optional

from transferia_tpu_torch.abstract.change_item import ChangeItem, OldKeys
from transferia_tpu_torch.abstract.interfaces import AsyncSink, Source
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator.interface import Coordinator
from transferia_tpu_torch.providers.mysql.gtid import GtidSet
from transferia_tpu_torch.providers.mysql.wire import (
    MySQLConnection,
    MySQLError,
)

logger = logging.getLogger(__name__)

# event types
EV_QUERY = 2
EV_ROTATE = 4
EV_FORMAT_DESCRIPTION = 15
EV_XID = 16
EV_TABLE_MAP = 19
EV_WRITE_ROWS_V1 = 23
EV_UPDATE_ROWS_V1 = 24
EV_DELETE_ROWS_V1 = 25
EV_WRITE_ROWS_V2 = 30
EV_UPDATE_ROWS_V2 = 31
EV_GTID = 33  # GTID_LOG_EVENT: flags(1) + sid(16) + gno(8 le)
EV_DELETE_ROWS_V2 = 32

COM_BINLOG_DUMP = 0x12

# column types (subset)
T_DECIMAL = 0
T_TINY = 1
T_SHORT = 2
T_LONG = 3
T_FLOAT = 4
T_DOUBLE = 5
T_NULL = 6
T_TIMESTAMP = 7
T_LONGLONG = 8
T_INT24 = 9
T_DATE = 10
T_TIME = 11
T_DATETIME = 12
T_YEAR = 13
T_VARCHAR = 15
T_BIT = 16
T_TIMESTAMP2 = 17
T_DATETIME2 = 18
T_TIME2 = 19
T_JSON = 245
T_NEWDECIMAL = 246
T_ENUM = 247
T_SET = 248
T_TINY_BLOB = 249
T_MEDIUM_BLOB = 250
T_LONG_BLOB = 251
T_BLOB = 252
T_VAR_STRING = 253
T_STRING = 254


class TableMap:
    __slots__ = ("schema", "table", "col_types", "col_meta", "null_bits")

    def __init__(self, schema: str, table: str, col_types: bytes,
                 col_meta: list[int]):
        self.schema = schema
        self.table = table
        self.col_types = col_types
        self.col_meta = col_meta


def _read_lenenc(data: bytes, pos: int) -> tuple[int, int]:
    first = data[pos]
    if first < 0xFB:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", data, pos + 1)[0], pos + 3
    if first == 0xFD:
        v = data[pos + 1] | (data[pos + 2] << 8) | (data[pos + 3] << 16)
        return v, pos + 4
    return struct.unpack_from("<Q", data, pos + 1)[0], pos + 9


def _parse_table_map(body: bytes) -> tuple[int, TableMap]:
    table_id = int.from_bytes(body[0:6], "little")
    pos = 8  # table id(6) + flags(2)
    slen = body[pos]
    schema = body[pos + 1:pos + 1 + slen].decode()
    pos += 1 + slen + 1
    tlen = body[pos]
    table = body[pos + 1:pos + 1 + tlen].decode()
    pos += 1 + tlen + 1
    n_cols, pos = _read_lenenc(body, pos)
    col_types = body[pos:pos + n_cols]
    pos += n_cols
    meta_len, pos = _read_lenenc(body, pos)
    meta_block = body[pos:pos + meta_len]
    pos += meta_len
    col_meta = _parse_col_meta(col_types, meta_block)
    return table_id, TableMap(schema, table, col_types, col_meta)


def _parse_col_meta(col_types: bytes, meta: bytes) -> list[int]:
    out = []
    mp = 0
    for t in col_types:
        if t in (T_FLOAT, T_DOUBLE, T_BLOB, T_TINY_BLOB, T_MEDIUM_BLOB,
                 T_LONG_BLOB, T_JSON, T_TIMESTAMP2, T_DATETIME2, T_TIME2):
            out.append(meta[mp])
            mp += 1
        elif t in (T_VARCHAR, T_VAR_STRING, T_BIT):
            out.append(struct.unpack_from("<H", meta, mp)[0])
            mp += 2
        elif t in (T_STRING, T_ENUM, T_SET, T_NEWDECIMAL, T_DECIMAL):
            out.append((meta[mp] << 8) | meta[mp + 1])
            mp += 2
        else:
            out.append(0)
    return out


def _decode_value(t: int, meta: int, data: bytes, pos: int):
    """One column value from a row image; returns (value, new_pos)."""
    if t == T_TINY:
        return struct.unpack_from("<b", data, pos)[0], pos + 1
    if t == T_SHORT:
        return struct.unpack_from("<h", data, pos)[0], pos + 2
    if t == T_INT24:
        v = int.from_bytes(data[pos:pos + 3], "little", signed=True)
        return v, pos + 3
    if t == T_LONG:
        return struct.unpack_from("<i", data, pos)[0], pos + 4
    if t == T_LONGLONG:
        return struct.unpack_from("<q", data, pos)[0], pos + 8
    if t == T_FLOAT:
        return struct.unpack_from("<f", data, pos)[0], pos + 4
    if t == T_DOUBLE:
        return struct.unpack_from("<d", data, pos)[0], pos + 8
    if t == T_YEAR:
        return 1900 + data[pos], pos + 1
    if t == T_DATE:
        # canonical DATE = int32 days since epoch
        import datetime as _dt

        v = int.from_bytes(data[pos:pos + 3], "little")
        year, month, day = v >> 9, (v >> 5) & 0x0F, v & 0x1F
        if year == 0 or month == 0 or day == 0:  # zero-date
            return None, pos + 3
        days = _dt.date(year, month, day).toordinal() \
            - _dt.date(1970, 1, 1).toordinal()
        return days, pos + 3
    if t == T_DATETIME2:
        # canonical TIMESTAMP = int64 microseconds since epoch
        import calendar

        raw = int.from_bytes(data[pos:pos + 5], "big")
        frac_bytes = (meta + 1) // 2
        micros = _read_fraction(data, pos + 5, frac_bytes)
        ym = (raw >> 22) & 0x1FFFF
        year, month = ym // 13, ym % 13
        day = (raw >> 17) & 0x1F
        hour = (raw >> 12) & 0x1F
        minute = (raw >> 6) & 0x3F
        second = raw & 0x3F
        if year == 0 or month == 0 or day == 0:
            return None, pos + 5 + frac_bytes
        secs = calendar.timegm(
            (year, month, day, hour, minute, second, 0, 0, 0)
        )
        return secs * 1_000_000 + micros, pos + 5 + frac_bytes
    if t == T_TIMESTAMP2:
        secs = int.from_bytes(data[pos:pos + 4], "big")
        frac_bytes = (meta + 1) // 2
        micros = _read_fraction(data, pos + 4, frac_bytes)
        return secs * 1_000_000 + micros, pos + 4 + frac_bytes
    if t == T_TIME2:
        raw = int.from_bytes(data[pos:pos + 3], "big")
        frac_bytes = (meta + 1) // 2
        sign = 1 if raw & 0x800000 else -1
        if sign < 0:
            raw = 0x1000000 - raw
        hours = (raw >> 12) & 0x3FF
        minutes = (raw >> 6) & 0x3F
        seconds = raw & 0x3F
        text = f"{'-' if sign < 0 else ''}" \
               f"{hours:02d}:{minutes:02d}:{seconds:02d}"
        return text, pos + 3 + frac_bytes
    if t in (T_VARCHAR, T_VAR_STRING):
        if meta > 255:
            ln = struct.unpack_from("<H", data, pos)[0]
            pos += 2
        else:
            ln = data[pos]
            pos += 1
        return data[pos:pos + ln].decode("utf-8", "replace"), pos + ln
    if t == T_STRING:
        real_type = meta >> 8
        if real_type in (T_ENUM, T_SET):
            ln = meta & 0xFF
            v = int.from_bytes(data[pos:pos + ln], "little")
            return v, pos + ln
        max_len = meta & 0x3FF
        if max_len > 255:
            ln = struct.unpack_from("<H", data, pos)[0]
            pos += 2
        else:
            ln = data[pos]
            pos += 1
        return data[pos:pos + ln].decode("utf-8", "replace"), pos + ln
    if t in (T_BLOB, T_TINY_BLOB, T_MEDIUM_BLOB, T_LONG_BLOB, T_JSON):
        ln = int.from_bytes(data[pos:pos + meta], "little")
        pos += meta
        raw = bytes(data[pos:pos + ln])
        return raw, pos + ln
    if t == T_NEWDECIMAL:
        precision, scale = meta >> 8, meta & 0xFF
        return _decode_decimal(data, pos, precision, scale)
    if t == T_BIT:
        nbits = ((meta >> 8) * 8) + (meta & 0xFF)
        nbytes = (nbits + 7) // 8
        return int.from_bytes(data[pos:pos + nbytes], "big"), pos + nbytes
    raise MySQLError(f"binlog: unsupported column type {t}")


def _read_fraction(data: bytes, pos: int, frac_bytes: int) -> int:
    """Big-endian fractional seconds -> microseconds."""
    if frac_bytes == 0:
        return 0
    frac = int.from_bytes(data[pos:pos + frac_bytes], "big")
    return frac * (10 ** (6 - 2 * frac_bytes))


_DIG2BYTES = [0, 1, 1, 2, 2, 3, 3, 4, 4, 4]


def _decode_decimal(data: bytes, pos: int, precision: int,
                    scale: int) -> tuple[str, int]:
    """MySQL packed decimal -> string."""
    intg = precision - scale
    intg0, frac0 = intg // 9, scale // 9
    intg0x, frac0x = intg - intg0 * 9, scale - frac0 * 9
    size = intg0 * 4 + _DIG2BYTES[intg0x] + frac0 * 4 + _DIG2BYTES[frac0x]
    buf = bytearray(data[pos:pos + size])
    negative = not (buf[0] & 0x80)
    buf[0] ^= 0x80
    if negative:
        for i in range(len(buf)):
            buf[i] = (~buf[i]) & 0xFF
    p = 0
    int_part = 0
    if intg0x:
        n = _DIG2BYTES[intg0x]
        int_part = int.from_bytes(buf[p:p + n], "big")
        p += n
    for _ in range(intg0):
        int_part = int_part * 10**9 + int.from_bytes(buf[p:p + 4], "big")
        p += 4
    frac_part = ""
    for _ in range(frac0):
        frac_part += f"{int.from_bytes(buf[p:p + 4], 'big'):09d}"
        p += 4
    if frac0x:
        n = _DIG2BYTES[frac0x]
        frac_part += \
            f"{int.from_bytes(buf[p:p + n], 'big'):0{frac0x}d}"
        p += n
    sign = "-" if negative else ""
    out = f"{sign}{int_part}.{frac_part}" if scale else f"{sign}{int_part}"
    return out, pos + size


def _decode_row_image(data: bytes, pos: int, tmap: TableMap,
                      present: list[bool]) -> tuple[list, int]:
    n_present = sum(present)
    null_bytes = (n_present + 7) // 8
    null_bits = data[pos:pos + null_bytes]
    pos += null_bytes
    values: list = []
    null_idx = 0
    for i, is_present in enumerate(present):
        if not is_present:
            values.append(None)
            continue
        is_null = (null_bits[null_idx // 8] >> (null_idx % 8)) & 1
        null_idx += 1
        if is_null:
            values.append(None)
            continue
        v, pos = _decode_value(tmap.col_types[i], tmap.col_meta[i],
                               data, pos)
        values.append(v)
    return values, pos


class BinlogReader:
    """Parses the binlog event stream into row events.

    table_filter(schema, table) gates which tables are decoded at all —
    events for foreign databases are skipped before row decoding, so an
    exotic column type in an unrelated table can never kill the stream.
    """

    def __init__(self, table_filter=None):
        self.table_maps: dict[int, TableMap] = {}
        self.binlog_file = ""
        self.table_filter = table_filter or (lambda s, t: True)

    def parse_event(self, body: bytes):
        """One event (after the OK byte).  Returns a list of tuples:
        ('row', schema, table, kind, values, old_values) |
        ('ddl', schema, query) | ('rotate', file, position) |
        ('pos', log_pos)."""
        ts, etype = struct.unpack_from("<IB", body, 0)
        log_pos = struct.unpack_from("<I", body, 13)[0]
        payload = body[19:]
        out = []
        if etype == EV_ROTATE:
            # rotate resets positions: pair the NEW file with ITS position.
            # binlog_file is NOT updated here — the consumer flushes pending
            # rows against the OLD file first, then applies the rotate
            new_pos = struct.unpack_from("<Q", payload, 0)[0]
            new_file = payload[8:].rstrip(b"\x00").decode()
            out.append(("rotate", new_file, new_pos))
            return out
        out.append(("pos", log_pos, ts))
        if etype == EV_GTID:
            import uuid as _uuid

            sid = str(_uuid.UUID(bytes=payload[1:17]))
            gno = struct.unpack_from("<Q", payload, 17)[0]
            out.append(("gtid", sid, gno))
        elif etype == EV_XID:
            out.append(("commit",))
        elif etype == EV_TABLE_MAP:
            tid, tmap = _parse_table_map(payload)
            self.table_maps[tid] = tmap
        elif etype in (EV_WRITE_ROWS_V1, EV_WRITE_ROWS_V2,
                       EV_UPDATE_ROWS_V1, EV_UPDATE_ROWS_V2,
                       EV_DELETE_ROWS_V1, EV_DELETE_ROWS_V2):
            out.extend(self._parse_rows(etype, payload))
        elif etype == EV_QUERY:
            slen = payload[8]
            # skip: thread(4) exec_time(4) schema_len(1) err(2) status_len(2)
            status_len = struct.unpack_from("<H", payload, 11)[0]
            pos = 13 + status_len
            schema = payload[pos:pos + slen].decode()
            query = payload[pos + slen + 1:].decode("utf-8", "replace")
            if query == "COMMIT":
                out.append(("commit",))
            elif query != "BEGIN":
                # DDL implicitly commits its transaction
                out.append(("ddl", schema, query))
                out.append(("commit",))
        return out

    def _parse_rows(self, etype: int, payload: bytes):
        table_id = int.from_bytes(payload[0:6], "little")
        pos = 8  # table id + flags
        if etype in (EV_WRITE_ROWS_V2, EV_UPDATE_ROWS_V2,
                     EV_DELETE_ROWS_V2):
            extra_len = struct.unpack_from("<H", payload, pos)[0]
            pos += extra_len  # includes the 2 length bytes
        n_cols, pos = _read_lenenc(payload, pos)
        bitmap_len = (n_cols + 7) // 8
        present1 = _bits(payload[pos:pos + bitmap_len], n_cols)
        pos += bitmap_len
        is_update = etype in (EV_UPDATE_ROWS_V1, EV_UPDATE_ROWS_V2)
        present2 = present1
        if is_update:
            present2 = _bits(payload[pos:pos + bitmap_len], n_cols)
            pos += bitmap_len
        tmap = self.table_maps.get(table_id)
        if tmap is None:
            logger.warning("binlog: rows event for unknown table id %d",
                           table_id)
            return []
        if not self.table_filter(tmap.schema, tmap.table):
            return []
        out = []
        while pos < len(payload):
            values, pos = _decode_row_image(payload, pos, tmap, present1)
            if is_update:
                new_values, pos = _decode_row_image(payload, pos, tmap,
                                                    present2)
                out.append(("row", tmap.schema, tmap.table, Kind.UPDATE,
                            new_values, values))
            elif etype in (EV_WRITE_ROWS_V1, EV_WRITE_ROWS_V2):
                out.append(("row", tmap.schema, tmap.table, Kind.INSERT,
                            values, None))
            else:
                out.append(("row", tmap.schema, tmap.table, Kind.DELETE,
                            None, values))
        return out


def _bits(data: bytes, n: int) -> list[bool]:
    return [(data[i // 8] >> (i % 8)) & 1 == 1 for i in range(n)]


class MySQLBinlogSource(Source):
    """CDC source: COM_BINLOG_DUMP stream -> ChangeItems with position
    checkpoints after confirmed pushes (at-least-once)."""

    STATE_KEY = "mysql_binlog"

    def __init__(self, params, transfer_id: str,
                 coordinator: Optional[Coordinator] = None,
                 server_id: int = 41789, batch_rows: int = 1024):
        self.params = params
        self.transfer_id = transfer_id
        self.cp = coordinator
        self.server_id = server_id
        self.batch_rows = batch_rows
        self._stop = threading.Event()
        self._schemas: dict[tuple[str, str], TableSchema] = {}
        self._gtid = GtidSet()
        self._gtid_valid = False  # True only when baselined/resumed

    def _schema_for(self, schema: str, table: str,
                    catalog: MySQLConnection) -> Optional[TableSchema]:
        key = (schema, table)
        if key not in self._schemas:
            from transferia_tpu_torch.providers.mysql.provider import (
                MySQLStorage,
            )

            storage = MySQLStorage(self.params)
            storage._c = catalog
            try:
                self._schemas[key] = storage.table_schema(
                    TableID(schema, table)
                )
            except MySQLError:
                return None
        return self._schemas[key]

    def run(self, sink: AsyncSink) -> None:
        conn = MySQLConnection(
            host=self.params.host, port=self.params.port,
            database="", user=self.params.user,
            password=self.params.password,
        ).connect()
        catalog = MySQLConnection(
            host=self.params.host, port=self.params.port,
            database=self.params.database, user=self.params.user,
            password=self.params.password,
        ).connect()
        try:
            # honor the server's checksum setting: MySQL >= 5.6 defaults to
            # CRC32 and appends 4 bytes per event that must be stripped
            conn.query(
                "SET @master_binlog_checksum = @@global.binlog_checksum"
            )
            checksum = str(conn.scalar(
                "SELECT @@global.binlog_checksum"
            ) or "NONE").upper()
            checksum_bytes = 4 if checksum == "CRC32" else 0
            file, pos, gtid_set = self._start_position(catalog)
            if gtid_set:
                # GTID resume survives source failover/renamed binlogs
                # (the executed set, not the file name, names the point)
                self._dump_gtid(conn, file, pos, gtid_set)
                self._gtid = gtid_set
            else:
                self._dump(conn, file, pos)
                # fresh start baselined self._gtid (+_gtid_valid) in
                # _start_position; a legacy file+pos state leaves
                # _gtid_valid False so checkpoints stay file+pos-only —
                # a partial executed set would make a later GTID resume
                # replay the whole retained history
            # GTID lifecycle: a gtid becomes EXECUTED only when its
            # transaction completes (XID/COMMIT/next GTID) — merging it
            # at first sight would let a mid-transaction flush checkpoint
            # it and a crash-restart skip the transaction's pushed tail
            open_gtid: list = [None]
            pending_gtids: list[tuple[str, int]] = []

            def table_filter(schema: str, table: str) -> bool:
                return (not self.params.database
                        or schema == self.params.database)

            reader = BinlogReader(table_filter)
            reader.binlog_file = file
            items: list[ChangeItem] = []
            futures: list = []
            last_pos = pos
            pending_pos = pos
            last_flush = time.monotonic()

            def flush():
                nonlocal items, last_pos
                for run in _runs(items):
                    if run[0].is_row_event() and run[0].table_schema:
                        futures.append(
                            sink.async_push(ColumnBatch.from_rows(run))
                        )
                    else:
                        futures.append(sink.async_push(run))
                items = []
                for f in futures:
                    f.result()
                futures.clear()
                # completed-transaction gtids merge into the executed set
                # only after the pushes above resolved (at-least-once)
                for sid, gno in pending_gtids:
                    self._gtid.add(sid, gno)
                dirty = bool(pending_gtids) or pending_pos != last_pos
                pending_gtids.clear()
                if dirty and self.cp is not None:
                    state = {"file": reader.binlog_file,
                             "pos": pending_pos}
                    if self._gtid_valid:
                        state["gtid_set"] = str(self._gtid)
                    self.cp.set_transfer_state(self.transfer_id, {
                        self.STATE_KEY: state,
                    })
                last_pos = pending_pos

            import select

            while not self._stop.is_set():
                # probe with select; only read when a packet is pending so
                # a short timeout can never abort mid-frame and desync.
                # BufferedSock may hold complete packets already pulled
                # off the wire — drain those before consulting the kernel
                # (select on the raw fd cannot see them)
                if not getattr(conn.sock, "pending", lambda: 0)():
                    readable, _, _ = select.select([conn.sock], [], [],
                                                   0.3)
                    if not readable:
                        if time.monotonic() - last_flush > 0.5:
                            flush()
                            last_flush = time.monotonic()
                        continue
                pkt = conn._read_packet()
                if pkt[:1] == b"\xff":
                    raise conn._err(pkt)
                if pkt[:1] == b"\xfe" and len(pkt) < 9:
                    break  # EOF
                event = pkt[1:len(pkt) - checksum_bytes] \
                    if checksum_bytes else pkt[1:]
                for ev in reader.parse_event(event):
                    if ev[0] == "pos":
                        pending_pos = max(pending_pos, ev[1])
                    elif ev[0] == "rotate":
                        # flush pending rows against the OLD file, THEN
                        # switch files — a crash between the two writes
                        # must never leave (new file, old position)
                        flush()
                        reader.binlog_file = ev[1]
                        pending_pos = ev[2]
                        last_pos = ev[2]
                        if self.cp is not None:
                            state = {"file": ev[1], "pos": ev[2]}
                            if self._gtid_valid:
                                state["gtid_set"] = str(self._gtid)
                            self.cp.set_transfer_state(self.transfer_id, {
                                self.STATE_KEY: state,
                            })
                    elif ev[0] == "gtid":
                        # a new GTID implies the previous txn completed
                        if open_gtid[0] is not None:
                            pending_gtids.append(open_gtid[0])
                        open_gtid[0] = (ev[1], ev[2])
                    elif ev[0] == "commit":
                        if open_gtid[0] is not None:
                            pending_gtids.append(open_gtid[0])
                            open_gtid[0] = None
                    elif ev[0] == "row":
                        _, schema, table, kind, values, old = ev
                        item = self._to_item(schema, table, kind, values,
                                             old, catalog, pending_pos)
                        if item is not None:
                            items.append(item)
                    elif ev[0] == "ddl":
                        items.append(ChangeItem(
                            kind=Kind.DDL, schema=ev[1],
                            column_names=("query",),
                            column_values=(ev[2],),
                        ))
                if len(items) >= self.batch_rows:
                    flush()
                    last_flush = time.monotonic()
            flush()
        finally:
            conn.close()
            catalog.close()

    def _start_position(self, catalog: MySQLConnection
                        ) -> tuple[str, int, Optional["GtidSet"]]:
        if self.cp is not None:
            state = self.cp.get_transfer_state(self.transfer_id).get(
                self.STATE_KEY
            )
            if state:
                gtid = GtidSet.parse(state.get("gtid_set", ""))
                if gtid:
                    self._gtid_valid = True
                    return state["file"], int(state["pos"]), gtid
                # legacy file+pos state: no executed-set baseline exists;
                # keep checkpointing file+pos only (_gtid_valid stays
                # False) rather than fabricating a partial set
                return state["file"], int(state["pos"]), None
        from transferia_tpu_torch.providers.mysql.provider import (
            MySQLStorage,
        )

        storage = MySQLStorage(self.params)
        storage._c = catalog
        pos = storage.position()
        if not pos.get("binlog_file"):
            raise MySQLError(
                "cannot determine binlog position; is binary logging on?"
            )
        # fresh start: baseline the executed set so future checkpoints
        # carry gtids (file+pos dump is still used for the first attach —
        # the server streams everything after that position)
        self._gtid = GtidSet.parse(pos.get("gtid_set", "") or "")
        self._gtid_valid = True
        return pos["binlog_file"], int(pos["binlog_pos"]), None

    def _dump(self, conn: MySQLConnection, file: str, pos: int) -> None:
        conn._seq = 0
        body = struct.pack("<BIHI", 0x12, max(4, pos), 0, self.server_id) \
            + file.encode()
        conn._send_packet(body)

    def _dump_gtid(self, conn: MySQLConnection, file: str, pos: int,
                   gtid_set: "GtidSet") -> None:
        """COM_BINLOG_DUMP_GTID (0x1e): resume from an executed set.

        flags carries BINLOG_THROUGH_GTID (0x04) — without it a real
        server ignores the GTID data and resumes by file+pos."""
        conn._seq = 0
        data = gtid_set.encode()
        body = (struct.pack("<BHI", 0x1E, 0x04, self.server_id)
                + struct.pack("<I", len(file)) + file.encode()
                + struct.pack("<Q", max(4, pos))
                + struct.pack("<I", len(data)) + data)
        conn._send_packet(body)

    def _to_item(self, schema: str, table: str, kind: Kind,
                 values, old, catalog, log_pos) -> Optional[ChangeItem]:
        tschema = self._schema_for(schema, table, catalog)
        if tschema is None:
            return None
        names = tuple(tschema.names())

        def normalize(vals):
            if vals is None:
                return None
            out = []
            for cs, v in zip(tschema, vals):
                # binlog frames TEXT/JSON values as blobs (bytes); decode
                # for every canonical type except raw STRING, which keeps
                # bytes by contract
                if isinstance(v, bytes) and \
                        cs.data_type != CanonicalType.STRING:
                    v = v.decode("utf-8", "replace")
                out.append(v)
            return tuple(out)

        new_vals = normalize(values)
        old_vals = normalize(old)
        old_keys = OldKeys()
        if old_vals is not None:
            key_names = tuple(
                c.name for c in tschema.key_columns()
            ) or names
            by_name = dict(zip(names, old_vals))
            old_keys = OldKeys(
                key_names, tuple(by_name.get(k) for k in key_names)
            )
        return ChangeItem(
            kind=kind, schema=schema, table=table,
            column_names=names if new_vals is not None else (),
            column_values=new_vals if new_vals is not None else (),
            table_schema=tschema,
            old_keys=old_keys,
            lsn=log_pos,
            commit_time_ns=time.time_ns(),
        )

    def stop(self) -> None:
        self._stop.set()


def _runs(items: list[ChangeItem]) -> list[list[ChangeItem]]:
    out: list[list[ChangeItem]] = []
    key = None
    for it in items:
        k = (it.table_id, id(it.table_schema), it.is_row_event())
        if not out or k != key:
            out.append([])
            key = k
        out[-1].append(it)
    return out
