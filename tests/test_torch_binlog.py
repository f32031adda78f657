"""The MySQL binlog tail of the port (the GTID set, the ROW event decoder
and `MySQLBinlogSource` through `run_replication`) against the JAX
package's, on the CPU, exactly.

Decoders: both packages' `BinlogReader.parse_event` over the same seeded
event stream (FORMAT_DESCRIPTION, QUERY BEGIN/COMMIT/DDL, GTID, XID,
ROTATE, TABLE_MAP, WRITE/UPDATE/DELETE_ROWS v1 and v2 with partial
present bitmaps and NULLs, a filtered schema, an unknown table id and an
unsupported column type) over row images of every type `_decode_value`
handles (decimals and fractional times included) give the same events,
and the packed decimals decode to the digits they were packed from;
`_read_lenenc` at each prefix; `GtidSet` parse, str, contains, add,
update and the COM_BINLOG_DUMP_GTID encoding over seeded sets.

Scenarios, each package against its own fake MySQL: the replication of
inserts, an update pair and a delete with a live event while running;
the GTID resume (executed transactions are not re-delivered), a GTID
not checkpointed before its commit, a rotate, and the users stream of
`recipes.cdc` (mixed kinds in GTID transactions) through the mask into
the memory sink and through the mask and Debezium envelopes into Kafka.
Held equal: the sink's rows, kinds, values and old keys (the wall-clock
commit time set aside), the checkpointed transfer state and the Kafka
records once `ts_ms` is set aside.  Every run stops its replication
thread through `stop_event` within a few seconds.
"""

import enum
import hashlib
import hmac
import json
import re
import struct
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from tests.recipes.fake_kafka import FakeKafka as RefFakeKafka
from tests.recipes.fake_mysql import FakeMySQL as RefFakeMySQL
from tests.recipes.fake_mysql import FakeMyTable as RefFakeMyTable
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers.kafka import KafkaTargetParams as RefKafkaParams
from transferia_tpu.providers.mysql import MySQLSourceParams as RefMyParams
from transferia_tpu.providers.mysql import binlog as ref_binlog
from transferia_tpu.providers.mysql.gtid import GtidSet as RefGtidSet
from transferia_tpu.runtime.local import run_replication as ref_run
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.debezium.receiver import DebeziumReceiver
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers.kafka import KafkaTargetParams
from transferia_tpu_torch.providers.mysql import MySQLSourceParams
from transferia_tpu_torch.providers.mysql import binlog as port_binlog
from transferia_tpu_torch.providers.mysql.gtid import GtidSet
from transferia_tpu_torch.recipes import cdc
from transferia_tpu_torch.recipes.fake_kafka import FakeKafka
from transferia_tpu_torch.recipes.fake_mysql import FakeMySQL, FakeMyTable
from transferia_tpu_torch.runtime.local import run_replication

B = port_binlog
PKGS = {
    "port": dict(mysql=FakeMySQL, table=FakeMyTable, kafka=FakeKafka,
                 params=MySQLSourceParams, kafka_params=KafkaTargetParams,
                 transfer=Transfer, coordinator=MemoryCoordinator,
                 memory=port_memory, run=run_replication,
                 kw={"device": "cpu"}),
    "jax": dict(mysql=RefFakeMySQL, table=RefFakeMyTable,
                kafka=RefFakeKafka, params=RefMyParams,
                kafka_params=RefKafkaParams, transfer=RefTransfer,
                coordinator=RefCoordinator, memory=ref_memory, run=ref_run,
                kw={}),
}
TS_MS = re.compile(rb'"ts_ms":\d+')
MASK = {"transformers": [{"mask_field": {"columns": ["email"],
                                         "salt": "cdc"}}]}


def outcome(fn):
    """A call's result, or its exception as (type name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:  # compared across the packages
        return ("raised", type(e).__name__, str(e))


def both(fn, *args):
    """fn over each package, the two runs at once (they share no fake,
    store or coordinator): (port's result, JAX package's result)."""
    with ThreadPoolExecutor(2) as ex:
        port, ref = ex.submit(fn, "port", *args), ex.submit(fn, "jax", *args)
        return port.result(), ref.result()


def plain(obj):
    """Enums (the packages' Kind) by value, containers walked."""
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return type(obj)(plain(x) for x in obj)
    return obj


# -- the event encoder --------------------------------------------------------

DIG2BYTES = [0, 1, 1, 2, 2, 3, 3, 4, 4, 4]
# (type, meta bytes as TABLE_MAP carries them)
COLUMN_SPECS = [
    (B.T_TINY, b""), (B.T_SHORT, b""), (B.T_INT24, b""), (B.T_LONG, b""),
    (B.T_LONGLONG, b""), (B.T_FLOAT, b"\x04"), (B.T_DOUBLE, b"\x08"),
    (B.T_YEAR, b""), (B.T_DATE, b""),
    (B.T_DATETIME2, b"\x00"), (B.T_DATETIME2, b"\x03"),
    (B.T_DATETIME2, b"\x06"), (B.T_TIMESTAMP2, b"\x00"),
    (B.T_TIMESTAMP2, b"\x02"), (B.T_TIMESTAMP2, b"\x05"),
    (B.T_TIME2, b"\x00"), (B.T_TIME2, b"\x04"),
    (B.T_VARCHAR, struct.pack("<H", 50)),
    (B.T_VARCHAR, struct.pack("<H", 1020)),
    (B.T_VAR_STRING, struct.pack("<H", 200)),
    (B.T_STRING, bytes([B.T_ENUM, 1])), (B.T_STRING, bytes([B.T_SET, 2])),
    (B.T_STRING, bytes([B.T_STRING, 40])),
    (B.T_BLOB, b"\x02"), (B.T_TINY_BLOB, b"\x01"),
    (B.T_MEDIUM_BLOB, b"\x03"), (B.T_LONG_BLOB, b"\x04"),
    (B.T_JSON, b"\x04"),
    (B.T_NEWDECIMAL, bytes([10, 2])), (B.T_NEWDECIMAL, bytes([30, 12])),
    (B.T_NEWDECIMAL, bytes([18, 0])), (B.T_NEWDECIMAL, bytes([7, 7])),
    (B.T_BIT, bytes([3, 2])), (B.T_BIT, bytes([0, 8])),
]
PACKED_DECIMALS: dict = {}    # packed bytes -> the digits packed


def event(etype: int, payload: bytes, log_pos: int,
          ts: int = 1_700_000_000) -> bytes:
    """One v4 event as it follows the OK byte: the 19-byte header, then
    the payload."""
    return struct.pack("<IBIIIH", ts, etype, 1, 19 + len(payload), log_pos,
                       0) + payload


def table_map(table_id: int, schema: str, table: str, specs) -> bytes:
    body = table_id.to_bytes(6, "little") + struct.pack("<H", 1)
    body += bytes([len(schema)]) + schema.encode() + b"\x00"
    body += bytes([len(table)]) + table.encode() + b"\x00"
    body += bytes([len(specs)]) + bytes(t for t, _ in specs)
    meta = b"".join(m for _, m in specs)
    return body + bytes([len(meta)]) + meta + bytes((len(specs) + 7) // 8)


def bitmap(bits) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)


def rows_event(etype: int, table_id: int, n_cols: int, present,
               images, present2=None) -> bytes:
    body = table_id.to_bytes(6, "little") + struct.pack("<H", 1)
    if etype in (B.EV_WRITE_ROWS_V2, B.EV_UPDATE_ROWS_V2,
                 B.EV_DELETE_ROWS_V2):
        body += struct.pack("<H", 2)
    body += bytes([n_cols]) + bitmap(present)
    if present2 is not None:
        body += bitmap(present2)
    return body + b"".join(images)


def decimal_bytes(rng, precision: int, scale: int) -> bytes:
    """MySQL's packed decimal of random digits, remembered with the text
    the digits make."""
    intg = precision - scale
    idig = "".join(map(str, rng.integers(0, 10, intg)))
    fdig = "".join(map(str, rng.integers(0, 10, scale)))
    neg = bool(rng.random() < 0.4)
    intg0, intg0x = divmod(intg, 9)
    frac0, frac0x = divmod(scale, 9)
    out = b""
    if intg0x:
        out += int(idig[:intg0x]).to_bytes(DIG2BYTES[intg0x], "big")
    for w in range(intg0):
        out += int(idig[intg0x + 9 * w:intg0x + 9 * w + 9]).to_bytes(4, "big")
    for w in range(frac0):
        out += int(fdig[9 * w:9 * w + 9]).to_bytes(4, "big")
    if frac0x:
        out += int(fdig[9 * frac0:]).to_bytes(DIG2BYTES[frac0x], "big")
    buf = bytearray(out)
    if neg:
        buf = bytearray(~b & 0xFF for b in buf)
    buf[0] ^= 0x80
    text = f"{'-' if neg else ''}{int(idig or '0')}"
    PACKED_DECIMALS[bytes(buf)] = f"{text}.{fdig}" if scale else text
    return bytes(buf)


def text_bytes(rng, max_len: int) -> bytes:
    n = int(rng.integers(0, max_len + 1))
    if rng.random() < 0.2:   # not UTF-8: both decode with replacement
        return bytes(rng.integers(0, 256, n, dtype=np.uint8))
    s = "".join(rng.choice(list("abcXYZ09 ,'\\äé€"), n))
    return s.encode()[:n]


def value_bytes(rng, t: int, meta: int) -> bytes:
    """One non-NULL value of column type `t` as a row image holds it."""
    if t in (B.T_TINY, B.T_SHORT, B.T_LONG, B.T_LONGLONG):
        fmt, bits = {B.T_TINY: ("<b", 8), B.T_SHORT: ("<h", 16),
                     B.T_LONG: ("<i", 32), B.T_LONGLONG: ("<q", 64)}[t]
        return struct.pack(fmt, int(rng.integers(-2 ** (bits - 1),
                                                 2 ** (bits - 1) - 1,
                                                 dtype=np.int64)))
    if t == B.T_INT24:
        return int(rng.integers(-2 ** 23, 2 ** 23)).to_bytes(
            3, "little", signed=True)
    if t == B.T_FLOAT:
        return struct.pack("<f", float(rng.normal() * 1e3))
    if t == B.T_DOUBLE:
        return struct.pack("<d", float(rng.normal() * 1e9))
    if t == B.T_YEAR:
        return bytes([int(rng.integers(0, 256))])
    frac = b""
    if t in (B.T_DATETIME2, B.T_TIMESTAMP2, B.T_TIME2):
        nb = (meta + 1) // 2
        frac = int(rng.integers(0, 10 ** (2 * nb))).to_bytes(nb, "big") \
            if nb else b""
    year, month, day = (int(rng.integers(1000, 3000)),
                        int(rng.integers(1, 13)), int(rng.integers(1, 29)))
    if rng.random() < 0.1:
        year = 0    # the zero date decodes to NULL
    if t == B.T_DATE:
        return (day | month << 5 | year << 9).to_bytes(3, "little")
    if t == B.T_DATETIME2:
        hms = (int(rng.integers(0, 24)) << 12 | int(rng.integers(0, 60)) << 6
               | int(rng.integers(0, 60)))
        raw = 1 << 39 | (year * 13 + month) << 22 | day << 17 | hms
        return raw.to_bytes(5, "big") + frac
    if t == B.T_TIMESTAMP2:
        return int(rng.integers(0, 2 ** 31)).to_bytes(4, "big") + frac
    if t == B.T_TIME2:
        return int(rng.integers(0, 2 ** 24)).to_bytes(3, "big") + frac
    if t in (B.T_VARCHAR, B.T_VAR_STRING):
        raw = text_bytes(rng, min(meta, 300))
        return (struct.pack("<H", len(raw)) if meta > 255
                else bytes([len(raw)])) + raw
    if t == B.T_STRING:
        if meta >> 8 in (B.T_ENUM, B.T_SET):
            n = meta & 0xFF
            return int(rng.integers(0, 2 ** (8 * n))).to_bytes(n, "little")
        raw = text_bytes(rng, 40)
        return (struct.pack("<H", len(raw)) if meta & 0x3FF > 255
                else bytes([len(raw)])) + raw
    if t in (B.T_BLOB, B.T_TINY_BLOB, B.T_MEDIUM_BLOB, B.T_LONG_BLOB,
             B.T_JSON):
        raw = json.dumps({"k": int(rng.integers(0, 99)),
                          "v": "x" * int(rng.integers(0, 40))}).encode() \
            if t == B.T_JSON else text_bytes(rng, 255)
        return len(raw).to_bytes(meta, "little") + raw
    if t == B.T_NEWDECIMAL:
        return decimal_bytes(rng, meta >> 8, meta & 0xFF)
    if t == B.T_BIT:
        n = ((meta >> 8) * 8 + (meta & 0xFF) + 7) // 8
        return bytes(rng.integers(0, 256, n, dtype=np.uint8))
    raise AssertionError(f"no encoder for type {t}")


def row_image(rng, specs, metas, present, null_share=0.2) -> bytes:
    nulls, values = [], b""
    for i, is_present in enumerate(present):
        if not is_present:
            continue
        null = bool(rng.random() < null_share)
        nulls.append(null)
        if not null:
            values += value_bytes(rng, specs[i][0], metas[i])
    return bitmap(nulls) + values


def event_stream(seed: int) -> list[bytes]:
    """A seeded binlog: every event kind the reader knows, row events of
    every kind in v1 and v2 over all column types."""
    rng = np.random.default_rng(seed)
    metas = ref_binlog._parse_col_meta(bytes(t for t, _ in COLUMN_SPECS),
                                       b"".join(m for _, m in COLUMN_SPECS))
    n = len(COLUMN_SPECS)
    pos = 4
    out = []

    def add(etype, payload):
        nonlocal pos
        pos += 19 + len(payload)
        out.append(event(etype, payload, pos))

    def query(schema: str, q: str) -> bytes:
        status = b"\x00\x01\x02"
        return (struct.pack("<IIBHH", 7, 0, len(schema), 0, len(status))
                + status + schema.encode() + b"\x00" + q.encode())

    add(B.EV_FORMAT_DESCRIPTION, struct.pack("<H", 4) + b"8.0.36" * 4)
    add(B.EV_TABLE_MAP, table_map(7, "shop", "wide", COLUMN_SPECS))
    add(B.EV_TABLE_MAP, table_map(8, "other", "skip",
                                  [(12, b""), (B.T_LONG, b"")]))
    for txn in range(6):
        sid = str(uuid.UUID(bytes=bytes(rng.integers(0, 256, 16,
                                                     dtype=np.uint8))))
        add(B.EV_GTID, b"\x00" + uuid.UUID(sid).bytes
            + struct.pack("<Q", txn + 1))
        add(B.EV_QUERY, query("shop", "BEGIN"))
        for etype in rng.permutation(
                [B.EV_WRITE_ROWS_V1, B.EV_WRITE_ROWS_V2,
                 B.EV_UPDATE_ROWS_V1, B.EV_UPDATE_ROWS_V2,
                 B.EV_DELETE_ROWS_V1, B.EV_DELETE_ROWS_V2]):
            etype = int(etype)
            full = rng.random() < 0.5
            present = [True] * n if full else list(rng.random(n) < 0.7)
            update = etype in (B.EV_UPDATE_ROWS_V1, B.EV_UPDATE_ROWS_V2)
            present2 = (list(rng.random(n) < 0.8) if update and not full
                        else present if update else None)
            images = []
            for _ in range(int(rng.integers(1, 5))):
                img = row_image(rng, COLUMN_SPECS, metas, present)
                if update:
                    img += row_image(rng, COLUMN_SPECS, metas, present2)
                images.append(img)
            add(etype, rows_event(etype, 7, n, present, images, present2))
        # the filtered schema's rows, and an unknown table id's
        add(B.EV_WRITE_ROWS_V2, rows_event(
            B.EV_WRITE_ROWS_V2, 8, 2, [True, True],
            [b"\x00" + bytes(12)]))
        add(B.EV_WRITE_ROWS_V2, rows_event(
            B.EV_WRITE_ROWS_V2, 99, 1, [True], [b"\x00" + bytes(4)]))
        if txn % 3 == 2:
            add(B.EV_QUERY, query("shop", "ALTER TABLE wide ADD c INT"))
        elif txn % 2:
            add(B.EV_QUERY, query("shop", "COMMIT"))
        else:
            add(B.EV_XID, struct.pack("<Q", txn))
        if txn == 3:
            out.append(event(B.EV_ROTATE, struct.pack("<Q", 4)
                             + b"binlog.000002", 0))
    return out


# -- decoders -----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_parse_event_equals_jax(seed):
    PACKED_DECIMALS.clear()
    events = event_stream(seed)

    def only_shop(schema, table):
        return schema == "shop"

    port = port_binlog.BinlogReader(only_shop)
    ref = ref_binlog.BinlogReader(only_shop)
    got, kinds = [], set()
    for body in events:
        a = outcome(lambda: port.parse_event(body))
        b = outcome(lambda: ref.parse_event(body))
        assert plain(a) == plain(b)
        assert a[0] == "ok", a
        got.extend(a[1])
        kinds.update(ev[0] for ev in a[1])
    assert kinds == {"pos", "gtid", "commit", "row", "ddl", "rotate"}
    rows = [ev for ev in got if ev[0] == "row"]
    assert {plain(ev[3]) for ev in rows} == {"insert", "update", "delete"}
    assert all(ev[1:3] == ("shop", "wide") for ev in rows)
    # every packed decimal decoded to the digits it was packed from
    dec_cols = [i for i, (t, _) in enumerate(COLUMN_SPECS)
                if t == B.T_NEWDECIMAL]
    decoded = {v for ev in rows for img in (ev[4], ev[5]) if img
               for i, v in enumerate(img) if i in dec_cols and v is not None}
    assert decoded and decoded <= set(PACKED_DECIMALS.values())
    for types in (port.table_maps, ref.table_maps):
        assert sorted(types) == [7, 8]
    assert [plain(list(m.col_meta)) for m in port.table_maps.values()] == \
        [plain(list(m.col_meta)) for m in ref.table_maps.values()]


def test_unsupported_type_raises_as_in_jax():
    body = event(B.EV_WRITE_ROWS_V2, rows_event(
        B.EV_WRITE_ROWS_V2, 8, 2, [True, True], [b"\x00" + bytes(12)]),
        500)
    out = []
    for mod in (port_binlog, ref_binlog):
        reader = mod.BinlogReader()
        reader.parse_event(event(B.EV_TABLE_MAP, table_map(
            8, "other", "skip", [(12, b""), (B.T_LONG, b"")]), 400))
        out.append(outcome(lambda: reader.parse_event(body)))
    assert out[0] == out[1]
    assert out[0][:2] == ("raised", "MySQLError")


@pytest.mark.parametrize("seed", range(3))
def test_decode_value_equals_jax(seed):
    rng = np.random.default_rng(100 + seed)
    metas = ref_binlog._parse_col_meta(bytes(t for t, _ in COLUMN_SPECS),
                                       b"".join(m for _, m in COLUMN_SPECS))
    for (t, _), meta in zip(COLUMN_SPECS, metas):
        for _ in range(20):
            data = b"\x99" + value_bytes(rng, t, meta)
            assert port_binlog._decode_value(t, meta, data, 1) == \
                ref_binlog._decode_value(t, meta, data, 1)
    for n in (0, 0xFA, 0xFB, 0x1234, 0xABCDEF, 2 ** 40 + 5):
        enc = (bytes([n]) if n < 0xFB else
               b"\xfc" + struct.pack("<H", n) if n < 1 << 16 else
               b"\xfd" + n.to_bytes(3, "little") if n < 1 << 24 else
               b"\xfe" + struct.pack("<Q", n))
        if n == 0xFB:
            enc = b"\xfc" + struct.pack("<H", n)
        assert port_binlog._read_lenenc(enc, 0) == \
            ref_binlog._read_lenenc(enc, 0) == (n, len(enc))
    for nb in range(4):
        raw = bytes(rng.integers(0, 256, nb, dtype=np.uint8))
        assert port_binlog._read_fraction(raw, 0, nb) == \
            ref_binlog._read_fraction(raw, 0, nb)


# -- the GTID set -------------------------------------------------------------

def gtid_text(rng) -> str:
    parts = []
    for _ in range(int(rng.integers(0, 4))):
        sid = str(uuid.UUID(bytes=bytes(rng.integers(0, 256, 16,
                                                     dtype=np.uint8))))
        if rng.random() < 0.3:
            sid = sid.upper()
        rngs = []
        for _ in range(int(rng.integers(1, 5))):
            a = int(rng.integers(1, 60))
            b = a + int(rng.integers(0, 8))
            rngs.append(f"{a}-{b}" if b != a or rng.random() < 0.3
                        else str(a))
        parts.append(f" {sid}:" + ":".join(rngs))
    if rng.random() < 0.3:
        parts.append("not-a-uuid:1-3")
    return ",\n".join(parts)


@pytest.mark.parametrize("seed", range(6))
def test_gtid_set_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        text = gtid_text(rng)
        port, ref = GtidSet.parse(text), RefGtidSet.parse(text)
        assert str(port) == str(ref) and port.sids == ref.sids
        assert bool(port) == bool(ref)
        enc = port.encode()
        assert enc == ref.encode()
        assert GtidSet.decode(enc) == port and \
            str(RefGtidSet.decode(enc)) == str(port)
        assert GtidSet.parse(str(port)) == port
        other = gtid_text(rng)
        port.update(GtidSet.parse(other))
        ref.update(RefGtidSet.parse(other))
        for sid in list(port.sids)[:2]:
            for gno in rng.integers(1, 80, 5).tolist():
                port.add(sid.upper(), gno)
                ref.add(sid.upper(), gno)
        assert str(port) == str(ref)
        for sid in list(port.sids):
            for gno in range(0, 90):
                assert port.contains(sid, gno) == ref.contains(sid, gno)
        copy = port.copy()
        copy.add(str(uuid.UUID(int=seed + 1)), 1)
        assert copy != port


def test_gtid_set_model():
    s = GtidSet.parse("3E11FA47-71CA-11E1-9E33-C80AA9429562:1-5:8,"
                      "aaaaaaaa-bbbb-cccc-dddd-eeeeeeeeeeee:1-3")
    sid = "3e11fa47-71ca-11e1-9e33-c80aa9429562"
    assert s.contains(sid, 4) and not s.contains(sid, 6)
    s.add(sid, 6)
    s.add(sid, 7)
    assert str(s).startswith(f"{sid}:1-8")
    assert GtidSet.decode(s.encode()) == s


# -- scenarios through run_replication ----------------------------------------

def wait_for(cond, seconds: float = 30.0) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("timed out")
        time.sleep(0.02)


class Replication:
    """One package's binlog replication into the memory sink or Kafka,
    on a thread, stopped through its stop event."""

    def __init__(self, pkg: str, srv, tid: str, cp=None, dst=None,
                 transformation=None):
        p = PKGS[pkg]
        self.p, self.tid = p, tid
        self.cp = cp or p["coordinator"]()
        self.store = None
        if dst is None:
            self.store = p["memory"].get_store(tid)
            dst = p["memory"].MemoryTargetParams(sink_id=tid)
        self.transfer = p["transfer"](
            id=tid, type="INCREMENT_ONLY", dst=dst,
            src=p["params"](host="127.0.0.1", port=srv.port,
                            database="shop", user="root", password="pw"),
            transformation=transformation)

    def __enter__(self):
        self.stop = threading.Event()
        self.thread = threading.Thread(
            target=self.p["run"], args=(self.transfer, self.cp),
            kwargs={"stop_event": self.stop, "backoff": 0.2,
                    **self.p["kw"]}, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(5)
        assert not self.thread.is_alive()
        return False

    def state(self) -> dict:
        return self.cp.get_transfer_state(self.tid).get("mysql_binlog", {})

    def rows(self):
        return [norm_item(it) for it in self.store.rows()]


def norm_item(it):
    """A delivered row, the wall-clock commit time set aside."""
    return (plain(it.kind), it.schema, it.table, tuple(it.column_names),
            tuple(it.column_values), tuple(it.old_keys.key_names),
            tuple(it.old_keys.key_values), it.lsn, it.txn_id)


SHOP = [("id", "bigint", "bigint", True, True),
        ("name", "varchar", "varchar(50)", False, False)]
SHOP_SPECS = [(B.T_LONGLONG, b""), (B.T_VARCHAR, struct.pack("<H", 50))]


def shop_image(id_val: int, name) -> bytes:
    if name is None:
        return b"\x02" + struct.pack("<q", id_val)
    raw = name.encode()
    return b"\x00" + struct.pack("<q", id_val) + bytes([len(raw)]) + raw


def shop_fake(pkg: str):
    srv = PKGS[pkg]["mysql"](user="root", password="pw").start()
    srv.add_table(PKGS[pkg]["table"]("shop", "users", SHOP))
    return srv


def replication_e2e(pkg: str):
    srv = shop_fake(pkg)
    try:
        srv.feed_table_map(7, "shop", "users", SHOP_SPECS)
        srv.feed_rows(30, 7, 2, [shop_image(1, "alice"),
                                 shop_image(2, None)])
        srv.feed_rows(31, 7, 2, [shop_image(1, "alice")
                                 + shop_image(1, "ALICE")])
        srv.feed_rows(32, 7, 2, [shop_image(2, None)])
        rep = Replication(pkg, srv, f"bl1-{pkg}")
        rep.store.clear()
        with rep:
            wait_for(lambda: rep.store.row_count() >= 4)
            srv.feed_rows(30, 7, 2, [shop_image(3, "carol")])
            wait_for(lambda: rep.store.row_count() >= 5)
            wait_for(lambda: rep.state().get("pos") == srv._next_log_pos)
        pk = rep.store.rows()[0].table_schema.find("id").primary_key
        return rep.rows(), rep.state(), pk
    finally:
        srv.stop()


def test_binlog_replication_equals_jax():
    got, want = both(replication_e2e)
    assert got == want
    rows, state, pk = got
    assert [r[0] for r in rows] == ["insert", "insert", "update", "delete",
                                    "insert"]
    assert rows[0][3:5] == (("id", "name"), (1, "alice"))
    assert rows[1][4] == (2, None)
    assert rows[2][4:7] == ((1, "ALICE"), ("id",), (1,))
    assert rows[3][5:7] == (("id",), (2,))
    assert rows[4][4] == (3, "carol")
    assert pk and state["file"] == "binlog.000001" and state["pos"] > 0


def gtid_resume(pkg: str):
    sid = "11111111-2222-3333-4444-555555555555"
    srv = shop_fake(pkg)
    try:
        srv.feed_gtid(sid, 1)
        srv.feed_table_map(7, "shop", "users", SHOP_SPECS)
        srv.feed_rows(30, 7, 2, [shop_image(1, "alice")])
        srv.feed_xid(1)
        srv.feed_gtid(sid, 2)
        srv.feed_rows(30, 7, 2, [shop_image(2, "bob")])
        srv.feed_xid(2)
        rep = Replication(pkg, srv, f"blg1-{pkg}")
        rep.store.clear()
        with rep:
            wait_for(lambda: rep.state().get("gtid_set") == f"{sid}:1-2")
        first = (rep.rows(), rep.state())
        # restart: the fake still holds every event; a transaction came
        # in while the replication was down
        srv.feed_gtid(sid, 3)
        srv.feed_table_map(7, "shop", "users", SHOP_SPECS)
        srv.feed_rows(30, 7, 2, [shop_image(3, "carol")])
        srv.feed_xid(3)
        with Replication(pkg, srv, f"blg1-{pkg}", cp=rep.cp) as rep2:
            # the resumed stream is in order: once gtid 3 is executed,
            # any re-delivery of 1-2 would have landed before it
            wait_for(lambda: rep2.state().get("gtid_set") == f"{sid}:1-3"
                     and rep2.state().get("pos") == srv._next_log_pos)
        return first, rep.rows(), rep2.state()
    finally:
        srv.stop()


def test_gtid_restart_resume_equals_jax():
    got, want = both(gtid_resume)
    assert got == want
    first, rows, state = got
    assert [r[4][0] for r in first[0]] == [1, 2]
    assert [r[4][0] for r in rows] == [1, 2, 3], \
        "the resumed run re-delivered executed gtids"
    assert state["gtid_set"].endswith(":1-3")


def gtid_open_transaction(pkg: str):
    sid = "99999999-8888-7777-6666-555555555555"
    srv = shop_fake(pkg)
    try:
        srv.feed_gtid(sid, 1)
        srv.feed_table_map(7, "shop", "users", SHOP_SPECS)
        srv.feed_rows(30, 7, 2, [shop_image(1, "a")])
        srv.feed_xid(1)
        # an open transaction: gtid 2 seen, its rows pushed, no commit
        srv.feed_gtid(sid, 2)
        srv.feed_rows(30, 7, 2, [shop_image(2, "b")])
        rep = Replication(pkg, srv, f"blg2-{pkg}")
        rep.store.clear()
        with rep:
            # the flush that pushed gtid 2's rows checkpointed their
            # position, and gtid 1 alone
            wait_for(lambda: rep.state().get("pos") == srv._next_log_pos)
            open_state = dict(rep.state())
            srv.feed_xid(2)
            wait_for(lambda: rep.state().get("gtid_set") == f"{sid}:1-2")
        return open_state, rep.state(), rep.rows()
    finally:
        srv.stop()


def test_gtid_not_checkpointed_before_commit_equals_jax():
    got, want = both(gtid_open_transaction)
    assert got == want
    open_state, state, rows = got
    assert open_state["gtid_set"].endswith(":1"), open_state
    assert state["gtid_set"].endswith(":1-2")
    assert len(rows) == 2


def rotate_run(pkg: str):
    srv = shop_fake(pkg)
    try:
        srv.feed_table_map(7, "shop", "users", SHOP_SPECS)
        srv.feed_rows(30, 7, 2, [shop_image(1, "a")])
        with srv.lock:
            srv.binlog_events.append(srv._event(
                B.EV_ROTATE, struct.pack("<Q", 4) + b"binlog.000002"))
        srv.feed_table_map(7, "shop", "users", SHOP_SPECS)
        srv.feed_rows(30, 7, 2, [shop_image(2, "b")])
        rep = Replication(pkg, srv, f"blr-{pkg}")
        rep.store.clear()
        with rep:
            wait_for(lambda: rep.state().get("pos") == srv._next_log_pos)
        return rep.rows(), rep.state()
    finally:
        srv.stop()


def test_rotate_equals_jax():
    got, want = both(rotate_run)
    assert got == want
    rows, state = got
    assert state["file"] == "binlog.000002" and len(rows) == 2


# -- the users stream: mixed kinds through the mask ---------------------------

USERS = cdc.users_changes(420, 120, 60, seed=5)


def users_fake(pkg: str):
    srv = PKGS[pkg]["mysql"](user="root", password="pw").start()
    srv.add_table(PKGS[pkg]["table"]("shop", "users", cdc.USERS_COLUMNS))
    last = cdc.feed_users_binlog(srv, USERS, database="shop", txn_changes=50)
    return srv, f"{cdc.USERS_SID}:1-{last}"


def masked(email):
    if email is None:
        return None
    return hmac.new(b"cdc", email.encode(), hashlib.sha256).hexdigest()


def users_to_memory(pkg: str):
    srv, fed = users_fake(pkg)
    try:
        rep = Replication(pkg, srv, f"blu-{pkg}", transformation=MASK)
        rep.store.clear()
        with rep:
            wait_for(lambda: rep.state().get("gtid_set") == fed)
        return rep.rows(), rep.state(), fed
    finally:
        srv.stop()


def test_users_stream_through_the_mask_equals_jax():
    (rows, state, fed), want = both(users_to_memory)
    assert (rows, state) == want[:2]
    assert state["gtid_set"] == fed
    assert len(rows) == len(USERS)
    for row, (kind, i, region, before, after) in zip(rows, USERS):
        assert row[0] == ("insert", "update", "delete")[kind]
        if kind == cdc.DELETE:
            assert row[4] == (None, None, None)
        else:
            assert row[4] == (i, masked(after), region)
        assert row[5:7] == ((), ()) if kind == cdc.INSERT \
            else (("id",), (i,))


def users_to_kafka(pkg: str):
    srv, fed = users_fake(pkg)
    kf = PKGS[pkg]["kafka"](n_partitions=4).start()
    try:
        dst = PKGS[pkg]["kafka_params"](
            brokers=[f"127.0.0.1:{kf.port}"], topic="cdc",
            serializer="debezium")
        with Replication(pkg, srv, f"blk-{pkg}", dst=dst,
                         transformation=MASK) as rep:
            wait_for(lambda: rep.state().get("gtid_set") == fed)
        records = [[(r.key, r.value) for r in kf.records("cdc", p)]
                   for p in range(4)]
        return records, rep.state()
    finally:
        kf.stop()
        srv.stop()


def test_users_stream_into_kafka_with_debezium_equals_jax():
    (records, state), (ref_records, ref_state) = both(users_to_kafka)

    def cut(parts):
        return [[(k, TS_MS.sub(b"", v)) for k, v in recs] for recs in parts]

    assert (cut(records), state) == (cut(ref_records), ref_state)
    got = {}
    receiver = DebeziumReceiver()
    for recs in records:
        for key, value in recs:
            it = receiver.receive(value, key)
            got.setdefault(json.loads(key)["payload"]["id"], []).append(it)
    want = {}
    for change in USERS:
        want.setdefault(change[1], []).append(change)
    assert sorted(got) == sorted(want)
    for i, items in got.items():
        # one key lands in one partition, in the binlog's order
        for it, (kind, _, region, _, after) in zip(items, want[i]):
            assert plain(it.kind) == ("insert", "update", "delete")[kind]
            if kind == cdc.DELETE:
                assert it.old_keys.as_dict() == {"id": i}
            else:
                assert it.as_dict() == {"id": i, "email": masked(after),
                                        "region": region}
            if kind == cdc.UPDATE:
                assert it.old_keys.as_dict() == {"id": i}
