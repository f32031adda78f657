"""BASELINE config #4's serializer half: the port's Debezium emitter,
receiver and packers, its `debezium` parser and every batch and queue
serializer against the JAX package's, on the CPU, exactly.

The emitter's envelopes carry the wall clock (`ts_ms`), so both
packages' emitter modules read a pinned clock here.  Held equal, byte
for byte: `DebeziumEmitter.emit_batch` over a seeded batch of every
canonical type the `mysql` rules map (and each MySQL original type the
emitter special-cases: bigint unsigned, time, year, enum, set, bit), by
the columnar fast route and the per-item route, with and without the
schema block, `snapshot` on and off; the fast route's deferral to the
per-item route for a batch out of its envelope (NaN, CDC kinds,
tombstones); the schema-registry packer's frames against each package's
fake registry; the `debezium` parser's batches over the JAX emitter's
messages (plain and Confluent-framed, with a tombstone and a malformed
message); and the bytes of every serializer.  The parquet serializer
needs pyarrow, which the port may not import: it raises.
"""

import types

import numpy as np
import pytest

import transferia_tpu.parsers.plugins  # noqa: F401  (registers debezium)
import transferia_tpu_torch.parsers.plugins  # noqa: F401
from tests.recipes.fake_sr import FakeSchemaRegistry as RefFakeSR
from transferia_tpu.abstract.change_item import ChangeItem as RefChangeItem
from transferia_tpu.abstract.change_item import OldKeys as RefOldKeys
from transferia_tpu.abstract.kinds import Kind as RefKind
from transferia_tpu.abstract.schema import CanonicalType as RefCT
from transferia_tpu.abstract.schema import ColSchema as RefColSchema
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import TableSchema as RefTableSchema
from transferia_tpu.columnar.batch import Column as RefColumn
from transferia_tpu.columnar.batch import ColumnBatch as RefColumnBatch
from transferia_tpu.debezium import emitter as ref_emitter_mod
from transferia_tpu.debezium.emitter import DebeziumEmitter as RefEmitter
from transferia_tpu.parsers import Message as RefMessage
from transferia_tpu.parsers import make_parser as ref_make_parser
from transferia_tpu.serializers import (
    make_queue_serializer as ref_make_queue_serializer,
)
from transferia_tpu.serializers import make_serializer as ref_make_serializer
from transferia_tpu_torch.abstract.change_item import ChangeItem, OldKeys
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import Column, ColumnBatch
from transferia_tpu_torch.debezium import emitter as port_emitter_mod
from transferia_tpu_torch.debezium.emitter import DebeziumEmitter
from transferia_tpu_torch.parsers import Message, make_parser
from transferia_tpu_torch.recipes.fake_sr import FakeSchemaRegistry
from transferia_tpu_torch.serializers import (
    ParquetSerializer,
    make_queue_serializer,
    make_serializer,
)

PKGS = {
    "port": dict(ct=CanonicalType, col_schema=ColSchema, tid=TableID,
                 schema=TableSchema, column=Column, batch=ColumnBatch,
                 item=ChangeItem, old_keys=OldKeys, kind=Kind,
                 emitter=DebeziumEmitter, message=Message,
                 make_parser=make_parser, make_serializer=make_serializer,
                 make_queue_serializer=make_queue_serializer,
                 fake_sr=FakeSchemaRegistry),
    "jax": dict(ct=RefCT, col_schema=RefColSchema, tid=RefTableID,
                schema=RefTableSchema, column=RefColumn,
                batch=RefColumnBatch, item=RefChangeItem,
                old_keys=RefOldKeys, kind=RefKind, emitter=RefEmitter,
                message=RefMessage, make_parser=ref_make_parser,
                make_serializer=ref_make_serializer,
                make_queue_serializer=ref_make_queue_serializer,
                fake_sr=RefFakeSR),
}

NOW_S = 1_753_000_000.125


@pytest.fixture(autouse=True)
def pinned_clock(monkeypatch):
    """Both emitter modules read a fixed wall clock (`ts_ms`)."""
    clock = types.SimpleNamespace(time=lambda: NOW_S)
    monkeypatch.setattr(port_emitter_mod, "time", clock)
    monkeypatch.setattr(ref_emitter_mod, "time", clock)


# (name, canonical type, original type, primary key, required): every
# canonical type the `mysql` source rules map, and each MySQL original
# type the emitter special-cases
MIXED = [
    ("id", "INT64", "mysql:bigint(20)", True, True),
    ("i8", "INT8", "mysql:tinyint(4)", False, False),
    ("i16", "INT16", "mysql:smallint(6)", False, False),
    ("i32", "INT32", "mysql:int(11)", False, False),
    ("u8", "UINT8", "mysql:tinyint(3) unsigned", False, False),
    ("u16", "UINT16", "mysql:smallint(5) unsigned", False, False),
    ("u32", "UINT32", "mysql:int(10) unsigned", False, False),
    ("u64", "UINT64", "mysql:bigint(20) unsigned", False, False),
    ("f32", "FLOAT", "mysql:float", False, False),
    ("f64", "DOUBLE", "mysql:double", False, False),
    ("dec", "DECIMAL", "mysql:decimal(10,2)", False, False),
    ("flag", "BOOLEAN", "mysql:bool", False, False),
    ("email", "UTF8", "mysql:varchar(255)", False, False),
    ("blob", "STRING", "mysql:varbinary(16)", False, False),
    ("day", "DATE", "mysql:date", False, False),
    ("ts", "TIMESTAMP", "mysql:datetime(6)", False, False),
    ("doc", "ANY", "mysql:json", False, False),
    ("t", "UTF8", "mysql:time", False, False),
    ("yr", "INT32", "mysql:year", False, False),
    ("en", "UTF8", "mysql:enum('a','B')", False, False),
    ("st", "UTF8", "mysql:set('x','y')", False, False),
    ("b1", "UINT64", "mysql:bit(1)", False, False),
    ("b8", "UINT64", "mysql:bit(8)", False, False),
    ("seen", "DATETIME", "", False, False),
]


def mixed_values(n: int, seed: int = 13) -> dict:
    """Seeded values for MIXED; NULLs in every nullable column."""
    rng = np.random.default_rng(seed)

    def nulls(vals, every):
        return [None if i % every == 3 else v for i, v in enumerate(vals)]

    emails = [f"user{i}@example.test" if i % 5 else
              (f'q"uo\\te{i}\t' if i % 2 else f"котик{i}@пример.рф")
              for i in range(n)]
    return {
        "id": list(range(n)),
        "i8": nulls(rng.integers(-128, 128, n).tolist(), 7),
        "i16": nulls(rng.integers(-2**15, 2**15, n).tolist(), 8),
        "i32": nulls(rng.integers(-2**31, 2**31, n).tolist(), 9),
        "u8": nulls(rng.integers(0, 256, n).tolist(), 10),
        "u16": nulls(rng.integers(0, 2**16, n).tolist(), 11),
        "u32": nulls(rng.integers(0, 2**32, n).tolist(), 12),
        "u64": nulls(rng.integers(0, 2**64 - 1, n, dtype=np.uint64,
                                  endpoint=True).tolist(), 13),
        "f32": nulls((rng.standard_normal(n) * 1e3).tolist(), 7),
        "f64": nulls((rng.standard_normal(n) * 1e9).tolist(), 8),
        "dec": nulls([f"{v / 100:.2f}" for v in
                      rng.integers(-10**7, 10**7, n).tolist()], 9),
        "flag": nulls([bool(v) for v in rng.integers(0, 2, n)], 10),
        "email": nulls(emails, 11),
        "blob": nulls([bytes(rng.integers(0, 256, k, dtype=np.uint8))
                       for k in rng.integers(0, 16, n)], 12),
        "day": nulls(rng.integers(-1000, 30000, n).tolist(), 13),
        "ts": nulls(rng.integers(0, 2**50, n).tolist(), 7),
        "doc": nulls([{"k": int(v), "a": [1, "x"]}
                      for v in rng.integers(0, 100, n)], 8),
        "t": nulls([f"{h:02d}:{m:02d}:{s:02d}" for h, m, s in
                    rng.integers(0, 60, (n, 3)).tolist()], 9),
        "yr": nulls(rng.integers(1901, 2156, n).tolist(), 10),
        "en": nulls(["a" if v else "B" for v in rng.integers(0, 2, n)], 11),
        "st": nulls(["x,y" if v else "x" for v in rng.integers(0, 2, n)],
                    12),
        "b1": nulls(rng.integers(0, 2, n).tolist(), 13),
        "b8": nulls(rng.integers(0, 256, n).tolist(), 7),
        "seen": nulls(rng.integers(0, 2**31, n).tolist(), 8),
    }


def make_schema(pkg: str, spec=MIXED):
    p = PKGS[pkg]
    return p["schema"]([
        p["col_schema"](name, p["ct"][ct], primary_key=pk, required=req,
                        original_type=orig)
        for name, ct, orig, pk, req in spec])


def make_batch(pkg: str, values: dict, spec=MIXED, table=("db", "users"),
               **kw):
    p = PKGS[pkg]
    schema = make_schema(pkg, spec)
    cols = {c.name: p["column"].from_pylist(c.name, c.data_type,
                                            values[c.name])
            for c in schema}
    return p["batch"](p["tid"](*table), schema, cols, **kw)


def emit(pkg: str, batch, route: str, snapshot: bool, **cfg):
    em = PKGS[pkg]["emitter"](**cfg)
    if route == "fast":
        out = em._emit_columnar_fast(batch, snapshot)
        assert out is not None, f"{pkg}: fast route refused the batch"
        assert out == em.emit_batch(batch, snapshot)
        return out
    return em.emit_batch(batch.to_rows(), snapshot)


# -- the emitter ---------------------------------------------------------------

@pytest.mark.parametrize("snapshot", [False, True])
@pytest.mark.parametrize("include_schema", [True, False])
@pytest.mark.parametrize("route", ["fast", "per_item"])
def test_emit_batch_equals_jax(route, include_schema, snapshot):
    values = mixed_values(97)
    cfg = dict(topic_prefix="tp", connector="cn", source_db_type="mysql",
               include_schema=include_schema)
    got = emit("port", make_batch("port", values), route, snapshot, **cfg)
    want = emit("jax", make_batch("jax", values), route, snapshot, **cfg)
    assert len(got) == 97
    assert got == want


@pytest.mark.parametrize("include_schema", [True, False])
def test_fast_route_equals_per_item_route(include_schema):
    values = mixed_values(61, seed=5)
    batch = make_batch("port", values)
    assert emit("port", batch, "fast", True,
                include_schema=include_schema) == \
        emit("port", batch, "per_item", True,
             include_schema=include_schema)


def test_fast_route_defers_out_of_its_envelope():
    values = mixed_values(24, seed=3)
    values["f64"][5] = float("nan")
    values["f32"][6] = float("inf")
    got = {}
    for pkg in PKGS:
        batch = make_batch(pkg, values)
        em = PKGS[pkg]["emitter"](include_schema=False)
        # NaN and infinity spell differently in JSON: per-item route
        assert em._emit_columnar_fast(batch, False) is None
        got[pkg] = em.emit_batch(batch)
    assert got["port"] == got["jax"]
    assert b"NaN" in got["port"][5][1]


@pytest.mark.parametrize("tombstones", [False, True])
def test_cdc_kinds_take_the_per_item_route(tombstones):
    spec = MIXED[:4] + [MIXED[12]]
    values = mixed_values(9, seed=8)
    got = {}
    for pkg, p in PKGS.items():
        kind = p["kind"]
        batch = make_batch(pkg, values, spec)
        items = batch.to_rows()
        key = p["old_keys"](("id",), (items[4].value("id"),))
        items[4] = items[4].__class__(
            kind=kind.UPDATE, schema="db", table="users",
            column_names=items[4].column_names,
            column_values=items[4].column_values,
            table_schema=items[4].table_schema, old_keys=key, lsn=77,
            txn_id="tx-9", commit_time_ns=1_700_000_000_123_456_789)
        items[6] = items[6].__class__(
            kind=kind.DELETE, schema="db", table="users",
            table_schema=items[6].table_schema,
            old_keys=p["old_keys"](("id",), (items[6].value("id"),)))
        cdc = p["batch"].from_rows(items)
        em = p["emitter"](emit_tombstones=tombstones,
                          source_db_type="mysql")
        assert em._emit_columnar_fast(cdc, False) is None
        got[pkg] = em.emit_batch(cdc)
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 9 + tombstones
    if tombstones:
        assert got["port"][7][1] is None


def test_schema_registry_packer_equals_jax():
    values = mixed_values(12, seed=21)
    got = {}
    for pkg, p in PKGS.items():
        sr = p["fake_sr"]().start()
        try:
            em = p["emitter"](packer="schema_registry", topic="cdc",
                              schema_registry_url=sr.url)
            msgs = em.emit_batch(make_batch(pkg, values))
            parser = p["make_parser"]({"debezium": {
                "schema_registry_url": sr.url}})
            res = parser.do_batch([
                p["message"](value=v, key=k, topic="cdc", offset=i)
                for i, (k, v) in enumerate(msgs)])
            got[pkg] = (msgs, sorted(sr.schemas.items()),
                        [batch_view(b) for b in res.batches],
                        res.unparsed)
        finally:
            sr.stop()
    assert got["port"] == got["jax"]
    msgs, registered, batches, unparsed = got["port"]
    assert all(v[:1] == b"\x00" for _, v in msgs)
    assert len(registered) == 2 and unparsed is None
    assert sum(len(b[2]["id"]) for b in batches) == 12


# -- the parser ----------------------------------------------------------------

def batch_view(b) -> tuple:
    """A ColumnBatch as plain data, comparable across the packages."""
    def arr(a):
        return None if a is None else np.asarray(a).tolist()

    return (str(b.table_id),
            [(c.name, c.data_type.value, c.primary_key, c.required,
              c.original_type, tuple(c.properties)) for c in b.schema],
            b.to_pydict(), arr(b.kinds), arr(b.lsns), arr(b.commit_times),
            b.txn_ids,
            None if b.old_keys is None else
            [(k.key_names, k.key_values) for k in b.old_keys])


@pytest.mark.parametrize("include_schema", [True, False])
def test_debezium_parser_equals_jax(include_schema):
    values = mixed_values(40, seed=17)
    jax_batch = make_batch("jax", values)
    em = RefEmitter(include_schema=include_schema, emit_tombstones=True,
                    source_db_type="mysql")
    msgs = em.emit_batch(jax_batch, snapshot=True)
    items = jax_batch.to_rows()
    deleted = RefChangeItem(
        kind=RefKind.DELETE, schema="db", table="users",
        table_schema=jax_batch.schema,
        old_keys=RefOldKeys(("id",), (items[2].value("id"),)))
    msgs += em.emit_item(deleted)          # the delete and its tombstone
    msgs.append((b"k", b"{not json"))
    got = {}
    for pkg, p in PKGS.items():
        res = p["make_parser"]({"debezium": {}}).do_batch([
            p["message"](value=v or b"", key=k or b"", topic="cdc",
                         partition=0, offset=i,
                         write_time_ns=1_700_000_000_000_000_000 + i)
            for i, (k, v) in enumerate(msgs)])
        got[pkg] = ([batch_view(b) for b in res.batches],
                    res.unparsed.to_pydict() if res.unparsed else None)
    assert got["port"] == got["jax"]
    batches, unparsed = got["port"]
    assert sum(len(b[2]["id"]) for b in batches) == 41
    assert unparsed["unparsed_row"] == [b"{not json"]


# -- the serializers -----------------------------------------------------------

SERIAL_SPEC = [MIXED[0], MIXED[3], MIXED[9], MIXED[10], MIXED[11],
               MIXED[12], MIXED[13]]
# the blank parser's raw key/data rows (the mirror and raw formats)
RAW_SPEC = [("key", "STRING", "", True, True),
            ("data", "STRING", "", False, False),
            ("email", "UTF8", "", False, True)]


def raw_values(n: int) -> dict:
    return {"key": [bytes([i]) for i in range(n)],
            "data": [None if i % 9 == 0 else f"d{i}".encode()
                     for i in range(n)],
            "email": [f"u{i}@e.test" for i in range(n)]}


@pytest.mark.parametrize("fmt,cfg", [
    ("json", {}), ("json", {"add_meta": True}), ("csv", {}),
    ("csv", {"header": True, "delimiter": ";"}), ("raw", {}),
    ("raw", {"column": "email"}),
    ("json", {"concurrency": 3, "threshold": 10}),
    ("csv", {"concurrency": 3, "threshold": 10}),
    ("raw", {"concurrency": 3, "threshold": 10}),
])
def test_batch_serializers_equal_jax(fmt, cfg):
    values, spec = mixed_values(50, seed=31), SERIAL_SPEC
    if fmt == "raw":
        values, spec = raw_values(50), RAW_SPEC
    got = {pkg: p["make_serializer"](fmt, **cfg).serialize(
        make_batch(pkg, values, spec)) for pkg, p in PKGS.items()}
    assert got["port"] == got["jax"]
    assert got["port"]


@pytest.mark.parametrize("fmt,cfg", [
    ("json", {}), ("native", {}), ("debezium", {"snapshot": True}),
    ("debezium", {"include_schema": False, "threads": 3,
                  "threshold": 10}),
    ("mirror", {}), ("raw_column", {"column": "email"}),
    ("json", {"threads": 4, "threshold": 7}),
])
def test_queue_serializers_equal_jax(fmt, cfg):
    values, spec = mixed_values(50, seed=37), SERIAL_SPEC
    if fmt == "mirror":
        values, spec = raw_values(50), RAW_SPEC
    got = {pkg: p["make_queue_serializer"](fmt, **cfg).serialize_messages(
        make_batch(pkg, values, spec)) for pkg, p in PKGS.items()}
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 50


def test_parquet_serializer_raises():
    with pytest.raises(NotImplementedError, match="pyarrow"):
        make_serializer("parquet")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ParquetSerializer()


def test_unknown_serializers_raise_as_jax():
    for pkg, p in PKGS.items():
        with pytest.raises(KeyError, match="unknown serializer"):
            p["make_serializer"]("xml")
        with pytest.raises(KeyError, match="unknown queue serializer"):
            p["make_queue_serializer"]("xml")
