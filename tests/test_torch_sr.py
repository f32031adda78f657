"""BASELINE config #5's source half: the port's schema registry client,
Avro decoder and `confluent_schema_registry` parser against the JAX
package's, on the CPU, exactly.

Held equal on seeded messages: the row-by-row Avro decoder over flat,
nullable-union and out-of-envelope (arrays, maps, enums, fixed, a
three-branch union, nested records) schemas; the parser's columnar
route over the host library's `avro_decode_flat` against the JAX
parser on the same runs, with a malformed message, invalid UTF-8, a
missing magic byte, a JSON-schema id and an unknown id in the stream;
the 404 cache and the transient registry failure that raises; and a
small `run_replication` of config #5 (4 partitions x 200 Avro records,
the schema registry parser, the lambda, ClickHouse without a Bufferer),
each package against its own fake broker, registry and ClickHouse.
"""

import json
import struct
import threading
import time

import numpy as np
import pytest

from tests.recipes.fake_clickhouse import FakeCH as RefFakeCH
from tests.recipes.fake_kafka import FakeKafka as RefFakeKafka
from tests.recipes.fake_sr import FakeSchemaRegistry as RefFakeSR
from transferia_tpu import parsers as ref_parsers
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.providers.clickhouse import CHTargetParams as RefCHParams
from transferia_tpu.providers.kafka import KafkaSourceParams as RefKafkaParams
from transferia_tpu.providers.kafka.client import KafkaClient as RefClient
from transferia_tpu.providers.kafka.protocol import Record as RefRecord
from transferia_tpu.runtime.local import run_replication as ref_run
from transferia_tpu.schemaregistry import SchemaRegistryClient as RefSRClient
from transferia_tpu.schemaregistry.avro import AvroSchema as RefAvroSchema
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu_torch import parsers
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.providers.clickhouse import CHTargetParams
from transferia_tpu_torch.providers.kafka import KafkaSourceParams
from transferia_tpu_torch.providers.kafka.client import KafkaClient
from transferia_tpu_torch.providers.kafka.protocol import Record
from transferia_tpu_torch.recipes.fake_clickhouse import FakeCH
from transferia_tpu_torch.recipes.fake_kafka import FakeKafka
from transferia_tpu_torch.recipes.fake_sr import FakeSchemaRegistry
from transferia_tpu_torch.runtime.local import run_replication
from transferia_tpu_torch.schemaregistry import SchemaRegistryClient
from transferia_tpu_torch.schemaregistry.avro import AvroSchema
from transferia_tpu_torch.schemaregistry.client import SRError
from transferia_tpu_torch.transform import fused as port_tfused

PKGS = {
    "port": dict(parsers=parsers, sr=FakeSchemaRegistry,
                 client=SchemaRegistryClient, avro=AvroSchema),
    "jax": dict(parsers=ref_parsers, sr=RefFakeSR, client=RefSRClient,
                avro=RefAvroSchema),
}

FLAT = {"type": "record", "name": "Flat", "fields": [
    {"name": "id", "type": "long"}, {"name": "url", "type": "string"},
    {"name": "region", "type": "int"}, {"name": "score", "type": "double"},
    {"name": "ok", "type": "boolean"}, {"name": "f", "type": "float"},
    {"name": "raw", "type": "bytes"}]}
NULLABLE = {"type": "record", "name": "Nul", "namespace": "t", "fields": [
    {"name": "id", "type": "long"},
    {"name": "name", "type": ["null", "string"]},
    {"name": "v", "type": ["long", "null"]},
    {"name": "d", "type": ["null", "double"]},
    {"name": "b", "type": ["boolean", "null"]}]}
OUT = {"type": "record", "name": "Out", "namespace": "t", "fields": [
    {"name": "id", "type": "long"},
    {"name": "tags", "type": {"type": "array", "items": "string"}},
    {"name": "kind", "type": {"type": "enum", "name": "K",
                              "symbols": ["A", "B", "C"]}},
    {"name": "m", "type": {"type": "map", "values": "long"}},
    {"name": "u", "type": ["null", "string", "long"]},
    {"name": "fx", "type": {"type": "fixed", "name": "F4", "size": 4}},
    {"name": "sub", "type": {"type": "record", "name": "Sub", "fields": [
        {"name": "x", "type": "int"}, {"name": "k2", "type": "t.K"}]}}]}
SCHEMAS = {"flat": FLAT, "nullable": NULLABLE, "out_of_envelope": OUT}


# -- an independent Avro encoder for the tests ------------------------------

def zz(n: int) -> bytes:
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        out.append(b | (0x80 if u else 0))
        if not u:
            return bytes(out)


def enc(t, v, named) -> bytes:
    if isinstance(t, str) and t in named:
        t = named[t]
    if isinstance(t, list):
        if v is None:
            return zz(t.index("null")) + b""
        for i, b in enumerate(t):
            if b == "null":
                continue
            if (b == "string") == isinstance(v, str):
                return zz(i) + enc(b, v, named)
        raise ValueError(v)
    if isinstance(t, dict):
        kind = t["type"]
        if kind == "record":
            named[t["name"]] = t
            named[f"{t.get('namespace', 't')}.{t['name']}"] = t
            return b"".join(enc(f["type"], v[f["name"]], named)
                            for f in t["fields"])
        if kind in ("enum", "fixed"):
            named[t["name"]] = t
            named[f"t.{t['name']}"] = t
            if kind == "fixed":
                return v
            return zz(t["symbols"].index(v))
        if kind == "array":
            body = b"".join(enc(t["items"], x, named) for x in v)
            return (zz(len(v)) + body + zz(0)) if v else zz(0)
        if kind == "map":
            body = b"".join(enc("string", k, named) + enc(t["values"], x,
                                                          named)
                            for k, x in v.items())
            return (zz(len(v)) + body + zz(0)) if v else zz(0)
    if t == "null":
        return b""
    if t == "boolean":
        return bytes([1 if v else 0])
    if t in ("int", "long"):
        return zz(v)
    if t == "float":
        return struct.pack("<f", v)
    if t == "double":
        return struct.pack("<d", v)
    if t == "bytes":
        return zz(len(v)) + v
    if t == "string":
        raw = v.encode()
        return zz(len(raw)) + raw
    raise ValueError(t)


def value_of(rng, t):
    if isinstance(t, list):
        if "null" in t and rng.random() < 0.3:
            return None
        b = [x for x in t if x != "null"][int(rng.integers(
            0, len(t) - 1))]
        return value_of(rng, b)
    if isinstance(t, dict):
        kind = t["type"]
        if kind == "record":
            return {f["name"]: value_of(rng, f["type"]) for f in t["fields"]}
        if kind == "enum":
            return t["symbols"][int(rng.integers(0, len(t["symbols"])))]
        if kind == "fixed":
            return rng.bytes(t["size"])
        if kind == "array":
            return [value_of(rng, t["items"])
                    for _ in range(int(rng.integers(0, 4)))]
        if kind == "map":
            return {f"k{j}": value_of(rng, t["values"])
                    for j in range(int(rng.integers(0, 3)))}
    if t == "t.K":
        return "B"
    if t == "boolean":
        return bool(rng.integers(0, 2))
    if t == "int":
        return int(rng.integers(-2**31, 2**31))
    if t == "long":
        return int(rng.integers(-2**63, 2**63, dtype=np.int64))
    if t == "float":
        return float(np.float32(rng.normal() * 1e3))
    if t == "double":
        return float(rng.normal() * 1e6)
    if t == "bytes":
        return rng.bytes(int(rng.integers(0, 12)))
    if t == "string":
        return "".join(chr(c) for c in rng.integers(
            32, 0x500, int(rng.integers(0, 10))))
    raise ValueError(t)


def records(name: str, n: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    schema = SCHEMAS[name]
    return [enc(schema, value_of(rng, schema), {}) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_avro_decoder_equals_jax(name):
    raw = json.dumps(SCHEMAS[name])
    port, ref = AvroSchema(raw), RefAvroSchema(raw)
    for payload in records(name, 300, seed=len(name)):
        assert port.decode(payload) == ref.decode(payload)
    for bad in (b"", b"\x80", b"\x02\xff\xff"):
        with pytest.raises(ValueError) as e_port:
            port.decode(bad)
        with pytest.raises(ValueError) as e_ref:
            ref.decode(bad)
        assert str(e_port.value) == str(e_ref.value)


# -- the parser ---------------------------------------------------------------

def column_bytes(col):
    return (col.ctype.value, np.asarray(col.data).tobytes(),
            None if col.offsets is None else col.offsets.tobytes(),
            None if col.validity is None else col.validity.tobytes())


def batch_state(b):
    def arr(a):
        return None if a is None else (a.dtype.str, a.tobytes())

    schema = tuple((c.name, c.data_type.value, c.primary_key, c.required)
                   for c in b.schema)
    return (str(b.table_id), schema, b.n_rows,
            {n: column_bytes(c) for n, c in b.columns.items()},
            arr(b.kinds), arr(b.commit_times))


def parse_state(result):
    return ([batch_state(b) for b in result.batches],
            None if result.unparsed is None
            else batch_state(result.unparsed))


def register(url: str, schema: dict, schema_type: str = "AVRO") -> int:
    import urllib.request

    req = urllib.request.Request(
        url + f"/subjects/s{abs(hash(json.dumps(schema))) % 997}/versions",
        data=json.dumps({"schema": json.dumps(schema),
                         "schemaType": schema_type}).encode(),
        headers={"Content-Type": "application/vnd.schemaregistry.v1+json"})
    return json.loads(urllib.request.urlopen(req, timeout=10).read())["id"]


def stream(ids: dict, seed: int) -> list[tuple[bytes, int]]:
    """(value, offset) pairs: runs of each schema, a truncated record, a
    record with invalid UTF-8, a missing magic byte, JSON payloads under
    a JSON schema id and a binary payload under an unknown id."""
    out = []

    def wire(sid, body):
        return b"\x00" + sid.to_bytes(4, "big") + body

    for k, name in enumerate(sorted(SCHEMAS)):
        recs = records(name, 120, seed + k)
        out += [wire(ids[name], r) for r in recs[:60]]
        if name == "flat":
            # invalid UTF-8 in `url` (a well-formed length prefix)
            body = (zz(7) + zz(2) + b"\xff\xfe" + zz(3)
                    + struct.pack("<d", 1.5) + b"\x01"
                    + struct.pack("<f", 2.5) + zz(0))
            out.append(wire(ids[name], recs[60][:-3]))   # truncated
            out += [wire(ids[name], r) for r in recs[62:90]]
            out.append(wire(ids[name], body))
        out += [wire(ids[name], r) for r in recs[90:]]
    out.append(b"{no magic}")
    out += [wire(ids["json"], json.dumps({"a": i, "b": f"x{i}"}).encode())
            for i in range(5)]
    out.append(wire(999, b"\x01\x02\x03"))
    out += [wire(ids["flat"], r) for r in records("flat", 40, seed + 9)]
    return [(v, i) for i, v in enumerate(out)]


def count_columnar(prs) -> None:
    """Count on `prs.columnar` the records the columnar route decoded
    (a run it returns None for goes row by row)."""
    route = prs._avro_batch_native
    prs.columnar = 0

    def counted(avro, msgs):
        out = route(avro, msgs)
        prs.columnar += len(msgs) if out is not None else 0
        return out

    prs._avro_batch_native = counted


def parse(pkg: str, seed: int, per_run: bool):
    p = PKGS[pkg]
    sr = p["sr"]().start()
    try:
        ids = {name: register(sr.url, s) for name, s in SCHEMAS.items()}
        ids["json"] = register(sr.url, {
            "type": "object", "properties": {"a": {"type": "integer"},
                                             "b": {"type": "string"}},
            "required": ["a"]}, "JSON")
        prs = p["parsers"].make_parser({"confluent_schema_registry": {
            "registry_url": sr.url, "table": "t"}})
        if pkg == "port":
            count_columnar(prs)
        msgs = [p["parsers"].Message(value=v, offset=o, topic="tp",
                                     partition=0, write_time_ns=o * 1000)
                for v, o in stream(ids, seed)]
        if per_run:
            return [parse_state(prs.do_batch([m])) for m in msgs], prs
        return parse_state(prs.do_batch(msgs)), prs
    finally:
        sr.stop()


@pytest.mark.parametrize("seed", [1, 2])
def test_parser_equals_jax(seed):
    got, prs = parse("port", seed, per_run=False)
    want, ref = parse("jax", seed, per_run=False)
    assert got == want
    # the nullable run (90 records) and the last flat run (40) took the
    # columnar route; the flat run holding the malformed records and the
    # out-of-envelope run went row by row
    assert prs.columnar == 90 + 40
    assert prs._avro[999] is None and ref._avro[999] is None
    batches, unparsed = got
    assert unparsed[2] == 4  # truncated, bad UTF-8, no magic, unknown id


def test_parser_record_by_record_equals_jax():
    got, _ = parse("port", 3, per_run=True)
    want, _ = parse("jax", 3, per_run=True)
    assert got == want


def test_transient_registry_failure_raises():
    for pkg in ("port", "jax"):
        p = PKGS[pkg]
        sr = p["sr"]().start()
        url = sr.url
        sid = register(url, FLAT)
        sr.stop()  # the registry goes away: a transient outage
        prs = p["parsers"].make_parser({"confluent_schema_registry": {
            "registry_url": url, "table": "t"}})
        msg = p["parsers"].Message(
            value=b"\x00" + sid.to_bytes(4, "big") + records("flat", 1, 0)[0],
            offset=0)
        with pytest.raises(Exception, match="unreachable"):
            prs.do_batch([msg])
        assert sid not in prs._avro  # not cached: the batch retries
    with pytest.raises(SRError):
        SchemaRegistryClient(url).schema_by_id(sid)


# -- config #5 end to end ----------------------------------------------------

HIT = {"type": "record", "name": "Hit", "fields": [
    {"name": "id", "type": "long"}, {"name": "url", "type": "string"},
    {"name": "region", "type": "int"}]}


def sr2ch(pkg: str, partitions: int = 4, per: int = 200):
    if pkg == "port":
        fk, fch, fsr, client, rec, kparams, chp, transfer, cp, run = (
            FakeKafka, FakeCH, FakeSchemaRegistry, KafkaClient, Record,
            KafkaSourceParams, CHTargetParams, Transfer,
            MemoryCoordinator(), run_replication)
        fn, kw = "transferia_tpu_torch.ops.lambdas:bench_lambda", \
            {"device": "cpu"}
    else:
        fk, fch, fsr, client, rec, kparams, chp, transfer, cp, run = (
            RefFakeKafka, RefFakeCH, RefFakeSR, RefClient, RefRecord,
            RefKafkaParams, RefCHParams, RefTransfer, RefCoordinator(),
            ref_run)
        fn, kw = "bench:bench_lambda", {}
    sr, srv, ch = fsr().start(), fk(n_partitions=partitions).start(), \
        fch().start()
    try:
        sid = register(sr.url, HIT)
        header = b"\x00" + sid.to_bytes(4, "big")
        seed = client([f"127.0.0.1:{srv.port}"])
        srv.create_topic("hits")
        for p in range(partitions):
            recs = []
            for i in range(per):
                # ids past int32, so the lambda's int32 wrap shows
                rid = (p * per + i) * 40_000_001 - 2**31
                url = f"https://e.test/{rid % 997}".encode()
                recs.append(rec(key=b"", value=header + zz(rid)
                                + zz(len(url)) + url + zz(rid % 500)))
            seed.produce("hits", p, recs)
        seed.close()
        t = transfer(
            id="sr2ch", type="INCREMENT_ONLY",
            src=kparams(brokers=[f"127.0.0.1:{srv.port}"], topic="hits",
                        parallelism=4,
                        parser={"confluent_schema_registry": {
                            "registry_url": sr.url, "table": "hits"}}),
            dst=chp(host="127.0.0.1", port=ch.port, bufferer=None),
            transformation={"transformers": [
                {"lambda": {"function": fn}}]})
        expected = partitions * per
        stop = threading.Event()
        th = threading.Thread(target=run, args=(t, cp), daemon=True,
                              kwargs={"stop_event": stop, "backoff": 0.1,
                                      **kw})
        th.start()
        deadline = time.monotonic() + 60
        while ch.total_rows() < expected or len(cp.get_transfer_state(
                t.id).get("kafka_offsets", {})) < partitions or any(
                v != per - 1 for v in cp.get_transfer_state(t.id)
                ["kafka_offsets"].values()):
            assert time.monotonic() < deadline, "timed out"
            time.sleep(0.02)
        stop.set()
        th.join(10)
        assert not th.is_alive()
        tables = {name: (tb["ddl"], sorted(
            tuple(sorted(r.items())) for r in tb["rows"]))
            for name, tb in ch.tables.items()}
        return tables, cp.get_transfer_state(t.id)["kafka_offsets"]
    finally:
        sr.stop()
        srv.stop()
        ch.stop()


@pytest.mark.parametrize("mode", ["device", "host"])
def test_sr2ch_replication_equals_jax(mode):
    port_tfused.set_placement(mode)
    ref_tfused.set_placement("host")
    try:
        got = sr2ch("port")
        want = sr2ch("jax")
    finally:
        port_tfused.set_placement(None)
        ref_tfused.set_placement(None)
    assert got == want
    tables, offsets = got
    ddl, rows = tables["hits"]
    assert "`id` Nullable(Int32)" in ddl
    assert len(rows) == 800
    rid = np.array([(k * 40_000_001 - 2**31) for k in range(800)],
                   dtype=np.int64)
    flipped = np.where(rid % 500 < 400, rid, -rid).astype(np.int32)
    assert sorted(dict(r)["id"] for r in rows) == sorted(flipped.tolist())
