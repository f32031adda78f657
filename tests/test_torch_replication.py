"""INCREMENT_ONLY replication: the port's parsers, Kafka wire code, queue
source, ClickHouse sink and `run_replication` against the JAX package's,
on the CPU, exactly.

The port runs with device="cpu" (each kernel's plain version); the JAX
package runs as its own tests run it on the CPU.  Held equal: the JSON,
TSKV and blank parsers on seeded message batches with malformed lines,
NULLs, missing fields, nested paths and values to coerce (against the
JAX parser both with pyarrow's reader and with its stdlib route); the
Kafka record-batch bytes and CRC; the Sequencer's commits under
out-of-order acks; the ParseQueue's order and failure latch; RowBinary
bytes for every canonical type; Kafka -> memory and the 16-partition
Kafka -> ClickHouse fan-in with mask+filter, each package against its
own fake broker and fake ClickHouse (rows and committed offsets); the
retry loop's fatal/retriable classification; the sample replication
source; and a mixed-kind CDC batch (inserts, updates, deletes with old
keys and LSNs) through the INCREMENT_ONLY sink pipeline with mask+filter
and the Bufferer.
"""

import json
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np
import pytest

from tests.recipes.fake_clickhouse import FakeCH as RefFakeCH
from tests.recipes.fake_kafka import FakeKafka as RefFakeKafka
from transferia_tpu import parsers as ref_parsers
from transferia_tpu.abstract import errors as ref_errors
from transferia_tpu.abstract import interfaces as ref_interfaces
from transferia_tpu.abstract.change_item import ChangeItem as RefItem
from transferia_tpu.abstract.change_item import OldKeys as RefOldKeys
from transferia_tpu.abstract.kinds import Kind as RefKind
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.factories import make_async_sink as ref_make_async_sink
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models.endpoint import (
    EndpointParams as RefEndpointParams,
)
from transferia_tpu.models.endpoint import (
    register_endpoint as ref_register_endpoint,
)
from transferia_tpu.parsequeue import ParseQueue as RefParseQueue
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers import registry as ref_registry
from transferia_tpu.providers import sample as ref_sample
from transferia_tpu.providers.clickhouse import CHTargetParams as RefCHParams
from transferia_tpu.providers.clickhouse.rowbinary import (
    encode_rowbinary as ref_encode_rowbinary,
)
from transferia_tpu.providers.kafka import KafkaSourceParams as RefKafkaParams
from transferia_tpu.providers.kafka import protocol as ref_protocol
from transferia_tpu.providers.kafka.client import KafkaClient as RefClient
from transferia_tpu.providers.kafka.provider import (
    topic_partitions as ref_topic_partitions,
)
from transferia_tpu.providers.queue_common import Sequencer as RefSequencer
from transferia_tpu.runtime.local import run_replication as ref_run
from transferia_tpu.stats.registry import Metrics as RefMetrics
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu_torch import parsers
from transferia_tpu_torch.abstract import errors
from transferia_tpu_torch.abstract import interfaces
from transferia_tpu_torch.abstract.change_item import ChangeItem, OldKeys
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    new_table_schema,
)
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.factories import make_async_sink
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.models.endpoint import (
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.parsequeue import ParseQueue
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers import registry as port_registry
from transferia_tpu_torch.providers import sample as port_sample
from transferia_tpu_torch.providers.clickhouse import CHTargetParams
from transferia_tpu_torch.providers.clickhouse.rowbinary import (
    encode_rowbinary,
)
from transferia_tpu_torch.providers.kafka import KafkaSourceParams
from transferia_tpu_torch.providers.kafka import protocol
from transferia_tpu_torch.providers.kafka.client import KafkaClient
from transferia_tpu_torch.providers.kafka.provider import topic_partitions
from transferia_tpu_torch.providers.queue_common import Sequencer
from transferia_tpu_torch.recipes.fake_clickhouse import FakeCH
from transferia_tpu_torch.recipes.fake_kafka import FakeKafka
from transferia_tpu_torch.runtime.local import run_replication
from transferia_tpu_torch.stats.registry import Metrics
from transferia_tpu_torch.transform import fused as port_tfused

MASK_FILTER = {"transformers": [
    {"mask_field": {"columns": ["url"], "salt": "s"}},
    {"filter_rows": {"filter": "region < 20"}},
]}
HITS_SCHEMA = [
    {"name": "id", "type": "int64", "key": True},
    {"name": "url", "type": "utf8"},
    {"name": "region", "type": "int32"},
]


@pytest.fixture(autouse=True)
def device_placement():
    """Both packages' fused steps take their device strategy (the port's
    on the CPU runs the kernels' plain versions)."""
    for mod in (ref_tfused, port_tfused):
        mod.set_placement("device")
    yield
    for mod in (ref_tfused, port_tfused):
        mod.set_placement(None)


# -- comparable values -------------------------------------------------------

def column_bytes(col):
    return (col.ctype.value, np.asarray(col.data).tobytes(),
            None if col.offsets is None else col.offsets.tobytes(),
            None if col.validity is None else col.validity.tobytes())


def batch_state(b, commit_times: bool = True):
    """Everything a ColumnBatch carries, as comparable values."""
    def arr(a):
        return None if a is None else (a.dtype.str, a.tobytes())

    schema = tuple((c.name, c.data_type.value, c.primary_key, c.required,
                    c.path) for c in b.schema)
    return (str(b.table_id), schema, b.n_rows,
            {n: column_bytes(c) for n, c in b.columns.items()},
            arr(b.kinds), arr(b.lsns),
            arr(b.commit_times) if commit_times else None, b.part_id,
            None if b.old_keys is None else
            [(k.key_names, k.key_values) for k in b.old_keys],
            b.txn_ids)


def norm_item(it):
    return (it.kind.value, it.schema, it.table, tuple(it.column_names),
            tuple(it.column_values), it.lsn, it.commit_time_ns,
            tuple(it.old_keys.key_names), tuple(it.old_keys.key_values),
            it.txn_id, it.part_id)


def norm_out(out, commit_times: bool = True):
    if hasattr(out, "columns"):
        return ("block", batch_state(out, commit_times))
    return ("rows", [norm_item(it) for it in out])


def parse_state(result):
    return ([batch_state(b) for b in result.batches],
            None if result.unparsed is None
            else batch_state(result.unparsed))


# -- parsers ----------------------------------------------------------------

def json_line(rng, i: int) -> bytes:
    """One seeded line: mostly good rows, with NULLs, missing fields,
    values to coerce and malformed JSON."""
    r = rng.random()
    if r < 0.05:
        return b'{"id": ' + str(i).encode() + b', "url": '  # truncated
    if r < 0.07:
        return b"[1, 2, 3]"  # JSON, not an object
    if r < 0.09:
        return b'{"url": "no-key"}'  # NULL key
    row = {"id": i, "url": f"https://e.test/{i % 97}",
           "region": int(rng.integers(0, 500)),
           "amount": float(np.round(rng.normal(0, 100), 3)),
           "flag": bool(rng.integers(0, 2)),
           "ts": int(rng.integers(0, 2 ** 50)),
           "geo": {"city": f"c{i % 7}"}}
    if rng.random() < 0.15:
        row[["url", "region", "amount", "flag", "ts"][i % 5]] = None
    if rng.random() < 0.15:
        del row[["url", "amount", "geo"][i % 3]]
    if rng.random() < 0.1:  # values the declared types coerce
        row["region"] = str(row.get("region") or 0)
        row["flag"] = "true" if i % 2 else "False"
        row["amount"] = str(row.get("amount") or 0)
    if rng.random() < 0.05:
        row["extra"] = [1, {"x": None}]
    return json.dumps(row).encode()


def messages(msg_cls, n: int, seed: int, tskv: bool = False):
    """n messages of one to three lines each, over 3 partitions."""
    rng = np.random.default_rng(seed)
    out = []
    i = 0
    for k in range(n):
        lines = []
        for _ in range(1 + int(rng.integers(0, 3)) * (k % 4 == 0)):
            line = json_line(rng, i)
            if tskv:
                try:
                    row = json.loads(line)
                except ValueError:
                    row = None
                line = ("tskv\t" + "\t".join(
                    f"{key}={'' if v is None else v}"
                    for key, v in row.items()
                    if not isinstance(v, (dict, list)))).encode() \
                    if isinstance(row, dict) else b"no pairs here"
            lines.append(line)
            i += 1
        out.append(msg_cls(value=b"\n".join(lines), key=b"k%d" % k,
                           topic="hits", partition=k % 3, offset=k,
                           write_time_ns=(1_700_000_000 + k) * 10 ** 9))
    return out


FULL_SCHEMA = HITS_SCHEMA + [
    {"name": "amount", "type": "double"},
    {"name": "flag", "type": "boolean"},
    {"name": "ts", "type": "timestamp"},
]
PARSERS = {
    "json_scalar": {"json": {"schema": FULL_SCHEMA, "table": "hits"}},
    "json_path": {"json": {"schema": FULL_SCHEMA + [
        {"name": "city", "type": "utf8", "path": "geo.city"},
        {"name": "extra", "type": "any"}], "table": "hits",
        "namespace": "ns"}},
    "json_inferred": {"json": {"table": "hits"}},
    "json_no_system_cols": {"generic": {
        "schema": FULL_SCHEMA, "add_system_cols": False,
        "null_keys_allowed": True}},
    "json_no_key": {"json": {"schema": [
        {"name": "url", "type": "utf8"},
        {"name": "region", "type": "int64", "required": True}]}},
    "tskv": {"tskv": {"schema": FULL_SCHEMA, "table": "hits"}},
}


def without_pyarrow(monkeypatch):
    for name in ("pyarrow", "pyarrow.json"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("n", [40, 600])
@pytest.mark.parametrize("case", sorted(PARSERS))
def test_parser_equals_jax(case, n, monkeypatch):
    """The port's parser against the JAX parser with pyarrow's reader (it
    takes it from 256 lines on) and with its stdlib route."""
    cfg = PARSERS[case]
    tskv = case == "tskv"
    got = parsers.make_parser(cfg).do_batch(
        messages(parsers.Message, n, n, tskv))
    assert got.row_count() > 0
    if case != "json_no_system_cols":
        assert got.unparsed is not None and got.unparsed.n_rows > 0
    want = ref_parsers.make_parser(cfg).do_batch(
        messages(ref_parsers.Message, n, n, tskv))
    assert parse_state(got) == parse_state(want)
    without_pyarrow(monkeypatch)
    stdlib = ref_parsers.make_parser(cfg).do_batch(
        messages(ref_parsers.Message, n, n, tskv))
    assert parse_state(got) == parse_state(stdlib)


def test_blank_parser_equals_jax():
    cfgs = [{"blank": {}}, {"raw_to_table": {"table": "raw",
                                             "namespace": "q"}}]
    for cfg in cfgs:
        got = parsers.make_parser(cfg).do_batch(
            messages(parsers.Message, 30, 3))
        want = ref_parsers.make_parser(cfg).do_batch(
            messages(ref_parsers.Message, 30, 3))
        assert parse_state(got) == parse_state(want)
        assert got.batches[0].n_rows == 30
    assert parsers.make_parser({"blank": {}}).do_batch([]).batches == []


def test_unported_parser_names_the_ported_ones():
    with pytest.raises(KeyError, match="ROADMAP") as err:
        parsers.make_parser({"cloudevents": {}})
    for name in ("blank", "debezium", "generic", "json", "raw_to_table",
                 "tskv"):
        assert name in str(err.value)


# -- the Kafka wire ---------------------------------------------------------

def records(rec_cls, seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = None if rng.random() < 0.2 else bytes(
            rng.integers(0, 256, int(rng.integers(0, 20)), dtype=np.uint8))
        value = None if rng.random() < 0.1 else bytes(
            rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8))
        headers = [(b"h%d" % j, b"v" * j)
                   for j in range(int(rng.integers(0, 3)))]
        out.append(rec_cls(key=key, value=value, headers=headers,
                           timestamp_ms=1_700_000_000_000 + 3 * i))
    return out


def rec_state(recs):
    return [(r.key, r.value, r.offset, r.timestamp_ms, list(r.headers))
            for r in recs]


@pytest.mark.parametrize("compression", ["", "gzip"])
@pytest.mark.parametrize("seed", range(3))
def test_record_batch_bytes_equal_jax(seed, compression):
    recs = records(protocol.Record, seed, 50 + 40 * seed)
    ref_recs = records(ref_protocol.Record, seed, 50 + 40 * seed)
    blob = protocol.encode_record_batch(recs, base_offset=7 * seed,
                                        compression=compression)
    ref_blob = ref_protocol.encode_record_batch(
        ref_recs, base_offset=7 * seed, compression=compression)
    if compression:  # gzip stamps the time: compare what it holds
        assert len(blob) > 61
    else:
        assert blob == ref_blob
    two = blob + ref_blob
    got = protocol.decode_record_batches(two)
    assert rec_state(got) == rec_state(
        ref_protocol.decode_record_batches(two))
    assert [r.offset for r in got[:3]] == [7 * seed + k for k in range(3)]
    assert len(got) == 2 * len(recs)


def test_crc32c_equals_jax_and_corruption_raises():
    rng = np.random.default_rng(5)
    for n in (0, 1, 7, 64, 1000, 4097):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert protocol.crc32c(data) == ref_protocol.crc32c(data)
    assert protocol.crc32c(b"123456789") == 0xE3069283  # the check value
    blob = bytearray(protocol.encode_record_batch(
        [protocol.Record(key=b"k", value=b"v")]))
    blob[-1] ^= 0xFF
    for decode in (protocol.decode_record_batches,
                   ref_protocol.decode_record_batches):
        with pytest.raises(ValueError, match="CRC"):
            decode(bytes(blob))


def test_topic_partitions_equal_jax():
    got = []
    for fake, params, fn in (
            (FakeKafka, KafkaSourceParams, topic_partitions),
            (RefFakeKafka, RefKafkaParams, ref_topic_partitions)):
        srv = fake(n_partitions=3).start()
        try:
            got.append(fn(params(brokers=[f"127.0.0.1:{srv.port}"],
                                 topic="parts")))
        finally:
            srv.stop()
    assert got == [[0, 1, 2], [0, 1, 2]]


def test_client_produce_fetch_against_its_fake():
    srv = FakeKafka(n_partitions=2).start()
    try:
        client = KafkaClient([f"127.0.0.1:{srv.port}"])
        assert client.metadata(["t1"]) == {"t1": [0, 1]}
        assert client.produce("t1", 0, [protocol.Record(b"a", b"1"),
                                        protocol.Record(b"b", b"2")]) == 0
        assert client.produce("t1", 0, [protocol.Record(b"c", b"3")]) == 2
        recs, high = client.fetch("t1", 0, 0)
        assert [r.value for r in recs] == [b"1", b"2", b"3"] and high == 3
        assert [r.value for r in client.fetch("t1", 0, 2)[0]] == [b"3"]
        multi = client.fetch_multi("t1", {0: 1, 1: 0})
        assert [r.value for r in multi[0][0]] == [b"2", b"3"]
        assert multi[1] == ([], 0)
        assert client.list_offsets("t1", 0, -1) == 3
        assert client.list_offsets("t1", 0, -2) == 0
        client.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("what", ["tls", "sasl"])
def test_client_security_is_not_ported(what):
    kw = {"tls": True} if what == "tls" else {"sasl_mechanism": "PLAIN"}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        KafkaClient(["127.0.0.1:1"], **kw)


# -- the queue machinery ----------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_sequencer_commits_equal_jax(seed):
    rng = np.random.default_rng(seed)
    fetched = []
    nxt = {0: 0, 1: 100}
    for _ in range(30):
        p = int(rng.integers(0, 2))
        k = int(rng.integers(1, 6))
        fetched.append((p, list(range(nxt[p], nxt[p] + k))))
        nxt[p] += k
    order = rng.permutation(len(fetched))
    outs = []
    for seq in (Sequencer(), RefSequencer()):
        for p, offs in fetched:
            seq.start_processing("t", p, offs)
        outs.append([seq.ack("t", fetched[j][0], fetched[j][1])
                     for j in order])
    assert outs[0] == outs[1]
    # a commit never passes an unacked offset, and the last acks commit
    # each partition's last offset
    done = {0: set(), 1: set()}
    last = {}
    for j, commit in zip(order, outs[0]):
        p, offs = fetched[j]
        done[p].update(offs)
        if commit is not None:
            lo = 0 if p == 0 else 100
            assert set(range(lo, commit + 1)) <= done[p]
            last[p] = commit
    assert last == {p: nxt[p] - 1 for p in (0, 1)}


class _ListSink:
    """An AsyncSink recording its pushes in order."""

    def __init__(self):
        self.pushed = []

    def async_push(self, batch):
        import concurrent.futures

        self.pushed.append(batch)
        fut = concurrent.futures.Future()
        fut.set_result(None)
        return fut

    def close(self):
        pass


@pytest.mark.parametrize("fail_at", [None, 5])
def test_parsequeue_order_and_latch_equal_jax(fail_at):
    outs = []
    for queue_cls in (ParseQueue, RefParseQueue):
        release = threading.Event()
        sink = _ListSink()
        acks = []

        def parse(i):
            if i == 0:
                release.wait(10)
            time.sleep(0.002 * ((i * 7) % 5))
            if i == fail_at:
                raise ValueError(f"unit {i} failed")
            return [[f"row{i}-{k}" for k in range(i % 3 + 1)], []]

        def ack(i, err):
            acks.append((i, None if err is None else str(err)))

        q = queue_cls(4, sink, parse, ack)
        for i in range(12):
            q.add(i)
        release.set()
        try:
            q.wait()
            failure = None
        except ValueError as e:
            failure = str(e)
        q.close()
        outs.append((sink.pushed, acks, failure))
    assert outs[0] == outs[1]
    pushed, acks, failure = outs[0]
    n_ok = 12 if fail_at is None else fail_at
    assert pushed == [[f"row{i}-{k}" for k in range(i % 3 + 1)]
                      for i in range(n_ok)]
    assert [a[0] for a in acks] == list(range(12))
    if fail_at is not None:
        assert failure == "unit 5 failed"
        assert all(a[1] == failure for a in acks[fail_at:])


# -- RowBinary ----------------------------------------------------------------

def typed_columns(rng, n: int):
    """Every canonical type the parsers emit, with NULLs."""
    out = {}
    for t in CanonicalType:
        name = f"c_{t.value}"
        vals = []
        for i in range(n):
            if rng.random() < 0.25:
                vals.append(None)
            elif t.is_integer:
                bits = int(t.value.lstrip("uint"))
                lo, hi = (0, 2 ** bits - 1) if t.value[0] == "u" else \
                    (-2 ** (bits - 1), 2 ** (bits - 1) - 1)
                vals.append(int(rng.integers(lo, hi, dtype=np.int64))
                            if bits < 64 else
                            int(rng.integers(lo, hi, dtype=np.uint64
                                             if lo == 0 else np.int64)))
            elif t.is_float:
                vals.append(float(np.float32(rng.normal(0, 1e3))))
            elif t == CanonicalType.BOOLEAN:
                vals.append(bool(rng.integers(0, 2)))
            elif t in (CanonicalType.DATE, CanonicalType.DATETIME,
                       CanonicalType.TIMESTAMP, CanonicalType.INTERVAL):
                vals.append(int(rng.integers(0, 2 ** 31)))
            elif t == CanonicalType.STRING:
                vals.append(bytes(rng.integers(0, 256, int(rng.integers(
                    0, 300)), dtype=np.uint8)))
            elif t == CanonicalType.ANY:
                vals.append({"k": i, "v": [None, "x"]})
            else:
                vals.append("é" * int(rng.integers(0, 200)))
        out[name] = (t.value, vals)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_rowbinary_bytes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    cols = typed_columns(rng, 40 + 30 * seed)
    spec = [(name, t) for name, (t, _) in cols.items()]
    data = {name: vals for name, (_, vals) in cols.items()}
    batch = ColumnBatch.from_pydict(TableID("", "t"),
                                    new_table_schema(spec), data)
    ref = RefBatch.from_pydict(RefTableID("", "t"), ref_schema(spec), data)
    names = list(data)
    for nullable in (None, {n: True for n in names},
                     {n: k % 2 == 0 for k, n in enumerate(names)}):
        got = encode_rowbinary(batch, nullable)
        assert got == ref_encode_rowbinary(ref, nullable)
        assert len(got) > batch.n_rows
    assert encode_rowbinary(batch.slice(0, 0)) == b""


# -- whole replications -------------------------------------------------------

def wait_for(cond, seconds: float = 30.0) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("timed out")
        time.sleep(0.02)


def start(run, transfer, cp, **kw):
    stop = threading.Event()
    th = threading.Thread(target=run, args=(transfer, cp),
                          kwargs={"stop_event": stop, "backoff": 0.1, **kw},
                          daemon=True)
    th.start()
    return stop, th


def seed_broker(client_cls, rec_cls, port: int, topic: str,
                partitions: int, per: int, value) -> None:
    seed = client_cls([f"127.0.0.1:{port}"])
    for p in range(partitions):
        seed.produce(topic, p, [
            rec_cls(key=str(p * per + i).encode(),
                    value=value(p * per + i, i),
                    timestamp_ms=1_700_000_000_000 + i)
            for i in range(per)])
    seed.close()


def offsets_settled(cp, tid: str, partitions: int, last: int) -> bool:
    state = cp.get_transfer_state(tid).get("kafka_offsets", {})
    return len(state) == partitions and \
        all(v == last for v in state.values())


def kafka_to_memory(pkg: str):
    if pkg == "port":
        fake, client, rec, params, mem, transfer, cp, run = (
            FakeKafka, KafkaClient, protocol.Record, KafkaSourceParams,
            port_memory, Transfer, MemoryCoordinator(), run_replication)
        kw = {"device": "cpu"}
    else:
        fake, client, rec, params, mem, transfer, cp, run = (
            RefFakeKafka, RefClient, ref_protocol.Record, RefKafkaParams,
            ref_memory, RefTransfer, RefCoordinator(), ref_run)
        kw = {}
    srv = fake(n_partitions=2).start()
    sid = f"k2mem-{pkg}"
    try:
        seed_broker(client, rec, srv.port, "events", 2, 50,
                    lambda i, _: json.dumps({"id": i, "v": f"x{i}"}).encode()
                    if i % 17 else b"{broken")
        store = mem.get_store(sid)
        store.clear()
        t = transfer(id=sid, type="INCREMENT_ONLY", src=params(
            brokers=[f"127.0.0.1:{srv.port}"], topic="events",
            parser={"json": {"schema": [
                {"name": "id", "type": "int64", "key": True},
                {"name": "v", "type": "utf8"}], "table": "events"}}),
            dst=mem.MemoryTargetParams(sink_id=sid))
        stop, th = start(run, t, cp, **kw)
        wait_for(lambda: store.row_count() >= 100)
        wait_for(lambda: offsets_settled(cp, sid, 2, 49))
        stop.set()
        th.join(10)
        assert not th.is_alive()
        rows = sorted((norm_item(it) for it in store.rows()),
                      key=lambda r: (r[2], r[4]))
        return rows, cp.get_transfer_state(sid)["kafka_offsets"], \
            cp.get_status(sid).value
    finally:
        srv.stop()


def test_kafka_to_memory_equals_jax():
    rows, offsets, status = kafka_to_memory("port")
    assert (rows, offsets, status) == kafka_to_memory("jax")
    assert offsets == {"events:0": 49, "events:1": 49}
    events = [r for r in rows if r[2] == "events"]
    unparsed = [r for r in rows if r[2] == "_unparsed"]
    assert len(events) == 94 and len(unparsed) == 6
    assert sorted(r[4][4] for r in events) == [i for i in range(100)
                                               if i % 17]


def kafka_to_ch(pkg: str, partitions: int = 16, per: int = 40,
                shard_by: str = ""):
    if pkg == "port":
        fake, ch_fake, client, rec, params, ch_params, transfer, cp, run = (
            FakeKafka, FakeCH, KafkaClient, protocol.Record,
            KafkaSourceParams, CHTargetParams, Transfer,
            MemoryCoordinator(), run_replication)
        kw = {"device": "cpu"}
    else:
        fake, ch_fake, client, rec, params, ch_params, transfer, cp, run = (
            RefFakeKafka, RefFakeCH, RefClient, ref_protocol.Record,
            RefKafkaParams, RefCHParams, RefTransfer, RefCoordinator(),
            ref_run)
        kw = {}
    srv = fake(n_partitions=partitions).start()
    ch = ch_fake().start()
    try:
        srv.create_topic("hits")
        seed_broker(client, rec, srv.port, "hits", partitions, per,
                    lambda i, k: json.dumps({
                        "id": i, "url": f"https://x/{k}",
                        "region": k % 500}).encode())
        t = transfer(id=f"fan-{pkg}", type="INCREMENT_ONLY", src=params(
            brokers=[f"127.0.0.1:{srv.port}"], topic="hits",
            parallelism=4,
            parser={"json": {"schema": HITS_SCHEMA, "table": "hits"}}),
            dst=ch_params(host="127.0.0.1", port=ch.port, bufferer=None,
                          shard_by=shard_by),
            transformation=MASK_FILTER)
        expected = partitions * sum(1 for k in range(per) if k % 500 < 20)
        stop, th = start(run, t, cp, **kw)
        wait_for(lambda: ch.total_rows() >= expected, 60)
        wait_for(lambda: offsets_settled(cp, t.id, partitions, per - 1))
        stop.set()
        th.join(10)
        assert not th.is_alive()
        assert ch.total_rows() == expected
        tables = {name: (tb["ddl"], sorted(
            (tuple(sorted(r.items())) for r in tb["rows"]),
            key=lambda r: dict(r)["id"]))
            for name, tb in ch.tables.items()}
        return tables, cp.get_transfer_state(t.id)["kafka_offsets"]
    finally:
        srv.stop()
        ch.stop()


def test_16_partition_fanin_to_clickhouse_equals_jax():
    tables, offsets = kafka_to_ch("port")
    assert (tables, offsets) == kafka_to_ch("jax")
    assert offsets == {f"hits:{p}": 39 for p in range(16)}
    ddl, rows = tables["hits"]
    assert len(rows) == 16 * 20
    assert all(len(dict(r)["url"]) == 64 for r in rows)
    assert sorted(dict(r)["id"] for r in rows) == \
        [p * 40 + k for p in range(16) for k in range(20)]


def test_shard_by_on_one_shard_equals_jax():
    # shard_by picks a shard among several; on one shard both packages
    # write every row there
    tables, offsets = kafka_to_ch("port", partitions=2, shard_by="region")
    assert (tables, offsets) == kafka_to_ch("jax", partitions=2,
                                            shard_by="region")
    assert offsets == {"hits:0": 39, "hits:1": 39}
    assert len(tables["hits"][1]) == 2 * 20


# -- the retry loop -----------------------------------------------------------

class _FatalSource(interfaces.Source):
    def run(self, sink):
        raise errors.AbortTransferError("bad config")

    def stop(self):
        pass


class _RefFatalSource(ref_interfaces.Source):
    def run(self, sink):
        raise ref_errors.AbortTransferError("bad config")

    def stop(self):
        pass


@register_endpoint
@dataclass
class _FatalParams(EndpointParams):
    PROVIDER = "test_fatal_source"
    IS_SOURCE = True


@ref_register_endpoint
@dataclass
class _RefFatalParams(RefEndpointParams):
    PROVIDER = "test_fatal_source"
    IS_SOURCE = True


@port_registry.register_provider
class _FatalProvider(port_registry.Provider):
    NAME = "test_fatal_source"

    def source(self):
        return _FatalSource()


@ref_registry.register_provider
class _RefFatalProvider(ref_registry.Provider):
    NAME = "test_fatal_source"

    def source(self):
        return _RefFatalSource()


def classify(pkg: str, case: str):
    if pkg == "port":
        mem, sample, transfer, cp, run, metrics = (
            port_memory, port_sample, Transfer, MemoryCoordinator(),
            run_replication, Metrics())
        kw = {"device": "cpu"}
        fatal_params = _FatalParams
    else:
        mem, sample, transfer, cp, run, metrics = (
            ref_memory, ref_sample, RefTransfer, RefCoordinator(), ref_run,
            RefMetrics())
        kw = {}
        fatal_params = _RefFatalParams
    sid = f"classify-{case}-{pkg}"
    src = fatal_params() if case == "fatal" else \
        sample.SampleSourceParams(rows=0, replication_batch=64)
    t = transfer(id=sid, type="INCREMENT_ONLY", src=src,
                 dst=mem.MemoryTargetParams(sink_id=sid, fail_pushes=1))
    with pytest.raises(Exception) as err:
        run(t, cp, metrics=metrics, max_attempts=3, backoff=0.0, **kw)
    return (type(err.value).__name__, str(err.value),
            cp.get_status(sid).value, cp.status_messages(sid),
            [metrics.value(m) for m in (
                "replication_restarts", "replication_fatal_errors",
                "replication_running")])


@pytest.mark.parametrize("case", ["fatal", "retriable"])
def test_run_replication_classification_equals_jax(case):
    got = classify("port", case)
    assert got == classify("jax", case)
    if case == "fatal":
        assert got[0] == "AbortTransferError"
        assert got[4][:2] == [0.0, 1.0]  # no restart
    else:
        assert got[0] == "ConnectionError"
        assert got[4][:2] == [3.0, 0.0]  # max_attempts stopped it
    assert got[2] == "failed" and got[3] == [("replication", got[1])]


def sample_stream(pkg: str, n_batches: int = 4):
    mem, sample, transfer, cp, run = (
        (port_memory, port_sample, Transfer, MemoryCoordinator(),
         run_replication) if pkg == "port" else
        (ref_memory, ref_sample, RefTransfer, RefCoordinator(), ref_run))
    kw = {"device": "cpu"} if pkg == "port" else {}
    sid = f"sample-repl-{pkg}"
    store = mem.get_store(sid)
    store.clear()
    t = transfer(id=sid, type="INCREMENT_ONLY",
                 src=sample.SampleSourceParams(
                     preset="users", table="users", rows=1000,
                     replication_batch=256, rate=40_000.0, seed=3),
                 dst=mem.MemoryTargetParams(sink_id=sid),
                 transformation={"transformers": [
                     {"mask_field": {"columns": ["email"], "salt": "s"}},
                     {"filter_rows": {"filter": "age >= 30"}}]})
    stop, th = start(run, t, cp, **kw)
    wait_for(lambda: len(store.batches) >= n_batches)
    stop.set()
    th.join(10)
    assert not th.is_alive()
    return [norm_out(b, commit_times=False)
            for b in store.batches[:n_batches]]


def test_sample_replication_equals_jax():
    got = sample_stream("port")
    assert got == sample_stream("jax")
    lsns = [np.frombuffer(b[1][5][1], dtype=b[1][5][0]) for b in got]
    assert [set(a.tolist()) for a in lsns] == [{1}, {2}, {3}, {4}]
    assert all(b[1][0] == "sample.users" for b in got)


# -- CDC kinds through the INCREMENT_ONLY sink pipeline ----------------------

CDC_COLS = [("id", "int64", True), ("url", "utf8"), ("region", "int32"),
            ("amount", "double")]


def cdc_items(seed: int, n: int):
    """(port items, JAX items): inserts, updates and deletes with old
    keys, LSNs and NULLs."""
    rng = np.random.default_rng(seed)
    port, ref = [], []
    names = tuple(c[0] for c in CDC_COLS)
    for i in range(n):
        kind = ("insert", "update", "delete")[int(rng.integers(3))]
        values = (i, None if rng.random() < 0.1 else f"https://c/{i}",
                  None if rng.random() < 0.1 else int(rng.integers(0, 40)),
                  float(np.round(rng.normal(0, 10), 2)))
        old = (("id",), (i + 500,)) if kind != "insert" \
            and rng.random() < 0.6 else ((), ())
        lsn = 1000 + i
        table = "orders" if rng.random() < 0.8 else "refunds"
        for out, item, keys, kcls, schema in (
                (port, ChangeItem, OldKeys, Kind,
                 new_table_schema(CDC_COLS)),
                (ref, RefItem, RefOldKeys, RefKind, ref_schema(CDC_COLS))):
            out.append(item(kind=kcls(kind), schema="shop", table=table,
                            column_names=names, column_values=values,
                            table_schema=schema, lsn=lsn,
                            commit_time_ns=lsn * 1000, txn_id=f"tx{i // 4}",
                            old_keys=keys(*old)))
    return port, ref


@pytest.mark.parametrize("trigger_rows", [None, 25])
def test_cdc_batch_through_increment_pipeline_equals_jax(trigger_rows):
    items, ref_items = cdc_items(4, 120)
    config = {"transformers": [
        {"mask_field": {"columns": ["url"], "salt": "cdc"}},
        {"filter_rows": {"filter": "region < 20"}}]}
    bufferer = None if trigger_rows is None else \
        {"trigger_rows": trigger_rows, "trigger_interval": 0}
    outs = []
    for mem, transfer, make, rows, kw in (
            (port_memory, Transfer, make_async_sink, items,
             {"device": "cpu"}),
            (ref_memory, RefTransfer, ref_make_async_sink, ref_items, {})):
        sid = f"cdc-{trigger_rows}-{mem.__name__}"
        mem.get_store(sid).clear()
        t = transfer(id=sid, type="INCREMENT_ONLY",
                     dst=mem.MemoryTargetParams(sink_id=sid,
                                                bufferer=bufferer),
                     transformation=config)
        sink = make(t, **kw)
        futs = [sink.async_push(rows[i:i + 30])
                for i in range(0, len(rows), 30)]
        # one columnar CDC block (kinds, LSNs, old keys) as well
        batch_cls = ColumnBatch if mem is port_memory else RefBatch
        futs.append(sink.async_push(batch_cls.from_rows(
            [it for it in rows[:40] if it.table == "orders"])))
        for f in futs:
            f.result(timeout=30)
        sink.close()
        store = mem.get_store(sid)
        outs.append(([norm_out(b) for b in store.batches],
                     [norm_item(it) for it in store.rows()]))
    assert outs[0] == outs[1]
    kinds = {r[0] for r in outs[0][1]}
    assert kinds == {"insert", "update", "delete"}
    assert all(r[4][2] is not None and r[4][2] < 20 for r in outs[0][1])
    assert all(r[4][1] is None or len(r[4][1]) == 64 for r in outs[0][1])
