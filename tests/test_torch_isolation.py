"""The port stands alone: no JAX, no JAX package, no pyarrow, no silent CPU.

A fresh interpreter imports transferia_tpu_torch and runs the fused
chain (over a flat and a dictionary-encoded column), the ragged pack, a
table fingerprint, the sharded transform step, the chain's mesh route
(on a 2-shard virtual mesh), the lambda chain with the SR fan-in user
function in both placements, a rename chain and a snapshot transfer
(sample -> memory through SnapshotLoader, with the mask, the filter,
staged commits and fingerprint validation) and a replication (Kafka
JSON -> ClickHouse through run_replication with the mask and the
filter, against the port's own wire fakes) and a ClickBench Parquet
snapshot (a file the recipe writer wrote -> fs -> devnull through
SnapshotLoader under bench.py's chain), a pg2ch activation (the port's
fake Postgres -> the filter -> its fake ClickHouse through
activate_delivery, staged commits on), an Avro run through the
schema-registry parser and a my2kf activation (the port's fake MySQL ->
the mask -> Debezium envelopes -> its fake Kafka through
activate_delivery, the transactional staged publish, the envelopes read
back through the debezium parser) on the CPU, decodes a binlog and a
wal2json stream of `recipes.cdc` through the CDC tails' decoders (the
binlog reader, the GTID set, the wal2json decoder), imports `mvcc/`,
runs a SNAPSHOT_AND_INCREMENT activation through the MVCC store and
checksums its sink against the source with `tasks/checksum.py`
(compare, and the fingerprint's host lanes and device route); afterwards neither
jax, pyarrow, transferia_tpu nor any transferia_tpu.* module may be
loaded, and the only host library mapped is the port's own build.
A second fresh interpreter imports every module of the telemetry plane
and turns tracing, the stage timer, the lock watch, a failpoint and the
profiler on over a fused chain: neither jax, jax.monitoring,
prometheus_client nor the JAX package may be loaded, and a disabled
span is the shared no-op singleton.
And without CUDA, an entry point that was not asked for the CPU raises
instead of running there.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.ops.fused import FusedMaskFilterProgram
from transferia_tpu_torch.ops.rowhash import (
    DeviceFingerprintProgram,
    TableFingerprinter,
    batch_row_keys,
)
from transferia_tpu_torch.parallel import make_mesh, sharded_transform_step
from transferia_tpu_torch.parallel.fusedmesh import ShardedFusedProgram
from transferia_tpu_torch.runtime.device import resolve_device
from transferia_tpu_torch.transform import build_chain
from transferia_tpu_torch.transform.fused import set_placement

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = {"transformers": [
    {"mask_field": {"columns": ["url"], "salt": "s"}},
    {"filter_rows": {"filter": "region < 400"}},
]}

_CHILD = """
import sys
import numpy as np
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.transform import build_chain
from transferia_tpu_torch.transform.fused import DeviceFusedStep, set_placement
from transferia_tpu_torch.ops.decode import decode_dict_run
from transferia_tpu_torch.ops.rowhash import TableFingerprinter, batch_row_keys
import transferia_tpu_torch.ops.linkprobe, transferia_tpu_torch.weights  # noqa
from transferia_tpu_torch.columnar.batch import Column, DictEnc, DictPool
from transferia_tpu_torch.ops.raggedpack import pack_blocks_device

schema = new_table_schema([("url", "utf8"), ("region", "int32")])
batch = ColumnBatch.from_pydict(TableID("", "t"), schema, {
    "url": [f"u{i}" for i in range(300)], "region": list(range(300, 600))})
set_placement("device")
chain = build_chain(%r, device="cpu")
out = chain.apply(batch)
step = chain.plan_for(batch.table_id, batch.schema).steps[0]
assert isinstance(step, DeviceFusedStep), step
assert out.n_rows == 100, out.n_rows
fp = TableFingerprinter(backend="device", device="cpu")
fp.push(batch)
assert fp.result().count == 300
assert len(batch_row_keys(batch, backend="device", device="cpu")) == 300
import torch
codes = torch.tensor([0b1011], dtype=torch.int32)
pool = torch.tensor([7, 8], dtype=torch.int32)
assert decode_dict_run(codes, pool, 1, 4).tolist() == [8, 8, 7, 8]
blocks, nb = pack_blocks_device(np.frombuffer(b"abc", dtype=np.uint8),
                                np.array([0, 1, 3], dtype=np.int32), 4, 1,
                                device="cpu")
assert nb.tolist() == [1, 1, 0, 0], nb
dpool = DictPool(np.frombuffer(b"u1u2", dtype=np.uint8).copy(),
                 np.array([0, 2, 4, 4], dtype=np.int32), null_code=2)
url = Column("url", schema.find("url").data_type, dict_enc=DictEnc(
    np.array([i %% 2 for i in range(300)], dtype=np.int32), pool=dpool))
dbatch = ColumnBatch(TableID("", "t"), schema,
                     {"url": url, "region": batch.column("region")})
dout = chain.apply(dbatch)
assert dout.column("url").is_lazy_dict and dout.n_rows == 100
from transferia_tpu_torch.parallel import make_mesh, sharded_transform_step
from transferia_tpu_torch.parallel.fusedmesh import ShardedFusedProgram
from transferia_tpu_torch.parallel.mesh import example_step_args
from transferia_tpu_torch.testing import force_virtual_mesh
force_virtual_mesh(2)
mesh = make_mesh(device="cpu")
out = sharded_transform_step(mesh, n_shards=4)(*example_step_args(mesh, 8))
assert int(out[3].sum()) == int(out[4]) == 16, out
mchain = build_chain(%r, device="cpu")
big = ColumnBatch.from_pydict(TableID("", "t"), schema, {
    "url": [f"u{i}" for i in range(2048)], "region": list(range(2048))})
assert mchain.apply(big).n_rows == 400
mstep = mchain.plan_for(big.table_id, big.schema).steps[0]
assert mstep.sharded_program.last_kept == 400
force_virtual_mesh(None)
sr = new_table_schema([("id", "int64"), ("region", "int32")])
sbatch = ColumnBatch.from_pydict(TableID("", "hits"), sr, {
    "id": [2**31 + 5, 3], "region": [500, 1]})
for mode in ("host", "device"):
    set_placement(mode)
    lout = build_chain({"transformers": [{"lambda": {
        "function": "transferia_tpu_torch.ops.lambdas:bench_lambda"}}]},
        device="cpu").apply(sbatch)
    assert lout.column("id").data.tolist() == [2147483643, 3], lout
rchain = build_chain({"transformers": [
    {"rename_tables": {"tables": [{"from": ".t", "to": ".t2"}]}}]
    + %r["transformers"]
    + [{"rename_columns": {"columns": {"region": "r"}}}]}, device="cpu")
rout = rchain.apply(batch)
assert rout.table_id.name == "t2" and "r" in rout.columns, rout.columns
set_placement("device")
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import Runtime, ShardingUploadParams, Transfer
from transferia_tpu_torch.providers.memory import MemoryTargetParams, get_store
from transferia_tpu_torch.providers.sample import SampleSourceParams
from transferia_tpu_torch.tasks import SnapshotLoader
snap = Transfer(id="iso", src=SampleSourceParams(
    preset="users", table="users", rows=3000, shard_parts=2,
    batch_rows=500, dict_encode=True),
    dst=MemoryTargetParams(sink_id="iso", bufferer={"trigger_rows": 1000}),
    transformation={"transformers": [
        {"mask_field": {"columns": ["email"], "salt": "s"}},
        {"filter_rows": {"filter": "age >= 21"}}]},
    runtime=Runtime(sharding=ShardingUploadParams(process_count=2)),
    validation={"fingerprint": True})
cp = MemoryCoordinator()
SnapshotLoader(snap, cp, device="cpu").upload_tables()
parts = cp.operation_parts("op-iso")
assert len(parts) == 2 and all(p.completed and p.commit_epoch == 1
                               for p in parts), parts
digest = cp.get_operation_state("op-iso")["table_fingerprints"]
assert int(list(digest.values())[0].split(":")[1]) == \
    get_store("iso").row_count() > 0, digest
import json, threading, time
import transferia_tpu_torch.parsers.plugins, transferia_tpu_torch.stats.stagetimer  # noqa
from transferia_tpu_torch.models import TransferType
from transferia_tpu_torch.providers.clickhouse import CHTargetParams
from transferia_tpu_torch.providers.kafka import KafkaSourceParams
from transferia_tpu_torch.providers.kafka.client import KafkaClient
from transferia_tpu_torch.providers.kafka.protocol import Record
from transferia_tpu_torch.recipes.fake_clickhouse import FakeCH
from transferia_tpu_torch.recipes.fake_kafka import FakeKafka
from transferia_tpu_torch.runtime.local import run_replication
broker, ch = FakeKafka(n_partitions=2).start(), FakeCH().start()
producer = KafkaClient([f"127.0.0.1:{broker.port}"])
for p in range(2):
    producer.produce("hits", p, [Record(key=b"", value=json.dumps(
        {"id": p * 100 + i, "url": f"u{i}", "region": 5 * i}).encode())
        for i in range(100)])
producer.close()
repl = Transfer(id="iso-repl", type=TransferType.INCREMENT_ONLY,
    src=KafkaSourceParams(brokers=[f"127.0.0.1:{broker.port}"],
        topic="hits", parser={"json": {"schema": [
            {"name": "id", "type": "int64", "key": True},
            {"name": "url", "type": "utf8"},
            {"name": "region", "type": "int32"}], "table": "hits"}}),
    dst=CHTargetParams(host="127.0.0.1", port=ch.port),
    transformation=%r)
stop = threading.Event()
rcp = MemoryCoordinator()
th = threading.Thread(target=run_replication, args=(repl, rcp), kwargs={
    "stop_event": stop, "backoff": 0.1, "device": "cpu"}, daemon=True)
th.start()
deadline = time.monotonic() + 60
while ch.total_rows() < 160 and time.monotonic() < deadline:
    time.sleep(0.05)
stop.set()
th.join(10)
broker.stop()
ch.stop()
assert ch.total_rows() == 160, ch.total_rows()
import tempfile
from transferia_tpu_torch.providers.file import FileSourceParams
from transferia_tpu_torch.providers.stdout import NullTargetParams
from transferia_tpu_torch.recipes.clickbench import write_clickbench
with tempfile.TemporaryDirectory() as tmp:
    path = tmp + "/hits.parquet"
    _, kept = write_clickbench(path, 5000)
    cb = Transfer(id="iso-cb", src=FileSourceParams(
        path=path, table="hits", batch_rows=1024),
        dst=NullTargetParams(), transformation={"transformers": [
            {"mask_field": {"columns": ["URL"], "salt": "bench-salt"}},
            {"filter_rows": {"filter":
                "RegionID < 400 AND ResolutionWidth >= 390"}}]},
        runtime=Runtime(sharding=ShardingUploadParams(process_count=2)))
    fcp = MemoryCoordinator()
    SnapshotLoader(cb, fcp, operation_id="op-cb",
                   device="cpu").upload_tables()
    assert fcp.operation_progress("op-cb").completed_rows == kept > 0
from transferia_tpu_torch.providers.postgres import PGSourceParams
from transferia_tpu_torch.recipes.fake_postgres import FakePG, FakeTable
from transferia_tpu_torch.tasks import activate_delivery
pg, ch = FakePG().start(), FakeCH().start()
pg.add_table(FakeTable("public", "hits", [
    ("id", "bigint", True, True), ("region", "integer", False, False)],
    [{"id": str(i), "region": str(i %% 500)} for i in range(1000)]))
pg2ch = Transfer(id="iso-pg", src=PGSourceParams(host="127.0.0.1",
    port=pg.port), dst=CHTargetParams(host="127.0.0.1", port=ch.port,
    bufferer=None), transformation={"transformers": [
        {"filter_rows": {"filter": "region < 400"}}]})
activate_delivery(pg2ch, MemoryCoordinator(), device="cpu")
assert ch.total_rows() == 800, ch.total_rows()
assert len(ch.rows("__trtpu_commits")) == 1
pg.stop()
ch.stop()
from transferia_tpu_torch.parsers import Message, make_parser
from transferia_tpu_torch.recipes.fake_sr import FakeSchemaRegistry
import urllib.request
sr = FakeSchemaRegistry().start()
sid = json.loads(urllib.request.urlopen(urllib.request.Request(
    sr.url + "/subjects/h-value/versions", data=json.dumps({"schema":
    json.dumps({"type": "record", "name": "H", "fields": [
        {"name": "id", "type": "long"}]})}).encode()),
    timeout=10).read())["id"]
srp = make_parser({"confluent_schema_registry": {"registry_url": sr.url}})
res = srp.do_batch([Message(value=bytes(1) + sid.to_bytes(4, "big")
                            + bytes([2 * i]), offset=i) for i in range(5)])
assert res.batches[0].column("id").data.tolist() == list(range(5))
sr.stop()
from transferia_tpu_torch.providers.kafka import KafkaTargetParams
from transferia_tpu_torch.providers.mysql import MySQLSourceParams
from transferia_tpu_torch.recipes.fake_mysql import FakeMySQL, FakeMyTable
import transferia_tpu_torch.serializers  # noqa
my, kf = FakeMySQL().start(), FakeKafka(n_partitions=4).start()
my.add_table(FakeMyTable("db", "users", [
    ("id", "bigint", "bigint", True, True),
    ("email", "varchar", "varchar(255)", False, False)],
    [{"id": i, "email": f"u{i}@e.test"} for i in range(1000)]))
my2kf = Transfer(id="iso-my", src=MySQLSourceParams(host="127.0.0.1",
    port=my.port, database="db"), dst=KafkaTargetParams(
    brokers=[f"127.0.0.1:{kf.port}"], topic="cdc", serializer="debezium"),
    transformation={"transformers": [
        {"mask_field": {"columns": ["email"], "salt": "s"}}]})
activate_delivery(my2kf, MemoryCoordinator(), device="cpu")
assert kf.live_size("cdc") == 1000 and len(kf.txns) == 1, kf.txns
dbz = make_parser({"debezium": {}}).do_batch([
    Message(value=r.value, key=r.key, offset=r.offset)
    for r in kf.records("cdc", 0)])
assert sum(b.n_rows for b in dbz.batches) == len(kf.records("cdc", 0)) > 0
my.stop()
kf.stop()
from transferia_tpu_torch.providers.mysql.binlog import BinlogReader
from transferia_tpu_torch.providers.mysql.gtid import GtidSet
from transferia_tpu_torch.providers.postgres.replication import (
    Wal2JsonDecoder, int_to_lsn)
from transferia_tpu_torch.recipes import cdc
from transferia_tpu_torch.recipes.fake_postgres import FakePG
binlog = FakeMySQL()
last = cdc.feed_users_binlog(binlog, cdc.users_changes(70, 20, 10))
reader = BinlogReader()
rows = [ev for body in binlog.binlog_events
        for ev in reader.parse_event(body) if ev[0] == "row"]
assert len(rows) == 100 and last == 1, (len(rows), last)
gtids = GtidSet.parse(f"{cdc.USERS_SID}:1-{last}")
assert GtidSet.decode(gtids.encode()) == gtids
wal = FakePG()
cdc.feed_hits_wal(wal, 10)
dec = Wal2JsonDecoder()
items = [dec.decode(p, lsn) for lsn, p in wal.wal]
assert sum(it is not None for it in items) == 10, items
assert int_to_lsn(wal.wal[-1][0]) == "0/2058"
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.models import TransferType
from transferia_tpu_torch.mvcc import compact, pump  # noqa: F401
from transferia_tpu_torch.mvcc.runner import resume_state
from transferia_tpu_torch.providers.clickhouse import CHStorage  # noqa
from transferia_tpu_torch.factories import new_storage
from transferia_tpu_torch.providers.memory import (
    MemorySourceParams, MemoryStorage, MemoryStoreStorage, seed_source)
from transferia_tpu_torch.tasks.checksum import ChecksumParameters, checksum
sai = Transfer(id="iso-sai", type=TransferType.SNAPSHOT_AND_INCREMENT,
    src=SampleSourceParams(preset="users", table="users", rows=300),
    dst=MemoryTargetParams(sink_id="iso-sai"))
sai_cp = MemoryCoordinator()
activate_delivery(sai, sai_cp, device="cpu")
assert resume_state(sai_cp, "iso-sai") == {"watermark": -1, "epoch": 1}
# the source's rows as a memory source: MemoryStoreStorage counts no
# rows (as the reference's does), so the source side must not either
src_batches = []
new_storage(sai).load_table(TableDescription(id=TableID("sample", "users")),
                            src_batches.append)
seed_source("iso-chk", src_batches)
for method, backend in (("compare", "auto"), ("fingerprint", "host"),
                        ("fingerprint", "device")):
    rep = checksum(MemoryStorage(MemorySourceParams(source_id="iso-chk")),
                   MemoryStoreStorage("iso-sai"), device="cpu",
                   params=ChecksumParameters(method=method,
                                             fingerprint_backend=backend))
    assert rep.ok, rep.summary()
with open("/proc/self/maps") as fh:
    maps = {line.split()[-1] for line in fh if "libhostops" in line}
print("MAPS", json.dumps(sorted(maps)))
set_placement(None)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pyarrow",
                                    "transferia_tpu"))
print("LOADED", bad)
""" % (CONFIG, CONFIG, CONFIG, CONFIG)


def test_port_runs_without_jax_or_the_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
    (maps,) = [line for line in proc.stdout.splitlines()
               if line.startswith("MAPS ")]
    mapped = json.loads(maps[5:])
    assert len(mapped) == 1, mapped
    assert mapped[0].startswith(os.path.join(REPO, "build", "torch_kernels",
                                             "libhostops-")), mapped


_TELEMETRY_CHILD = """
import sys
import transferia_tpu_torch.chaos, transferia_tpu_torch.chaos.sites  # noqa
from transferia_tpu_torch.chaos import failpoints
from transferia_tpu_torch.runtime import lockwatch
from transferia_tpu_torch.stats import (hdr, ledger, profiler, stagetimer,
                                        trace, watermark)
from transferia_tpu_torch.stats.registry import ChaosStats, DeviceStats
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.transform import build_chain
from transferia_tpu_torch.transform.fused import set_placement

noop = trace.span("a")
assert noop is trace.span("b") and not noop, noop
trace.enable(True)
stagetimer.enable(True)
lockwatch.arm()
failpoints.configure("rowhash.pool_accs=times:1")
schema = new_table_schema([("url", "utf8"), ("region", "int32")])
batch = ColumnBatch.from_pydict(TableID("", "t"), schema, {
    "url": [f"u{i}" for i in range(300)], "region": list(range(300, 600))})
set_placement("device")
with profiler.profile(hz=200) as p:
    with ledger.LEDGER.context(transfer_id="iso"):
        out = build_chain(%r, device="cpu").apply(batch)
assert out.n_rows == 100, out.n_rows
names = {s[0] for s in trace.spans()}
assert {"fused_run", "device_dispatch", "device_wait"} <= names, names
assert trace.TELEMETRY.snapshot()["device_launches"] == 1
assert ledger.LEDGER.snapshot()["conservation"]["ok"]
print(trace.format_summary())
print(stagetimer.format_breakdown(1.0))
print(p.report.format(3))
lockwatch.disarm()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pyarrow",
                                    "prometheus_client", "transferia_tpu"))
print("LOADED", bad)
""" % (CONFIG,)


def test_telemetry_plane_imports_nothing_of_jax():
    """Every telemetry module of the port, with tracing, the stage
    timer, the lock watch, a failpoint and the profiler on over a fused
    chain: no jax (nor jax.monitoring), no prometheus_client, nothing of
    the JAX package is loaded."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.pop("TRANSFERIA_TPU_FAILPOINTS", None)
    proc = subprocess.run([sys.executable, "-c", _TELEMETRY_CHILD],
                          cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
    assert "device: launches=1" in proc.stdout, proc.stdout


def small_batch():
    schema = new_table_schema([("url", "utf8"), ("region", "int32")])
    return ColumnBatch.from_pydict(TableID("", "t"), schema, {
        "url": ["a", "b"], "region": [1, 500]})


@pytest.mark.parametrize("device", [None, "cuda"])
def test_no_silent_cpu_fallback(device, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(device)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedMaskFilterProgram([b"k"], None, device)
    set_placement("device")
    try:
        chain = build_chain(CONFIG, device=device)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            chain.apply(small_batch())
    finally:
        set_placement(None)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_mesh_needs_a_card_or_the_cpu(device, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedFusedProgram([b"k"], None, device=device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharded_transform_step(make_mesh(device=device))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(devices=[device or "cuda"])
    cpu_mesh = make_mesh(device="cpu")
    assert ShardedFusedProgram([b"k"], None, cpu_mesh).n_dev == 1
    assert ShardedFusedProgram([b"k"], None, device="cpu").n_dev == 1
    assert sharded_transform_step(cpu_mesh).mesh is cpu_mesh


@pytest.mark.parametrize("device", [None, "cuda"])
def test_fingerprint_needs_a_card_or_the_cpu(device, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TableFingerprinter(device=device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TableFingerprinter(backend="device", device=device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceFingerprintProgram(device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_row_keys(small_batch(), backend="device", device=device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_row_keys(small_batch(), device=device)
    if device is None:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            batch_row_keys(small_batch())
    keys = batch_row_keys(small_batch(), backend="device", device="cpu")
    assert keys.shape == (2,)


def test_explicit_cpu_runs_plain_versions():
    set_placement("device")
    try:
        out = build_chain(CONFIG, device="cpu").apply(small_batch())
    finally:
        set_placement(None)
    assert out.n_rows == 1
    assert len(bytes(out.column("url").data)) == 64


def test_unported_transformer_names_the_ported_ones():
    with pytest.raises(KeyError, match="not yet ported") as err:
        build_chain({"transformers": [{"sharder": {"shard_count": 2}}]},
                    device="cpu")
    for name in ("filter_rows", "lambda", "mask_field", "rename_columns",
                 "rename_tables"):
        assert name in str(err.value)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_lambda_needs_a_card_or_the_cpu(device, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chain = build_chain({"transformers": [{"lambda": {
        "function": "transferia_tpu_torch.ops.lambdas:bench_lambda"}}]},
        device=device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chain.apply(small_batch())
    # a rename plans no device step, so it runs anywhere
    out = build_chain({"transformers": [{"rename_tables": {"tables": [
        {"from": ".t", "to": ".u"}]}}]}, device=device).apply(small_batch())
    assert out.table_id == TableID("", "u")


@pytest.mark.parametrize("device", [None, "cuda"])
def test_snapshot_needs_a_card_or_the_cpu(device, monkeypatch):
    from transferia_tpu_torch.coordinator import MemoryCoordinator
    from transferia_tpu_torch.factories import make_async_sink, make_sinker
    from transferia_tpu_torch.models import Transfer
    from transferia_tpu_torch.providers.memory import (
        MemorySourceParams,
        MemoryTargetParams,
    )
    from transferia_tpu_torch.tasks import SnapshotLoader, upload

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = Transfer(id="nocard", src=MemorySourceParams(source_id="nocard"),
                 dst=MemoryTargetParams(sink_id="nocard"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SnapshotLoader(t, MemoryCoordinator(), device=device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_async_sink(t, device=device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sinker(t, device=device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        upload(t, MemoryCoordinator(), ["src.t"], device=device)
    make_async_sink(t, device="cpu").close()


@pytest.mark.parametrize("device", [None, "cuda"])
def test_activation_needs_a_card_or_the_cpu(device, monkeypatch):
    from transferia_tpu_torch.coordinator import MemoryCoordinator
    from transferia_tpu_torch.models import Transfer
    from transferia_tpu_torch.providers.clickhouse import CHTargetParams
    from transferia_tpu_torch.providers.postgres import PGSourceParams
    from transferia_tpu_torch.tasks import activate_delivery

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = Transfer(id="nocard-pg", src=PGSourceParams(),
                 dst=CHTargetParams())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        activate_delivery(t, MemoryCoordinator(), device=device)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_my2kf_needs_a_card_or_the_cpu(device, monkeypatch):
    from transferia_tpu_torch.coordinator import MemoryCoordinator
    from transferia_tpu_torch.models import Transfer
    from transferia_tpu_torch.providers.kafka import KafkaTargetParams
    from transferia_tpu_torch.providers.mysql import MySQLSourceParams
    from transferia_tpu_torch.tasks import activate_delivery

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = Transfer(id="nocard-my", src=MySQLSourceParams(),
                 dst=KafkaTargetParams(topic="cdc", serializer="debezium"),
                 transformation={"transformers": [
                     {"mask_field": {"columns": ["email"], "salt": "s"}}]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        activate_delivery(t, MemoryCoordinator(), device=device)


def test_pass_through_plan_needs_no_device():
    # a chain with no fusable run plans no device step, so it runs
    # anywhere (the filter alone stays on the vectorized host path)
    batch = small_batch()
    chain = build_chain({"transformers": [
        {"filter_rows": {"filter": "region < 400"}}]})
    assert np.array_equal(chain.apply(batch).column("region").data, [1])


@pytest.mark.parametrize("device", [None, "cuda"])
def test_replication_needs_a_card_or_the_cpu(device, monkeypatch):
    from transferia_tpu_torch.coordinator import MemoryCoordinator
    from transferia_tpu_torch.models import Transfer, TransferType
    from transferia_tpu_torch.providers.memory import (
        MemoryTargetParams,
        get_store,
    )
    from transferia_tpu_torch.providers.sample import SampleSourceParams
    from transferia_tpu_torch.runtime.local import LocalWorker, run_replication

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = Transfer(id="nocard-repl", type=TransferType.INCREMENT_ONLY,
                 src=SampleSourceParams(rows=0, replication_batch=64),
                 dst=MemoryTargetParams(sink_id="nocard-repl"))
    cp = MemoryCoordinator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_replication(t, cp, device=device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalWorker(t, cp, device=device)
    assert cp.get_status("nocard-repl").value == "new"
    # "cpu" runs: the worker pumps the sample stream until stopped
    worker = LocalWorker(t, cp, device="cpu")
    store = get_store("nocard-repl")
    store.clear()
    stopper = threading.Timer(0.3, worker.stop)
    stopper.start()
    worker.run()
    stopper.join()
    assert store.row_count() >= 64


def test_cdc_tails_are_ported_and_left_outs_name_their_items():
    """The binlog tail, the MySQL target and Postgres logical replication
    no longer raise, nor does the SNAPSHOT_AND_INCREMENT activation (the
    MVCC cutover); its one left-out part, a configured dbt step, and the
    DBLog snapshot raise naming their items."""
    from transferia_tpu_torch.coordinator import MemoryCoordinator
    from transferia_tpu_torch.models import Transfer, TransferType
    from transferia_tpu_torch.providers.memory import MemoryTargetParams
    from transferia_tpu_torch.providers.mysql import (
        MySQLSourceParams,
        MySQLTargetParams,
    )
    from transferia_tpu_torch.providers.postgres import PGSourceParams
    from transferia_tpu_torch.providers.registry import get_provider
    from transferia_tpu_torch.tasks import activate_delivery

    my = get_provider("mysql", Transfer(
        id="t", src=MySQLSourceParams(), dst=MySQLTargetParams()),
        device="cpu")
    assert type(my.source()).__name__ == "MySQLBinlogSource"
    assert type(my.sinker()).__name__ == "MySQLSinker"
    pg = Transfer(id="t", src=PGSourceParams(),
                  dst=MemoryTargetParams(sink_id="t"))
    assert type(get_provider("pg", pg, device="cpu").source()).__name__ \
        == "PGReplicationSource"
    dblog = Transfer(id="t", src=PGSourceParams(dblog_snapshot=True),
                     dst=MemoryTargetParams(sink_id="t"))
    with pytest.raises(NotImplementedError, match="DBLog.*ROADMAP.md A10"):
        get_provider("pg", dblog, device="cpu").source()
    sni = Transfer(id="t-sni", type=TransferType.SNAPSHOT_AND_INCREMENT,
                   src=MySQLSourceParams(), dst=MySQLTargetParams(),
                   transformation={"transformers": [{"dbt": {}}]})
    with pytest.raises(NotImplementedError, match="dbt.*ROADMAP.md A7"):
        activate_delivery(sni, MemoryCoordinator(), device="cpu")
