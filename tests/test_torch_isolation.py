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
(compare, and the fingerprint's host lanes and device route), runs a
two-worker sharded snapshot on the filestore coordinator (the workers as
threads) and a Kafka -> `fs` partitioned replication into staged JSONL
files, runs the CLI's `validate` on every example, and snapshots
ClickBench Parquet objects from the port's fake S3 by two workers on the
S3 coordinator; afterwards neither jax, pyarrow, yaml, fsspec, s3fs,
transferia_tpu nor any transferia_tpu.* module may be loaded, and
the only host library mapped is the port's own build.
A second fresh interpreter imports every module of the telemetry plane
and turns tracing, the stage timer, the lock watch, a failpoint and the
profiler on over a fused chain: neither jax, jax.monitoring, yaml,
prometheus_client nor the JAX package may be loaded, and a disabled
span is the shared no-op singleton.
A third imports the fleet (`fleet/`, `stats/fleetobs.py`, `stats/slo.py`,
`stats/critpath.py`, `mvcc/compact.py`), runs a fleet worker over two
`sample_snapshot` tickets with the mask and the filter (one preempted at
a part boundary and resumed) and reads the segments back through the
merge, the SLO evaluation and the critical path: again nothing of jax,
prometheus_client or the JAX package is loaded.
A fourth imports the chaos runner, the lint and the in-memory broker
(`chaos/`, `analysis/`, `providers/mq.py`), runs a seeded snapshot trial
and `check --strict` on the CPU: again nothing of jax, pyarrow or the
JAX package is loaded.
And without CUDA, an entry point that was not asked for the CPU raises
instead of running there (the CLI too, unless given `--device cpu`).
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
# a sharded snapshot on the filestore coordinator, two workers as threads
import tempfile
from transferia_tpu_torch.coordinator import FileStoreCoordinator
shard_root = tempfile.mkdtemp()
def shard_job(i):
    t = Transfer(id="iso-shard", src=SampleSourceParams(
        preset="users", table="users", rows=600, shard_parts=3),
        dst=MemoryTargetParams(sink_id="iso-shard"),
        transformation={"transformers": [
            {"mask_field": {"columns": ["email"], "salt": "s"}}]},
        runtime=Runtime(current_job=i, sharding=ShardingUploadParams(
            job_count=2)), validation={"fingerprint": True})
    SnapshotLoader(t, FileStoreCoordinator(root=shard_root),
                   device="cpu").upload_tables()
shard_threads = [threading.Thread(target=shard_job, args=(i,))
                 for i in range(2)]
for th in shard_threads:
    th.start()
for th in shard_threads:
    th.join()
shard_cp = FileStoreCoordinator(root=shard_root)
assert shard_cp.operation_progress("op-iso-shard").done
assert get_store("iso-shard").row_count() == 600
assert shard_cp.get_operation_state("op-iso-shard")["table_fingerprints"]
# Kafka -> fs: one pipeline a partition into staged JSONL files
import os
from transferia_tpu_torch.providers.file import FileTargetParams
k2fs_kf = FakeKafka(n_partitions=2).start()
k2fs_client = KafkaClient([f"127.0.0.1:{k2fs_kf.port}"])
for part in range(2):
    k2fs_client.produce("hits", part, [Record(b"", json.dumps(
        {"id": part * 100 + i, "url": f"u{i}", "region": i}).encode())
        for i in range(50)])
k2fs = Transfer(id="iso-k2fs", type=TransferType.INCREMENT_ONLY,
    src=KafkaSourceParams(brokers=[f"127.0.0.1:{k2fs_kf.port}"],
        topic="hits", parser={"json": {"table": "hits", "schema": [
            {"name": "id", "type": "int64", "key": True},
            {"name": "url", "type": "utf8"},
            {"name": "region", "type": "int32"}]}}),
    dst=FileTargetParams(path=os.path.join(shard_root, "fs"),
                         format="jsonl"),
    transformation=%r)
k2fs_cp, k2fs_stop = MemoryCoordinator(), threading.Event()
k2fs_th = threading.Thread(target=run_replication, args=(k2fs, k2fs_cp),
    kwargs={"stop_event": k2fs_stop, "device": "cpu"}, daemon=True)
k2fs_th.start()
deadline = time.monotonic() + 60
while k2fs_cp.get_transfer_state("iso-k2fs").get("kafka_offsets") != \
        {"hits:0": 49, "hits:1": 49} and time.monotonic() < deadline:
    time.sleep(0.02)
k2fs_stop.set()
k2fs_th.join(30)
k2fs_lines = sum(len(open(os.path.join(shard_root, "fs", f)).readlines())
                 for f in os.listdir(os.path.join(shard_root, "fs"))
                 if f.endswith(".jsonl"))
assert k2fs_lines == 100, k2fs_lines
k2fs_kf.stop()
# the CLI on every example, reading the YAML with the port's own reader
import contextlib, glob, io, os
from transferia_tpu_torch.cli.main import main as cli_main
os.environ.update(PG_PASSWORD="x", MASK_SALT="s", MYSQL_PASSWORD="x",
                  PII_SALT="s")
for path in sorted(glob.glob("examples/*.yaml")):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli_main(["--device", "cpu", "--log-level", "error",
                       "validate", "--transfer", path])
    assert rc == 0, (path, rc)
# ClickBench objects on the port's fake S3 (read anonymously, by ranged
# GETs) -> the chain -> devnull, two jobs (threads) on the S3 coordinator
from transferia_tpu_torch.coordinator import S3Coordinator
from transferia_tpu_torch.providers.s3 import S3SourceParams
from transferia_tpu_torch.recipes.clickbench import clickbench_rows, slice_rows
from transferia_tpu_torch.recipes.fake_s3 import FakeS3
s3 = FakeS3(public_read=True).start()
s3_rows, s3_kept = clickbench_rows(6000), 0
with tempfile.TemporaryDirectory() as tmp:
    for i in range(3):
        _, k = write_clickbench(tmp + "/h.parquet", 2000, rows=slice_rows(
            s3_rows, 2000 * i, 2000 * (i + 1)), row_group_rows=700)
        s3_kept += k
        s3.put_object("hits/h" + str(i) + ".parquet",
                      open(tmp + "/h.parquet", "rb").read())
def s3_job(i):
    t = Transfer(id="iso-s3", src=S3SourceParams(
        url="s3://cb/hits/*.parquet", endpoint_url=s3.endpoint,
        table="hits", batch_rows=1000), dst=NullTargetParams(),
        transformation={"transformers": [
            {"mask_field": {"columns": ["URL"], "salt": "bench-salt"}},
            {"filter_rows": {"filter":
                "RegionID < 400 AND ResolutionWidth >= 390"}}]},
        runtime=Runtime(current_job=i, sharding=ShardingUploadParams(
            job_count=2, process_count=2)))
    SnapshotLoader(t, S3Coordinator(bucket="cp", endpoint=s3.endpoint,
                                    access_key="test-ak",
                                    secret_key="test-sk"),
                   device="cpu").upload_tables()
s3_threads = [threading.Thread(target=s3_job, args=(i,)) for i in range(2)]
for th in s3_threads:
    th.start()
for th in s3_threads:
    th.join()
s3_cp = S3Coordinator(bucket="cp", endpoint=s3.endpoint,
                      access_key="test-ak", secret_key="test-sk")
assert s3_cp.operation_progress("op-iso-s3").done
assert s3_cp.operation_progress("op-iso-s3").completed_rows == 6000
assert len(s3_cp.operation_parts("op-iso-s3")) == 3 and s3.range_gets >= 9
s3.stop()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pyarrow", "yaml",
                                    "fsspec", "s3fs", "transferia_tpu"))
print("LOADED", bad)
""" % (CONFIG, CONFIG, CONFIG, CONFIG, CONFIG)


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
             if m.split(".")[0] in ("jax", "jaxlib", "pyarrow", "yaml",
                                    "fsspec", "s3fs", "prometheus_client",
                                    "transferia_tpu"))
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


_FLEET_CHILD = """
import sys
import time
from transferia_tpu_torch import fleet
from transferia_tpu_torch.abstract.ticket import FleetTicket
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.fleet import autoscaler, bench, leader
from transferia_tpu_torch.fleet.distributed import DistributedFleetScheduler
from transferia_tpu_torch.fleet.worker import FleetWorker
from transferia_tpu_torch.mvcc import compact
from transferia_tpu_torch.providers.memory import get_store
from transferia_tpu_torch.stats import critpath, fleetobs, slo, trace

chain = {"transformers": [
    {"mask_field": {"columns": ["email"], "salt": "s"}},
    {"filter_rows": {"filter": "age >= 21"}}]}
cp = MemoryCoordinator(lease_seconds=30)
s = DistributedFleetScheduler(cp, queue="q", capacity=lambda: 1)


def ticket(i, qos, rows):
    return FleetTicket(ticket_id=f"t{i}", transfer_id=f"tr{i}", qos=qos,
                       payload={"kind": "sample_snapshot", "rows": rows,
                                "preset": "users", "table": "users",
                                "shard_parts": 4, "sink_id": f"iso{i}",
                                "operation_id": f"op-iso{i}",
                                "transformation": chain})


s.submit(ticket(0, "batch", 2000))
holder = {}


def hook(t, boundary):
    if t.ticket_id == "t0" and boundary == 2 and "fired" not in holder:
        holder["fired"] = 1
        s.submit(ticket(1, "interactive", 500))
        s.preempt_if_needed()
        while not holder["w"]._revoked:
            time.sleep(0.005)


trace.enable(True)
w = holder["w"] = FleetWorker(cp, queue="q", max_tickets=2,
                              heartbeat_interval=0.02, device="cpu",
                              part_boundary_hook=hook,
                              idle_exit_seconds=20.0)
w.run()
trace.enable(False)
assert [c[0] for c in w.claim_log] == ["t0", "t1", "t0"], w.claim_log
assert all(t.state == "done" for t in cp.list_tickets("q"))
segs = cp.list_obs_segments(fleetobs.default_scope())
view = fleetobs.merge_segments(segs)
assert view["transfers"]["tr0"]["rows_out"] == get_store("iso0").row_count()
assert "objectives" in slo.evaluate(segs)
assert critpath.explain(critpath.records_from_segments(segs), "tr0")["spans"]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pyarrow", "yaml",
                                    "fsspec", "s3fs", "prometheus_client",
                                    "transferia_tpu"))
print("LOADED", bad)
"""


def test_fleet_plane_imports_nothing_of_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.pop("TRANSFERIA_TPU_FAILPOINTS", None)
    proc = subprocess.run([sys.executable, "-c", _FLEET_CHILD],
                          cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


@pytest.mark.parametrize("device", [None, "cuda"])
def test_fleet_needs_a_card_or_the_cpu(device, monkeypatch):
    """The fleet worker, a ticket's run context, the fleet bench and
    the `worker` command raise without a card unless asked for the
    CPU."""
    from transferia_tpu_torch.cli import main as cli_main
    from transferia_tpu_torch.coordinator import MemoryCoordinator
    from transferia_tpu_torch.fleet.bench import run_fleet_bench
    from transferia_tpu_torch.fleet.worker import (
        FleetWorker,
        TicketRunContext,
    )
    from transferia_tpu_torch.stats.registry import Metrics

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cp = MemoryCoordinator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetWorker(cp, device=device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TicketRunContext(cp, Metrics(), lambda: False, False, "w0", "q",
                         device=device)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fleet_bench(transfers=4, workers=1, device=device)
    argv = ["worker", "--idle-exit", "0.1"]
    if device is not None:
        argv = ["--device", device] + argv
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main.main(argv)
    assert FleetWorker(cp, device="cpu").device.type == "cpu"


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


@pytest.mark.parametrize("device", [None, "cuda"])
def test_partitioned_worker_and_secondary_need_a_card_or_the_cpu(
        device, monkeypatch, tmp_path):
    from transferia_tpu_torch.coordinator import FileStoreCoordinator
    from transferia_tpu_torch.models import (
        Runtime,
        ShardingUploadParams,
        Transfer,
        TransferType,
    )
    from transferia_tpu_torch.providers.file import FileTargetParams
    from transferia_tpu_torch.providers.kafka import KafkaSourceParams
    from transferia_tpu_torch.providers.sample import SampleSourceParams
    from transferia_tpu_torch.runtime.local import PartitionedWorker
    from transferia_tpu_torch.tasks import SnapshotLoader

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cp = FileStoreCoordinator(root=str(tmp_path / "cp"))
    t = Transfer(id="nocard-k2fs", type=TransferType.INCREMENT_ONLY,
                 src=KafkaSourceParams(topic="hits"),
                 dst=FileTargetParams(path=str(tmp_path / "fs"),
                                      format="jsonl"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PartitionedWorker(t, cp, device=device)
    sec = Transfer(id="nocard-sec", src=SampleSourceParams(rows=10),
                   dst=FileTargetParams(path=str(tmp_path / "fs"),
                                        format="jsonl"),
                   runtime=Runtime(current_job=1, sharding=(
                       ShardingUploadParams(job_count=2))))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SnapshotLoader(sec, cp, device=device)
    assert PartitionedWorker(t, cp, device="cpu").device.type == "cpu"


def test_cdc_tails_are_ported_and_left_outs_name_their_items():
    """The binlog tail, the MySQL target and Postgres logical replication
    no longer raise, nor does the SNAPSHOT_AND_INCREMENT activation (the
    MVCC cutover); its one left-out part, a configured dbt step, and the
    DBLog snapshot raise naming their items.  Every ROADMAP.md item the
    port's code names is an open item of ROADMAP.md's queue A."""
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
    with pytest.raises(NotImplementedError, match="DBLog.*ROADMAP.md A7"):
        get_provider("pg", dblog, device="cpu").source()
    sni = Transfer(id="t-sni", type=TransferType.SNAPSHOT_AND_INCREMENT,
                   src=MySQLSourceParams(), dst=MySQLTargetParams(),
                   transformation={"transformers": [{"dbt": {}}]})
    with pytest.raises(NotImplementedError, match="dbt.*ROADMAP.md A7"):
        activate_delivery(sni, MemoryCoordinator(), device="cpu")
    import re

    roadmap = open(os.path.join(REPO, "ROADMAP.md")).read()
    queue_a = roadmap.split("### A.", 1)[1].split("### B.", 1)[0]
    open_items = set(re.findall(r"^(\d+)\. \*\*", queue_a, re.M))
    named = {}
    for root, _, files in os.walk(os.path.join(REPO,
                                               "transferia_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                for m in re.finditer(r"ROADMAP\.md\s+A(\d+)",
                                     open(path).read()):
                    named.setdefault(m.group(1), []).append(
                        os.path.relpath(path, REPO))
    assert named and set(named) <= open_items, \
        {k: v for k, v in named.items() if k not in open_items}


def test_cli_needs_a_card_or_the_cpu(monkeypatch):
    """Without a card the CLI raises unless `--device cpu`."""
    from transferia_tpu_torch.cli.main import main as cli_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PG_PASSWORD", "x")
    path = os.path.join(REPO, "examples", "pg2ch.yaml")
    for argv in (["validate", "--transfer", path], ["describe"],
                 ["--device", "cuda", "activate", "--transfer", path]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_main(argv)
    assert cli_main(["--device", "cpu", "--log-level", "error", "validate",
                     "--transfer", path]) == 0


_A2_CHILD = """
import json, os, sys, tempfile, urllib.request
import transferia_tpu_torch.events  # noqa
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.providers import misc_providers
from transferia_tpu_torch.providers.clickhouse import CHTargetParams, a2
from transferia_tpu_torch.recipes.clickbench import write_clickbench
from transferia_tpu_torch.recipes.fake_clickhouse import FakeCH
from transferia_tpu_torch.stats import exposition
from transferia_tpu_torch.tasks.snapshot_v2 import upload_v2
from transferia_tpu_torch.transform.plugins import (convert, logger_tf, misc,
                                                    pk)

root = os.path.join(tempfile.mkdtemp(), "hits")
os.makedirs(os.path.join(root, "_delta_log"))
_, kept = write_clickbench(os.path.join(root, "a.parquet"), 3000,
                           row_group_rows=1000)
with open(os.path.join(root, "_delta_log", "0.json"), "w") as fh:
    fh.write(json.dumps({"add": {"path": "a.parquet"}}))
ch = FakeCH().start()
chain = {"transformers": [
    {"replace_primary_key": {"keys": ["WatchID"]}},
    {"mask_field": {"columns": ["URL"], "salt": "s"}},
    {"filter_rows": {"filter": "RegionID < 400 AND ResolutionWidth >= 390"}},
    {"number_to_float": {}}, {"logger": {}}]}
for tid, tf in (("a", None), ("b", chain)):
    t = Transfer(id=tid, src=misc_providers.DeltaSourceParams(
        path=root, table=tid, batch_rows=1024),
        dst=CHTargetParams(host="127.0.0.1", port=ch.port, bufferer=None),
        transformation=tf)
    upload_v2(t, MemoryCoordinator(),
              misc_providers.DeltaSnapshotProvider(t.src), device="cpu")
assert len(ch.rows("a")) == 3000 and len(ch.rows("b")) == kept, kept
ch.stop()
srv = exposition.start_http_server(0, "127.0.0.1")
body = urllib.request.urlopen(
    f"http://127.0.0.1:{srv.server_address[1]}/metrics").read()
assert b"python_info" in body
srv.shutdown()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pyarrow", "yaml",
                                    "fsspec", "s3fs", "prometheus_client",
                                    "transferia_tpu"))
print("LOADED", bad)
"""


def test_event_model_delta_logsinks_and_metrics_import_nothing_of_jax():
    """The event model, the Delta source, the ClickHouse a2 target, the
    log sinks, the four host transformers and the metrics exposition,
    run on a Delta table the port's recipe writer made: no jax, pyarrow,
    prometheus_client or JAX package module is loaded."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _A2_CHILD], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


@pytest.mark.parametrize("side,text", [
    ("src", "{type: delta, params: {path: /tmp/t, table: hits}}"),
    ("dst", "{type: coralogix, params: {private_key: k}}"),
    ("dst", "{type: datadog, params: {api_key: k}}"),
])
def test_delta_and_the_log_sinks_are_accepted(side, text):
    from transferia_tpu_torch.cli.config import parse_transfer_yaml

    other = "dst: {type: memory, params: {sink_id: x}}" if side == "src" \
        else "src: {type: memory, params: {}}"
    t = parse_transfer_yaml(f"id: x\n{side}: {text}\n{other}\n")
    assert getattr(t, side).PROVIDER == text.split(",")[0].split()[-1]


def test_metrics_port_no_longer_exits_2():
    import socket

    from transferia_tpu_torch.cli.main import LEFT_OUT
    from transferia_tpu_torch.cli.main import main as cli_main

    assert "--metrics-port" not in LEFT_OUT
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert cli_main(["--device", "cpu", "--log-level", "error",
                     "--metrics-port", str(port), "describe"]) == 0


@pytest.mark.parametrize("device", [None, "cuda"])
def test_delta_activation_needs_a_card_or_the_cpu(device, monkeypatch,
                                                  tmp_path):
    from transferia_tpu_torch.coordinator import MemoryCoordinator
    from transferia_tpu_torch.models import Transfer
    from transferia_tpu_torch.providers.memory import MemoryTargetParams
    from transferia_tpu_torch.providers.misc_providers import (
        DeltaSnapshotProvider,
        DeltaSourceParams,
    )
    from transferia_tpu_torch.tasks import activate_delivery
    from transferia_tpu_torch.tasks.snapshot_v2 import (
        make_event_target,
        upload_v2,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = Transfer(id="nocard-delta", src=DeltaSourceParams(
        path=str(tmp_path)), dst=MemoryTargetParams(sink_id="nocard"))
    for call in (lambda: activate_delivery(t, MemoryCoordinator(),
                                           device=device),
                 lambda: make_event_target(t, device=device),
                 lambda: upload_v2(t, MemoryCoordinator(),
                                   DeltaSnapshotProvider(t.src),
                                   device=device)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


_CHAOS_CHILD = """
import io, sys
from contextlib import redirect_stdout
import transferia_tpu_torch.analysis, transferia_tpu_torch.analysis.rules  # noqa
from transferia_tpu_torch.chaos import invariants, runner, wire_backends
from transferia_tpu_torch.cli.main import main as cli_main
from transferia_tpu_torch.providers import mq

report = runner.run_trials(trials=1, seed=7, mode="snapshot", rows=512,
                           device="cpu")
assert report.passed, report.format_summary()
assert report.results[0].fire_counts.get("device.dispatch"), report.results
broker = mq.get_broker("iso-mq", 2)
broker.produce("t", b"k", b"v")
assert broker.size("t") == 1
assert not wire_backends.backend_available("ydb")[0]
out = io.StringIO()
with redirect_stdout(out):
    rc = cli_main(["--log-level", "error", "check", "--strict"])
assert rc == 0 and "0 new finding(s)" in out.getvalue(), out.getvalue()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pyarrow", "yaml",
                                    "fsspec", "s3fs", "prometheus_client",
                                    "transferia_tpu"))
print("LOADED", bad)
"""


def test_chaos_lint_and_mq_import_nothing_of_jax():
    """`chaos/`, `analysis/` and `providers/mq.py` in a fresh
    interpreter: a seeded snapshot trial on the CPU (the fused step's
    device.dispatch site on its path) and `check --strict` over the
    port's tree, with no jax, pyarrow or JAX package module loaded."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.pop("TRANSFERIA_TPU_FAILPOINTS", None)
    proc = subprocess.run([sys.executable, "-c", _CHAOS_CHILD], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


@pytest.mark.parametrize("device", [None, "cuda"])
def test_chaos_needs_a_card_or_the_cpu(device, monkeypatch):
    """`run_trials` and the `chaos` command raise without a card unless
    asked for the CPU, before any trial runs; `check` runs no device
    work and needs none."""
    from transferia_tpu_torch.chaos import runner
    from transferia_tpu_torch.cli.main import main as cli_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.run_trials(trials=1, mode="snapshot", device=device)
    argv = ["chaos", "--mode", "snapshot", "--trials", "1"]
    if device is not None:
        argv = ["--device", device] + argv
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(argv)
    assert cli_main(["--log-level", "error", "check", "--list-rules"]) == 0
