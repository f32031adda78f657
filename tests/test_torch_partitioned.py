"""Kafka -> `fs` partitioned replication (`runtime/local.py::
PartitionedWorker`, `providers/kafka/provider.py::_KafkaQueueClient(
partitions=)`) and the `fs` sink (`providers/file.py::FileSinker`,
`providers/staging.py::DirectoryPartStage`) against the JAX package, on
the CPU.

- Both packages' `run_replication` over the port's fake Kafka (4
  partitions) into `fs` `jsonl` through the mask: one pipeline and one
  file a partition, equal rows a file, equal committed offsets; a
  failing pipeline stops the others and fails the attempt in both.
- `FileSinker` with `DirectoryPartStage`: publish, abort, replace, the
  stale-epoch fence and a torn write's replay, file names (the sinker's
  random token aside) and contents equal to the JAX package's; the
  provider's cleanup; the `parquet` format refused naming ROADMAP.md A7.
"""

import json
import os
import re
import threading
import time

import pytest

from transferia_tpu.abstract.errors import \
    StaleEpochPublishError as RefStale
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models import TransferType as RefTransferType
from transferia_tpu.providers import file as ref_file
from transferia_tpu.providers.kafka import \
    KafkaSourceParams as RefKafkaParams
from transferia_tpu.runtime import local as ref_local
from transferia_tpu_torch.abstract.errors import StaleEpochPublishError
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.factories import make_sinker
from transferia_tpu_torch.models import Transfer, TransferType
from transferia_tpu_torch.providers import file as port_file
from transferia_tpu_torch.providers.kafka import KafkaSourceParams
from transferia_tpu_torch.providers.kafka.client import KafkaClient
from transferia_tpu_torch.providers.kafka.protocol import Record
from transferia_tpu_torch.recipes.fake_kafka import FakeKafka
from transferia_tpu_torch.runtime import local as port_local

PARTITIONS, PER_PARTITION = 4, 300
SCHEMA = [{"name": "id", "type": "int64", "key": True},
          {"name": "url", "type": "utf8"}, {"name": "region", "type": "int32"}]
MASK = {"transformers": [{"mask_field": {"columns": ["url"],
                                         "salt": "part-salt"}}]}

PKGS = {
    "port": dict(transfer=Transfer, ttype=TransferType,
                 kafka=KafkaSourceParams, file=port_file,
                 cp=MemoryCoordinator, local=port_local,
                 kw={"device": "cpu"}),
    "jax": dict(transfer=RefTransfer, ttype=RefTransferType,
                kafka=RefKafkaParams, file=ref_file, cp=RefCoordinator,
                local=ref_local, kw={}),
}


def wait_for(cond, seconds: float = 60.0) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("timed out")
        time.sleep(0.02)


def message(p: int, i: int) -> bytes:
    k = p * 1000 + i
    return json.dumps({"id": k, "url": f"https://e.test/{k % 97}",
                       "region": k % 500}).encode()


@pytest.fixture
def broker():
    kf = FakeKafka(n_partitions=PARTITIONS).start()
    c = KafkaClient([f"127.0.0.1:{kf.port}"])
    for p in range(PARTITIONS):
        c.produce("hits", p, [Record(b"", message(p, i))
                              for i in range(PER_PARTITION)])
    c.close()
    yield kf
    kf.stop()


def transfer(p, port: int, out: str):
    return p["transfer"](
        id="k2fs", type=p["ttype"].INCREMENT_ONLY,
        src=p["kafka"](brokers=[f"127.0.0.1:{port}"], topic="hits",
                       parser={"json": {"table": "hits",
                                        "schema": SCHEMA}}),
        dst=p["file"].FileTargetParams(path=out, format="jsonl"),
        transformation=MASK)


def read_files(out: str) -> dict:
    """Each jsonl file's rows (sorted), keyed by the partition its ids
    come from."""
    files = {}
    for name in os.listdir(out):
        if name.startswith("."):
            continue
        with open(os.path.join(out, name)) as fh:
            rows = sorted((json.loads(ln) for ln in fh),
                          key=lambda r: r["id"])
        files[rows[0]["id"] // 1000] = rows
    return files


def replicate(pkg: str, port: int, out: str) -> tuple:
    p = PKGS[pkg]
    t = transfer(p, port, out)
    assert p["local"].is_partitioned_replication(t)
    cp, stop = p["cp"](), threading.Event()
    workers = []
    real = p["local"].PartitionedWorker

    class Recorded(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            workers.append(self)

    p["local"].PartitionedWorker = Recorded
    try:
        th = threading.Thread(target=p["local"].run_replication,
                              args=(t, cp), kwargs={"stop_event": stop,
                                                    **p["kw"]},
                              daemon=True)
        th.start()
        want = {f"hits:{q}": PER_PARTITION - 1 for q in range(PARTITIONS)}
        wait_for(lambda: cp.get_transfer_state("k2fs").get(
            "kafka_offsets") == want)
        stop.set()
        th.join(30)
        assert not th.is_alive()
    finally:
        p["local"].PartitionedWorker = real
    return (read_files(out), cp.get_transfer_state("k2fs"), len(workers),
            len(workers[0]._pipelines))


def test_partitioned_replication_equals_jax(broker, tmp_path):
    got = replicate("port", broker.port, str(tmp_path / "port"))
    # the committed offsets are the transfer's: the JAX run starts over
    # from a fresh coordinator on the same broker
    want = replicate("jax", broker.port, str(tmp_path / "jax"))
    assert got == want
    files, state, attempts, pipelines = got
    assert attempts == 1 and pipelines == PARTITIONS
    assert sorted(files) == list(range(PARTITIONS))
    assert all(len(rows) == PER_PARTITION for rows in files.values())
    assert files[0][0]["url"] != "https://e.test/0"  # masked


def failing_run(pkg: str, port: int, out: str) -> tuple:
    """One partition's sink raises: the attempt fails, the other
    pipelines stop."""
    p = PKGS[pkg]
    sinker = p["file"].FileSinker
    real_push = sinker.push

    def push(self, batch):
        if hasattr(batch, "columns") and \
                2_000 <= int(batch.columns["id"].data[0]) < 3_000:
            raise RuntimeError("partition 2's sink failed")
        return real_push(self, batch)

    sinker.push = push
    try:
        worker = p["local"].PartitionedWorker(
            transfer(p, port, out), p["cp"](), **p["kw"])
        with pytest.raises(RuntimeError, match="partition 2's sink"):
            worker.run()
    finally:
        sinker.push = real_push
    return (len(worker.failures), str(worker.failure),
            all(src._stop.is_set() for src, _ in worker._pipelines))


def test_one_failing_pipeline_fails_the_attempt_as_jax(broker, tmp_path):
    got = failing_run("port", broker.port, str(tmp_path / "port"))
    assert got == failing_run("jax", broker.port, str(tmp_path / "jax"))
    assert got[0] >= 1 and got[2]


# -- FileSinker and DirectoryPartStage ------------------------------------------


def batch(pkg: str, lo: int, n: int):
    from transferia_tpu.abstract.schema import \
        new_table_schema as ref_schema
    from transferia_tpu_torch.abstract.schema import new_table_schema

    schema_fn, cls, tid = (new_table_schema, ColumnBatch, TableID) \
        if pkg == "port" else (ref_schema, RefBatch, RefTableID)
    schema = schema_fn([("id", "int64", True), ("url", "utf8"),
                        ("region", "int32")])
    return cls.from_pydict(tid("ns", "t"), schema, {
        "id": list(range(lo, lo + n)),
        "url": [f"u{i}" for i in range(lo, lo + n)],
        "region": [i % 7 for i in range(lo, lo + n)]})


def listing(root: str) -> dict:
    """Files under root (the sinker's 8-hex token read as TOKEN), with
    their contents; the staging area's entries by name."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            rel = re.sub(r"\.[0-9a-f]{8}\.", ".TOKEN.",
                         os.path.relpath(path, root))
            with open(path) as fh:
                out[rel] = fh.read()
    return out


def staged_sink(pkg: str, root: str) -> list:
    p = PKGS[pkg]
    stale = StaleEpochPublishError if pkg == "port" else RefStale
    params = p["file"].FileTargetParams(path=root, format="jsonl")

    def sink():
        return p["file"].FileSinker(params, device="cpu") \
            if pkg == "port" else p["file"].FileSinker(params)

    out = []
    s = sink()
    s.push(batch(pkg, 0, 3))               # unstaged: straight in
    s.begin_part("op/ns.t/0", 1)
    s.push(batch(pkg, 10, 4))
    out.append(listing(root))              # staged, invisible
    out.append(s.publish_part("op/ns.t/0", 1))
    out.append(listing(root))
    s.begin_part("op/ns.t/0", 2)           # a retry restages
    s.push(batch(pkg, 20, 2))
    s.abort_part("op/ns.t/0")
    out.append(listing(root))              # nothing new landed
    s2 = sink()
    s2.begin_part("op/ns.t/0", 3)
    s2.push(batch(pkg, 30, 5))
    s2.note_push_retry()
    s2.push(batch(pkg, 30, 6))             # a torn write's replay
    out.append(s2.publish_part("op/ns.t/0", 3))
    out.append(s2.last_dedup_dropped)
    out.append(listing(root))              # replaced, deduped
    s.begin_part("op/ns.t/0", 2)           # a zombie's late publish
    s.push(batch(pkg, 40, 1))
    with pytest.raises(stale):
        s.publish_part("op/ns.t/0", 2)
    s.close()
    s2.close()
    out.append(listing(root))
    return out


def test_file_sink_staged_commits_equal_jax(tmp_path):
    got = staged_sink("port", str(tmp_path / "port"))
    assert got == staged_sink("jax", str(tmp_path / "jax"))
    assert got[1] == 4 and got[4] == 6 and got[5] == 5
    final = got[-1]
    published = [k for k in final if ".part-" in k]
    assert published == ["ns.t.TOKEN.part-op_ns.t_0.jsonl"]
    assert [json.loads(ln)["id"] for ln in
            final[published[0]].splitlines()] == list(range(30, 36))


def cleanup_run(pkg: str, root: str) -> dict:
    p = PKGS[pkg]
    os.makedirs(root)
    for name in ("ns.t.0123abcd.jsonl", "ns.t.0123abcd.000001.parquet",
                 "ns.t.0123abcd.part-op_ns.t_0.jsonl",
                 "ns.t.x.0123abcd.jsonl", "ns.u.0123abcd.jsonl", "keep"):
        with open(os.path.join(root, name), "w") as fh:
            fh.write(name)
    tid = TableID("ns", "t") if pkg == "port" else RefTableID("ns", "t")
    t = p["transfer"](id="fs-clean", dst=p["file"].FileTargetParams(
        path=root, format="jsonl"))
    p["file"].FileProvider(t).cleanup([tid])
    return sorted(os.listdir(root))


def test_file_cleanup_equals_jax(tmp_path):
    got = cleanup_run("port", str(tmp_path / "port"))
    assert got == cleanup_run("jax", str(tmp_path / "jax"))
    assert got == ["keep", "ns.t.x.0123abcd.jsonl", "ns.u.0123abcd.jsonl"]


def test_parquet_sink_names_its_item(tmp_path):
    t = Transfer(id="fs-sink", src=port_file.FileSourceParams(),
                 dst=port_file.FileTargetParams(path=str(tmp_path)))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7") as e:
        make_sinker(t, device="cpu")
    assert "pyarrow" in str(e.value)
