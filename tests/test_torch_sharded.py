"""Sharded snapshots across workers (`tasks/snapshot.py`'s secondary flow
and resume, `coordinator/filestore.py`, the CLI's `--coordinator
filestore` and `checksum --against-operation`) against the JAX package,
on the CPU (`device="cpu"`: the kernels' plain versions).

- A `job_count=3` snapshot on each package's filestore coordinator, the
  three workers as threads (tests/e2e/test_snapshot_e2e.py's pattern):
  equal delivered multisets and `table_fingerprints`.
- The lease cases of tests/unit/test_snapshot_leases.py on both
  packages: a steal of a dead worker's parts, a zombie's completion
  fenced, the main's fail-fast with the orphan diagnostic, and the wait
  on a live lease.
- Resume: a queue with committed parts is reused, this worker's stale
  claim released, and only the rest uploaded; `MAIN_WORKER_RESTART`.
- The port's fake Postgres lies on pages: `shard_table` through both
  packages' `PGStorage` gives parts whose union is the table once.
- The CLI: a PG -> ClickHouse transfer.yaml run by two `--device cpu`
  worker processes on the filestore coordinator (the JAX CLI's two
  workers as threads, over its own fakes), then `checksum
  --against-operation` exiting 0 clean, 1 altered and 2 with no
  fingerprints recorded, its output equal to the JAX CLI's.
"""

import io
import os
import subprocess
import sys
import threading
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

from tests.recipes.fake_clickhouse import FakeCH as RefFakeCH
from tests.recipes.fake_postgres import FakePG as RefFakePG
from tests.recipes.fake_postgres import FakeTable as RefFakeTable
from transferia_tpu.abstract.errors import CodedError as RefCodedError
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.table import \
    TableDescription as RefTableDescription
from transferia_tpu.cli import main as ref_main
from transferia_tpu.coordinator import \
    FileStoreCoordinator as RefFileStoreCoordinator
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.factories import new_storage as ref_new_storage
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models.transfer import Runtime as RefRuntime
from transferia_tpu.models.transfer import \
    ShardingUploadParams as RefSharding
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers import sample as ref_sample
from transferia_tpu.providers.postgres import PGSourceParams as RefPGParams
from transferia_tpu.providers.postgres.provider import \
    PGStorage as RefPGStorage
from transferia_tpu.tasks import snapshot as ref_snapshot
from transferia_tpu.tasks.table_splitter import \
    split_tables as ref_split_tables
from transferia_tpu_torch.abstract.errors import CodedError, Codes
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.cli import main as port_main
from transferia_tpu_torch.coordinator import (
    FileStoreCoordinator,
    MemoryCoordinator,
)
from transferia_tpu_torch.factories import new_storage
from transferia_tpu_torch.models import (
    Runtime,
    ShardingUploadParams,
    Transfer,
)
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers import sample as port_sample
from transferia_tpu_torch.providers.postgres import PGSourceParams
from transferia_tpu_torch.providers.postgres.provider import PGStorage
from transferia_tpu_torch.recipes.fake_clickhouse import FakeCH
from transferia_tpu_torch.recipes.fake_postgres import (
    ROWS_PER_PAGE,
    FakePG,
    FakeTable,
)
from transferia_tpu_torch.tasks import snapshot as port_snapshot
from transferia_tpu_torch.tasks.table_splitter import split_tables

ROOT = Path(__file__).resolve().parents[1]

FUSED = {"transformers": [
    {"mask_field": {"columns": ["email"], "salt": "s3cr3t"}},
    {"filter_rows": {"filter": "age >= 21"}},
]}

PKGS = {
    "port": dict(mem=port_memory, sample=port_sample, transfer=Transfer,
                 runtime=Runtime, sharding=ShardingUploadParams,
                 snapshot=port_snapshot, memory_cp=MemoryCoordinator,
                 filestore=FileStoreCoordinator, tid=TableID,
                 storage=new_storage, split=split_tables,
                 coded=CodedError, kw={"device": "cpu"}),
    "jax": dict(mem=ref_memory, sample=ref_sample, transfer=RefTransfer,
                runtime=RefRuntime, sharding=RefSharding,
                snapshot=ref_snapshot, memory_cp=RefCoordinator,
                filestore=RefFileStoreCoordinator, tid=RefTableID,
                storage=ref_new_storage, split=ref_split_tables,
                coded=RefCodedError, kw={}),
}


@pytest.fixture(autouse=True)
def fast_tuning(monkeypatch):
    """The tests/unit/test_snapshot_leases.py schedule, in both
    packages."""
    for p in PKGS.values():
        mod = p["snapshot"]
        monkeypatch.setattr(mod, "TUNING", mod.SnapshotTuning(
            secondary_bootstrap_timeout=5.0, wait_poll=0.02,
            wait_timeout=20.0, stall_timeout=0.3,
            heartbeat_interval=0.02))


def make_transfer(p, tid: str, sink: str, rows: int = 200,
                  shard_parts: int = 2, current_job: int = 0,
                  job_count: int = 2, process_count: int = 1,
                  config=None, fingerprint: bool = False):
    return p["transfer"](
        id=tid,
        src=p["sample"].SampleSourceParams(
            preset="users", table="users", rows=rows, batch_rows=64,
            shard_parts=shard_parts),
        dst=p["mem"].MemoryTargetParams(sink_id=sink),
        transformation=config,
        runtime=p["runtime"](current_job=current_job,
                             sharding=p["sharding"](
                                 job_count=job_count,
                                 process_count=process_count)),
        validation={"fingerprint": fingerprint})


def loader(p, t, cp, op_id: str, **kw):
    return p["snapshot"].SnapshotLoader(t, cp, operation_id=op_id,
                                        **kw, **p["kw"])


def delivered(p, sink: str) -> list:
    """The memory store's rows of sample.users, as a sorted multiset."""
    tid = p["tid"]("sample", "users")
    return sorted(tuple(r.column_values)
                  for r in p["mem"].get_store(sink).rows(tid))


def publish_parts(p, cp, transfer, op_id: str) -> list:
    """The main's control-plane role, without its upload loop."""
    storage = p["storage"](transfer)
    try:
        tables = loader(p, transfer, cp, op_id).filtered_table_list(storage)
        parts = p["split"](storage, tables, transfer, op_id)
    finally:
        storage.close()
    cp.create_operation_parts(op_id, parts)
    cp.set_operation_state(op_id, {"parts_discovery_done": True})
    return parts


# -- job_count=3 on the filestore coordinator --------------------------------

def sharded_threads(pkg: str, root: str):
    p = PKGS[pkg]
    sink = f"shard3_{pkg}"
    p["mem"].get_store(sink).clear()
    cp = p["filestore"](root=root)
    op_id = "op-shard3"
    errors = []

    def run(idx):
        try:
            t = make_transfer(p, "shard3", sink, rows=400, shard_parts=8,
                              current_job=idx, job_count=3,
                              process_count=2, config=FUSED,
                              fingerprint=True)
            loader(p, t, p["filestore"](root=root), op_id).upload_tables()
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not errors, errors
    parts = cp.operation_parts(op_id)
    assert len(parts) == 8 and all(x.completed for x in parts)
    assert {x.worker_index for x in parts} <= {0, 1, 2}
    return (delivered(p, sink),
            cp.get_operation_state(op_id)["table_fingerprints"],
            sorted((x.part_index, x.completed_rows) for x in parts))


def test_sharded_threads_on_filestore_equal_jax(tmp_path):
    got = sharded_threads("port", str(tmp_path / "port"))
    want = sharded_threads("jax", str(tmp_path / "jax"))
    assert got == want
    rows, digests, _ = got
    assert len(rows) == len(set(rows)) and 0 < len(rows) < 400
    assert list(digests) == ['"sample"."users"']


# -- the lease cases ----------------------------------------------------------

def case_steal(p):
    sink = "lease_steal_sink"
    p["mem"].get_store(sink).clear()
    cp = p["memory_cp"](lease_seconds=0.1)
    op_id = "op-steal"
    t_main = make_transfer(p, "lease-t", sink)
    assert len(publish_parts(p, cp, t_main, op_id)) == 2
    # a worker that died mid-operation: parts leased, never renewed
    assert cp.assign_operation_part(op_id, 9) is not None
    assert cp.assign_operation_part(op_id, 9) is not None
    t_sec = make_transfer(p, "lease-t", sink, current_job=1)
    sec = loader(p, t_sec, cp, op_id)
    sec.upload_tables()  # lingers on the live leases, then reclaims
    final = cp.operation_parts(op_id)
    loader(p, t_main, cp, op_id)._wait_all_parts_done()
    return ([(x.completed, x.worker_index, x.stolen_from,
              x.assignment_epoch) for x in final],
            sec.metrics.value("lease_steals"), delivered(p, sink))


def case_zombie(p):
    sink = "lease_fence_sink"
    p["mem"].get_store(sink).clear()
    cp = p["memory_cp"](lease_seconds=0.1)
    op_id = "op-fence"
    publish_parts(p, cp, make_transfer(p, "lease-t", sink, rows=100,
                                       shard_parts=1), op_id)
    zombie = cp.assign_operation_part(op_id, 9)
    loader(p, make_transfer(p, "lease-t", sink, rows=100, shard_parts=1,
                            current_job=1), cp, op_id).upload_tables()
    assert cp.operation_progress(op_id).done
    # the dead worker wakes and flushes its stale completion
    zombie.completed, zombie.completed_rows = True, 1
    rejected = cp.update_operation_parts(op_id, [zombie])
    final = cp.operation_parts(op_id)[0]
    return rejected, final.worker_index, final.completed_rows


def case_orphaned(p):
    cp = p["memory_cp"](lease_seconds=0.05)
    op_id = "op-orphan"
    publish_parts(p, cp, make_transfer(p, "lease-t", "orphan_sink"), op_id)
    dead = cp.assign_operation_part(op_id, 7)
    cp.operation_health(op_id, 7, {"phase": "uploading"})
    main = loader(p, make_transfer(p, "lease-t", "orphan_sink"), cp, op_id)
    t0 = time.monotonic()
    with pytest.raises(p["coded"]) as ei:
        main._wait_all_parts_done()
    assert time.monotonic() - t0 < 10.0  # fail fast, not 24 h
    msg = str(ei.value)
    assert dead.key() in msg and "worker 7" in msg
    assert "never claimed" in msg and "last heartbeat" in msg
    # the ages differ run to run; the rest of the message must not
    return ei.value.code, [ln.split(",")[0] for ln in
                           msg.split(": ", 2)[-1].split("; ")]


def case_live_lease(p):
    cp = p["memory_cp"](lease_seconds=30.0)
    op_id = "op-live"
    publish_parts(p, cp, make_transfer(p, "lease-t", "live_sink",
                                       shard_parts=1), op_id)
    held = cp.assign_operation_part(op_id, 3)

    def complete_later():
        time.sleep(0.5)
        held.completed = True
        cp.update_operation_parts(op_id, [held])

    th = threading.Thread(target=complete_later, daemon=True)
    th.start()
    loader(p, make_transfer(p, "lease-t", "live_sink", shard_parts=1), cp,
           op_id)._wait_all_parts_done()  # a live lease: no fail-fast
    th.join()
    return cp.operation_progress(op_id).done


@pytest.mark.parametrize("case", [case_steal, case_zombie, case_orphaned,
                                  case_live_lease])
def test_lease_cases_equal_jax(case):
    got = case(PKGS["port"])
    assert got == case(PKGS["jax"])
    if case is case_steal:
        assert got[0] == [(True, 1, 9, 2)] * 2 and got[1] == 2
        assert len(got[2]) == 200
    elif case is case_zombie:
        assert got[1:] == (1, 100) and len(got[0]) == 1
    elif case is case_orphaned:
        assert got[0] == Codes.SNAPSHOT_PARTS_ORPHANED
    else:
        assert got is True


# -- a secondary killed mid-part, staged commits into ClickHouse ---------------

def killed_secondary(pkg: str):
    """A worker claims a part, stages a batch into ClickHouse and dies
    (its lease and staging table stay); a survivor steals the part after
    the lease expires.  What the target holds afterwards."""
    from transferia_tpu.providers.clickhouse.provider import (
        CHSinker as RefCHSinker,
    )
    from transferia_tpu.providers.clickhouse.provider import (
        CHTargetParams as RefCHTargetParams,
    )
    from transferia_tpu_torch.providers.clickhouse.provider import (
        CHSinker,
        CHTargetParams,
    )

    p = PKGS[pkg]
    ch = (FakeCH if pkg == "port" else RefFakeCH)().start()
    params = (CHTargetParams if pkg == "port" else RefCHTargetParams)(
        host="127.0.0.1", port=ch.port, bufferer=None)
    try:
        cp = p["memory_cp"](lease_seconds=0.3)
        op_id = "op-kill"

        def transfer(job):
            t = make_transfer(p, "kill-t", "unused", rows=300,
                              shard_parts=3, current_job=job,
                              job_count=3, config=FUSED)
            t.dst = params
            return t

        publish_parts(p, cp, transfer(0), op_id)
        dead = cp.assign_operation_part(op_id, 2)
        storage = p["storage"](transfer(2))
        batches = []
        storage.load_table(dead.to_description(), batches.append)
        storage.close()
        sink = CHSinker(params, "cpu") if pkg == "port" else \
            RefCHSinker(params)
        sink.begin_part(dead.key(), dead.assignment_epoch)
        sink.push(batches[0])  # then the process dies: no abort, no close
        staged_before = sorted(n for n in ch.tables
                               if n.startswith("__trtpu_stg_"))
        survivor = loader(p, transfer(1), cp, op_id)
        survivor.upload_tables()
        loader(p, transfer(0), cp, op_id)._wait_all_parts_done()
        parts = cp.operation_parts(op_id)
        return {"staged_before": len(staged_before),
                "staging_left": sorted(n for n in ch.tables
                                       if n.startswith("__trtpu_stg_")),
                "fences": len(ch.rows("__trtpu_commits")),
                "rows": sorted(r["user_id"]
                               for r in ch.rows("sample__users")),
                "steals": survivor.metrics.value("lease_steals"),
                "parts": sorted((x.part_index, x.worker_index,
                                 x.stolen_from) for x in parts)}
    finally:
        ch.stop()


def test_killed_secondary_leaves_what_jax_leaves():
    got = killed_secondary("port")
    assert got == killed_secondary("jax")
    # the dead worker's staging table is swept by the survivor's begin
    assert got["staged_before"] == 1 and got["staging_left"] == []
    assert got["fences"] == 3 and got["steals"] == 1
    assert len(got["rows"]) == len(set(got["rows"])) > 0
    assert [x[2] for x in got["parts"]].count(2) == 1


# -- resume and the main's restart refusal ------------------------------------

def resumed(pkg: str):
    p = PKGS[pkg]
    sink = f"resume_{pkg}"
    p["mem"].get_store(sink).clear()
    cp = p["memory_cp"](lease_seconds=30.0)
    op_id = "op-resume"
    t = make_transfer(p, "resume-t", sink, rows=400, shard_parts=4,
                      job_count=1, fingerprint=True)
    publish_parts(p, cp, t, op_id)
    # a previous attempt committed two parts and left a claim leased
    for _ in range(2):
        part = cp.assign_operation_part(op_id, 0)
        part.completed, part.completed_rows = True, 7
        assert cp.update_operation_parts(op_id, [part]) == []
    stale = cp.assign_operation_part(op_id, 0)
    loader(p, t, cp, op_id, resume=True).upload_tables()
    parts = sorted(cp.operation_parts(op_id), key=lambda x: x.part_index)
    return (delivered(p, sink),
            [(x.part_index, x.completed, x.completed_rows,
              x.assignment_epoch) for x in parts],
            stale.part_index, cp.get_operation_state(op_id))


def test_resume_uploads_only_uncommitted_parts_as_jax():
    got = resumed("port")
    assert got == resumed("jax")
    rows, parts, stale, state = got
    assert len(rows) == 200 and all(x[1] for x in parts)
    # the two committed parts kept their records; the stale claim was
    # released and claimed again (epoch 2)
    assert sorted(x[2] for x in parts) == [7, 7, 100, 100]
    assert [x[3] for x in parts if x[0] == stale] == [2]
    assert state["parts_discovery_done"] is True


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_main_worker_restart_refused(pkg):
    p = PKGS[pkg]
    cp = p["memory_cp"]()
    t = make_transfer(p, "restart-t", "restart_sink")
    publish_parts(p, cp, t, "op-restart-t")
    with pytest.raises(p["coded"]) as ei:
        loader(p, t, cp, "op-restart-t").upload_tables()
    assert ei.value.code == Codes.MAIN_WORKER_RESTART
    assert "operation op-restart-t has incomplete parts" in str(ei.value)


# -- the fake's pages ---------------------------------------------------------

HITS = [("id", "bigint", True, True), ("url", "text", False, False),
        ("region", "integer", False, False),
        ("score", "double precision", False, False)]


def hits_rows(n: int, lo: int = 0) -> list:
    return [{"id": str(i), "url": f"https://e.test/{i % 997}",
             "region": str(i % 500), "score": f"{(i % 91) * 1.5}"}
            for i in range(lo, lo + n)]


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("rows", [1, ROWS_PER_PAGE, 4_000])
def test_ctid_parts_cover_the_table_once(pkg, rows):
    storage, params, tid, td = {
        "port": (PGStorage, PGSourceParams, TableID, TableDescription),
        "jax": (RefPGStorage, RefPGParams, RefTableID,
                RefTableDescription)}[pkg]
    pg = FakePG().start()
    try:
        pg.add_table(FakeTable("public", "hits", HITS, hits_rows(rows)))
        st = storage(params(host="127.0.0.1", port=pg.port, database="db",
                            user="u", desired_part_size_bytes=50_000))
        try:
            parts = st.shard_table(td(id=tid("public", "hits"),
                                      eta_rows=rows))
            ids = []
            for part in parts:
                st.load_table(part, lambda b: ids.extend(
                    b.columns["id"].data.tolist()))
        finally:
            st.close()
    finally:
        pg.stop()
    assert sorted(ids) == list(range(rows))
    assert len(parts) == (8 if rows == 4_000 else 1)


# -- the CLI on the CPU -------------------------------------------------------

CLI_YAML = """\
id: shard-cli
type: SNAPSHOT_ONLY
src:
  type: pg
  params:
    host: 127.0.0.1
    port: {src}
    database: shop
    user: postgres
    schemas: [public]
    desired_part_size_bytes: 60000
dst:
  type: ch
  params:
    host: 127.0.0.1
    port: {dst}
    database: default
    bufferer: null
    cleanup_policy: disabled
transformation:
  transformers:
    - mask_field: {{columns: [url], salt: shard-salt}}
    - filter_rows: {{filter: "region < 400"}}
validation: {{fingerprint: true}}
"""


def run_cli(entry, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = entry(argv)
    return rc, out.getvalue(), err.getvalue()


def target_fingerprint(pkg: str, port: int) -> str:
    """The package's own fingerprint of the ClickHouse target's hits."""
    from transferia_tpu.ops.rowhash import \
        TableFingerprinter as RefFingerprinter
    from transferia_tpu.providers.clickhouse.provider import (
        CHSourceParams as RefCHParams,
    )
    from transferia_tpu.providers.clickhouse.provider import \
        CHStorage as RefCHStorage
    from transferia_tpu_torch.ops.rowhash import TableFingerprinter
    from transferia_tpu_torch.providers.clickhouse.provider import (
        CHSourceParams,
        CHStorage,
    )

    if pkg == "port":
        st = CHStorage(CHSourceParams(host="127.0.0.1", port=port))
        fp = TableFingerprinter(backend="device", device="cpu")
        td = TableDescription(id=TableID("public", "hits"))
    else:
        st = RefCHStorage(RefCHParams(host="127.0.0.1", port=port))
        fp = RefFingerprinter(backend="device")
        td = RefTableDescription(id=RefTableID("public", "hits"))
    try:
        st.load_table(td, fp.push)
    finally:
        st.close()
    return fp.result().digest()


def cli_run(pkg: str, tmp: Path) -> dict:
    """Two workers of one activation on the filestore coordinator, then
    the checksum against the operation: clean, altered, unrecorded."""
    fakes = {"port": (FakePG, FakeTable, FakeCH),
             "jax": (RefFakePG, RefFakeTable, RefFakeCH)}[pkg]
    pg, ch = fakes[0]().start(), fakes[2]().start()
    tmp.mkdir()
    try:
        pg.add_table(fakes[1]("public", "hits", HITS, hits_rows(3_000)))
        yaml_path = tmp / "t.yaml"
        yaml_path.write_text(CLI_YAML.format(src=pg.port, dst=ch.port))
        coord = ["--coordinator", "filestore", "--coordinator-dir",
                 str(tmp / "cp")]

        def worker_argv(i):
            return coord + ["--job-count", "2", "--job-index", str(i),
                            "--log-level", "warning", "activate",
                            "--transfer", str(yaml_path)]

        if pkg == "port":
            env = dict(os.environ, PYTHONPATH=str(ROOT),
                       TRANSFERIA_TPU_SNAPSHOT_WAIT_POLL="0.05")
            procs = [subprocess.Popen(
                [sys.executable, "-m", "transferia_tpu_torch.cli.main",
                 "--device", "cpu"] + worker_argv(i),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env) for i in range(2)]
            outs = [pr.communicate(timeout=300) for pr in procs]
            rcs = [pr.returncode for pr in procs]
            assert rcs == [0, 0], [o[1][-2000:] for o in outs]
            entry = port_main.main
            pre = ["--device", "cpu"]
        else:
            results = {}

            def run(i):
                results[i] = run_cli(ref_main.main, worker_argv(i))

            ths = [threading.Thread(target=run, args=(i,))
                   for i in range(2)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(300)
            assert [results[i][0] for i in range(2)] == [0, 0], results
            entry, pre = ref_main.main, []
        parts = FileStoreCoordinator(root=str(tmp / "cp")).operation_parts(
            "op-shard-cli")
        check = pre + coord + ["checksum", "--transfer", str(yaml_path),
                               "--fingerprint-backend", "device",
                               "--against-operation"]
        recorded = FileStoreCoordinator(root=str(tmp / "cp")) \
            .get_operation_state("op-shard-cli")["table_fingerprints"]
        clean = run_cli(entry, check + ["op-shard-cli"])
        with ch.lock:
            row = min(ch.tables["public__hits"]["rows"],
                      key=lambda r: r["id"])
            row["score"] = row["score"] + 0.5
        altered = run_cli(entry, check + ["op-shard-cli"])
        unrecorded = run_cli(entry, check + ["op-none"])
        return {"parts": len(parts), "recorded": recorded,
                "target": target_fingerprint(pkg, ch.port),
                "completed": all(x.completed for x in parts),
                "fences": len(ch.rows("__trtpu_commits")),
                "staging": [n for n in ch.tables
                            if n.startswith("__trtpu_stg_")],
                "rows": len(ch.rows("public__hits")),
                "clean": clean, "altered": altered,
                "unrecorded": unrecorded}
    finally:
        pg.stop()
        ch.stop()


def test_cli_sharded_workers_and_checksum_against_operation(tmp_path):
    got = cli_run("port", tmp_path / "port")
    want = cli_run("jax", tmp_path / "jax")
    # the JAX fake has one page a table: one part; the port's splits
    assert want["parts"] == 1 and got["parts"] == 5
    assert got["completed"] and want["completed"]
    assert got["fences"] == got["parts"] and want["fences"] == 1
    assert got["staging"] == want["staging"] == []
    assert got["rows"] == want["rows"] == 3_000 * 400 // 500
    # the same rows, so the same recorded digests and, once altered, the
    # same target digest
    assert got["recorded"] == want["recorded"]
    assert got["target"] == want["target"]
    (fqtn, digest), = got["recorded"].items()
    assert fqtn == '"public"."hits"' and digest.endswith(":2400")
    assert got["clean"] == (0, f"{fqtn}: OK [fingerprint] {digest}\n", "")
    assert got["altered"] == (
        1, f"{fqtn}: MISMATCH [fingerprint] uploaded={digest} "
           f"target={got['target']}\n", "")
    assert got["unrecorded"] == want["unrecorded"]
    assert got["unrecorded"][0] == 2
    assert "no recorded fingerprints" in got["unrecorded"][2]
    # the reference splits the recorded key '"public"."hits"' at its
    # first dot and keeps the quotes, so it reads no table (ROADMAP.md
    # C, a deliberate difference)
    for key in ("clean", "altered"):
        assert want[key][0] == 1 and want[key][1].startswith(
            f"{fqtn}: ERROR reading target")
