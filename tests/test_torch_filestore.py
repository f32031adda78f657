"""The port's shared-directory coordinator
(`transferia_tpu_torch/coordinator/filestore.py`) against the JAX
package's, on the CPU.

- One sequence of calls on both packages' `FileStoreCoordinator` over
  fresh directories: status and messages, transfer and operation state,
  the part queue (assign, lease renewal, clear, a steal after the lease
  expired, the fenced `commit_part` and `update_operation_parts`),
  health, the MVCC control doc and blobs, the ticket queue and the
  observability segments.  The results (timestamps read as present or
  absent) and the JSON documents on disk must be equal.
- Two `spawn` processes claiming from one queue: each part is claimed
  once.
- The JAX package's own conformance cases (`tests/unit/
  test_coordinator.py`, `test_mvcc_coordinator.py`,
  `test_fleet_queue.py`'s ticket queue, `test_fleetobs.py`'s segment
  store) run against the port's coordinator.
"""

import json
import multiprocessing
import os
import time

import pytest

from tests.unit import test_coordinator as ref_cp_tests
from tests.unit import test_fleet_queue as ref_queue_tests
from tests.unit import test_fleetobs as ref_obs_tests
from tests.unit import test_mvcc_coordinator as ref_mvcc_tests
from transferia_tpu.abstract import TableID as RefTableID
from transferia_tpu.abstract.table import \
    OperationTablePart as RefOperationTablePart
from transferia_tpu.abstract.ticket import FleetTicket as RefFleetTicket
from transferia_tpu.coordinator import \
    FileStoreCoordinator as RefFileStoreCoordinator
from transferia_tpu.coordinator import \
    MemoryCoordinator as RefMemoryCoordinator
from transferia_tpu.coordinator.interface import \
    TransferStatus as RefTransferStatus
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.abstract.table import OperationTablePart
from transferia_tpu_torch.abstract.ticket import FleetTicket
from transferia_tpu_torch.coordinator import (
    FileStoreCoordinator,
    MemoryCoordinator,
    new_coordinator,
)
from transferia_tpu_torch.coordinator.interface import TransferStatus

PKGS = {
    "port": dict(cp=FileStoreCoordinator, part=OperationTablePart,
                 tid=TableID, ticket=FleetTicket, status=TransferStatus),
    "jax": dict(cp=RefFileStoreCoordinator, part=RefOperationTablePart,
                tid=RefTableID, ticket=RefFleetTicket,
                status=RefTransferStatus),
}

def is_clock(key: str) -> bool:
    """Keys whose values are wall-clock times (`ts`, `*_at`): compared
    as present or absent."""
    return key == "ts" or str(key).endswith("_at")


def unclock(v):
    if isinstance(v, dict):
        return {k: (bool(x) if is_clock(k) else unclock(x))
                for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [unclock(x) for x in v]
    if hasattr(v, "to_json"):
        return unclock(v.to_json())
    if hasattr(v, "value") and hasattr(v, "name"):  # an enum
        return v.value
    return v


def parts(p, op: str, n: int) -> list:
    return [p["part"](operation_id=op, table_id=p["tid"]("s", "t"),
                      part_index=i, parts_count=n, eta_rows=10 * i)
            for i in range(n)]


def sequence(pkg: str, root: str) -> list:
    """The same calls on one package's coordinator; their results."""
    p = PKGS[pkg]
    cp = p["cp"](root=root, lease_seconds=0.2)
    out = []
    # status, messages and transfer state
    out.append(cp.get_status("t1"))
    cp.set_status("t1", p["status"].RUNNING)
    cp.open_status_message("t1", "replication", "lag")
    cp.set_transfer_state("t1", {"lsn": 42, "slot": "s"})
    cp.set_transfer_state("t1", {"lsn": 43})
    out += [cp.get_status("t1"), cp.get_transfer_state("t1")]
    cp.remove_transfer_state("t1", ["slot", "absent"])
    out.append(cp.get_transfer_state("t1"))
    cp.set_operation_state("op", {"parts_discovery_done": False})
    cp.set_operation_state("op", {"sharded_state": {"lsn": "0/1"},
                                  "parts_discovery_done": True})
    out.append(cp.get_operation_state("op"))
    # the part queue: claims, renewals, a release, a steal and the fences
    cp.create_operation_parts("op", parts(p, "op", 3))
    cp.add_operation_parts("op", [p["part"](
        operation_id="op", table_id=p["tid"]("s", "u"), part_index=0,
        parts_count=1, eta_rows=5)])
    a = cp.assign_operation_part("op", 1)
    b = cp.assign_operation_part("op", 2)
    out += [a, b, cp.renew_lease("op", 1), cp.renew_lease("op", 7)]
    out.append(cp.clear_assigned_parts("op", 2))
    c = cp.assign_operation_part("op", 3)
    out.append(c)
    time.sleep(0.35)  # every lease expires
    stolen = [cp.assign_operation_part("op", 4) for _ in range(3)]
    out.append(stolen)
    out.append(cp.commit_part("op", a))          # a zombie: fenced
    out.append(cp.commit_part("op", stolen[0]))  # granted
    out.append(cp.commit_part("op", stolen[0]))  # re-granted
    a.completed, a.completed_rows = True, 99
    out.append(cp.update_operation_parts("op", [a]))
    for s in stolen:
        s.completed, s.completed_rows, s.fingerprint = True, 10, "fp"
    out.append(cp.update_operation_parts("op", stolen))
    out += [cp.operation_parts("op"), cp.operation_progress("op").__dict__]
    # health
    cp.operation_health("op", 0, {"phase": "uploading"})
    cp.operation_health("op", 0, {"phase": "waiting"})
    cp.operation_health("op", 1, None)
    cp.transfer_health("t1", 0, healthy=False)
    out.append(cp.get_operation_health("op"))
    # the MVCC control doc and blobs
    layer = {"worker": "w0", "seq": 0, "table": "s.t", "lsn_min": 1,
             "lsn_max": 9, "rows": 3, "content_key": "k"}
    out += [cp.mvcc_admit_layer("mvcc/a", layer),
            cp.mvcc_admit_layer("mvcc/a", dict(layer, seq=1, lsn_max=20)),
            cp.mvcc_admit_layer("mvcc/a", dict(layer, content_key="x")),
            cp.mvcc_record_base("mvcc/a", {"table": "s.t", "part": "p0",
                                           "epoch": 2, "rows": 5,
                                           "content_key": "c",
                                           "locator": "l"}),
            cp.mvcc_record_base("mvcc/a", {"table": "s.t", "part": "p0",
                                           "epoch": 1, "rows": 5,
                                           "content_key": "c",
                                           "locator": "l"}),
            cp.mvcc_cutover("mvcc/a", 20, 2, offsets={"t:0": 7}),
            cp.mvcc_cutover("mvcc/a", 30, 3),
            cp.mvcc_admit_layer("mvcc/a", dict(layer, worker="zombie")),
            cp.mvcc_prune_layers("mvcc/a", [("w0", 0)]),
            cp.mvcc_state("mvcc/a"), cp.mvcc_state("mvcc/none")]
    loc = cp.put_mvcc_blob("mvcc/a", "base-0", b"\x00bytes")
    out += [loc.startswith("file://"), cp.get_mvcc_blob("mvcc/a", loc),
            cp.get_mvcc_blob("mvcc/a", "heap://x"),
            cp.delete_mvcc_blobs("mvcc/a", [loc, loc]),
            cp.get_mvcc_blob("mvcc/a", loc)]
    # the ticket queue
    tk = [p["ticket"](ticket_id=f"k{i}", transfer_id=f"tr{i}",
                      tenant="a", qos="batch", payload={"i": i})
          for i in range(3)]
    out += [cp.enqueue_ticket("q", t) for t in tk]
    out.append(cp.enqueue_ticket("q", tk[0]))  # idempotent
    won = cp.claim_ticket("q", "k0", "w1")
    out += [won, cp.claim_ticket("q", "k0", "w2"),
            cp.claim_ticket("q", "nope", "w2"),
            cp.renew_ticket_leases("q", "w1", ticket_id="k0",
                                   claim_epoch=won.claim_epoch),
            cp.renew_ticket_leases("q", "w1", claim_epoch=99)]
    time.sleep(0.35)
    again = cp.claim_ticket("q", "k0", "w2")  # crash reclaim
    out += [again, cp.complete_ticket("q", won),  # a zombie: fenced
            cp.complete_ticket("q", again, error=""),
            cp.complete_ticket("q", again)]       # a duplicate
    k1 = cp.claim_ticket("q", "k1", "w1")
    out += [cp.release_ticket("q", k1, failed=True),
            cp.claim_ticket("q", "k1", "w3"), cp.revoke_ticket("q", "k1"),
            cp.revoke_ticket("q", "k2"), cp.list_tickets("q"),
            cp.gc_tickets("q", retention_seconds=3600.0),
            cp.gc_tickets("q", retention_seconds=0.0),
            cp.list_tickets("q")]
    # observability segments
    for w, seq in (("w1", 2), ("w0", 1), ("w0", 2), ("w0", 1)):
        cp.put_obs_segment("s", {"worker": w, "seq": seq,
                                 "ts": time.time(), "kind": f"k{seq}"})
    cp.put_obs_segment("s", {"worker": "w9", "seq": 1,
                             "ts": time.time() - 99_999})
    with open(os.path.join(root, "obs", "s", "torn-00000099.json"),
              "w") as fh:
        fh.write('{"worker": "torn", "seq": 99, "led')
    out.append(cp.list_obs_segments("s"))
    out.append(cp.gc_obs_segments("s", retention_seconds=3600.0))
    out.append(cp.list_obs_segments("s"))
    out.append([cp.supports_staged_commits(), cp.supports_mvcc(),
                cp.supports_mvcc_blobs(), cp.supports_ticket_queue(),
                cp.supports_obs_segments()])
    return unclock(out)


def disk(root: str) -> dict:
    """Every JSON document under the root, by relative path."""
    docs = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".json"):
                with open(path) as fh:
                    try:
                        docs[rel] = unclock(json.load(fh))
                    except ValueError:
                        docs[rel] = "torn"
            else:
                docs[rel] = f.rsplit(".", 1)[-1]
    return docs


def test_call_sequence_equals_jax(tmp_path):
    got = sequence("port", str(tmp_path / "port"))
    want = sequence("jax", str(tmp_path / "jax"))
    assert got == want
    assert disk(str(tmp_path / "port")) == disk(str(tmp_path / "jax"))
    # the steal took all three incomplete parts, and the zombie's commit
    # and completion were fenced
    assert [s["stolen_from"] for s in got[11]] == [1, 3, None]
    assert got[12:17] == [False, True, True, ["op/s.t/0"], []]


def _claim_all(root: str, worker: int, out) -> None:
    cp = FileStoreCoordinator(root=root)
    got = []
    while True:
        p = cp.assign_operation_part("op-mp", worker)
        if p is None:
            break
        got.append(p.part_index)
    out.put((worker, got))


def test_two_processes_claim_each_part_once(tmp_path):
    root = str(tmp_path / "cp")
    cp = FileStoreCoordinator(root=root)
    cp.create_operation_parts("op-mp", [
        OperationTablePart(operation_id="op-mp", table_id=TableID("s", "t"),
                           part_index=i, parts_count=200)
        for i in range(200)])
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_claim_all, args=(root, w, out))
             for w in (1, 2)]
    for pr in procs:
        pr.start()
    got = dict(out.get(timeout=120) for _ in procs)
    for pr in procs:
        pr.join(60)
        assert pr.exitcode == 0
    assert sorted(got[1] + got[2]) == list(range(200))
    stored = cp.operation_parts("op-mp")
    assert all(s.assignment_epoch == 1 for s in stored)
    assert {s.part_index for s in stored if s.worker_index == 1} == \
        set(got[1])


def test_new_coordinator_kinds(tmp_path):
    assert isinstance(new_coordinator("memory"), MemoryCoordinator)
    fs = new_coordinator("filestore", root=str(tmp_path))
    assert isinstance(fs, FileStoreCoordinator) and fs.root == str(tmp_path)
    # the s3 coordinator is ported (tests/test_torch_s3_coordinator.py)
    s3 = new_coordinator("s3", bucket="b", endpoint="http://127.0.0.1:1")
    assert type(s3).__name__ == "S3Coordinator" and s3.client.bucket == "b"
    with pytest.raises(ValueError, match="unknown coordinator"):
        new_coordinator("etcd")
    m = MemoryCoordinator()
    ref = RefMemoryCoordinator()
    # the capability probes answer by override, as the reference's: the
    # memory coordinators of both packages hold tickets and segments
    assert [m.supports_mvcc(), m.supports_mvcc_blobs(),
            m.supports_ticket_queue(), m.supports_obs_segments()] == \
        [ref.supports_mvcc(), ref.supports_mvcc_blobs(),
         ref.supports_ticket_queue(), ref.supports_obs_segments()] == \
        [True, True, True, True]


# -- the JAX package's conformance cases, on the port -------------------------

@pytest.fixture
def cp(tmp_path):
    yield FileStoreCoordinator(root=str(tmp_path / "cp"))


class TestPortCoordinator(ref_cp_tests.TestCoordinator):
    pass


class TestPortMvccConformance(ref_mvcc_tests.TestMvccConformance):
    pass


class TestPortTicketQueue(ref_queue_tests.TestTicketQueue):
    pass


class TestPortObsSegments(ref_obs_tests.TestObsSegmentConformance):
    def test_memory_put_bounds_per_worker_without_gc(self):
        """The JAX case is of its memory backend: the port's memory
        coordinator trims each worker's segments at put time too."""
        from transferia_tpu_torch.coordinator.interface import (
            obs_segments_per_worker,
        )

        cp = MemoryCoordinator()
        for seq in range(1, 40):
            cp.put_obs_segment("s", ref_obs_tests.make_segment(
                worker="w0", seq=seq))
        got = cp.list_obs_segments("s")
        assert [g["seq"] for g in got] == list(
            range(40 - obs_segments_per_worker(), 40))

    def test_torn_stored_segment_skipped(self, cp, tmp_path):
        cp.put_obs_segment("s", ref_obs_tests.make_segment(worker="w0",
                                                           seq=1))
        with open(os.path.join(cp.root, "obs", "s",
                               "torn-00000099.json"), "w") as fh:
            fh.write('{"worker": "torn", "seq": 99, "led')
        got = cp.list_obs_segments("s")
        assert [g["worker"] for g in got] == ["w0"]
        assert ref_obs_tests.merge_segments(got)["segments"] == 1
