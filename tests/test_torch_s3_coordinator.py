"""The port's object-store coordinator (`transferia_tpu_torch/coordinator/
s3store.py`) against the JAX package's, on the CPU.  Exact throughout.

- One sequence of calls on both packages' `S3Coordinator`, each over its
  own package's fake S3 (the port's `recipes/fake_s3.py`, the JAX
  package's `tests/recipes/fake_s3.py`), with conditional writes and
  without them (the last-writer-wins degrade): status and messages,
  transfer and operation state, the part queue (assign, renewal, clear,
  a steal after the lease expired, the fenced `commit_part` and
  `update_operation_parts`), health, the MVCC control doc and blobs, the
  ticket queue and the observability segments.  The results (clock
  values read as present or absent) and the objects in the buckets must
  be equal.
- Claims from separate processes, as tests/e2e/test_s3_coordinator_e2e.py
  makes them: each part claimed once.
- The JAX package's own conformance cases (`tests/unit/
  test_coordinator.py`, `test_mvcc_coordinator.py`, `test_fleet_queue.py`'s
  ticket queue, `test_fleetobs.py`'s segment store) on the port's
  coordinator, with and without conditional writes.
"""

import json
import os
import re
import subprocess
import sys
import time

import pytest

from tests.recipes.fake_s3 import FakeS3 as RefFakeS3
from tests.test_torch_filestore import PKGS, parts, unclock
from tests.unit import test_coordinator as ref_cp_tests
from tests.unit import test_fleet_queue as ref_queue_tests
from tests.unit import test_fleetobs as ref_obs_tests
from tests.unit import test_mvcc_coordinator as ref_mvcc_tests
from transferia_tpu.coordinator import S3Coordinator as RefS3Coordinator
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.abstract.table import OperationTablePart
from transferia_tpu_torch.coordinator import S3Coordinator, new_coordinator
from transferia_tpu_torch.recipes.fake_s3 import FakeS3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AK, SK = "test-ak", "test-sk"
S3PKGS = {"port": dict(PKGS["port"], cp=S3Coordinator, fake=FakeS3),
          "jax": dict(PKGS["jax"], cp=RefS3Coordinator, fake=RefFakeS3)}


def sequence(pkg: str, fake, prefix: str = "") -> list:
    """The same calls on one package's coordinator; their results."""
    p = S3PKGS[pkg]
    cp = p["cp"](bucket="cp", endpoint=fake.endpoint, access_key=AK,
                 secret_key=SK, prefix=prefix, lease_seconds=1.0)
    out = []
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
    # (add_operation_parts differs: test_add_operation_parts_appends)
    cp.create_operation_parts("op", parts(p, "op", 3) + [p["part"](
        operation_id="op", table_id=p["tid"]("s", "u"), part_index=0,
        parts_count=1, eta_rows=5)])
    a = cp.assign_operation_part("op", 1)
    b = cp.assign_operation_part("op", 2)
    out += [a, b, cp.renew_lease("op", 1), cp.renew_lease("op", 7)]
    out.append(cp.clear_assigned_parts("op", 2))
    c = cp.assign_operation_part("op", 3)
    out.append(c)
    time.sleep(1.2)  # every lease expires
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
    # a re-activation's create replaces the queue
    cp.create_operation_parts("op2", parts(p, "op2", 2))
    cp.create_operation_parts("op2", parts(p, "op2", 1))
    out.append(cp.operation_parts("op2"))
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
            cp.mvcc_cutover("mvcc/a", 20, 2, offsets={"t:0": 7}),
            cp.mvcc_cutover("mvcc/a", 30, 3),
            cp.mvcc_admit_layer("mvcc/a", dict(layer, worker="zombie")),
            cp.mvcc_prune_layers("mvcc/a", [("w0", 0)]),
            cp.mvcc_state("mvcc/a"), cp.mvcc_state("mvcc/none")]
    loc = cp.put_mvcc_blob("mvcc/a", "base-0", b"\x00bytes")
    out += [loc, cp.get_mvcc_blob("mvcc/a", loc),
            cp.get_mvcc_blob("mvcc/a", "file://x"),
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
    time.sleep(1.2)
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
    cp.client.put(cp._obs_key("s", "torn", 99),
                  b'{"worker": "torn", "seq": 99, "led')
    out.append(cp.list_obs_segments("s"))
    out.append(cp.gc_obs_segments("s", retention_seconds=3600.0))
    out.append(cp.list_obs_segments("s"))
    out.append([cp.supports_staged_commits(), cp.supports_mvcc(),
                cp.supports_mvcc_blobs(), cp.supports_ticket_queue(),
                cp.supports_obs_segments()])
    return unclock(out)


def fast(fake):
    """TCP_NODELAY on the fake's connections (the port's fake sets it;
    the JAX package's answers each request 40 ms late otherwise, on the
    client's delayed ACK)."""
    fake.server.RequestHandlerClass.disable_nagle_algorithm = True
    return fake


_MESSAGE = re.compile(r"/messages/[0-9.]+-\d+\.json$")


def bucket(fake) -> dict:
    """Every object in the fake, by key (a status message's time and pid
    masked), JSON bodies unclocked."""
    out = {}
    for key, (body, _) in fake.objects.items():
        key = _MESSAGE.sub("/messages/M.json", key)
        try:
            out[key] = unclock(json.loads(body))
        except ValueError:
            out[key] = body
    return out


@pytest.mark.parametrize("conditional", [True, False])
@pytest.mark.parametrize("prefix", ["", "pods/a"])
def test_call_sequence_equals_jax(conditional, prefix):
    fakes = {pkg: fast(S3PKGS[pkg]["fake"](conditional_writes=conditional,
                                           page_size=3)).start()
             for pkg in S3PKGS}
    try:
        got = sequence("port", fakes["port"], prefix)
        want = sequence("jax", fakes["jax"], prefix)
        assert got == want
        assert bucket(fakes["port"]) == bucket(fakes["jax"])
    finally:
        for f in fakes.values():
            f.stop()
    # the steal took all three incomplete parts, the zombie's commit and
    # completion were fenced, and the queue was replaced on re-create
    assert [s["stolen_from"] for s in got[11]] == [1, 3, None]
    assert got[12:17] == [False, True, True, ["op/s.t/0"], []]
    assert len(got[19]) == 1


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_add_operation_parts_appends(pkg):
    """Async discovery publishes parts in flushes through
    add_operation_parts.  The port's appends; the JAX package's calls
    create_operation_parts, which first deletes the queue, so each flush
    drops the parts the earlier ones published (claimed and completed
    ones too): a fault of the reference, pinned (ROADMAP.md C)."""
    p = S3PKGS[pkg]
    fake = fast(p["fake"]()).start()
    try:
        cp = p["cp"](bucket="cp", endpoint=fake.endpoint, access_key=AK,
                     secret_key=SK)
        cp.create_operation_parts("op", [])
        first, second = parts(p, "op", 5)[:3], parts(p, "op", 5)[3:]
        cp.add_operation_parts("op", first)
        claimed = cp.assign_operation_part("op", 1)
        cp.add_operation_parts("op", second)
        got = sorted(q.part_index for q in cp.operation_parts("op"))
    finally:
        fake.stop()
    assert claimed.part_index == 0
    assert got == ([0, 1, 2, 3, 4] if pkg == "port" else [3, 4])


CLAIM_WORKER = """
import json, os, sys
from {pkg}.coordinator import S3Coordinator

cp = S3Coordinator(bucket="b", endpoint=os.environ["FAKE_S3"],
                   access_key="test-ak", secret_key="test-sk")
widx = int(sys.argv[1])
claimed = []
while True:
    part = cp.assign_operation_part("op-x", widx)
    if part is None:
        break
    part.completed = True
    part.completed_rows = 10
    part.worker_index = widx
    cp.update_operation_parts("op-x", [part])
    claimed.append(part.part_index)
print(json.dumps(claimed))
"""


@pytest.mark.parametrize("pkg", ["transferia_tpu_torch", "transferia_tpu"])
def test_processes_claim_each_part_once(pkg):
    fake = FakeS3().start()
    try:
        cp = S3Coordinator(bucket="b", endpoint=fake.endpoint,
                           access_key=AK, secret_key=SK)
        cp.create_operation_parts("op-x", [
            OperationTablePart(operation_id="op-x",
                               table_id=TableID("s", "t"), part_index=i,
                               parts_count=40)
            for i in range(40)])
        env = dict(os.environ, FAKE_S3=fake.endpoint, JAX_PLATFORMS="cpu",
                   PYTHONPATH=REPO)
        procs = [subprocess.Popen(
            [sys.executable, "-c", CLAIM_WORKER.format(pkg=pkg), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO) for i in range(3)]
        outs = []
        for proc in procs:
            so, se = proc.communicate(timeout=180)
            assert proc.returncode == 0, se
            outs.append(json.loads(so.strip().splitlines()[-1]))
        claimed = sorted(i for o in outs for i in o)
        assert claimed == list(range(40))
        stored = cp.operation_parts("op-x")
        assert all(p.completed and p.assignment_epoch == 1 for p in stored)
        assert cp.operation_progress("op-x").completed_rows == 400
    finally:
        fake.stop()


def test_new_coordinator_s3_and_environment_credentials(monkeypatch):
    fake = FakeS3().start()
    try:
        monkeypatch.setenv("AWS_ACCESS_KEY_ID", AK)
        monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", SK)
        cp = new_coordinator("s3", bucket="b", endpoint=fake.endpoint,
                             prefix="x/")
        assert isinstance(cp, S3Coordinator) and cp.prefix == "x/"
        cp.set_transfer_state("t", {"a": 1})
        assert cp.get_transfer_state("t") == {"a": 1}
        assert "x/transfers/t/state.json" in fake.objects
    finally:
        fake.stop()


# -- the JAX package's conformance cases, on the port -------------------------

@pytest.fixture(params=["s3", "s3-lww"])
def cp(request):
    fake = FakeS3(conditional_writes=(request.param == "s3"),
                  page_size=3).start()
    try:
        yield S3Coordinator(bucket="cp-bucket", endpoint=fake.endpoint,
                            access_key=AK, secret_key=SK)
    finally:
        fake.stop()


class TestPortCoordinator(ref_cp_tests.TestCoordinator):
    pass


class TestPortMvccConformance(ref_mvcc_tests.TestMvccConformance):
    pass


class TestPortTicketQueue(ref_queue_tests.TestTicketQueue):
    pass


class TestPortObsSegments(ref_obs_tests.TestObsSegmentConformance):
    def test_memory_put_bounds_per_worker_without_gc(self, cp):
        """The JAX case is of its memory backend: the port's memory
        coordinator trims at put time, and the S3 one's bound is its gc
        (below)."""
        from transferia_tpu_torch.coordinator import MemoryCoordinator
        from transferia_tpu_torch.coordinator.interface import (
            obs_segments_per_worker,
        )

        m = MemoryCoordinator()
        for seq in range(1, 40):
            m.put_obs_segment("s", ref_obs_tests.make_segment(
                worker="w0", seq=seq))
        assert len(m.list_obs_segments("s")) == obs_segments_per_worker()
        assert cp.supports_obs_segments()

    def test_torn_stored_segment_skipped(self, cp, tmp_path):
        cp.put_obs_segment("s", ref_obs_tests.make_segment(worker="w0",
                                                           seq=1))
        cp.client.put(cp._obs_key("s", "torn", 99),
                      b'{"worker": "torn", "seq": 99, "led')
        got = cp.list_obs_segments("s")
        assert [g["worker"] for g in got] == ["w0"]
        assert ref_obs_tests.merge_segments(got)["segments"] == 1
