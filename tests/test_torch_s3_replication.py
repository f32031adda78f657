"""The port's S3 replication source (`transferia_tpu_torch/providers/
s3source.py`) against the JAX package's, on the CPU, as
tests/e2e/test_s3_replication_e2e.py runs the JAX one: each scenario on
both packages, the JAX package over `file://` with its fake SQS, the port
over `s3://` on its own fake S3 (and over `file://`) with its own fake
SQS.  Equal rows delivered (each once), equal watermarks, every message
consumed.  Exact throughout.
"""

import json
import os
import threading
import time

import fsspec
import pytest

from tests.recipes.fake_sqs import FakeSQS as RefFakeSQS
from transferia_tpu.coordinator import MemoryCoordinator as RefMemoryCP
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models import TransferType as RefTransferType
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers import s3 as ref_s3
from transferia_tpu.providers import s3source as ref_source
from transferia_tpu.runtime import run_replication as ref_run_replication
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import Transfer, TransferType
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers import s3 as port_s3
from transferia_tpu_torch.providers import s3source as port_source
from transferia_tpu_torch.recipes.fake_s3 import FakeS3
from transferia_tpu_torch.recipes.fake_sqs import FakeSQS
from transferia_tpu_torch.runtime.local import run_replication

AK, SK = "test-ak", "test-sk"


class Place:
    """Where one package's objects land: a local directory (`file://`) or
    a bucket on the port's fake S3 (`s3://b/in`)."""

    def __init__(self, tmp_path, kind: str):
        self.kind = kind
        self.dir = tmp_path / f"bucket-{kind}"
        self.dir.mkdir()
        self.fake = FakeS3(public_read=True).start() if kind == "s3" \
            else None

    @property
    def url(self) -> str:
        return "s3://b/in" if self.fake else f"file://{self.dir}"

    def key(self, name: str) -> str:
        """What an S3 notification names: a bucket key, or (the JAX
        e2e's form over file://) the local path."""
        return f"in/{name}" if self.fake else str(self.dir / name)

    def write(self, name: str, rows: list, mtime=None) -> None:
        body = "".join(json.dumps(r) + "\n" for r in rows).encode()
        if self.fake:
            self.fake.put_object(f"in/{name}", body)
            if mtime is not None:
                self.fake.mtimes[f"in/{name}"] = mtime
        else:
            (self.dir / name).write_bytes(body)
            if mtime is not None:
                os.utime(self.dir / name, (mtime, mtime))

    def close(self) -> None:
        if self.fake:
            self.fake.stop()


PKG = {
    "port": dict(transfer=Transfer, ttype=TransferType, cp=MemoryCoordinator,
                 memory=port_memory, s3=port_s3, source=port_source,
                 sqs=FakeSQS, run=lambda t, cp, stop: run_replication(
                     t, cp, stop_event=stop, backoff=0.1, device="cpu")),
    "jax": dict(transfer=RefTransfer, ttype=RefTransferType, cp=RefMemoryCP,
                memory=ref_memory, s3=ref_s3, source=ref_source,
                sqs=RefFakeSQS, run=lambda t, cp, stop: ref_run_replication(
                    t, cp, stop_event=stop, backoff=0.1)),
}


def src_params(pkg: str, place: Place, **kw):
    extra = {"endpoint_url": place.fake.endpoint} if place.fake else {}
    return PKG[pkg]["s3"].S3SourceParams(
        url=place.url, format="jsonl", table="events", **extra, **kw)


def start(pkg: str, t, cp):
    stop = threading.Event()
    th = threading.Thread(target=PKG[pkg]["run"], args=(t, cp, stop),
                          daemon=True)
    th.start()
    return stop, th


def wait_rows(store, n, timeout=20.0):
    deadline = time.monotonic() + timeout
    while store.row_count() < n and time.monotonic() < deadline:
        time.sleep(0.05)
    return store.row_count()


def ids(store) -> list:
    return sorted(r.value("id") for r in store.rows())


def poll_scenario(pkg: str, place: Place, sid: str) -> tuple:
    p = PKG[pkg]
    store = p["memory"].get_store(sid)
    store.clear()
    place.write("b1.jsonl", [{"id": i, "v": f"a{i}"} for i in range(3)])
    cp = p["cp"]()
    t = p["transfer"](id=sid, type=p["ttype"].INCREMENT_ONLY,
                      src=src_params(pkg, place, event_source="poll",
                                     poll_interval=0.1),
                      dst=p["memory"].MemoryTargetParams(sink_id=sid))
    stop, th = start(pkg, t, cp)
    counts = [wait_rows(store, 3)]
    time.sleep(0.05)
    place.write("b2.jsonl", [{"id": 3, "v": "a3"}])  # lands mid-run
    counts.append(wait_rows(store, 4))
    stop.set()
    th.join(timeout=10)
    assert not th.is_alive()
    wm = cp.get_transfer_state(sid)["s3_poll_watermark"]
    place.write("b3.jsonl", [{"id": 4, "v": "a4"}])
    stop2, th2 = start(pkg, t, cp)  # a restarted worker resumes
    counts.append(wait_rows(store, 5))
    stop2.set()
    th2.join(timeout=10)
    got = ids(store)
    store.clear()
    return counts, got, [os.path.basename(n) for n in wm["names"]]


@pytest.mark.parametrize("kind", ["s3", "file"])
def test_poll_replication_with_resume_equals_jax(tmp_path, kind):
    port, ref = Place(tmp_path, kind), Place(tmp_path, "ref")
    try:
        got = poll_scenario("port", port, f"s3pp-{kind}")
        want = poll_scenario("jax", ref, f"s3pr-{kind}")
    finally:
        port.close()
        ref.close()
    assert got == want
    assert got[1] == [0, 1, 2, 3, 4] and "b2.jsonl" in got[2]


def sqs_scenario(pkg: str, place: Place, sid: str) -> tuple:
    p = PKG[pkg]
    sqs = p["sqs"]().start()
    try:
        store = p["memory"].get_store(sid)
        store.clear()
        t = p["transfer"](
            id=sid, type=p["ttype"].INCREMENT_ONLY,
            src=src_params(pkg, place, event_source="sqs",
                           sqs_queue_url=sqs.queue_url, sqs_access_key=AK,
                           sqs_secret_key=SK, sqs_wait_seconds=0,
                           path_pattern="*.jsonl"),
            dst=p["memory"].MemoryTargetParams(sink_id=sid))
        stop, th = start(pkg, t, p["cp"]())
        place.write("x1.jsonl", [{"id": 1, "v": "one"}])
        sqs.send_s3_event(place.key("x1.jsonl"))
        counts = [wait_rows(store, 1)]
        # an SNS-wrapped event, a non-matching key and a test event
        place.write("x2.jsonl", [{"id": 2, "v": "two"}])
        sqs.send_raw(json.dumps({"Event": "s3:TestEvent"}))
        sqs.send_s3_event(place.key("ignore.tmp"))
        sqs.send_s3_event(place.key("x2.jsonl"), sns_wrapped=True)
        counts.append(wait_rows(store, 2))
        stop.set()
        th.join(timeout=10)
        assert not th.is_alive()
        deadline = time.monotonic() + 5
        while sqs.queue and time.monotonic() < deadline:
            time.sleep(0.05)
        got = ids(store)
        store.clear()
        return counts, got, len(sqs.queue), len(sqs.deleted)
    finally:
        sqs.stop()


@pytest.mark.parametrize("kind", ["s3", "file"])
def test_sqs_replication_equals_jax(tmp_path, kind):
    port, ref = Place(tmp_path, kind), Place(tmp_path, "ref")
    try:
        got = sqs_scenario("port", port, f"s3sp-{kind}")
        want = sqs_scenario("jax", ref, f"s3sr-{kind}")
    finally:
        port.close()
        ref.close()
    assert got == want == ([1, 2], [1, 2], 0, 4)


def redelivery(pkg: str, place: Place) -> list:
    """A failed push leaves the message; it replicates again once its
    visibility timeout re-delivers it (at-least-once)."""
    import concurrent.futures

    p = PKG[pkg]
    sqs = p["sqs"](visibility=0.2).start()
    try:
        params = src_params(pkg, place, event_source="sqs",
                            sqs_queue_url=sqs.queue_url, sqs_access_key=AK,
                            sqs_secret_key=SK, sqs_wait_seconds=0)
        place.write("y.jsonl", [{"id": 7, "v": "seven"}])
        sqs.send_s3_event(place.key("y.jsonl"))
        pushed, fails = [], {"left": 1}

        class FlakySink:
            def async_push(self, batch):
                f = concurrent.futures.Future()
                if fails["left"] > 0:
                    fails["left"] -= 1
                    f.set_exception(RuntimeError("injected"))
                else:
                    pushed.extend(batch.to_rows())
                    f.set_result(None)
                return f

        stop = threading.Event()

        def worker():
            while not stop.is_set():
                src = p["source"].S3ReplicationSource(params, "r",
                                                      p["cp"]())
                threading.Thread(target=lambda e=stop, s=src: (
                    e.wait(), s.stop()), daemon=True).start()
                try:
                    src.run(FlakySink())
                    return
                except RuntimeError:
                    time.sleep(0.05)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        deadline = time.monotonic() + 20
        while not pushed and time.monotonic() < deadline:
            time.sleep(0.05)
        stop.set()
        th.join(timeout=10)
        deadline = time.monotonic() + 5
        while sqs.queue and time.monotonic() < deadline:
            time.sleep(0.05)
        return [[r.value("id") for r in pushed], len(sqs.queue)]
    finally:
        sqs.stop()


@pytest.mark.parametrize("kind", ["s3", "file"])
def test_sqs_redelivery_after_failed_push_equals_jax(tmp_path, kind):
    port, ref = Place(tmp_path, kind), Place(tmp_path, "ref")
    try:
        got = redelivery("port", port)
        want = redelivery("jax", ref)
    finally:
        port.close()
        ref.close()
    assert got == want == [[7], 0]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_sqs_multi_record_message_deleted_only_when_all_committed(pkg):
    p = PKG[pkg]
    sqs = p["sqs"]().start()
    try:
        sqs.send_raw(json.dumps({"Records": [
            {"eventName": "ObjectCreated:Put",
             "s3": {"bucket": {"name": "b"},
                    "object": {"key": f"in/m{i}.jsonl", "size": 1}}}
            for i in (1, 2)]}))
        params = p["s3"].S3SourceParams(
            url="s3://b/in", format="jsonl", event_source="sqs",
            sqs_queue_url=sqs.queue_url, sqs_access_key=AK,
            sqs_secret_key=SK, sqs_wait_seconds=0)
        fetcher = p["source"].SQSObjectFetcher(params)
        keys = fetcher.fetch_objects()
        assert keys == ["in/m1.jsonl", "in/m2.jsonl"]
        fetcher.commit(keys[0])
        assert sqs.queue, "message deleted before all records committed"
        fetcher.commit(keys[1])
        assert not sqs.queue
    finally:
        sqs.stop()


def fetcher_runs(pkg: str, place: Place, fs, root: str) -> list:
    """Same-second objects whose names sort before a committed one, then a
    resumed fetcher; a glob root."""
    p = PKG[pkg]
    cp = p["cp"]()
    place.write("b.jsonl", [{"id": 1}], mtime=1000)
    f = p["source"].PollingObjectFetcher(fs, root, "t", cp)
    got = [f.fetch_objects()]
    f.commit(got[0][0])
    place.write("a.jsonl", [{"id": 2}], mtime=1000)
    got.append(f.fetch_objects())
    f.commit(got[1][0])
    got.append(p["source"].PollingObjectFetcher(fs, root, "t",
                                                cp).fetch_objects())
    place.write("x.tmp", [{"id": 3}])
    got.append(p["source"].PollingObjectFetcher(
        fs, f"{root}/*.jsonl", "t2", p["cp"]()).fetch_objects())
    return [[os.path.basename(k) for k in g] for g in got]


@pytest.mark.parametrize("kind", ["s3", "file"])
def test_polling_watermark_and_glob_equal_jax(tmp_path, kind):
    port, ref = Place(tmp_path, kind), Place(tmp_path, "ref")
    try:
        fs, root = port_s3._fs_for(port.url, port_s3.S3SourceParams(
            endpoint_url=port.fake.endpoint if port.fake else ""))
        got = fetcher_runs("port", port, fs, root)
        want = fetcher_runs("jax", ref, fsspec.filesystem("file"),
                            str(ref.dir))
    finally:
        port.close()
        ref.close()
    assert got == want == [["b.jsonl"], ["a.jsonl"], [],
                           ["a.jsonl", "b.jsonl"]]


def test_object_replication_through_the_chain_into_s3(tmp_path):
    """16 objects landing while the port's source polls them, through the
    mask, into an s3:// jsonl target: every row once."""
    fake = FakeS3(public_read=True).start()
    try:
        t = Transfer(
            id="s3chain", type=TransferType.INCREMENT_ONLY,
            src=port_s3.S3SourceParams(
                url="s3://b/in/*.jsonl", endpoint_url=fake.endpoint,
                format="jsonl", table="events", event_source="poll",
                poll_interval=0.05, batch_rows=100),
            dst=port_s3.S3TargetParams(
                url="s3://b/out", format="jsonl", endpoint_url=fake.endpoint,
                access_key=AK, secret_key=SK, max_rows_per_file=10_000),
            transformation={"transformers": [{"mask_field": {
                "columns": ["v"], "salt": "s"}}]})
        cp, stop = MemoryCoordinator(), threading.Event()
        th = threading.Thread(target=run_replication, args=(t, cp),
                              kwargs={"stop_event": stop, "device": "cpu",
                                      "backoff": 0.1}, daemon=True)
        th.start()
        for o in range(16):
            fake.put_object(f"in/o{o:02d}.jsonl", "".join(
                json.dumps({"id": o * 50 + i, "v": f"v{i}"}) + "\n"
                for i in range(50)).encode())
            time.sleep(0.01)
        deadline = time.monotonic() + 30
        while "b/in/o15.jsonl" not in cp.get_transfer_state("s3chain").get(
                "s3_poll_watermark", {}).get("names", []) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        stop.set()
        th.join(10)
        assert not th.is_alive()
        # an object sink writes its open objects whole when it closes
        rows = [json.loads(ln) for k, (body, _) in fake.objects.items()
                if k.startswith("out/") for ln in body.decode().splitlines()]
        want = 16 * 50
    finally:
        fake.stop()
    import hashlib
    import hmac

    assert sorted(r["id"] for r in rows) == list(range(want))
    assert all(r["v"] == hmac.new(b"s", f"v{r['id'] % 50}".encode(),
                                  hashlib.sha256).hexdigest() for r in rows)
