"""The port's object-storage source and sink (`transferia_tpu_torch/
providers/s3.py`, `s3readers.py`, `coordinator/s3client.py`,
`utils/awssign.py`) against the JAX package's, on the CPU.  Every
comparison is exact.

- `awssign`: canonical query strings and SigV4 headers on fixed vectors.
- `S3Client` against both fakes (the JAX package's `tests/recipes/
  fake_s3.py` and the port's `recipes/fake_s3.py`): objects, listings of
  64 keys over 10-key pages, conditional writes and the 412 of a lost
  CAS, the degrade to `ConditionalUnsupported`, ranged GETs (the JAX
  fake answers them whole), unsigned reads of a public bucket.
- Each reader against the JAX package's over `file://` (pyarrow reads
  the reference side): Parquet batches of `batch_rows` rows across row
  groups in file order, JSONL schema inference, line, nginx.
- `S3Storage` over `s3://` on the port's fake against the JAX package's
  over `file://` on the same files: schema, `eta_rows`, parts by object
  name and every batch's rows in order.
- The snapshot's async part discovery: parts published while workers
  claim them, the discovery flag reset on re-activation, a discovery
  error reaching the caller, and the whole run equal to the JAX
  package's.
- The staged `jsonl` sink against the JAX package's, each on its own
  fake, and the plain sink over `file://`.
- csv, proto, `parquet` as a target, and other URL schemes raise naming
  ROADMAP.md A7.
"""

import datetime
import json
import os
import threading
import time

import fsspec
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tests.recipes.fake_s3 import FakeS3 as RefFakeS3
from transferia_tpu.abstract import TableID as RefTableID
from transferia_tpu.abstract.errors import \
    StaleEpochPublishError as RefStaleEpoch
from transferia_tpu.columnar.batch import ColumnBatch as RefColumnBatch
from transferia_tpu.coordinator import MemoryCoordinator as RefMemoryCP
from transferia_tpu.coordinator import s3client as ref_client
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models.transfer import Runtime as RefRuntime
from transferia_tpu.models.transfer import \
    ShardingUploadParams as RefSharding
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers import s3 as ref_s3
from transferia_tpu.providers import s3readers as ref_readers
from transferia_tpu.tasks import SnapshotLoader as RefLoader
from transferia_tpu.utils import awssign as ref_sign
from transferia_tpu_torch.abstract.errors import StaleEpochPublishError
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.coordinator import s3client as port_client
from transferia_tpu_torch.models import Runtime, ShardingUploadParams, Transfer
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers import s3 as port_s3
from transferia_tpu_torch.providers import s3readers as port_readers
from transferia_tpu_torch.recipes.clickbench import (
    clickbench_rows,
    slice_rows,
    write_clickbench,
)
from transferia_tpu_torch.recipes.fake_s3 import FakeS3
from transferia_tpu_torch.tasks import SnapshotLoader
from transferia_tpu_torch.utils import awssign as port_sign

AK, SK = "test-ak", "test-sk"
CHAIN = {"transformers": [
    {"mask_field": {"columns": ["URL"], "salt": "bench-salt"}},
    {"filter_rows": {"filter": "RegionID < 400 AND ResolutionWidth >= 390"}},
]}


# -- awssign -------------------------------------------------------------------

QUERIES = [{}, {"list-type": "2", "prefix": "a b/c"},
           {"continuation-token": "k~1+2", "z": "", "a": "ü/%"}]


@pytest.mark.parametrize("query", QUERIES)
def test_canonical_query_equals_jax(query):
    assert port_sign.canonical_query(query) == \
        ref_sign.canonical_query(query)


@pytest.mark.parametrize("method,host,path,query,headers,body,service", [
    ("GET", "127.0.0.1:9000", "/b/k%20x", {"list-type": "2"}, {}, b"",
     "s3"),
    ("PUT", "s3.us-east-1.amazonaws.com", "/b/dir/obj.json", {},
     {"If-Match": '"e1"', "Content-Type": "  a   b "}, b'{"x": 1}', "s3"),
    ("POST", "sqs.eu-west-1.amazonaws.com", "/", {},
     {"x-amz-target": "AmazonSQS.ReceiveMessage"}, b"{}", "sqs"),
])
def test_sign_request_equals_jax(method, host, path, query, headers, body,
                                 service):
    now = datetime.datetime(2026, 1, 2, 3, 4, 5,
                            tzinfo=datetime.timezone.utc)
    args = (method, host, path, query, headers, body, "eu-west-1", service,
            AK, SK)
    got = port_sign.sign_request(*args, now=now)
    assert got == ref_sign.sign_request(*args, now=now)
    assert got["authorization"].startswith(
        f"AWS4-HMAC-SHA256 Credential={AK}/20260102/eu-west-1/{service}/")


# -- the S3 client ---------------------------------------------------------------

@pytest.fixture(params=["port-fake", "jax-fake"])
def fake(request):
    cls = FakeS3 if request.param == "port-fake" else RefFakeS3
    f = cls(page_size=10).start()
    yield f
    f.stop()


def client_sequence(mod, endpoint: str) -> list:
    c = mod.S3Client("b", endpoint=endpoint, access_key=AK, secret_key=SK)
    out = [c.get("missing")]
    for i in range(64):
        c.put(f"dir/k{i:03d}", f"v{i}".encode())
    listing = c.list("dir/")
    out.append([(o.key, o.size, o.etag) for o in listing])
    out.append(len(c.list("")))
    e1 = c.put("cas", b"one", if_none_match=True)
    try:
        c.put("cas", b"two", if_none_match=True)
        out.append("no 412")
    except mod.PreconditionFailed as e:
        out.append(("412", e.status))
    e2 = c.put("cas", b"two", if_match=e1)
    try:
        c.put("cas", b"three", if_match=e1)
        out.append("no 412")
    except mod.PreconditionFailed as e:
        out.append(("412", e.status))
    out.append(c.get("cas"))
    out.append(e2 != e1)
    c.delete("cas")
    c.delete("cas")
    out.append(c.get("cas"))
    return out


def test_client_equals_jax_on_both_fakes(fake):
    got = client_sequence(port_client, fake.endpoint)
    fake.objects.clear()
    want = client_sequence(ref_client, fake.endpoint)
    assert got == want
    assert len(got[1]) == 64 and got[2] == 64
    assert got[3] == got[4] == ("412", 412)


@pytest.mark.parametrize("make", [FakeS3, RefFakeS3])
def test_conditional_unsupported_as_jax(make):
    f = make(conditional_writes=False).start()
    try:
        for mod in (port_client, ref_client):
            c = mod.S3Client("b", endpoint=f.endpoint, access_key=AK,
                             secret_key=SK)
            with pytest.raises(mod.ConditionalUnsupported):
                c.put("k", b"x", if_none_match=True)
            c.put("k", b"x")
            assert c.get("k")[0] == b"x"
    finally:
        f.stop()


def test_ranged_gets(fake):
    c = port_client.S3Client("b", endpoint=fake.endpoint, access_key=AK,
                             secret_key=SK)
    body = bytes(range(256)) * 40
    c.put("obj", body)
    for lo, hi in [(0, 1), (0, len(body)), (17, 4099), (len(body) - 8,
                                                        len(body))]:
        if isinstance(fake, FakeS3):
            assert c.get_range("obj", lo, hi) == body[lo:hi]
            continue
        # the JAX fake ignores Range and answers 200 with the whole body:
        # the client refuses it rather than cut it, span after span
        with pytest.raises(port_client.S3Error,
                           match="ignored the Range header") as e:
            c.get_range("obj", lo, hi)
        assert e.value.status == 200
    assert c.get_range("obj", 5, 5) == b""
    with pytest.raises(FileNotFoundError):
        c.get_range("absent", 0, 10)
    if isinstance(fake, FakeS3):
        # the port's fake answers 206
        assert fake.range_gets == 4 and fake.range_bytes == \
            1 + len(body) + 4082 + 8


def test_parquet_on_an_endpoint_that_ignores_range_raises(tmp_path):
    """A Parquet object behind an endpoint that answers ranged GETs with
    the whole object (the JAX package's fake) raises naming the ignored
    header, before any row is read."""
    paths, _ = write_objects(tmp_path, 3_000, 1, 1024)
    f = RefFakeS3().start()
    try:
        c = port_client.S3Client("clickbench", endpoint=f.endpoint,
                                 access_key=AK, secret_key=SK)
        with open(paths[0], "rb") as fh:
            c.put("hits/h0.parquet", fh.read())
        st = port_s3.S3Storage(port_s3.S3SourceParams(
            url="s3://clickbench/hits/*.parquet", endpoint_url=f.endpoint,
            anon=False, storage_options={"key": AK, "secret": SK},
            table="hits"))
        with pytest.raises(port_client.S3Error,
                           match="ignored the Range header"):
            st.table_list()
    finally:
        f.stop()


def test_anonymous_reads_of_a_public_bucket():
    f = FakeS3(public_read=True).start()
    private = FakeS3().start()
    try:
        signed = port_client.S3Client("b", endpoint=f.endpoint,
                                      access_key=AK, secret_key=SK)
        signed.put("hits/a", b"abc")
        anon = port_client.S3Client("b", endpoint=f.endpoint)
        assert not anon.signed
        assert anon.get("hits/a")[0] == b"abc"
        assert anon.get_range("hits/a", 1, 3) == b"bc"
        assert [o.key for o in anon.list("hits/")] == ["hits/a"]
        with pytest.raises(port_client.S3Error) as e:
            anon.put("hits/b", b"x")  # writes stay signed
        assert e.value.status == 403
        with pytest.raises(port_client.S3Error) as e:
            port_client.S3Client("b", endpoint=private.endpoint).list("")
        assert e.value.status == 403
    finally:
        f.stop()
        private.stop()


def test_listing_carries_last_modified():
    f = FakeS3().start()
    try:
        c = port_client.S3Client("b", endpoint=f.endpoint, access_key=AK,
                                 secret_key=SK)
        t0 = time.time()
        c.put("k", b"x")
        (obj,) = c.list("")
        assert abs(obj.last_modified - t0) < 5
        assert port_client._parse_last_modified(
            "2026-01-01T00:00:00.250Z") == 1767225600.25
    finally:
        f.stop()


# -- readers over file:// -------------------------------------------------------------

def write_objects(d, n: int, k: int, rg: int) -> tuple[list, int]:
    """n ClickBench rows as k Parquet files of `rg`-row groups."""
    rows = clickbench_rows(n)
    paths, kept = [], 0
    for i in range(k):
        p = str(d / f"h{i}.parquet")
        _, kk = write_clickbench(p, n // k, rows=slice_rows(
            rows, i * n // k, (i + 1) * n // k), row_group_rows=rg)
        paths.append(p)
        kept += kk
    return paths, kept


def rows_of(batch) -> list:
    return [tuple(it.as_dict().items()) for it in batch.to_rows()]


def read_all(reader, fs, path, tid, schema, batch_rows) -> list:
    out = []
    reader.read(fs, path, tid, schema, batch_rows, out.append)
    return out


@pytest.mark.parametrize("batch_rows", [1000, 4096, 5000, 20_000])
def test_parquet_reader_equals_jax(tmp_path, batch_rows):
    (path,), _ = write_objects(tmp_path, 12_000, 1, 4096)
    ref_fs = fsspec.filesystem("file")
    ref_r = ref_readers.ParquetReader()
    ref_schema = ref_r.infer_schema(ref_fs, path)
    fs, _ = port_s3._fs_for(f"file://{path}", port_s3.S3SourceParams())
    port_r = port_readers.make_reader("parquet", decode_threads=2)
    schema = port_r.infer_schema(fs, path)
    assert schema.to_json() == ref_schema.to_json()
    assert port_r.estimate_rows(fs, path) == \
        ref_r.estimate_rows(ref_fs, path) == 12_000
    want = read_all(ref_r, ref_fs, path, RefTableID("s3", "hits"),
                    ref_schema, batch_rows)
    got = read_all(port_r, fs, path, TableID("s3", "hits"), schema,
                   batch_rows)
    assert [b.n_rows for b in got] == [b.n_rows for b in want]
    assert [rows_of(b) for b in got] == [rows_of(b) for b in want]


JSONL_ROWS = [
    {"id": 1, "v": "a", "score": 1, "tags": ["x"], "meta": {"k": 1},
     "flag": True, "none": None},
    {"id": 2, "v": None, "score": 2.5, "tags": [], "meta": {"j": "q"},
     "flag": False, "none": None, "extra": 7},
    {"id": 3, "v": "ü", "score": -3, "tags": None, "meta": None,
     "flag": None, "none": None},
]


def test_jsonl_reader_equals_jax(tmp_path):
    path = tmp_path / "x.jsonl"
    lines = [json.dumps(r) for r in JSONL_ROWS] * 70 + [""]
    path.write_text("\n".join(lines) + "\n")
    ref_fs = fsspec.filesystem("file")
    fs, _ = port_s3._fs_for(f"file://{path}", port_s3.S3SourceParams())
    ref_r, port_r = ref_readers.JsonlReader(), port_readers.JsonlReader()
    schema = port_r.infer_schema(fs, str(path))
    ref_schema = ref_r.infer_schema(ref_fs, str(path))
    assert schema.to_json() == ref_schema.to_json()
    want = read_all(ref_r, ref_fs, str(path), RefTableID("s3", "j"),
                    ref_schema, 64)
    got = read_all(port_r, fs, str(path), TableID("s3", "j"), schema, 64)
    assert [rows_of(b) for b in got] == [rows_of(b) for b in want]
    assert [b.read_bytes for b in got] == [b.read_bytes for b in want]


@pytest.mark.parametrize("rows", [
    [{"a": 1}, {"a": True}], [{"a": 1.5}, {"a": "x"}], [{"a": 2 ** 64}]])
def test_jsonl_schema_that_arrow_refuses_raises(tmp_path, rows):
    with pytest.raises((pa.ArrowInvalid, pa.ArrowTypeError, OverflowError)):
        pa.Table.from_pylist(rows)
    with pytest.raises(port_readers.ReaderError):
        port_readers.infer_json_schema(rows)


NGINX_LINES = [
    '10.0.0.1 - - [01/Jan/2026:00:00:00 +0000] "GET / HTTP/1.1" 200 512 '
    '"-" "curl/8"',
    "",
    "garbage line",
    '10.0.0.2 - bob [01/Jan/2026:00:00:01 +0000] "POST /x HTTP/1.1" 500 - '
    '"http://r" "ua"',
] * 30


@pytest.mark.parametrize("fmt,policy", [("line", "route"),
                                        ("nginx", "route"),
                                        ("nginx", "skip")])
def test_line_and_nginx_readers_equal_jax(tmp_path, fmt, policy):
    path = tmp_path / "access.log"
    path.write_text("\n".join(NGINX_LINES) + "\n")
    ref_fs = fsspec.filesystem("file")
    fs, _ = port_s3._fs_for(f"file://{path}", port_s3.S3SourceParams())
    ref_r = ref_readers.make_reader(fmt, unparsed_policy=policy)
    port_r = port_readers.make_reader(fmt, unparsed_policy=policy)
    schema = port_r.infer_schema(fs, str(path))
    assert schema.to_json() == ref_r.infer_schema(ref_fs,
                                                  str(path)).to_json()
    want = read_all(ref_r, ref_fs, str(path), RefTableID("s3", "log"),
                    ref_r.infer_schema(ref_fs, str(path)), 25)
    got = read_all(port_r, fs, str(path), TableID("s3", "log"), schema, 25)
    strip = ("_timestamp",)  # the unparsed table stamps the read time
    assert [[tuple(kv for kv in r if kv[0] not in strip)
             for r in rows_of(b)] for b in got] == \
        [[tuple(kv for kv in r if kv[0] not in strip) for r in rows_of(b)]
         for b in want]
    assert [b.table_id.name for b in got] == [b.table_id.name for b in want]


def test_nginx_fail_policy_raises_as_jax(tmp_path):
    path = tmp_path / "access.log"
    path.write_text("\n".join(NGINX_LINES) + "\n")
    fs, _ = port_s3._fs_for(f"file://{path}", port_s3.S3SourceParams())
    r = port_readers.make_reader("nginx", unparsed_policy="fail")
    with pytest.raises(port_readers.ReaderError, match=":2: 'garbage"):
        read_all(r, fs, str(path), TableID("s3", "l"), r.schema, 10)
    rr = ref_readers.make_reader("nginx", unparsed_policy="fail")
    with pytest.raises(ref_readers.ReaderError, match=":2: 'garbage"):
        read_all(rr, fsspec.filesystem("file"), str(path),
                 RefTableID("s3", "l"), rr.schema, 10)


def test_glob_regex_as_fsspec(tmp_path):
    for rel in ("a/x.parquet", "a/y.jsonl", "a/b/z.parquet", "a/.staging/s",
                "a/x1.parquet", "c.parquet"):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("x")
    fs = fsspec.filesystem("file")
    local = port_s3.LocalFS()
    for pat in ("a/*.parquet", "a/**/*.parquet", "a/x?.parquet",
                "a/[xy]*", "a/[!x]*", "*.parquet", "a/**"):
        full = f"{tmp_path}/{pat}"
        want = sorted(p for p in fs.glob(full) if os.path.isfile(p))
        assert [i.path for i in local.glob(full)] == want, pat


# -- S3Storage over s3:// against the JAX package's over file:// -----------------

@pytest.fixture
def bucket(tmp_path):
    """Six ClickBench objects under hits/ on the port's fake (public
    read), the same files under tmp_path/hits, and a staging leftover
    readers must skip."""
    d = tmp_path / "hits"
    d.mkdir()
    paths, kept = write_objects(d, 18_000, 6, 2048)
    fake = FakeS3(public_read=True, page_size=4).start()
    for p in paths:
        with open(p, "rb") as fh:
            fake.put_object(f"hits/{os.path.basename(p)}", fh.read())
    fake.put_object("hits/.staging/x/e1/000000.s3.hits.parquet", b"junk")
    (d / ".staging").mkdir()
    (d / ".staging" / "junk.parquet").write_bytes(b"junk")
    yield fake, str(d), kept
    fake.stop()


def storages(fake, d: str, url_tail: str = "*.parquet", batch_rows=5000):
    port = port_s3.S3Storage(port_s3.S3SourceParams(
        url=f"s3://clickbench/hits/{url_tail}", endpoint_url=fake.endpoint,
        table="hits", batch_rows=batch_rows))
    ref = ref_s3.S3Storage(ref_s3.S3SourceParams(
        url=f"file://{d}/{url_tail}", table="hits", batch_rows=batch_rows))
    return port, ref


@pytest.mark.parametrize("url_tail", ["*.parquet", "", "h[0-2]*",
                                      "h?.parquet"])
def test_storage_equals_jax(bucket, url_tail):
    fake, d, _ = bucket
    port, ref = storages(fake, d, url_tail)
    base = lambda p: os.path.basename(p)  # noqa: E731
    assert [base(f) for f in port.files()] == [base(f) for f in ref.files()]
    assert all(f.startswith("clickbench/hits/") for f in port.files())
    (ptid, pinfo), = port.table_list().items()
    (rtid, rinfo), = ref.table_list().items()
    assert ptid.fqtn() == rtid.fqtn()
    assert pinfo.eta_rows == rinfo.eta_rows
    assert pinfo.schema.to_json() == rinfo.schema.to_json()
    from transferia_tpu.abstract.table import \
        TableDescription as RefTD
    from transferia_tpu_torch.abstract.table import TableDescription

    pparts = port.shard_table(TableDescription(id=ptid))
    rparts = ref.shard_table(RefTD(id=rtid))
    assert [(base(p.filter), p.eta_rows) for p in pparts] == \
        [(base(p.filter), p.eta_rows) for p in rparts]
    assert [(base(p.filter), p.eta_rows) for p in
            port.iter_table_parts(TableDescription(id=ptid))] == \
        [(base(p.filter), p.eta_rows) for p in pparts]
    assert all(p.filter.startswith("obj:clickbench/hits/") for p in pparts)
    for pp, rp in zip(pparts, rparts):
        got, want = [], []
        port.load_table(pp, got.append)
        ref.load_table(rp, want.append)
        assert [b.n_rows for b in got] == [b.n_rows for b in want]
        assert [rows_of(b) for b in got] == [rows_of(b) for b in want]


def test_storage_listing_pages_and_missing(bucket):
    fake, d, _ = bucket
    for i in range(64):  # 64 more objects: the listing spans 10-key pages
        fake.put_object(f"more/m{i:02d}.jsonl", b'{"id": 1}\n')
    st = port_s3.S3Storage(port_s3.S3SourceParams(
        url="s3://clickbench/more/", endpoint_url=fake.endpoint,
        format="jsonl"))
    assert len(st.files()) == 64
    assert st.table_list()[TableID("s3", "data")].eta_rows == 0
    with pytest.raises(FileNotFoundError, match="no objects match"):
        port_s3.S3Storage(port_s3.S3SourceParams(
            url="s3://clickbench/none/*.parquet",
            endpoint_url=fake.endpoint)).files()


def run_snapshot(pkg: str, url: str, sid: str, workers: int,
                 endpoint: str = "") -> tuple:
    """The bench chain into the memory sink: (rows by WatchID, parts by
    object name with their eta and rows)."""
    if pkg == "port":
        params = port_s3.S3SourceParams(url=url, endpoint_url=endpoint,
                                        table="hits", batch_rows=5000)
        t = Transfer(id=sid, src=params,
                     dst=port_memory.MemoryTargetParams(sink_id=sid),
                     transformation=CHAIN,
                     runtime=Runtime(sharding=ShardingUploadParams(
                         process_count=workers)))
        cp, mem = MemoryCoordinator(), port_memory
        SnapshotLoader(t, cp, operation_id=f"op-{sid}",
                       device="cpu").upload_tables()
    else:
        params = ref_s3.S3SourceParams(url=url, table="hits",
                                       batch_rows=5000)
        t = RefTransfer(id=sid, src=params,
                        dst=ref_memory.MemoryTargetParams(sink_id=sid),
                        transformation=CHAIN,
                        runtime=RefRuntime(sharding=RefSharding(
                            process_count=workers)))
        cp, mem = RefMemoryCP(), ref_memory
        RefLoader(t, cp, operation_id=f"op-{sid}").upload_tables()
    rows = sorted((tuple(it.as_dict().items())
                   for it in mem.get_store(sid).rows()),
                  key=lambda r: r[0][1])
    mem.get_store(sid).clear()
    parts = sorted((os.path.basename(p.filter), p.eta_rows,
                    p.completed_rows, p.completed, p.parts_count)
                   for p in cp.operation_parts(f"op-{sid}"))
    return rows, parts, cp.get_operation_state(f"op-{sid}")


@pytest.mark.parametrize("workers", [1, 3])
def test_snapshot_equals_jax(bucket, workers):
    fake, d, kept = bucket
    got = run_snapshot("port", "s3://clickbench/hits/*.parquet",
                       f"s3p{workers}", workers, fake.endpoint)
    want = run_snapshot("jax", f"file://{d}/*.parquet", f"s3r{workers}",
                        workers)
    assert got[0] == want[0] and len(got[0]) == kept
    assert got[1] == want[1] and len(got[1]) == 6
    assert got[2] == want[2] == {"parts_discovery_done": True}
    # each row group once: a footer GET and a GET a row group an object
    # (the footers read once for the listing's eta, shared after)
    assert fake.range_gets == 6 + 6 * 2


class Recorder:
    """A memory coordinator that logs add_operation_parts, the claims
    and the discovery flag, in order."""

    def __init__(self):
        self.cp = MemoryCoordinator()
        self.log = []
        self.lock = threading.Lock()
        cp = self.cp
        real_add, real_assign, real_set = (cp.add_operation_parts,
                                           cp.assign_operation_part,
                                           cp.set_operation_state)

        def add(op, parts):
            with self.lock:
                self.log.append(("add", len(parts)))
            real_add(op, parts)

        def assign(op, w):
            part = real_assign(op, w)
            if part is not None:
                with self.lock:
                    self.log.append(("claim", part.part_index))
            return part

        def set_state(op, state):
            if "parts_discovery_done" in state:
                with self.lock:
                    self.log.append(("done", state["parts_discovery_done"]))
            real_set(op, state)

        cp.add_operation_parts = add
        cp.assign_operation_part = assign
        cp.set_operation_state = set_state


def test_async_discovery_streams_parts_and_resets(bucket, monkeypatch):
    fake, _, kept = bucket
    real = port_s3.S3Storage.iter_table_parts

    def slow(self, table):
        for td in real(self, table):
            yield td
            time.sleep(0.15)  # past the 0.1 s flush age: a flush a part

    monkeypatch.setattr(port_s3.S3Storage, "iter_table_parts", slow)
    rec = Recorder()
    t = Transfer(id="disc", src=port_s3.S3SourceParams(
        url="s3://clickbench/hits/*.parquet", endpoint_url=fake.endpoint,
        table="hits", batch_rows=5000),
        dst=port_memory.MemoryTargetParams(sink_id="disc"),
        transformation=CHAIN,
        runtime=Runtime(sharding=ShardingUploadParams(process_count=2)))
    for run in range(2):  # the second run is a re-activation
        rec.log.clear()
        SnapshotLoader(t, rec.cp, operation_id="op-disc",
                       device="cpu").upload_tables()
        log = rec.log
        assert log[0] == ("done", False), log
        adds = [i for i, e in enumerate(log) if e[0] == "add"]
        claims = [i for i, e in enumerate(log) if e[0] == "claim"]
        # flushed by age: the first part waits for the second's
        assert [log[i][1] for i in adds] == [2, 1, 1, 1, 1], log
        assert sorted(log[i][1] for i in claims) == list(range(6)), log
        # a worker claimed a part before discovery published the last
        assert claims[0] < adds[-1], log
        assert log[-1] == ("done", True) or ("done", True) in log
        parts = rec.cp.operation_parts("op-disc")
        assert len(parts) == 6 and all(p.completed for p in parts)
        assert sum(p.completed_rows for p in parts) == 18_000
        assert port_memory.get_store("disc").row_count() == kept
        port_memory.get_store("disc").clear()


def test_discovery_error_reaches_the_caller(bucket, monkeypatch):
    fake, _, _ = bucket

    def broken(self, table):
        yield from ()
        raise ConnectionError("listing died")

    monkeypatch.setattr(port_s3.S3Storage, "iter_table_parts", broken)
    cp = MemoryCoordinator()
    t = Transfer(id="derr", src=port_s3.S3SourceParams(
        url="s3://clickbench/hits/*.parquet", endpoint_url=fake.endpoint,
        table="hits"), dst=port_memory.MemoryTargetParams(sink_id="derr"))
    with pytest.raises(ConnectionError, match="listing died"):
        SnapshotLoader(t, cp, device="cpu").upload_tables()
    assert cp.get_operation_state("op-derr")["parts_discovery_done"]


# -- the sink ----------------------------------------------------------------------

def sink_batch(mod, cb, tid, lo: int, hi: int):
    schema = mod.new_table_schema([("id", "int64"), ("v", "utf8"),
                                   ("x", "double")])
    return cb.from_pydict(tid("s3", "t"), schema, {
        "id": list(range(lo, hi)), "v": [f"v{i}" for i in range(lo, hi)],
        "x": [i / 4 for i in range(lo, hi)]})


def staged_sequence(pkg: str, fake) -> list:
    """begin / push / publish sequences on a staged s3:// sink: a push
    retry, a restage, a newer epoch replacing the publish, a zombie."""
    if pkg == "port":
        from transferia_tpu_torch.abstract import schema as smod

        mod, cb, tid, stale = port_s3, ColumnBatch, TableID, \
            StaleEpochPublishError
        make = lambda: port_s3.S3Sinker(params, device="cpu")  # noqa
    else:
        from transferia_tpu.abstract import schema as smod

        mod, cb, tid, stale = ref_s3, RefColumnBatch, RefTableID, \
            RefStaleEpoch
        make = lambda: ref_s3.S3Sinker(params)  # noqa
    params = mod.S3TargetParams(url="s3://out/dump", format="jsonl",
                                endpoint_url=fake.endpoint, access_key=AK,
                                secret_key=SK)
    out = []
    s = make()
    out.append(s.staged_commit_available())
    s.begin_part("s3.t/0", 1)
    s.push(sink_batch(smod, cb, tid, 0, 10))
    s.note_push_retry()
    s.push(sink_batch(smod, cb, tid, 0, 10))   # the retried push
    s.push(sink_batch(smod, cb, tid, 10, 15))
    out.append(s.publish_part("s3.t/0", 1))
    out.append(s.last_dedup_dropped)
    s2 = make()
    s2.begin_part("s3.t/0", 3)
    s2.push(sink_batch(smod, cb, tid, 100, 104))
    out.append(s2.publish_part("s3.t/0", 3))
    zombie = make()
    zombie.begin_part("s3.t/0", 2)
    zombie.push(sink_batch(smod, cb, tid, 50, 60))
    try:
        zombie.publish_part("s3.t/0", 2)
        out.append("published")
    except stale as e:
        out.append(("stale", e.epoch, e.published_epoch))
    aborted = make()
    aborted.begin_part("s3.t/1", 1)
    aborted.push(sink_batch(smod, cb, tid, 0, 3))
    aborted.abort_part("s3.t/1")
    out.append({k: v[0].decode() for k, v in sorted(fake.objects.items())})
    return out


def test_staged_sink_equals_jax():
    port_fake, ref_fake = FakeS3().start(), RefFakeS3().start()
    try:
        got = staged_sequence("port", port_fake)
        want = staged_sequence("jax", ref_fake)
    finally:
        port_fake.stop()
        ref_fake.stop()
    assert got == want
    assert got[:5] == [True, 15, 10, 4, ("stale", 2, 3)]
    finals = [k for k in got[5] if not k.startswith("dump/.staging/")]
    assert len(finals) == 1 and got[5][finals[0]].count("\n") == 4


def test_plain_sink_over_file_equals_jax(tmp_path):
    from transferia_tpu.abstract import schema as ref_smod
    from transferia_tpu_torch.abstract import schema as port_smod

    outs = {}
    for pkg, mod, cb, tid, smod in (
            ("port", port_s3, ColumnBatch, TableID, port_smod),
            ("jax", ref_s3, RefColumnBatch, RefTableID, ref_smod)):
        d = tmp_path / pkg
        d.mkdir()  # fsspec's local writer makes no directories
        s = mod.S3Sinker(mod.S3TargetParams(url=f"file://{d}",
                                            format="jsonl",
                                            max_rows_per_file=25))
        assert not s.staged_commit_available()
        for lo in range(0, 60, 10):
            s.push(sink_batch(smod, cb, tid, lo, lo + 10))
        s.close()
        outs[pkg] = sorted((f.replace(s.token, "T"), (d / f).read_text())
                           for f in os.listdir(d))
    assert outs["port"] == outs["jax"] and len(outs["port"]) == 2


# -- what is not ported ---------------------------------------------------------------

def test_unported_formats_and_schemes_raise(tmp_path):
    for fmt in ("csv", "proto"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
            port_s3.S3SourceParams(url=f"file://{tmp_path}",
                                   format=fmt).make_reader()
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
        port_s3.S3Sinker(port_s3.S3TargetParams(url=f"file://{tmp_path}"))
    for url in ("gs://b/x.parquet", "az://c/x", "https://h/x"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
            port_s3.S3Storage(port_s3.S3SourceParams(url=url)).files()
    with pytest.raises(port_readers.ReaderError, match="unknown s3 format"):
        port_readers.make_reader("xml")
    # the JAX package reads csv through pyarrow
    path = tmp_path / "a.csv"
    path.write_text("a,b\n1,x\n")
    assert ref_readers.make_reader("csv").infer_schema(
        fsspec.filesystem("file"), str(path)).to_json()[0]["name"] == "a"


def test_params_round_trip_equals_jax():
    for port_cls, ref_cls in ((port_s3.S3SourceParams,
                               ref_s3.S3SourceParams),
                              (port_s3.S3TargetParams,
                               ref_s3.S3TargetParams)):
        d = port_cls(url="s3://b/p", storage_options={"key": "k"}).to_dict()
        assert d == ref_cls(url="s3://b/p",
                            storage_options={"key": "k"}).to_dict()
        assert port_cls.from_dict(d).to_dict() == d


def test_parquet_footer_ranged_reads(tmp_path):
    """The footer with one read of the file's tail, a second only when
    the footer is longer than the guess."""
    (path,), _ = write_objects(tmp_path, 4000, 1, 1000)
    from transferia_tpu_torch.providers.parquet_meta import (
        parquet_metadata,
        read_footer_ranged,
    )

    data = open(path, "rb").read()
    for guess, reads in ((1 << 16, 1), (64, 2)):
        calls = []

        def read(lo, hi):
            calls.append((lo, hi))
            return data[lo:hi]

        meta = read_footer_ranged(read, len(data), path, guess=guess)
        assert len(calls) == reads
        assert meta == parquet_metadata(path)
    assert pq.ParquetFile(path).metadata.num_rows == meta.num_rows
