"""S3 / object-storage provider: the port's copy of
``transferia_tpu/providers/s3.py`` (reference: pkg/providers/s3/).

The snapshot source (`S3Storage`) lists the objects a URL names and reads
each through a format reader (providers/s3readers.py), one part an
object (`obj:<path>`), published while the upload runs
(AsyncPartDiscovery, tpp_setter_async.go).  The sink (`S3Sinker`) writes
`jsonl` objects with size-based splitting (sink/file_splitter.go), and,
on an `s3://` target with credentials, stages them for the snapshot's
fenced two-phase commit.  A replication source (providers/s3source.py)
follows new objects through SQS notifications or a polling listing.

Storage access: `s3://bucket/prefix` goes through the port's S3 REST
client (coordinator/s3client.py): a listing with ListObjectsV2, whole
objects or byte ranges with GET, unsigned with `anon: true` (a public
bucket, the default) and SigV4-signed with credentials from
`storage_options` (`key`, `secret`) or AWS_ACCESS_KEY_ID and
AWS_SECRET_ACCESS_KEY otherwise; `file://` (or a bare path) goes through
the local file system.  Paths have the form s3fs gives them: `bucket/key`
in a bucket, absolute paths on the local disk.  The JAX package reaches
storage through fsspec, which the port does not import.

Not ported (each raises NotImplementedError naming ROADMAP.md A7): other
URL schemes (gs://, az://, ...), the csv and proto formats (s3readers.py)
and `parquet` as a target format, whose writer is pyarrow's.
"""

from __future__ import annotations

import json
import logging
import os
import re
import uuid
from dataclasses import dataclass, field
from typing import Optional

from transferia_tpu_torch.abstract.commit import StagedSinker
from transferia_tpu_torch.abstract.errors import (
    CategorizedError,
    StaleEpochPublishError,
)
from transferia_tpu_torch.abstract.interfaces import (
    AsyncPartDiscovery,
    Batch,
    Pusher,
    ShardingStorage,
    Sinker,
    Storage,
    TableInfo,
    is_columnar,
)
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator.s3client import (
    ConditionalUnsupported,
    PreconditionFailed,
    S3Client,
)
from transferia_tpu_torch.models.endpoint import (
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.providers.parquet_native import MappedFile
from transferia_tpu_torch.providers.registry import (
    Provider,
    TestResult,
    register_provider,
)
from transferia_tpu_torch.providers.s3readers import NOT_PORTED, RangedObject
from transferia_tpu_torch.runtime.device import DeviceLike
from transferia_tpu_torch.runtime.limits import effective_cpus
from transferia_tpu_torch.stats import trace

logger = logging.getLogger(__name__)


@register_endpoint
@dataclass
class S3SourceParams(EndpointParams):
    PROVIDER = "s3"
    IS_SOURCE = True

    url: str = ""              # e.g. s3://bucket/prefix/*.parquet
    format: str = "parquet"    # parquet | jsonl | line | nginx (csv, proto)
    table: str = "data"
    namespace: str = "s3"
    batch_rows: int = 65_536
    endpoint_url: str = ""     # custom S3 endpoint (minio etc.)
    anon: bool = True
    storage_options: dict = field(default_factory=dict)
    nginx_format: str = ""     # log_format template (default: combined)
    unparsed_policy: str = "route"   # route | skip | fail
    parser: Optional[dict] = None    # protobuf descriptor config (proto)

    # -- replication (reference pkg/providers/s3/source/) -------------------
    event_source: str = ""     # "" (snapshot-only) | poll | sqs
    poll_interval: float = 5.0
    sqs_queue_url: str = ""
    sqs_region: str = "us-east-1"
    sqs_access_key: str = ""
    sqs_secret_key: str = ""
    sqs_endpoint: str = ""     # custom endpoint (localstack / fakes)
    sqs_wait_seconds: int = 10
    path_pattern: str = ""     # restrict replicated keys (glob)

    def make_reader(self, upload_workers: int = 1):
        from transferia_tpu_torch.providers.s3readers import make_reader

        cpus = int(effective_cpus())
        return make_reader(
            self.format, nginx_format=self.nginx_format,
            unparsed_policy=self.unparsed_policy,
            # as the fs source's auto: parts already decode in parallel
            # across upload workers, so a part widens only on spare cores
            decode_threads=max(1, min(8, cpus // (2 * upload_workers))),
            readahead_groups=2 if cpus >= 2 else 0,
        )


@register_endpoint
@dataclass
class S3TargetParams(EndpointParams):
    PROVIDER = "s3"
    IS_TARGET = True

    url: str = ""              # output directory URL
    format: str = "parquet"    # jsonl (parquet: not ported)
    endpoint_url: str = ""
    anon: bool = False
    storage_options: dict = field(default_factory=dict)
    max_rows_per_file: int = 1_000_000   # file splitting (file_splitter.go)
    # -- staged-commit credentials (the exactly-once object path signs
    # its own requests through the SigV4 client)
    access_key: str = ""
    secret_key: str = ""
    region: str = "us-east-1"


# -- object stores -----------------------------------------------------------

@dataclass
class ObjectInfo:
    path: str
    size: int
    mtime: float
    etag: str


def glob_regex(pattern: str) -> "re.Pattern":
    """A glob as fsspec matches it over whole paths: `*` and `?` within
    one path component, `**` across components (`**/` also matching
    none), `[...]` / `[!...]` character classes."""
    out, i, n = [], 0, len(pattern)
    while i < n:
        if pattern.startswith("**/", i):
            out.append("(?:.*/)?")
            i += 3
            continue
        if pattern.startswith("**", i):
            out.append(".*")
            i += 2
            continue
        c = pattern[i]
        if c == "*":
            out.append("[^/]*")
        elif c == "?":
            out.append("[^/]")
        elif c == "[" and pattern.find("]", i + 1) > i:
            j = pattern.find("]", i + 1)
            cls = pattern[i + 1:j]
            if cls.startswith("!"):
                cls = "^" + cls[1:]
            out.append(f"[{cls}]")
            i = j + 1
            continue
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("".join(out) + r"\Z")


def _has_magic(path: str) -> bool:
    """Whether a URL's path is a glob: a `*` or `?` in it, as the
    reference decides (a `[` alone names a key)."""
    return "*" in path or "?" in path


def _glob_base(pattern: str) -> str:
    """The wildcard-free leading directory of a glob."""
    head = re.split(r"[*?\[]", pattern, 1)[0]
    return head.rsplit("/", 1)[0] if "/" in head else head


class BucketFS:
    """A bucket through the port's S3 client; paths are `bucket/key`."""

    def __init__(self, client: S3Client):
        self.client = client
        self.bucket = client.bucket
        self.endpoint = f"{client.host}:{client.port}"
        self._infos: dict[str, ObjectInfo] = {}

    def _key(self, path: str) -> str:
        bucket, _, key = path.partition("/")
        if bucket != self.bucket:
            raise ValueError(f"{path!r} is not in bucket {self.bucket!r}")
        return key

    def _listed(self, prefix_key: str) -> list[ObjectInfo]:
        out = []
        for o in self.client.list(prefix_key):
            info = ObjectInfo(f"{self.bucket}/{o.key}", o.size,
                              o.last_modified, o.etag)
            self._infos[info.path] = info
            out.append(info)
        return out

    def find(self, root: str) -> list[ObjectInfo]:
        """Every object under the directory `root`, or `root` itself."""
        key = self._key(root.rstrip("/")) if "/" in root else ""
        under = self._listed(key + "/" if key else "")
        if under or not key:
            return sorted(under, key=lambda i: i.path)
        info = self.info(root)
        return [info] if info is not None else []

    def glob(self, pattern: str) -> list[ObjectInfo]:
        rx = glob_regex(pattern)
        base = _glob_base(pattern)
        key = self._key(base) if "/" in base else ""
        return sorted((i for i in self._listed(key + "/" if key else "")
                       if rx.match(i.path)), key=lambda i: i.path)

    def isdir(self, path: str) -> bool:
        key = self._key(path.rstrip("/")) if "/" in path else ""
        return not key or bool(self.client.list(key + "/"))

    def info(self, path: str) -> Optional[ObjectInfo]:
        info = self._infos.get(path)
        if info is None:
            key = self._key(path)
            for i in self._listed(key):
                if i.path == path:
                    info = i
        return info

    def read_range(self, path: str, lo: int, hi: int) -> bytes:
        return self.client.get_range(self._key(path), lo, hi)

    def cat(self, path: str) -> bytes:
        got = self.client.get(self._key(path))
        if got is None:
            raise FileNotFoundError(f"s3://{path}")
        return got[0]

    def write(self, path: str, data: bytes) -> None:
        self.client.put(self._key(path), data)

    def byte_source(self, path: str):
        info = self.info(path)
        if info is None:
            raise FileNotFoundError(f"s3://{path}")
        return RangedObject(self, path, info.size, info.etag)


class LocalFS:
    """The local file system; paths are absolute."""

    endpoint = "file"

    @staticmethod
    def _info(path: str) -> ObjectInfo:
        st = os.stat(path)
        return ObjectInfo(path, st.st_size, st.st_mtime, str(st.st_mtime_ns))

    def find(self, root: str) -> list[ObjectInfo]:
        if os.path.isfile(root):
            return [self._info(root)]
        out = []
        for d, _, names in os.walk(root):
            out.extend(self._info(os.path.join(d, n)) for n in names)
        return sorted(out, key=lambda i: i.path)

    def glob(self, pattern: str) -> list[ObjectInfo]:
        rx = glob_regex(pattern)
        return [i for i in self.find(_glob_base(pattern) or ".")
                if rx.match(i.path)]

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def info(self, path: str) -> Optional[ObjectInfo]:
        try:
            return self._info(path)
        except FileNotFoundError:
            return None

    def read_range(self, path: str, lo: int, hi: int) -> bytes:
        with open(path, "rb") as fh:
            fh.seek(lo)
            return fh.read(hi - lo)

    def cat(self, path: str) -> bytes:
        with open(path, "rb") as fh:
            return fh.read()

    def write(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as fh:
            fh.write(data)

    def byte_source(self, path: str):
        return MappedFile(path)


def _credentials(params) -> tuple[str, str]:
    """(access key, secret key): none for an anonymous endpoint, else the
    params' own, `storage_options` key/secret, or the environment."""
    if params.anon:
        return "", ""
    opts = params.storage_options or {}
    ak = getattr(params, "access_key", "") or opts.get("key", "") or \
        os.environ.get("AWS_ACCESS_KEY_ID", "")
    sk = getattr(params, "secret_key", "") or opts.get("secret", "") or \
        os.environ.get("AWS_SECRET_ACCESS_KEY", "")
    return ak, sk


def _fs_for(url: str, params) -> tuple[object, str]:
    """The object store and root path a URL names."""
    scheme, sep, rest = url.partition("://")
    if not sep:
        return LocalFS(), os.path.abspath(url)
    if scheme == "file":
        return LocalFS(), rest
    if scheme != "s3":
        raise NotImplementedError(
            f"s3 provider: the {scheme}:// scheme is {NOT_PORTED}; "
            f"s3:// and file:// are served")
    bucket = rest.split("/", 1)[0]
    opts = params.storage_options or {}
    client_kw = opts.get("client_kwargs") or {}
    ak, sk = _credentials(params)
    client = S3Client(
        bucket,
        endpoint=params.endpoint_url or client_kw.get("endpoint_url", ""),
        region=client_kw.get("region_name")
        or getattr(params, "region", "") or "us-east-1",
        access_key=ak, secret_key=sk)
    return BucketFS(client), rest.rstrip("/")


# -- snapshot source ---------------------------------------------------------

class S3Storage(Storage, ShardingStorage, AsyncPartDiscovery):
    def __init__(self, params: S3SourceParams, upload_workers: int = 1):
        self.params = params
        self.table = TableID(params.namespace, params.table)
        self._schema: Optional[TableSchema] = None
        self._fs = None
        self._root = ""
        self._files: Optional[list[str]] = None
        self._reader = None
        self._upload_workers = max(1, upload_workers)

    @property
    def fs(self):
        if self._fs is None:
            self._fs, self._root = _fs_for(self.params.url, self.params)
        return self._fs

    def files(self) -> list[str]:
        if self._files is None:
            fs = self.fs
            if _has_magic(self._root):
                found = [i.path for i in fs.glob(self._root)]
            elif fs.isdir(self._root):
                found = [i.path for i in fs.find(self._root)]
            else:
                found = [self._root] if fs.info(self._root) else []
            # the staged-commit sink keeps in-flight parts and publish
            # markers under `.staging/` in the same prefix; readers
            # must never ingest them as table data
            found = [p for p in found if "/.staging/" not in f"/{p}"]
            if not found:
                raise FileNotFoundError(
                    f"s3 source: no objects match {self.params.url!r}"
                )
            self._files = found
        return self._files

    @property
    def reader(self):
        if self._reader is None:
            self._reader = self.params.make_reader(self._upload_workers)
        return self._reader

    # -- schema inference (reader/abstract.go:40-52) ------------------------
    def table_schema(self, table: TableID) -> TableSchema:
        if self._schema is None:
            self._schema = self.reader.infer_schema(
                self.fs, self.files()[0])
        return self._schema

    def _eta(self, path: str) -> int:
        if self.params.format == "parquet":
            return self.reader.estimate_rows(self.fs, path)
        return 0

    def table_list(self, include=None):
        if include and not any(
                self.table.include_matches(p) for p in include):
            return {}
        eta = sum(self._eta(f) for f in self.files())
        return {self.table: TableInfo(
            eta_rows=eta, schema=self.table_schema(self.table)
        )}

    def estimate_table_rows_count(self, table: TableID) -> int:
        info = self.table_list().get(self.table)
        return info.eta_rows if info else 0

    def shard_table(self, table: TableDescription) -> list[TableDescription]:
        return list(self.iter_table_parts(table))

    def iter_table_parts(self, table: TableDescription):
        """Stream one part an object while the upload runs (huge
        listings must not serialize activation: tpp_setter_async.go)."""
        for f in self.files():
            yield TableDescription(id=table.id, filter=f"obj:{f}",
                                   eta_rows=self._eta(f))

    def load_table(self, table: TableDescription, pusher: Pusher) -> None:
        files = [table.filter[4:]] if table.filter.startswith("obj:") \
            else self.files()
        schema = self.table_schema(table.id)
        for f in files:
            trace.instant("s3_object_open", path=f)
            self.reader.read(self.fs, f, table.id, schema,
                             self.params.batch_rows, pusher)

    def ping(self) -> None:
        self.files()


# -- sink --------------------------------------------------------------------

def _s3_stage(key: str, epoch: int, prefix: str, device: DeviceLike):
    """One part's staging state inside the S3 object sink: the shared
    WireStage plus the staging key prefix and an object sequence."""
    from transferia_tpu_torch.providers.staging import WireStage

    stage = WireStage(key, epoch, device=device)
    # slug is a path COMPONENT ("/" cannot appear in a slug), so one
    # part's staging prefix can never prefix-match another's even for
    # dotted slugs where "a.t" prefixes "a.t.z"
    stage.dir = f"{prefix}.staging/{stage.slug}/e{epoch}/"
    stage.seq = 0
    return stage


def _jsonl(batch: ColumnBatch) -> bytes:
    return b"".join(json.dumps(row.as_dict(), default=str).encode() + b"\n"
                    for row in batch.to_rows())


class S3Sinker(Sinker, StagedSinker):
    """Object sink with size-based file splitting (sink/file_splitter.go):
    one `jsonl` object a table at a time, rotated at `max_rows_per_file`
    rows and written whole when it closes (object stores have no
    append).

    Staged-commit capable on s3:// targets with explicit credentials
    (abstract/commit.py): with an open part stage each pushed batch
    lands as an object under `.staging/<part slug>/e<epoch>/`, invisible
    to readers, which skip the `.staging/` prefix; publish FIRST
    advances the persisted `.staging/.published.<slug>.json` marker with
    a CONDITIONAL PUT (If-Match on the observed marker ETag /
    If-None-Match on first publish), THEN does the batched copy-to-final
    (delete the part's previous objects under `<prefix><slug>/`, copy
    the staged keys in).  Racing publishers serialize at the store on
    the marker CAS: a zombie raises StaleEpochPublishError before
    touching any final object, and a crash between the marker and the
    copy is repaired by the retried part republishing idempotently
    under the same epoch.  The stage's dedup window keys each push on
    `device` (K10 on the card)."""

    def __init__(self, params: S3TargetParams, device: DeviceLike = None):
        if params.format == "parquet":
            raise NotImplementedError(
                "s3 sink: the parquet format needs pyarrow's Parquet "
                "writer, which the port does not import (ROADMAP.md A7); "
                "use format: jsonl")
        if params.format != "jsonl":
            raise ValueError(f"s3 sink: unknown format {params.format!r}")
        self.params = params
        self.device = device
        self._fs = None
        self._root: Optional[str] = None
        self.token = uuid.uuid4().hex[:8]
        self._counters: dict[TableID, int] = {}
        self._rows_in_file: dict[TableID, int] = {}
        self._buffers: dict[TableID, bytearray] = {}
        self._stage = None  # staging.WireStage (+ dir/seq) when open
        self._client = None

    @property
    def fs(self):
        if self._fs is None:
            self._fs, self._root = _fs_for(self.params.url, self.params)
        return self._fs

    @property
    def root(self) -> str:
        if self._root is None:
            self.fs  # resolves both
        return self._root

    def _next_path(self, tid: TableID) -> str:
        n = self._counters.get(tid, 0)
        return f"{self.root.rstrip('/')}/" \
               f"{tid.namespace}.{tid.name}.{self.token}.{n:06d}.jsonl"

    def push(self, batch: Batch) -> None:
        if not is_columnar(batch):
            if self._stage is None:
                for it in batch:
                    if it.kind in (Kind.DONE_TABLE_LOAD,
                                   Kind.DONE_SHARDED_TABLE_LOAD):
                        self._finish(it.table_id)
            rows = [it for it in batch if it.is_row_event()]
            if not rows:
                return
            batch = ColumnBatch.from_rows(rows)
        if self._stage is not None:
            self._stage_push(batch)
            return
        tid = batch.table_id
        buf = self._buffers.setdefault(tid, bytearray())
        self._rows_in_file.setdefault(tid, 0)
        buf += _jsonl(batch)
        self._rows_in_file[tid] += batch.n_rows
        if self._rows_in_file[tid] >= self.params.max_rows_per_file:
            self._finish(tid)

    def _finish(self, tid: TableID) -> None:
        buf = self._buffers.pop(tid, None)
        self._rows_in_file.pop(tid, None)
        if buf is None:
            return
        self.fs.write(self._next_path(tid), bytes(buf))
        self._counters[tid] = self._counters.get(tid, 0) + 1

    def close(self) -> None:
        for tid in list(self._buffers):
            self._finish(tid)

    # -- StagedSinker (publish = batched copy behind a marker fence) --------
    def _bucket_prefix(self) -> tuple[str, str]:
        rest = self.params.url[len("s3://"):]
        bucket, _, prefix = rest.partition("/")
        prefix = prefix.strip("/")
        return bucket, (prefix + "/") if prefix else ""

    def staged_commit_available(self) -> bool:
        if not self.params.url.startswith("s3://"):
            return False
        opts = self.params.storage_options or {}
        return bool((self.params.access_key or opts.get("key"))
                    and (self.params.secret_key or opts.get("secret")))

    def _staged_client(self) -> S3Client:
        if self._client is None:
            opts = self.params.storage_options or {}
            bucket, _ = self._bucket_prefix()
            self._client = S3Client(
                bucket=bucket,
                endpoint=self.params.endpoint_url,
                region=self.params.region,
                access_key=self.params.access_key or opts.get("key", ""),
                secret_key=self.params.secret_key
                or opts.get("secret", ""),
            )
        return self._client

    def begin_part(self, key: str, epoch: int) -> None:
        _, prefix = self._bucket_prefix()
        stage = _s3_stage(key, epoch, prefix, self.device)
        client = self._staged_client()
        # begin replaces, for EVERY epoch of this key: sweep crashed
        # earlier attempts' staged objects too (all epochs live under
        # the part's own `.staging/<slug>/`), or a steal's epoch bump
        # would leak them forever
        for obj in client.list(f"{prefix}.staging/{stage.slug}/"):
            client.delete(obj.key)
        self._stage = stage

    def _stage_push(self, batch: ColumnBatch) -> None:
        stage = self._stage
        staged = stage.state.stage(batch)
        if staged.n_rows == 0:
            return
        tid = staged.table_id
        stage_key = (f"{stage.dir}{stage.seq:06d}."
                     f"{tid.namespace}.{tid.name}.jsonl")
        stage.seq += 1
        try:
            self._staged_client().put(stage_key, _jsonl(staged))
        except BaseException:
            # the staging write died after the dedup window recorded
            # this batch: only a full part restage is safe
            stage.state.mark_failed()
            raise

    def _marker_key(self, slug: str) -> str:
        _, prefix = self._bucket_prefix()
        return f"{prefix}.staging/.published.{slug}.json"

    def _advance_marker(self, key: str, epoch: int, slug: str) -> None:
        """Persist the publish epoch with a conditional write; racing
        publishers serialize at the store, the loser re-checks."""
        client = self._staged_client()
        body = json.dumps({"epoch": epoch, "key": key}).encode()
        for _ in range(8):
            cur = client.get(self._marker_key(slug))
            if cur is not None:
                prev = int(json.loads(cur[0]).get("epoch", -1))
                if epoch < prev:
                    raise StaleEpochPublishError(key, epoch, prev)
            try:
                if cur is None:
                    client.put(self._marker_key(slug), body,
                               if_none_match=True)
                else:
                    client.put(self._marker_key(slug), body,
                               if_match=cur[1])
                return
            except PreconditionFailed:
                continue  # lost the race: re-read and re-fence
            except ConditionalUnsupported:
                # endpoint without conditional writes: last-writer-wins
                # degrade, same contract as the s3 coordinator backend
                logger.warning(
                    "s3 target lacks conditional writes; publish "
                    "marker for %s written last-writer-wins", key)
                client.put(self._marker_key(slug), body)
                return
        raise CategorizedError(
            CategorizedError.TARGET,
            f"publish marker CAS for {key!r} did not converge")

    def publish_part(self, key: str, epoch: int) -> int:
        from transferia_tpu_torch.providers.staging import publish_guard

        stage = self._stage
        if stage is None or stage.key != key:
            raise RuntimeError(f"s3 sink: no open stage for {key!r}")
        client = self._staged_client()
        _, prefix = self._bucket_prefix()
        with publish_guard(key, epoch):
            trace.instant("s3_publish_copy", part=key, epoch=epoch,
                          rows=stage.state.rows)
            failpoint("sink.s3.publish")
            # fence FIRST: the conditional marker write must win before
            # any final object is touched, so a zombie raises here with
            # the survivor's objects intact
            self._advance_marker(key, epoch, stage.slug)
            # replace: drop what an older publish of this part landed;
            # the part's final objects live under their own slug-keyed
            # "directory", so the listing is O(this part)
            part_prefix = f"{prefix}{stage.slug}/"
            for obj in client.list(part_prefix):
                client.delete(obj.key)
            # batched copy-to-final: staged keys become
            # `<prefix><slug>/<seq>.<ns>.<table>.jsonl` objects
            staged_objs = sorted(client.list(stage.dir),
                                 key=lambda o: o.key)
            for obj in staged_objs:
                got = client.get(obj.key)
                if got is None:
                    continue  # concurrent abort of a superseded stage
                name = obj.key[len(stage.dir):]
                client.put(f"{part_prefix}{name}", got[0])
            for obj in staged_objs:
                client.delete(obj.key)
            self.last_dedup_dropped = stage.state.dedup_dropped
            rows = stage.state.rows
        self._stage = None
        return rows

    def abort_part(self, key: str) -> None:
        stage = self._stage
        if stage is None or stage.key != key:
            return
        self._stage = None
        try:
            client = self._staged_client()
            for obj in client.list(stage.dir):
                client.delete(obj.key)
        except (OSError, CategorizedError) as e:
            logger.warning("s3 staged abort of %s: %s", key, e)

    def note_push_retry(self) -> None:
        if self._stage is not None:
            self._stage.state.note_push_retry()


@register_provider
class S3Provider(Provider):
    NAME = "s3"

    def storage(self):
        if isinstance(self.transfer.src, S3SourceParams):
            return S3Storage(
                self.transfer.src,
                upload_workers=self.transfer.runtime.sharding.process_count)
        return None

    def sinker(self):
        if isinstance(self.transfer.dst, S3TargetParams):
            return S3Sinker(self.transfer.dst, device=self.device)
        return None

    def source(self):
        if isinstance(self.transfer.src, S3SourceParams) \
                and self.transfer.src.event_source:
            from transferia_tpu_torch.providers.s3source import (
                S3ReplicationSource,
            )

            return S3ReplicationSource(
                self.transfer.src, self.transfer.id, self.coordinator)
        return None

    def test(self) -> TestResult:
        result = TestResult(ok=True)
        try:
            if isinstance(self.transfer.src, S3SourceParams):
                S3Storage(self.transfer.src).ping()
            result.add("list")
        except Exception as e:  # the check reports every failure
            result.add("list", e)
        return result
