"""The Delta Lake source and the log-shipping sinks (Coralogix, Datadog):
the port's copy of ``transferia_tpu/providers/misc_providers.py``
(reference: pkg/providers/{delta,coralogix,datadog}).

Delta: the transaction log (`_delta_log/*.json`, in name order;
checkpoints are not read) names the live Parquet files, which the port's
own Parquet decoder reads (`providers/s3readers.py::ParquetReader`:
batches of `batch_rows` across row-group boundaries, as pyarrow's
`iter_batches` cuts them).  The table lies in a directory, under
`file://` or on `s3://` through the port's S3 client
(`providers/s3.py::_fs_for`).  The source is a v1 Storage and an
event-model snapshot provider (`events/`), one part a live file; the
activation takes the event-model path for it (`tasks/snapshot_v2.py`).

Not ported: the BigQuery sink, which needs `google-cloud-bigquery` and
pyarrow's Parquet writer (BIGQUERY_BLOCKED names its ROADMAP.md item).
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass, field
from typing import Optional

from transferia_tpu_torch.abstract.errors import CategorizedError
from transferia_tpu_torch.abstract.interfaces import (
    Batch,
    Pusher,
    Sinker,
    Storage,
    TableInfo,
    is_columnar,
    resolve_all,
)
from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.events.model import InsertBatchEvent
from transferia_tpu_torch.events.pipeline import (
    DataObjectPart,
    EventSourceProgress,
    ProgressableEventSource,
    SnapshotProvider,
)
from transferia_tpu_torch.models.endpoint import (
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.providers.registry import (
    Provider,
    register_provider,
)
BIGQUERY_BLOCKED = (
    "the bigquery sink is not ported to transferia_tpu_torch: it needs "
    "google-cloud-bigquery and pyarrow's Parquet writer (ROADMAP.md A7, "
    "blocked)")


# ---------------------------------------------------------------------------
# Delta Lake source
# ---------------------------------------------------------------------------

@register_endpoint
@dataclass
class DeltaSourceParams(EndpointParams):
    PROVIDER = "delta"
    IS_SOURCE = True

    path: str = ""            # table root containing _delta_log/
    table: str = "delta"
    namespace: str = ""
    batch_rows: int = 65_536
    storage_options: dict = field(default_factory=dict)
    anon: bool = True
    endpoint_url: str = ""


class DeltaStorage(Storage):
    """Reads the Delta transaction log to find the live Parquet files,
    then streams them columnar (the log is JSON actions: add/remove/
    metaData)."""

    def __init__(self, params: DeltaSourceParams):
        self.params = params
        self.table = TableID(params.namespace, params.table)
        self._files: Optional[list[str]] = None
        self._schema: Optional[TableSchema] = None
        self._fs_root = None
        self._reader = None

    def _fs(self):
        if self._fs_root is None:
            from transferia_tpu_torch.providers.s3 import _fs_for

            self._fs_root = _fs_for(self.params.path, self.params)
        return self._fs_root

    @property
    def reader(self):
        """The Parquet reader; it parses each file's footer once."""
        if self._reader is None:
            from transferia_tpu_torch.providers.s3readers import make_reader
            from transferia_tpu_torch.runtime.limits import effective_cpus

            # the parts load one at a time (tasks/snapshot_v2.py), so a
            # file's row groups decode on half the cores
            cpus = int(effective_cpus())
            self._reader = make_reader(
                "parquet", decode_threads=max(1, min(8, cpus // 2)),
                readahead_groups=2 if cpus >= 2 else 0)
        return self._reader

    def file_row_count(self, path: str) -> int:
        """num_rows from the Parquet footer."""
        return self.reader.estimate_rows(self._fs()[0], path)

    def _resolve(self) -> list[str]:
        if self._files is not None:
            return self._files
        fs, root = self._fs()
        base = root.rstrip("/")
        log_dir = f"{base}/_delta_log"
        if not (fs.isdir(log_dir) or fs.info(log_dir) is not None):
            raise FileNotFoundError(
                f"delta source: no _delta_log under {self.params.path!r}"
            )
        # the log's own entries (not its subdirectories), as `ls` lists
        versions = sorted(
            i.path for i in fs.find(log_dir)
            if "/" not in i.path[len(log_dir) + 1:]
            and i.path.endswith(".json")
        )
        live: dict[str, bool] = {}
        for v in versions:
            for line in io.BytesIO(fs.cat(v)):
                if not line.strip():
                    continue
                action = json.loads(line)
                if "add" in action:
                    live[action["add"]["path"]] = True
                elif "remove" in action:
                    live.pop(action["remove"]["path"], None)
        self._files = [f"{base}/{p}" for p, ok in live.items() if ok]
        if not self._files:
            raise FileNotFoundError(
                f"delta table at {self.params.path!r} has no live files"
            )
        return self._files

    def table_schema(self, table: TableID) -> TableSchema:
        if self._schema is None:
            self._schema = self.reader.infer_schema(self._fs()[0],
                                                    self._resolve()[0])
        return self._schema

    def table_list(self, include=None):
        if include and not any(
                self.table.include_matches(p) for p in include):
            return {}
        eta = sum(self.file_row_count(f) for f in self._resolve())
        return {self.table: TableInfo(
            eta_rows=eta, schema=self.table_schema(self.table)
        )}

    def read_file(self, path: str, tid: TableID, pusher: Pusher) -> None:
        """One live file's batches, in file order."""
        self.reader.read(self._fs()[0], path, tid,
                         self.table_schema(tid), self.params.batch_rows,
                         pusher)

    def load_table(self, table: TableDescription, pusher: Pusher) -> None:
        for f in self._resolve():
            self.read_file(f, table.id, pusher)


class _FileSource(ProgressableEventSource):
    """One live file as a snapshot source: every batch is pushed as an
    InsertBatchEvent without waiting, and the futures resolve at the
    end."""

    def __init__(self, storage: DeltaStorage, part: DataObjectPart):
        self.storage = storage
        self.part = part
        self._progress = EventSourceProgress(total=part.eta_rows)
        self._running = False

    def start(self, target) -> None:
        self._running = True
        futures = []
        try:
            def pusher(batch):
                futures.append(target.async_push([InsertBatchEvent(batch)]))
                self._progress.current += batch.n_rows

            self.storage.read_file(self.part.part_key, self.part.table,
                                   pusher)
            resolve_all(futures)
            self._progress.done = True
        finally:
            self._running = False

    def running(self) -> bool:
        return self._running

    def progress(self) -> EventSourceProgress:
        return self._progress


class DeltaSnapshotProvider(SnapshotProvider):
    """Event-model-v2 snapshot provider for Delta tables.

    Data objects: the table; parts: one a live Parquet file from the
    transaction log, so part-parallel loads never split a file."""

    def __init__(self, params: DeltaSourceParams):
        self.params = params
        self.storage = DeltaStorage(params)

    def init(self) -> None:
        self.storage._resolve()

    def ping(self) -> None:
        self.storage._resolve()

    def close(self) -> None:
        pass

    def begin_snapshot(self) -> None:
        # the file list is the snapshot: resolved once, reads stay pinned
        # to it even if the log advances mid-load
        self.storage._resolve()

    def end_snapshot(self) -> None:
        self.storage._files = None

    def data_objects(self, include=None):
        tid = self.storage.table
        if include and not any(tid.include_matches(p) for p in include):
            return {}
        parts = [
            DataObjectPart(table=tid, part_key=f,
                           eta_rows=self.storage.file_row_count(f))
            for f in self.storage._resolve()
        ]
        return {tid: parts}

    def table_schema(self, part) -> TableSchema:
        return self.storage.table_schema(part.table)

    def create_snapshot_source(self, part) -> _FileSource:
        return _FileSource(self.storage, part)


@register_provider
class DeltaProvider(Provider):
    NAME = "delta"

    def storage(self):
        if isinstance(self.transfer.src, DeltaSourceParams):
            return DeltaStorage(self.transfer.src)
        return None

    def snapshot_provider(self):
        if isinstance(self.transfer.src, DeltaSourceParams):
            return DeltaSnapshotProvider(self.transfer.src)
        return None


# ---------------------------------------------------------------------------
# Log-shipping sinks (pkg/providers/coralogix, datadog)
# ---------------------------------------------------------------------------

def _http_post_json(host: str, path: str, body: object,
                    headers: dict, secure: bool = True,
                    timeout: float = 60.0) -> None:
    import http.client

    cls = http.client.HTTPSConnection if secure \
        else http.client.HTTPConnection
    conn = cls(host, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body, default=str),
                     headers={"Content-Type": "application/json",
                              **headers})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status >= 300:
            raise CategorizedError(
                CategorizedError.TARGET,
                f"log sink HTTP {resp.status}: {data[:200]!r}",
            )
    finally:
        conn.close()


def _row_items(batch: Batch) -> list:
    return batch.to_rows() if is_columnar(batch) else [
        it for it in batch if it.is_row_event()
    ]


@register_endpoint
@dataclass
class CoralogixTargetParams(EndpointParams):
    PROVIDER = "coralogix"
    IS_TARGET = True

    domain: str = "coralogix.com"
    private_key: str = ""
    application: str = "transferia"
    subsystem: str = "transfer"
    secure: bool = True


class CoralogixSinker(Sinker):
    def __init__(self, params: CoralogixTargetParams):
        self.params = params

    def push(self, batch: Batch) -> None:
        rows = _row_items(batch)
        if not rows:
            return
        entries = [
            {"severity": 3,
             "text": json.dumps(it.as_dict(), default=str)}
            for it in rows
        ]
        _http_post_json(
            f"ingress.{self.params.domain}", "/logs/v1/bulk",
            {
                "applicationName": self.params.application,
                "subsystemName": self.params.subsystem,
                "logEntries": entries,
            },
            {"Authorization": f"Bearer {self.params.private_key}"},
            secure=self.params.secure,
        )


@register_endpoint
@dataclass
class DatadogTargetParams(EndpointParams):
    PROVIDER = "datadog"
    IS_TARGET = True

    site: str = "datadoghq.com"
    api_key: str = ""
    service: str = "transferia"
    source: str = "transfer"
    secure: bool = True


class DatadogSinker(Sinker):
    def __init__(self, params: DatadogTargetParams):
        self.params = params

    def push(self, batch: Batch) -> None:
        rows = _row_items(batch)
        if not rows:
            return
        entries = [
            {
                "ddsource": self.params.source,
                "service": self.params.service,
                "message": json.dumps(it.as_dict(), default=str),
            }
            for it in rows
        ]
        _http_post_json(
            f"http-intake.logs.{self.params.site}", "/api/v2/logs",
            entries, {"DD-API-KEY": self.params.api_key},
            secure=self.params.secure,
        )


@register_provider
class CoralogixProvider(Provider):
    NAME = "coralogix"

    def sinker(self):
        if isinstance(self.transfer.dst, CoralogixTargetParams):
            return CoralogixSinker(self.transfer.dst)
        return None


@register_provider
class DatadogProvider(Provider):
    NAME = "datadog"

    def sinker(self):
        if isinstance(self.transfer.dst, DatadogTargetParams):
            return DatadogSinker(self.transfer.dst)
        return None
