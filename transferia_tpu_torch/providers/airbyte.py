"""Airbyte connector provider: any Airbyte source image as a snapshot
source (the port's copy of ``transferia_tpu/providers/airbyte.py``).

The connector speaks the Airbyte protocol over stdout:
  spec / check / discover / read, line-framed JSON AirbyteMessages.
discover yields the stream catalog (-> table list + schemas); read with a
ConfiguredAirbyteCatalog streams RECORD/STATE/LOG messages.  The final
STATE message checkpoints into the coordinator KV (airbyte_state) and is
passed back via --state on the next run (incremental syncs).

Execution goes through the container runner (docker/podman, or
runtime "exec" to run a connector binary/script directly — also how the
tests drive the full protocol without a container runtime).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from dataclasses import dataclass, field
from typing import Optional

from transferia_tpu_torch.abstract.errors import CategorizedError
from transferia_tpu_torch.abstract.interfaces import (
    Pusher,
    Storage,
    TableInfo,
)
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.container import ContainerRunner, ContainerSpec
from transferia_tpu_torch.models.endpoint import (
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.providers.registry import (
    Provider,
    TestResult,
    register_provider,
)

logger = logging.getLogger(__name__)

STATE_KEY = "airbyte_state"


class AirbyteError(CategorizedError):
    def __init__(self, message: str):
        super().__init__(CategorizedError.SOURCE, message)


@register_endpoint
@dataclass
class AirbyteSourceParams(EndpointParams):
    PROVIDER = "airbyte"
    IS_SOURCE = True

    image: str = ""                  # connector image (docker/podman)
    config: dict = field(default_factory=dict)
    namespace: str = "airbyte"
    streams: list = field(default_factory=list)  # include list ([]=all)
    batch_rows: int = 10_000
    runtime: str = ""                # "" autodetect | docker | podman | exec
    exec_argv: list = field(default_factory=list)  # runtime=exec connector
    sync_mode: str = "full_refresh"  # full_refresh | incremental


_JSON_TO_CANONICAL = {
    "string": CanonicalType.UTF8,
    "integer": CanonicalType.INT64,
    "number": CanonicalType.DOUBLE,
    "boolean": CanonicalType.BOOLEAN,
    "object": CanonicalType.ANY,
    "array": CanonicalType.ANY,
}


def _json_type(prop: dict) -> CanonicalType:
    t = prop.get("type")
    if isinstance(t, list):  # ["null", "string"]
        t = next((x for x in t if x != "null"), "string")
    return _JSON_TO_CANONICAL.get(t, CanonicalType.ANY)


class AirbyteStorage(Storage):
    def __init__(self, params: AirbyteSourceParams, transfer_id: str = "",
                 coordinator=None):
        import threading

        self.params = params
        self.transfer_id = transfer_id
        self.cp = coordinator
        self.runner = ContainerRunner(params.runtime)
        self._catalog: Optional[dict] = None
        # one instance serves all upload worker threads: the catalog must
        # resolve once (discover is a full container run) and the state
        # blob read-modify-write must not lose concurrent streams' updates
        self._lock = threading.Lock()

    # -- protocol plumbing --------------------------------------------------
    def _spec(self, mode_args: list[str],
              files: dict[str, dict]) -> tuple[ContainerSpec, object]:
        """Build the run spec; files land in a temp dir that docker mounts
        at /data (exec connectors get host paths)."""
        tmp = tempfile.TemporaryDirectory(prefix="airbyte_")
        args = list(mode_args)
        for name, content in files.items():
            host = os.path.join(tmp.name, name)
            with open(host, "w") as fh:
                json.dump(content, fh)
            ctr = host if self.runner.runtime == "exec" \
                else f"/data/{name}"
            args += [f"--{name.split('.')[0]}", ctr]
        if self.runner.runtime == "exec":
            argv = list(self.params.exec_argv) + args
            return ContainerSpec(args=argv), tmp
        return ContainerSpec(
            image=self.params.image, args=args,
            mounts=[(tmp.name, "/data")], network="host",
        ), tmp

    def _messages(self, mode_args: list[str], files: dict[str, dict]):
        spec, tmp = self._spec(mode_args, files)
        try:
            for line in self.runner.stream(
                    spec, on_stderr=lambda ln: logger.debug(
                        "airbyte: %s", ln)):
                line = line.strip()
                if not line.startswith("{"):
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    logger.debug("non-json connector line: %.200s", line)
        finally:
            tmp.cleanup()

    # -- catalog ------------------------------------------------------------
    def catalog(self) -> dict:
        with self._lock:
            return self._catalog_locked()

    def _catalog_locked(self) -> dict:
        if self._catalog is None:
            for msg in self._messages(["discover"],
                                      {"config.json": self.params.config}):
                if msg.get("type") == "CATALOG":
                    self._catalog = msg["catalog"]
                    break
                if msg.get("type") == "TRACE" and \
                        msg.get("trace", {}).get("type") == "ERROR":
                    raise AirbyteError(
                        msg["trace"].get("error", {}).get("message",
                                                          "discover failed"))
            if self._catalog is None:
                raise AirbyteError("connector emitted no CATALOG message")
        return self._catalog

    def _streams(self) -> list[dict]:
        streams = self.catalog().get("streams", [])
        if self.params.streams:
            include = set(self.params.streams)
            streams = [s for s in streams if s["name"] in include]
        return streams

    def _schema_of(self, stream: dict) -> TableSchema:
        props = (stream.get("json_schema") or {}).get("properties", {})
        pkeys = {k[0] if isinstance(k, list) else k
                 for k in (stream.get("source_defined_primary_key") or [])}
        cols = [
            ColSchema(name, _json_type(prop), primary_key=name in pkeys,
                      original_type=f"airbyte:{prop.get('type')}")
            for name, prop in props.items()
        ]
        return TableSchema(cols)

    def table_list(self, include=None):
        out = {}
        for s in self._streams():
            tid = TableID(self.params.namespace, s["name"])
            if include and not any(tid.include_matches(p)
                                   for p in include):
                continue
            out[tid] = TableInfo(eta_rows=0, schema=self._schema_of(s))
        return out

    def table_schema(self, table: TableID) -> TableSchema:
        for s in self._streams():
            if s["name"] == table.name:
                return self._schema_of(s)
        raise AirbyteError(f"stream {table.name!r} not in catalog")

    def estimate_table_rows_count(self, table: TableID) -> int:
        return 0

    # -- read ---------------------------------------------------------------
    def load_table(self, table: TableDescription, pusher: Pusher) -> None:
        stream = next((s for s in self._streams()
                       if s["name"] == table.id.name), None)
        if stream is None:
            raise AirbyteError(f"stream {table.id.name!r} not in catalog")
        schema = self._schema_of(stream)
        configured = {"streams": [{
            "stream": stream,
            "sync_mode": self.params.sync_mode,
            "destination_sync_mode": "overwrite",
        }]}
        files = {"config.json": self.params.config,
                 "catalog.json": configured}
        # state is per-stream: a single transfer-wide blob would hand
        # stream B's cursor to stream A on the next run
        saved_state = None
        if self.cp is not None and \
                self.params.sync_mode == "incremental":
            all_state = self.cp.get_transfer_state(
                self.transfer_id).get(STATE_KEY) or {}
            saved_state = all_state.get(table.id.name)
        if saved_state is not None:
            files["state.json"] = saved_state

        rows: list[dict] = []
        nbytes = 0
        last_state = None

        def flush():
            nonlocal rows, nbytes
            if not rows:
                return
            data = {c.name: [r.get(c.name) for r in rows]
                    for c in schema}
            batch = ColumnBatch.from_pydict(table.id, schema, data)
            batch.read_bytes = nbytes
            pusher(batch)
            rows, nbytes = [], 0

        for msg in self._messages(["read"], files):
            mtype = msg.get("type")
            if mtype == "RECORD":
                rec = msg.get("record", {})
                if rec.get("stream") != table.id.name:
                    continue
                rows.append(rec.get("data", {}))
                nbytes += len(json.dumps(rec)) if rec else 0
                if len(rows) >= self.params.batch_rows:
                    flush()
            elif mtype == "STATE":
                last_state = msg.get("state")
            elif mtype == "TRACE" and \
                    msg.get("trace", {}).get("type") == "ERROR":
                raise AirbyteError(
                    msg["trace"].get("error", {}).get(
                        "message", "read failed"))
        flush()
        if last_state is not None and self.cp is not None:
            with self._lock:  # RMW of the whole blob: no lost updates
                all_state = self.cp.get_transfer_state(
                    self.transfer_id).get(STATE_KEY) or {}
                all_state[table.id.name] = last_state
                self.cp.set_transfer_state(self.transfer_id,
                                           {STATE_KEY: all_state})

    def ping(self) -> None:
        self.runner.require()
        for msg in self._messages(["check"],
                                  {"config.json": self.params.config}):
            if msg.get("type") == "CONNECTION_STATUS":
                if msg["connectionStatus"].get("status") != "SUCCEEDED":
                    raise AirbyteError(
                        msg["connectionStatus"].get("message",
                                                    "check failed"))
                return
        raise AirbyteError("connector emitted no CONNECTION_STATUS")


@register_provider
class AirbyteProvider(Provider):
    NAME = "airbyte"

    def storage(self):
        if isinstance(self.transfer.src, AirbyteSourceParams):
            return AirbyteStorage(self.transfer.src, self.transfer.id,
                                  self.coordinator)
        return None

    def test(self) -> TestResult:
        result = TestResult(ok=True)
        try:
            if isinstance(self.transfer.src, AirbyteSourceParams):
                AirbyteStorage(self.transfer.src).ping()
            result.add("check")
        except Exception as e:
            result.add("check", e)
        return result
