"""Mongo storage/sink/change-stream source (the port's copy of
``transferia_tpu/providers/mongo/provider.py``).

Documents map to the reference's mongo row shape: `_id` (key, canonical
utf8 via extended-JSON for ObjectIds) + `document` (ANY).  Snapshot loads
page per collection (each collection is a parallelization unit,
parallelization_unit*.go); replication tails a cluster-wide change stream
with resume tokens checkpointed through the coordinator; the sink applies
replace/delete bulk ops (sink_bulk_operations.go).
"""

from __future__ import annotations

import json
import logging
import threading
from dataclasses import dataclass, field
from typing import Optional

from transferia_tpu_torch.abstract.change_item import ChangeItem, OldKeys
from transferia_tpu_torch.abstract.interfaces import (
    AsyncSink,
    Batch,
    Pusher,
    ShardingStorage,
    Sinker,
    Source,
    Storage,
    TableInfo,
    is_columnar,
)
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator.interface import Coordinator
from transferia_tpu_torch.models.endpoint import (
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.providers.mongo import bson
from transferia_tpu_torch.providers.mongo.wire import (
    MongoConnection,
    MongoError,
)
from transferia_tpu_torch.providers.registry import (
    Provider,
    TestResult,
    register_provider,
)

logger = logging.getLogger(__name__)

DOC_SCHEMA = TableSchema([
    ColSchema("_id", CanonicalType.UTF8, primary_key=True),
    ColSchema("document", CanonicalType.ANY),
])


@register_endpoint
@dataclass
class MongoSourceParams(EndpointParams):
    PROVIDER = "mongo"
    IS_SOURCE = True

    host: str = "localhost"
    port: int = 27017
    user: str = ""
    password: str = ""
    auth_db: str = "admin"
    database: str = ""
    collections: list[str] = field(default_factory=list)  # [] = all
    batch_rows: int = 1000
    shard_parts: int = 0   # split big collections by _id ranges when > 1


@register_endpoint
@dataclass
class MongoTargetParams(EndpointParams):
    PROVIDER = "mongo"
    IS_TARGET = True

    host: str = "localhost"
    port: int = 27017
    user: str = ""
    password: str = ""
    auth_db: str = "admin"
    database: str = ""      # "" -> use the item's namespace


def _conn(params) -> MongoConnection:
    return MongoConnection(
        host=params.host, port=params.port, user=params.user,
        password=params.password, auth_db=params.auth_db,
    ).connect()


def _id_str(v) -> str:
    return json.dumps(bson.to_jsonish(v), sort_keys=True, default=str) \
        if not isinstance(v, (str, int, float)) else str(v)


def _docs_to_batch(tid: TableID, docs: list[dict]) -> ColumnBatch:
    return ColumnBatch.from_pydict(tid, DOC_SCHEMA, {
        "_id": [_id_str(d.get("_id")) for d in docs],
        "document": [bson.to_jsonish(d) for d in docs],
    })


class MongoStorage(Storage, ShardingStorage):
    def __init__(self, params: MongoSourceParams):
        self.params = params
        self._c: Optional[MongoConnection] = None

    @property
    def conn(self) -> MongoConnection:
        if self._c is None:
            self._c = _conn(self.params)
        return self._c

    def close(self) -> None:
        if self._c is not None:
            self._c.close()
            self._c = None

    def _collections(self) -> list[str]:
        if self.params.collections:
            return self.params.collections
        return self.conn.list_collections(self.params.database)

    def table_list(self, include=None):
        out = {}
        for coll in self._collections():
            tid = TableID(self.params.database, coll)
            if include and not any(tid.include_matches(p) for p in include):
                continue
            out[tid] = TableInfo(
                eta_rows=self.conn.count(self.params.database, coll),
                schema=DOC_SCHEMA,
            )
        return out

    def table_schema(self, table: TableID) -> TableSchema:
        return DOC_SCHEMA

    def exact_table_rows_count(self, table: TableID) -> int:
        return self.conn.count(table.namespace, table.name)

    def shard_table(self, table: TableDescription) -> list[TableDescription]:
        """_id-range splits (reference parallelization_unit*.go): walk the
        sorted _id index and cut shard_parts ranges.  Only JSON-safe _id
        types (str/int/float) split — exotic ids keep one part (the filter
        travels as a string through the coordinator)."""
        parts = self.params.shard_parts
        total = table.eta_rows or self.exact_table_rows_count(table.id)
        if parts <= 1 or total < parts * 2:
            return [table]
        chunk = (total + parts - 1) // parts
        # one serial _id-projection pre-pass (analogous to an index scan;
        # the reference's splitVector metadata path needs admin rights) —
        # large batches keep round-trips low.  EVERY id's type is checked:
        # MongoDB range queries are type-bracketed, so a mixed-type
        # collection split at e.g. [25, "s0"] would silently drop the
        # numbers above 25 — mixed types refuse to split.
        boundaries: list = []
        seen = 0
        splittable = True
        id_type = None
        for docs in self.conn.find_all(
                table.id.namespace, table.id.name,
                sort={"_id": 1}, projection={"_id": 1},
                batch_size=max(self.params.batch_rows, 10_000)):
            for d in docs:
                v = d.get("_id")
                t = (int if isinstance(v, int)
                     and not isinstance(v, bool) else type(v))
                t = int if t is float else t  # numbers compare cross-type
                if id_type is None:
                    id_type = t
                if t is not id_type or not isinstance(v, (str, int,
                                                          float)) or \
                        isinstance(v, bool):
                    splittable = False
                    break
                if seen and seen % chunk == 0:
                    boundaries.append(v)
                seen += 1
            if not splittable:
                break
        if not splittable or not boundaries:
            return [table]
        import json as _json

        edges = [None] + boundaries + [None]
        out = []
        for i in range(len(edges) - 1):
            rng = {}
            if edges[i] is not None:
                rng["gte"] = edges[i]
            if edges[i + 1] is not None:
                rng["lt"] = edges[i + 1]
            out.append(TableDescription(
                id=table.id, filter=f"idrange:{_json.dumps(rng)}",
                eta_rows=chunk))
        return out

    def load_table(self, table: TableDescription, pusher: Pusher) -> None:
        conn = _conn(self.params)  # dedicated cursor per part
        filt = None
        if table.filter.startswith("idrange:"):
            import json as _json

            rng = _json.loads(table.filter[len("idrange:"):])
            cond = {}
            if "gte" in rng:
                cond["$gte"] = rng["gte"]
            if "lt" in rng:
                cond["$lt"] = rng["lt"]
            filt = {"_id": cond}
        try:
            for docs in conn.find_all(
                    table.id.namespace, table.id.name,
                    filter=filt, sort={"_id": 1},
                    batch_size=self.params.batch_rows):
                pusher(_docs_to_batch(table.id, docs))
        finally:
            conn.close()

    def ping(self) -> None:
        self.conn.command("admin", {"ping": 1})


class MongoChangeStreamSource(Source):
    """Cluster/database change stream with resume-token checkpoints
    (change_stream.go)."""

    STATE_KEY = "mongo_resume_token"

    def __init__(self, params: MongoSourceParams, transfer_id: str,
                 coordinator: Optional[Coordinator]):
        self.params = params
        self.transfer_id = transfer_id
        self.cp = coordinator
        self._stop = threading.Event()

    def run(self, sink: AsyncSink) -> None:
        conn = _conn(self.params)
        try:
            stage: dict = {"$changeStream": {"fullDocument": "updateLookup"}}
            if not self.params.database:
                # no database scoping: watch the whole cluster (a db-level
                # stream on admin would silently see nothing)
                stage["$changeStream"]["allChangesForCluster"] = True
            if self.cp is not None:
                token = self.cp.get_transfer_state(self.transfer_id).get(
                    self.STATE_KEY
                )
                if token:
                    stage["$changeStream"]["resumeAfter"] = {"_data":
                                                             token}
            out = conn.command(self.params.database or "admin", {
                "aggregate": 1,
                "pipeline": [stage],
                "cursor": {"batchSize": self.params.batch_rows},
            })
            cursor = out["cursor"]
            cid = cursor.get("id", 0)
            pending = cursor.get("firstBatch", [])
            while not self._stop.is_set():
                if pending:
                    items, token = self._decode_events(pending)
                    if items:
                        sink.async_push(items).result()
                    if token and self.cp is not None:
                        self.cp.set_transfer_state(
                            self.transfer_id, {self.STATE_KEY: token}
                        )
                    pending = []
                if not cid:
                    raise MongoError("change stream cursor closed")
                out = conn.command(self.params.database or "admin", {
                    "getMore": cid, "collection": "$cmd.aggregate",
                    "batchSize": self.params.batch_rows,
                    "maxTimeMS": 500,
                })
                cursor = out["cursor"]
                cid = cursor.get("id", 0)
                pending = cursor.get("nextBatch", [])
        finally:
            conn.close()

    def _decode_events(self, events: list[dict]
                       ) -> tuple[list[ChangeItem], Optional[str]]:
        items: list[ChangeItem] = []
        token = None
        for ev in events:
            token_doc = ev.get("_id") or {}
            token = token_doc.get("_data", token)
            op = ev.get("operationType")
            ns = ev.get("ns") or {}
            tid = TableID(ns.get("db", ""), ns.get("coll", ""))
            key_id = _id_str((ev.get("documentKey") or {}).get("_id"))
            if op in ("insert", "replace", "update"):
                doc = ev.get("fullDocument")
                if doc is None and op == "update":
                    # updateLookup raced a delete: upserting {} would wipe
                    # the target doc; the delete event follows anyway
                    logger.warning(
                        "mongo change stream: update for %s/%s lost its "
                        "fullDocument (deleted before lookup); skipping",
                        tid, key_id,
                    )
                    continue
                doc = doc or {}
                items.append(ChangeItem(
                    kind=Kind.INSERT if op == "insert" else Kind.UPDATE,
                    schema=tid.namespace, table=tid.name,
                    column_names=("_id", "document"),
                    column_values=(key_id, bson.to_jsonish(doc)),
                    table_schema=DOC_SCHEMA,
                    old_keys=OldKeys(("_id",), (key_id,))
                    if op != "insert" else OldKeys(),
                ))
            elif op == "delete":
                items.append(ChangeItem(
                    kind=Kind.DELETE,
                    schema=tid.namespace, table=tid.name,
                    table_schema=DOC_SCHEMA,
                    old_keys=OldKeys(("_id",), (key_id,)),
                ))
            elif op in ("drop", "dropDatabase", "rename", "invalidate"):
                logger.warning("mongo change stream: %s on %s", op, tid)
        return items, token

    def stop(self) -> None:
        self._stop.set()


class MongoSinker(Sinker):
    """Replace/delete bulk operations keyed on _id."""

    def __init__(self, params: MongoTargetParams):
        self.params = params
        self._c: Optional[MongoConnection] = None

    @property
    def conn(self) -> MongoConnection:
        if self._c is None:
            self._c = _conn(self.params)
        return self._c

    def close(self) -> None:
        if self._c is not None:
            self._c.close()
            self._c = None

    @staticmethod
    def _doc_of(it: ChangeItem) -> dict:
        doc = it.value("document")
        if isinstance(doc, dict):
            out = dict(doc)
        else:
            out = {"value": doc}
        out["_id"] = it.value("_id") or _id_str(out.get("_id"))
        return out

    def push(self, batch: Batch) -> None:
        items = batch.to_rows() if is_columnar(batch) else [
            it for it in batch if it.is_row_event()
        ]
        if not items:
            return
        by_coll: dict[tuple[str, str], list[ChangeItem]] = {}
        for it in items:
            db = self.params.database or it.table_id.namespace or "db"
            by_coll.setdefault((db, it.table_id.name), []).append(it)
        for (db, coll), rows in by_coll.items():
            # apply in item order: a delete followed by a re-insert of the
            # same _id must not be reordered into upsert-then-delete
            run_kind: Optional[bool] = None  # True = delete run
            run_ops: list[dict] = []

            def flush_run():
                nonlocal run_ops, run_kind
                if not run_ops:
                    return
                if run_kind:
                    self.conn.command(db, {"delete": coll,
                                           "deletes": run_ops})
                else:
                    self.conn.command(db, {"update": coll,
                                           "updates": run_ops})
                run_ops = []

            for it in rows:
                is_delete = it.kind == Kind.DELETE
                if run_kind is not None and is_delete != run_kind:
                    flush_run()
                run_kind = is_delete
                if is_delete:
                    key = it.effective_key()
                    run_ops.append({
                        "q": {"_id": key[0] if key else None}, "limit": 1,
                    })
                else:
                    doc = self._doc_of(it)
                    run_ops.append({
                        "q": {"_id": doc["_id"]}, "u": doc, "upsert": True,
                    })
            flush_run()


@register_provider
class MongoProvider(Provider):
    NAME = "mongo"

    def storage(self):
        if isinstance(self.transfer.src, MongoSourceParams):
            return MongoStorage(self.transfer.src)
        return None

    def source(self):
        if isinstance(self.transfer.src, MongoSourceParams):
            return MongoChangeStreamSource(
                self.transfer.src, self.transfer.id, self.coordinator
            )
        return None

    def sinker(self):
        if isinstance(self.transfer.dst, MongoTargetParams):
            return MongoSinker(self.transfer.dst)
        return None

    def test(self) -> TestResult:
        result = TestResult(ok=True)
        params = self.transfer.src if isinstance(
            self.transfer.src, MongoSourceParams) else self.transfer.dst
        try:
            conn = _conn(params)
            conn.command("admin", {"ping": 1})
            conn.close()
            result.add("ping")
        except Exception as e:
            result.add("ping", e)
        return result
