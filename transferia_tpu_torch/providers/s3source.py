"""S3 replication source: new-object events -> reader -> async sink (the
port's copy of ``transferia_tpu/providers/s3source.py``).

Reference parity: pkg/providers/s3/source/ (S3Source over an
ObjectFetcher) + s3util/object_fetcher/, two fetch strategies:

  sqs  - S3 bucket notifications through an SQS queue (JSON protocol,
         SigV4 via utils/awssign); creation events are unwrapped (plain or
         SNS-enveloped), filtered by path pattern, and their messages are
         deleted only AFTER every object they name has its rows durably
         pushed (at-least-once, object_fetcher_sqs.go).
  poll - periodic listing with a (mtime, name) watermark persisted in the
         coordinator transfer-state KV (object_fetcher_poller.go).

Objects decode through the same readers as snapshots
(providers/s3readers.py).
"""

from __future__ import annotations

import fnmatch
import http.client
import json
import logging
import threading
import time
import urllib.parse
from typing import Optional

from transferia_tpu_torch.abstract.errors import CategorizedError
from transferia_tpu_torch.abstract.interfaces import AsyncSink, Source
from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.coordinator.interface import Coordinator
from transferia_tpu_torch.utils.awssign import sign_request

logger = logging.getLogger(__name__)


class S3SourceError(CategorizedError):
    def __init__(self, message: str):
        super().__init__(CategorizedError.SOURCE, message)


class SQSClient:
    """Minimal SQS client (JSON protocol, AmazonSQS.* targets)."""

    def __init__(self, queue_url: str, region: str = "us-east-1",
                 access_key: str = "", secret_key: str = "",
                 endpoint: str = "", timeout: float = 70.0):
        self.queue_url = queue_url
        self.region = region
        self.access_key = access_key
        self.secret_key = secret_key
        self.timeout = timeout
        parsed = urllib.parse.urlparse(endpoint or queue_url)
        self.host = parsed.hostname or ""
        self.port = parsed.port or (443 if parsed.scheme == "https" else 80)
        self.secure = parsed.scheme == "https"

    def call(self, action: str, payload: dict) -> dict:
        body = json.dumps(payload).encode()
        default = 443 if self.secure else 80
        host = self.host if self.port == default \
            else f"{self.host}:{self.port}"
        headers = sign_request(
            "POST", host, "/", {}, {
                "content-type": "application/x-amz-json-1.0",
                "x-amz-target": f"AmazonSQS.{action}",
            }, body, self.region, "sqs", self.access_key, self.secret_key,
        )
        cls = (http.client.HTTPSConnection if self.secure
               else http.client.HTTPConnection)
        conn = cls(self.host, self.port, timeout=self.timeout)
        try:
            conn.request("POST", "/", body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            try:
                obj = json.loads(data) if data else {}
            except ValueError:
                obj = {"message": data[:200].decode("utf-8", "replace")}
            if resp.status != 200:
                raise S3SourceError(
                    f"sqs {action}: {obj.get('message', resp.status)}")
            return obj
        finally:
            conn.close()

    def receive(self, max_messages: int = 10,
                wait_seconds: int = 10) -> list[dict]:
        out = self.call("ReceiveMessage", {
            "QueueUrl": self.queue_url,
            "MaxNumberOfMessages": max_messages,
            "WaitTimeSeconds": wait_seconds,
            "VisibilityTimeout": 600,
        })
        return out.get("Messages", []) or []

    def delete(self, receipt_handle: str) -> None:
        self.call("DeleteMessage", {
            "QueueUrl": self.queue_url,
            "ReceiptHandle": receipt_handle,
        })


class SQSObjectFetcher:
    """S3 event notifications via SQS (object_fetcher_sqs.go)."""

    def __init__(self, params):
        self.client = SQSClient(
            params.sqs_queue_url, region=params.sqs_region,
            access_key=params.sqs_access_key,
            secret_key=params.sqs_secret_key,
            endpoint=params.sqs_endpoint,
        )
        self.wait_seconds = params.sqs_wait_seconds
        self.pattern = params.path_pattern
        self.inflight: dict[str, str] = {}       # key -> receipt handle
        self._pending: dict[str, set] = {}       # receipt -> pending keys

    def fetch_objects(self) -> list[str]:
        msgs = self.client.receive(wait_seconds=self.wait_seconds)
        keys: list[str] = []
        for m in msgs:
            receipt = m.get("ReceiptHandle", "")
            body = m.get("Body", "")
            if "s3:TestEvent" in body:
                self.client.delete(receipt)
                continue
            try:
                doc = json.loads(body)
            except ValueError:
                self.client.delete(receipt)
                continue
            if not doc.get("Records") and doc.get("Message"):
                # SNS-enveloped notification: records are one level down
                try:
                    doc = json.loads(doc["Message"])
                except ValueError:
                    self.client.delete(receipt)
                    continue
            matched: set[str] = set()
            for rec in doc.get("Records", []):
                if "ObjectCreated" not in rec.get("eventName", ""):
                    continue
                key = urllib.parse.unquote_plus(
                    rec.get("s3", {}).get("object", {}).get("key", ""))
                if not key or (self.pattern and not fnmatch.fnmatch(
                        key, self.pattern)):
                    continue
                self.inflight[key] = receipt
                matched.add(key)
                keys.append(key)
            if not matched:
                # folder creation / non-matching events: drop the message
                self.client.delete(receipt)
            else:
                # one message may carry several records: delete it only
                # when EVERY key's object has been durably pushed
                self._pending[receipt] = matched
        return keys

    def commit(self, key: str) -> None:
        receipt = self.inflight.pop(key, None)
        if receipt is None:
            return
        pending = self._pending.get(receipt)
        if pending is not None:
            pending.discard(key)
            if pending:
                return  # other records on this message still replicating
            self._pending.pop(receipt, None)
        self.client.delete(receipt)

    def close(self) -> None:
        pass


class PollingObjectFetcher:
    """Bucket listing with an (mtime, name) watermark persisted in the
    coordinator state (object_fetcher_poller.go).  `fs` is an object
    store of providers/s3.py."""

    STATE_KEY = "s3_poll_watermark"

    def __init__(self, fs, root: str, transfer_id: str,
                 coordinator: Optional[Coordinator],
                 pattern: str = ""):
        from transferia_tpu_torch.providers.s3 import _glob_base, _has_magic

        self.fs = fs
        # a glob URL (s3://bucket/prefix/*.jsonl) lists from the first
        # wildcard-free parent and filters with the glob itself
        if _has_magic(root):
            if not pattern:
                pattern = root
            root = _glob_base(root)
        self.root = root
        self.transfer_id = transfer_id
        self.cp = coordinator
        self.pattern = pattern
        saved = {}
        if self.cp is not None:
            saved = self.cp.get_transfer_state(transfer_id).get(
                self.STATE_KEY, {})
        # watermark: highest committed mtime + every name committed AT
        # that mtime.  (mtime, name) lexicographic alone would skip an
        # object whose name sorts before an already-committed same-second
        # name (S3 LastModified has 1s granularity).
        self.wm_mtime: float = saved.get("mtime", -1.0)
        self.wm_names: set[str] = set(saved.get("names", []))
        self._pending: dict[str, float] = {}

    def fetch_objects(self) -> list[str]:
        found = []
        # every poll lists afresh: objects uploaded after the first poll
        # must be seen
        for info in self.fs.find(self.root):
            path, mtime = info.path, info.mtime
            if self.pattern and not fnmatch.fnmatch(path, self.pattern):
                continue
            if mtime < self.wm_mtime:
                continue
            if mtime == self.wm_mtime and path in self.wm_names:
                continue
            if path in self._pending:
                continue
            found.append((mtime, path))
        found.sort()
        out = []
        for mtime, path in found:
            self._pending[path] = mtime
            out.append(path)
        return out

    def commit(self, key: str) -> None:
        mtime = self._pending.pop(key, None)
        if mtime is None:
            return
        if mtime > self.wm_mtime:
            self.wm_mtime = mtime
            self.wm_names = {key}
        elif mtime == self.wm_mtime:
            self.wm_names.add(key)
        else:
            return  # older than the watermark; nothing to persist
        if self.cp is not None:
            self.cp.set_transfer_state(self.transfer_id, {
                self.STATE_KEY: {"mtime": self.wm_mtime,
                                 "names": sorted(self.wm_names)},
            })

    def close(self) -> None:
        pass


class S3ReplicationSource(Source):
    """Replicates newly created objects through the format reader."""

    def __init__(self, params, transfer_id: str,
                 coordinator: Optional[Coordinator] = None):
        from transferia_tpu_torch.providers.s3 import _fs_for

        self.params = params
        self.table = TableID(params.namespace, params.table)
        self.fs, self.root = _fs_for(params.url, params)
        self.reader = params.make_reader()
        self._schema: Optional[TableSchema] = None
        self._stop = threading.Event()
        if params.event_source == "sqs":
            if not params.sqs_queue_url:
                raise S3SourceError("event_source=sqs needs sqs_queue_url")
            self.fetcher = SQSObjectFetcher(params)
        elif params.event_source == "poll":
            self.fetcher = PollingObjectFetcher(
                self.fs, self.root, transfer_id, coordinator,
                params.path_pattern)
        else:
            raise S3SourceError(
                f"unknown event_source {params.event_source!r} (sqs|poll)")

    def _full_path(self, key: str) -> str:
        # key shape is determined by the fetcher: SQS events carry
        # bucket-relative keys, the poller lists full paths; never probe
        # for existence (a relative key could resolve against the WRONG
        # bucket that happens to exist)
        if isinstance(self.fetcher, SQSObjectFetcher):
            bucket = self.root.split("/", 1)[0]
            return f"{bucket}/{key}"
        return key

    def run(self, sink: AsyncSink) -> None:
        while not self._stop.is_set():
            keys = self.fetcher.fetch_objects()
            if not keys:
                if isinstance(self.fetcher, PollingObjectFetcher):
                    self._stop.wait(self.params.poll_interval)
                continue
            for key in keys:
                if self._stop.is_set():
                    break
                self._replicate_object(key, sink)
        self.fetcher.close()

    def _replicate_object(self, key: str, sink: AsyncSink) -> None:
        path = self._full_path(key)
        try:
            if self._schema is None:
                self._schema = self.reader.infer_schema(self.fs, path)
        except FileNotFoundError:
            # deleted between notification and processing (lifecycle
            # rules): skip+commit, or a poison message would crash the
            # worker on every redelivery
            logger.warning("s3 object %s vanished before replication; "
                           "skipping", path)
            self.fetcher.commit(key)
            return
        futures = []

        def pusher(batch):
            futures.append(sink.async_push(batch))

        t0 = time.monotonic()
        try:
            self.reader.read(self.fs, path, self.table, self._schema,
                             self.params.batch_rows, pusher)
        except FileNotFoundError:
            logger.warning("s3 object %s vanished mid-read; skipping",
                           path)
            for f in futures:
                f.result()  # partial rows already pushed stay pushed
            self.fetcher.commit(key)
            return
        for f in futures:
            f.result()  # at-least-once: commit only after durable push
        self.fetcher.commit(key)
        logger.info("s3 replicated %s in %.2fs (%d pushes)",
                    path, time.monotonic() - t0, len(futures))

    def stop(self) -> None:
        self._stop.set()
