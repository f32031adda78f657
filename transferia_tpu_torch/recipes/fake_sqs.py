"""In-process SQS fake (JSON protocol) for the S3 replication source: the
port's copy of ``tests/recipes/fake_sqs.py``.

Serves AmazonSQS.ReceiveMessage / AmazonSQS.DeleteMessage with
visibility timeouts: received messages go invisible until deleted or
re-delivered after `visibility` seconds, so the at-least-once
commit-after-push discipline runs for real.  SigV4 is checked for
presence + access-key match (like the fake S3).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class FakeSQS:
    def __init__(self, access_key: str = "test-ak",
                 visibility: float = 30.0):
        self.access_key = access_key
        self.visibility = visibility
        self.lock = threading.Lock()
        self.queue: list[dict] = []  # {id, body, receipt, invisible_until}
        self.deleted: list[str] = []
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            # a response's headers and body go out in two writes: with
            # Nagle on, the body waits for the client's delayed ACK
            disable_nagle_algorithm = True

            def log_message(self, *a):
                pass

            def do_POST(self):
                auth = self.headers.get("Authorization", "")
                if ("AWS4-HMAC-SHA256" not in auth
                        or fake.access_key not in auth):
                    return self._send(403, {"message": "AccessDenied"})
                length = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(length) or b"{}")
                action = self.headers.get(
                    "X-Amz-Target", "").split(".")[-1]
                if action == "ReceiveMessage":
                    return self._send(200, fake.receive(req))
                if action == "DeleteMessage":
                    fake.delete(req.get("ReceiptHandle", ""))
                    return self._send(200, {})
                self._send(400, {"message": f"unknown action {action}"})

            def _send(self, status, obj):
                out = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type",
                                 "application/x-amz-json-1.0")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    # -- queue ops ----------------------------------------------------------
    def send_s3_event(self, key: str, bucket: str = "bucket",
                      event: str = "ObjectCreated:Put",
                      sns_wrapped: bool = False) -> None:
        body = json.dumps({"Records": [{
            "eventName": event,
            "eventTime": "2026-01-01T00:00:00Z",
            "s3": {"bucket": {"name": bucket},
                   "object": {"key": key, "size": 1}},
        }]})
        if sns_wrapped:
            body = json.dumps({"Type": "Notification", "Message": body})
        self.send_raw(body)

    def send_raw(self, body: str) -> None:
        with self.lock:
            self.queue.append({
                "id": uuid.uuid4().hex, "body": body,
                "receipt": uuid.uuid4().hex, "invisible_until": 0.0,
            })

    def receive(self, req: dict) -> dict:
        now = time.monotonic()
        out = []
        with self.lock:
            for m in self.queue:
                if m["invisible_until"] > now:
                    continue
                m["invisible_until"] = now + self.visibility
                out.append({
                    "MessageId": m["id"],
                    "ReceiptHandle": m["receipt"],
                    "Body": m["body"],
                })
                if len(out) >= req.get("MaxNumberOfMessages", 10):
                    break
        return {"Messages": out}

    def delete(self, receipt: str) -> None:
        with self.lock:
            self.queue = [m for m in self.queue
                          if m["receipt"] != receipt]
            self.deleted.append(receipt)

    @property
    def queue_url(self) -> str:
        return f"http://127.0.0.1:{self.port}/queue/events"

    def start(self) -> "FakeSQS":
        self.thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
