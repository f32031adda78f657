"""In-process Confluent Schema Registry fake, register and fetch (the
port's copy of ``tests/recipes/fake_sr.py``)."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class FakeSchemaRegistry:
    def __init__(self):
        self.schemas: dict[int, dict] = {}          # id -> {schema, type}
        self.by_subject: dict[str, list[int]] = {}  # subject -> versions
        self._dedup: dict[tuple[str, str], int] = {}
        self.lock = threading.Lock()
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, status, obj):
                out = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def do_GET(self):
                if self.path.startswith("/schemas/ids/"):
                    sid = int(self.path.rsplit("/", 1)[-1])
                    with fake.lock:
                        reg = fake.schemas.get(sid)
                    if reg is None:
                        return self._send(404, {"error_code": 40403})
                    return self._send(200, {
                        "schema": reg["schema"],
                        "schemaType": reg["type"],
                    })
                self._send(404, {"error_code": 404})

            def do_POST(self):
                if self.path.endswith("/versions") and \
                        self.path.startswith("/subjects/"):
                    subject = self.path.split("/")[2]
                    length = int(self.headers.get("Content-Length") or 0)
                    req = json.loads(self.rfile.read(length))
                    with fake.lock:
                        key = (subject, req["schema"])
                        sid = fake._dedup.get(key)
                        if sid is None:
                            sid = len(fake.schemas) + 1
                            fake.schemas[sid] = {
                                "schema": req["schema"],
                                "type": req.get("schemaType", "AVRO"),
                            }
                            fake._dedup[key] = sid
                            fake.by_subject.setdefault(
                                subject, []).append(sid)
                    return self._send(200, {"id": sid})
                self._send(404, {"error_code": 404})

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "FakeSchemaRegistry":
        self.thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
