"""In-process S3-compatible HTTP server: the port's copy of
``tests/recipes/fake_s3.py``, with ranged reads and public buckets.

The S3 REST subset the port's clients speak: GET (whole, or a `Range:
bytes=a-b` / `bytes=a-` / `bytes=-n` part answered 206 with its
Content-Range), PUT and DELETE of objects, ListObjectsV2 with
continuation (`page_size` keys a page) and each key's LastModified,
ETags, and conditional writes (If-Match / If-None-Match: *), so the
optimistic-CAS coordinator paths run for real.  `conditional_writes=
False` emulates an endpoint without them (clients must degrade to
last-writer-wins).

Requests must carry a SigV4 Authorization header (presence + access-key
match only; signatures are not re-derived, as localstack does), except
reads (GET, listing) when `public_read` is on: a public bucket such as
ClickBench's, which its users read anonymously.
"""

from __future__ import annotations

import hashlib
import http.server
import threading
import time
import urllib.parse
from typing import Optional


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts)) + \
        f".{int(ts * 1000) % 1000:03d}Z"


def _byte_range(spec: str, size: int) -> Optional[tuple[int, int]]:
    """`bytes=a-b` | `bytes=a-` | `bytes=-n` -> [lo, hi) within the
    object, or None when it cannot be satisfied."""
    if not spec.startswith("bytes=") or "," in spec:
        return None
    a, _, b = spec[len("bytes="):].partition("-")
    try:
        if not a:
            n = int(b)
            return (max(0, size - n), size) if n > 0 and size else None
        lo = int(a)
        hi = min(int(b) + 1, size) if b else size
    except ValueError:
        return None
    return (lo, hi) if lo < hi else None


class FakeS3:
    def __init__(self, access_key: str = "test-ak",
                 conditional_writes: bool = True,
                 page_size: int = 10, public_read: bool = False):
        self.access_key = access_key
        self.conditional_writes = conditional_writes
        self.page_size = page_size
        self.public_read = public_read
        self.objects: dict[str, tuple[bytes, str]] = {}  # key -> (body, etag)
        self.mtimes: dict[str, float] = {}
        self.lock = threading.Lock()
        self.requests: list[str] = []
        self.range_gets = 0
        self.range_bytes = 0
        fake = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            # a response's headers and body go out in two writes: with
            # Nagle on, the body waits for the client's delayed ACK
            disable_nagle_algorithm = True

            def log_message(self, *a):
                pass

            def _reject(self, status: int, code: str):
                body = (f"<Error><Code>{code}</Code></Error>").encode()
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _auth_ok(self, read: bool = False) -> bool:
                if read and fake.public_read:
                    return True
                auth = self.headers.get("Authorization", "")
                return ("AWS4-HMAC-SHA256" in auth
                        and fake.access_key in auth)

            def _parse(self) -> tuple[str, str, dict]:
                parsed = urllib.parse.urlparse(self.path)
                segs = parsed.path.lstrip("/").split("/", 1)
                bucket = segs[0]
                key = urllib.parse.unquote(segs[1]) if len(segs) > 1 else ""
                query = dict(urllib.parse.parse_qsl(parsed.query))
                return bucket, key, query

            def do_PUT(self):
                if not self._auth_ok():
                    return self._reject(403, "AccessDenied")
                _, key, _ = self._parse()
                fake.requests.append(f"PUT {key}")
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                if_match = self.headers.get("If-Match")
                if_none = self.headers.get("If-None-Match")
                with fake.lock:
                    if (if_match or if_none) and not fake.conditional_writes:
                        return self._reject(501, "NotImplemented")
                    cur = fake.objects.get(key)
                    if if_none == "*" and cur is not None:
                        return self._reject(412, "PreconditionFailed")
                    if if_match is not None and (
                            cur is None
                            or cur[1] != if_match.strip('"')):
                        return self._reject(412, "PreconditionFailed")
                    etag = fake._store_locked(key, body)
                self.send_response(200)
                self.send_header("ETag", f'"{etag}"')
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                if not self._auth_ok(read=True):
                    return self._reject(403, "AccessDenied")
                _, key, query = self._parse()
                if not key and query.get("list-type") == "2":
                    return self._list(query)
                fake.requests.append(f"GET {key}")
                with fake.lock:
                    cur = fake.objects.get(key)
                if cur is None:
                    return self._reject(404, "NoSuchKey")
                body, etag = cur
                spec = self.headers.get("Range")
                if spec is None:
                    self.send_response(200)
                    self.send_header("ETag", f'"{etag}"')
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                rng = _byte_range(spec, len(body))
                if rng is None:
                    return self._reject(416, "InvalidRange")
                lo, hi = rng
                with fake.lock:
                    fake.range_gets += 1
                    fake.range_bytes += hi - lo
                self.send_response(206)
                self.send_header("ETag", f'"{etag}"')
                self.send_header("Content-Range",
                                 f"bytes {lo}-{hi - 1}/{len(body)}")
                self.send_header("Content-Length", str(hi - lo))
                self.end_headers()
                self.wfile.write(memoryview(body)[lo:hi])

            def do_DELETE(self):
                if not self._auth_ok():
                    return self._reject(403, "AccessDenied")
                _, key, _ = self._parse()
                with fake.lock:
                    fake.objects.pop(key, None)
                    fake.mtimes.pop(key, None)
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def _list(self, query: dict):
                prefix = query.get("prefix", "")
                token = query.get("continuation-token", "")
                with fake.lock:
                    keys = sorted(k for k in fake.objects
                                  if k.startswith(prefix))
                start = 0
                if token:
                    start = next((i + 1 for i, k in enumerate(keys)
                                  if k == token), len(keys))
                page = keys[start:start + fake.page_size]
                truncated = start + fake.page_size < len(keys)
                parts = ["<?xml version='1.0'?><ListBucketResult>"]
                parts.append(
                    f"<IsTruncated>{'true' if truncated else 'false'}"
                    f"</IsTruncated>")
                if truncated and page:
                    parts.append(f"<NextContinuationToken>{page[-1]}"
                                 f"</NextContinuationToken>")
                for k in page:
                    with fake.lock:
                        got = fake.objects.get(k)
                        mtime = fake.mtimes.get(k, 0.0)
                    if got is None:
                        continue  # deleted since the page was cut
                    body, etag = got
                    parts.append(
                        f"<Contents><Key>{k}</Key>"
                        f"<LastModified>{_iso(mtime)}</LastModified>"
                        f"<Size>{len(body)}</Size>"
                        f'<ETag>"{etag}"</ETag></Contents>')
                parts.append("</ListBucketResult>")
                out = "".join(parts).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/xml")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self.server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True)

    def _store_locked(self, key: str, body: bytes) -> str:
        etag = hashlib.md5(body).hexdigest()
        self.objects[key] = (body, etag)
        self.mtimes[key] = time.time()
        return etag

    def put_object(self, key: str, body: bytes) -> str:
        """Store an object without a request (test and smoke set-up)."""
        with self.lock:
            return self._store_locked(key, bytes(body))

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "FakeS3":
        self.thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
