"""Minimal S3 REST client (the port's copy of
``transferia_tpu/coordinator/s3client.py``, no SDK).

GET/PUT/DELETE of objects, ranged GETs and ListObjectsV2, path-style
addressing so any S3-compatible endpoint works (AWS, GCS interop, MinIO,
localstack, the port's fake in `recipes/fake_s3.py`).  A request is
SigV4-signed (utils/awssign.py) when the client has credentials and goes
unsigned otherwise: an anonymous read of a public bucket.  PUT supports
conditional writes (If-Match / If-None-Match), which real S3 has since
2024, so the coordinator claims work atomically; callers fall back to
last-writer-wins when an endpoint rejects conditions (the reference's
semantics, coordinator_s3.go:236-268).

Each thread keeps one connection a client (`threading.local`): the
snapshot's upload threads and the readers' decode threads each read
over their own kept-alive socket.
"""

from __future__ import annotations

import calendar
import http.client
import logging
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Optional

from transferia_tpu_torch.abstract.errors import CategorizedError
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.utils.awssign import canonical_query, sign_request


class S3Error(CategorizedError):
    def __init__(self, message: str, status: int = 0, code: str = ""):
        super().__init__(CategorizedError.INTERNAL, message)
        self.status = status
        self.code = code


class PreconditionFailed(S3Error):
    """Conditional PUT lost the race (412): the caller retries or moves
    on."""


class ConditionalUnsupported(S3Error):
    """Endpoint doesn't implement conditional writes (501/NotImplemented)."""


@dataclass
class S3Object:
    key: str
    size: int
    etag: str
    # the listing's LastModified as seconds since the epoch (0.0 when
    # the endpoint leaves it out)
    last_modified: float = 0.0


def _parse_last_modified(text: str) -> float:
    """ISO 8601 `2026-01-01T00:00:00.000Z` -> seconds since the epoch."""
    if not text:
        return 0.0
    base, _, frac = text.rstrip("Z").partition(".")
    try:
        secs = calendar.timegm(time.strptime(base, "%Y-%m-%dT%H:%M:%S"))
    except ValueError:
        return 0.0
    return secs + (float(f"0.{frac}") if frac.isdigit() else 0.0)


def _etag(headers: dict) -> str:
    return (headers.get("ETag") or headers.get("etag") or "").strip('"')


class S3Client:
    def __init__(self, bucket: str, endpoint: str = "",
                 region: str = "us-east-1", access_key: str = "",
                 secret_key: str = "", timeout: float = 30.0):
        self.bucket = bucket
        self.region = region
        self.access_key = access_key
        self.secret_key = secret_key
        self.timeout = timeout
        if endpoint:
            parsed = urllib.parse.urlparse(endpoint)
            self.host = parsed.hostname or ""
            self.port = parsed.port or (
                443 if parsed.scheme == "https" else 80)
            self.secure = parsed.scheme == "https"
        else:
            self.host = f"s3.{region}.amazonaws.com"
            self.port = 443
            self.secure = True
        self._local = threading.local()  # persistent conn per thread

    @property
    def signed(self) -> bool:
        return bool(self.access_key and self.secret_key)

    # -- plumbing -----------------------------------------------------------
    def _signed_host(self) -> str:
        default = 443 if self.secure else 80
        return self.host if self.port == default \
            else f"{self.host}:{self.port}"

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = (http.client.HTTPSConnection if self.secure
                   else http.client.HTTPConnection)
            conn = cls(self.host, self.port, timeout=self.timeout)
            self._local.conn = conn
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError as e:
                logging.getLogger(__name__).debug(
                    "closing stale s3 connection failed: %s", e)
            self._local.conn = None

    def _request(self, method: str, key: str, query: dict[str, str],
                 body: bytes = b"",
                 extra_headers: Optional[dict[str, str]] = None
                 ) -> tuple[int, dict, bytes]:
        failpoint("client.s3.request")
        # coordinator lease renewals, CAS part claims and the readers'
        # ranged GETs ride this path: the span makes S3 latency
        # attributable in the same timeline as the work it gates
        sp = trace.span("s3_request", method=method, key=key)
        path = f"/{self.bucket}"
        if key:
            path += "/" + urllib.parse.quote(key, safe="/-_.~")
        headers = dict(extra_headers or {})
        if self.signed:
            headers = sign_request(
                method, self._signed_host(), path, query, headers, body,
                self.region, "s3", self.access_key, self.secret_key,
            )
        # the wire query string must byte-match the signed canonical form
        qs = canonical_query(query)
        url = path + (f"?{qs}" if qs else "")
        # one reconnect retry: a kept-alive connection may have gone stale
        with sp:
            for attempt in (0, 1):
                conn = self._conn()
                try:
                    conn.request(method, url, body=body or None,
                                 headers=headers)
                    resp = conn.getresponse()
                    data = resp.read()
                    if sp:
                        sp.add(status=resp.status, bytes=len(data))
                    return resp.status, dict(resp.getheaders()), data
                except (http.client.HTTPException, ConnectionError,
                        OSError):
                    self._drop_conn()
                    if attempt:
                        raise
        raise AssertionError("unreachable")  # pragma: no cover

    # -- object ops ---------------------------------------------------------
    def put(self, key: str, body: bytes,
            if_match: Optional[str] = None,
            if_none_match: bool = False) -> str:
        """PUT an object; returns the new ETag.

        if_match: only write over the exact current version (etag);
        if_none_match: only create (fails if the key exists).
        """
        headers = {}
        if if_match is not None:
            headers["if-match"] = if_match
        if if_none_match:
            headers["if-none-match"] = "*"
        status, rh, data = self._request("PUT", key, {}, body, headers)
        if status in (200, 201):
            return _etag(rh)
        if status == 412:
            raise PreconditionFailed(
                f"put {key}: precondition failed", status)
        if status == 501 or (status == 400 and b"NotImplemented" in data):
            raise ConditionalUnsupported(
                f"put {key}: conditional writes unsupported", status)
        raise S3Error(f"put {key}: HTTP {status} {data[:200]!r}", status)

    def get(self, key: str) -> Optional[tuple[bytes, str]]:
        """Returns (body, etag) or None when the key doesn't exist."""
        status, rh, data = self._request("GET", key, {})
        if status == 200:
            return data, _etag(rh)
        if status == 404:
            return None
        raise S3Error(f"get {key}: HTTP {status} {data[:200]!r}", status)

    def get_range(self, key: str, start: int, end: int) -> bytes:
        """Bytes [start, end) of an object through `Range: bytes=a-b`
        (206).  An endpoint that ignores the header answers 200 with the
        whole object: that raises, since a reader that GETs each span
        would otherwise download the whole object again for each one.
        A missing key raises FileNotFoundError."""
        if end <= start:
            return b""
        status, _, data = self._request(
            "GET", key, {}, extra_headers={"range":
                                           f"bytes={start}-{end - 1}"})
        if status == 206:
            if len(data) != end - start:
                raise S3Error(f"get {key} [{start}, {end}): "
                              f"{len(data)} bytes came", status)
            return data
        if status == 200:
            raise S3Error(f"get {key} [{start}, {end}): the endpoint "
                          "ignored the Range header and sent the whole "
                          f"object ({len(data)} bytes); reading objects "
                          "a span at a time needs ranged GETs", status)
        if status == 404:
            raise FileNotFoundError(f"s3://{self.bucket}/{key}")
        raise S3Error(f"get {key} [{start}, {end}): HTTP {status} "
                      f"{data[:200]!r}", status)

    def delete(self, key: str) -> None:
        status, _, data = self._request("DELETE", key, {})
        if status not in (200, 204, 404):
            raise S3Error(f"delete {key}: HTTP {status}", status)

    def list(self, prefix: str) -> list[S3Object]:
        """ListObjectsV2 with continuation (full listing)."""
        out: list[S3Object] = []
        token = ""
        while True:
            query = {"list-type": "2", "prefix": prefix}
            if token:
                query["continuation-token"] = token
            status, _, data = self._request("GET", "", query)
            if status != 200:
                raise S3Error(
                    f"list {prefix}: HTTP {status} {data[:200]!r}", status)
            root = ET.fromstring(data)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[:root.tag.index("}") + 1]
            for c in root.findall(f"{ns}Contents"):
                out.append(S3Object(
                    key=c.findtext(f"{ns}Key", ""),
                    size=int(c.findtext(f"{ns}Size", "0")),
                    etag=c.findtext(f"{ns}ETag", "").strip('"'),
                    last_modified=_parse_last_modified(
                        c.findtext(f"{ns}LastModified", "")),
                ))
            if root.findtext(f"{ns}IsTruncated", "false") != "true":
                return out
            token = root.findtext(f"{ns}NextContinuationToken", "")
            if not token:
                return out
