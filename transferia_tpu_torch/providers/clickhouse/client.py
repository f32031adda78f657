"""ClickHouse HTTP interface client (the port's copy of
``transferia_tpu/providers/clickhouse/client.py``).

Pure stdlib http.client: POST queries, INSERT bodies, basic auth,
per-query settings, the JSON query helpers the staged commit reads the
system tables and the fence with, and the streamed SELECT the
ClickHouse storage reads tables with.
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
import urllib.parse
from typing import Optional

from transferia_tpu_torch.abstract.errors import CategorizedError

logger = logging.getLogger(__name__)


class CHError(CategorizedError):
    def __init__(self, message: str, code: Optional[int] = None):
        super().__init__(CategorizedError.TARGET, message)
        self.code = code


class CHClient:
    # retire pooled sockets idle longer than this before sending.  The
    # common stale-keep-alive failure mode is request() writing into a
    # half-closed socket successfully and getresponse() failing — a path
    # that can never be retried safely (the body may have executed), so
    # it always surfaced a CHError to the outer retrier.  Proactively
    # reconnecting under the server's keep_alive_timeout (3s on older
    # ClickHouse releases, 10s on newer) avoids ever entering that race
    # while keeping the conservative no-retry-after-send policy.
    KEEP_ALIVE_IDLE = 2.5
    TIMEOUT = 300.0

    def __init__(self, host: str = "localhost", port: int = 8123,
                 database: str = "default", user: str = "default",
                 password: str = "", secure: bool = False,
                 settings: Optional[dict] = None):
        self.host = host
        self.port = port
        self.database = database
        self.user = user
        self.password = password
        self.secure = secure
        self.settings = settings or {}
        # keep-alive: one persistent connection per thread (sink workers
        # push concurrently) — a connect+teardown per INSERT dominated the
        # small-batch replication profile.  All pooled connections are
        # tracked so close() can release them regardless of which thread
        # created them.
        self._local = threading.local()
        self._pool_lock = threading.Lock()
        self._all_conns: list = []

    def _connect(self) -> http.client.HTTPConnection:
        cls = http.client.HTTPSConnection if self.secure \
            else http.client.HTTPConnection
        return cls(self.host, self.port, timeout=self.TIMEOUT)

    def _pooled(self) -> tuple[http.client.HTTPConnection, bool]:
        """(connection, reused): reused reflects the RETURNED socket —
        a proactively retired idle connection hands back a fresh one,
        which must not qualify for the stale-keep-alive retry."""
        conn = getattr(self._local, "conn", None)
        if conn is not None and \
                time.monotonic() - getattr(conn, "_last_use", 0.0) \
                > self.KEEP_ALIVE_IDLE:
            # idle past the server keep-alive window: the socket may be
            # half-closed server-side; drop it before sending
            self._drop_pooled()
            conn = None
        reused = conn is not None
        if conn is None:
            conn = self._connect()
            conn._last_use = time.monotonic()
            self._local.conn = conn
            with self._pool_lock:
                self._all_conns.append(conn)
        return conn, reused

    def _drop_pooled(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
            self._local.conn = None
            with self._pool_lock:
                try:
                    self._all_conns.remove(conn)
                except ValueError:
                    pass

    def close(self) -> None:
        """Release every pooled connection (all threads)."""
        with self._pool_lock:
            conns, self._all_conns = self._all_conns, []
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        self._local = threading.local()

    def _params(self, query: str, extra: Optional[dict] = None) -> str:
        params = {
            "database": self.database,
            "query": query,
            **{f"{k}": str(v) for k, v in self.settings.items()},
            **(extra or {}),
        }
        return urllib.parse.urlencode(params)

    def execute(self, query: str, body: bytes = b"",
                extra_params: Optional[dict] = None) -> bytes:
        """Run a query; body carries INSERT payload bytes.

        Rides the thread's keep-alive connection; a dead/half-closed
        connection (server restart, idle timeout) gets one transparent
        retry on a fresh socket before the error surfaces."""
        headers = {"Content-Type": "application/octet-stream"}
        if self.user:
            import base64

            cred = base64.b64encode(
                f"{self.user}:{self.password}".encode()
            ).decode()
            headers["Authorization"] = f"Basic {cred}"
        path = "/?" + self._params(query, extra_params)
        for attempt in (0, 1):
            conn, reused = self._pooled()
            sent = False
            try:
                conn.request("POST", path, body=body, headers=headers)
                sent = True
                resp = conn.getresponse()
                data = resp.read()
            except (ConnectionError, OSError,
                    http.client.HTTPException) as e:
                self._drop_pooled()
                # Retry ONLY the stale-keep-alive race: a REUSED socket
                # failing before the request went out (server closed the
                # idle connection).  Once the body was sent the server
                # may have executed a non-idempotent INSERT — resending
                # would duplicate rows, so the error surfaces instead
                # (the sink's retry policy owns that decision).
                if attempt == 0 and reused and not sent:
                    continue
                raise CHError(f"clickhouse connection failed: {e}") from e
            if resp.status != 200:
                # responses may close the stream on error statuses
                if resp.will_close:
                    self._drop_pooled()
                raise CHError(
                    f"clickhouse HTTP {resp.status}: "
                    f"{data[:500].decode('utf-8', 'replace')}",
                    code=resp.status,
                )
            if resp.will_close:
                self._drop_pooled()
            else:
                conn._last_use = time.monotonic()
            return data
        raise CHError("clickhouse connection failed")  # unreachable

    def execute_stream(self, query: str):
        """Run a query on a connection of its own and return (read_fn,
        close_fn) streaming the response body in chunks: a table read
        must not buffer whole tables."""
        conn = self._connect()
        headers = {"Content-Type": "application/octet-stream"}
        if self.user:
            import base64

            cred = base64.b64encode(
                f"{self.user}:{self.password}".encode()
            ).decode()
            headers["Authorization"] = f"Basic {cred}"
        try:
            conn.request("POST", "/?" + self._params(query),
                         body=b"", headers=headers)
            resp = conn.getresponse()
            if resp.status != 200:
                data = resp.read()
                conn.close()
                raise CHError(
                    f"clickhouse HTTP {resp.status}: "
                    f"{data[:500].decode('utf-8', 'replace')}",
                    code=resp.status,
                )
        except (ConnectionError, OSError, http.client.HTTPException) as e:
            conn.close()
            raise CHError(f"clickhouse connection failed: {e}") from e
        return resp.read, conn.close

    def insert_rowbinary(self, table: str, columns: list[str],
                         payload: bytes) -> None:
        cols = ", ".join(f"`{c}`" for c in columns)
        self.execute(
            f"INSERT INTO {table} ({cols}) FORMAT RowBinary", payload
        )

    def ping(self) -> None:
        out = self.execute("SELECT 1")
        if out.strip() != b"1":
            raise CHError(f"unexpected ping response {out[:50]!r}")

    def query_json(self, query: str) -> list[dict]:
        raw = self.execute(query + " FORMAT JSON")
        return json.loads(raw).get("data", [])

    def query_rows(self, query: str) -> list[list]:
        raw = self.execute(query + " FORMAT JSONCompact")
        return json.loads(raw).get("data", [])

    def scalar(self, query: str):
        rows = self.query_rows(query)
        return rows[0][0] if rows and rows[0] else None
