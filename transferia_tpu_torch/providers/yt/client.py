"""Dependency-free YTsaurus HTTP-proxy client (the port's copy of
``transferia_tpu/providers/yt/client.py``).

Speaks the public YT HTTP API (api/v4): light commands (get/list/exists/
create/remove/set, transactions) as JSON requests, heavy commands
(read_table/write_table) as streamed newline-delimited JSON ("json"
format, list_fragment).  Row ranges use rich-YPath suffixes
(``//path[#lo:#hi]``) so sharded snapshot parts are server-side range
reads, exactly like the Go SDK the reference uses
(pkg/providers/yt/cypress.go, storage/).

Auth: ``Authorization: OAuth <token>`` when a token is configured.
"""

from __future__ import annotations

import http.client
import json
import logging
import re
import urllib.parse
from typing import Any, Iterator, Optional

from transferia_tpu_torch.abstract.errors import CategorizedError

logger = logging.getLogger(__name__)

# rich YPath row-range suffix: //path[#lo:#hi] (either bound optional)
RANGE_RE = re.compile(r"^(?P<path>.*?)\[#(?P<lo>\d*):#?(?P<hi>\d*)\]$")


class YTError(CategorizedError):
    def __init__(self, message: str, category: str = CategorizedError.SOURCE):
        super().__init__(category, message)


class YTClient:
    def __init__(self, proxy: str, token: str = "", secure: bool = False,
                 timeout: float = 300.0):
        if "://" in proxy:
            parsed = urllib.parse.urlparse(proxy)
            self.host = parsed.hostname or "localhost"
            self.port = parsed.port or (443 if parsed.scheme == "https"
                                        else 80)
            self.secure = parsed.scheme == "https"
        else:
            host, _, port = proxy.partition(":")
            self.host = host or "localhost"
            self.port = int(port) if port else 80
            self.secure = secure
        self.token = token
        self.timeout = timeout

    # -- transport ----------------------------------------------------------
    def _headers(self, extra: Optional[dict] = None) -> dict:
        h = {"Accept": "application/json"}
        if self.token:
            h["Authorization"] = f"OAuth {self.token}"
        if extra:
            h.update(extra)
        return h

    def _request(self, method: str, command: str, params: dict,
                 body: Optional[bytes] = None,
                 headers: Optional[dict] = None,
                 stream: bool = False):
        qs = urllib.parse.urlencode(
            {k: (json.dumps(v) if isinstance(v, (dict, list, bool))
                 else str(v))
             for k, v in params.items() if v is not None})
        path = f"/api/v4/{command}" + (f"?{qs}" if qs else "")
        cls = (http.client.HTTPSConnection if self.secure
               else http.client.HTTPConnection)
        conn = cls(self.host, self.port, timeout=self.timeout)
        try:
            conn.request(method, path, body=body,
                         headers=self._headers(headers))
            resp = conn.getresponse()
            if resp.status >= 300:
                data = resp.read()
                raise YTError(
                    f"yt {command} HTTP {resp.status}: "
                    f"{data[:300].decode('utf-8', 'replace')}")
            if stream:
                return resp, conn  # caller reads + closes
            data = resp.read()
            return json.loads(data) if data else {}
        except (ConnectionError, OSError,
                http.client.HTTPException) as e:
            conn.close()
            raise YTError(f"yt proxy unreachable: {e}") from e
        except YTError:
            conn.close()
            raise
        finally:
            if not stream:
                conn.close()

    # -- light commands -----------------------------------------------------
    def get(self, path: str, default: Any = ...) -> Any:
        try:
            return self._request("GET", "get", {"path": path})["value"]
        except YTError:
            if default is not ...:
                return default
            raise

    def set(self, path: str, value: Any, tx: str = "") -> None:
        self._request("PUT", "set",
                      {"path": path, "transaction_id": tx or None},
                      body=json.dumps(value).encode())

    def list(self, path: str) -> list[str]:
        return self._request("GET", "list", {"path": path})["value"]

    def exists(self, path: str) -> bool:
        return bool(
            self._request("GET", "exists", {"path": path})["value"])

    def create(self, node_type: str, path: str,
               attributes: Optional[dict] = None, recursive: bool = True,
               ignore_existing: bool = False, tx: str = "") -> None:
        self._request("POST", "create", {
            "type": node_type, "path": path,
            "attributes": attributes or {},
            "recursive": recursive,
            "ignore_existing": ignore_existing,
            "transaction_id": tx or None,
        })

    def remove(self, path: str, force: bool = True) -> None:
        self._request("POST", "remove", {"path": path, "force": force})

    # -- transactions -------------------------------------------------------
    def start_transaction(self, timeout_ms: int = 120_000) -> str:
        out = self._request("POST", "start_transaction",
                            {"timeout": timeout_ms})
        return out.get("transaction_id", out.get("value", ""))

    def commit_transaction(self, tx: str) -> None:
        self._request("POST", "commit_transaction",
                      {"transaction_id": tx})

    def abort_transaction(self, tx: str) -> None:
        self._request("POST", "abort_transaction",
                      {"transaction_id": tx})

    # -- heavy commands -----------------------------------------------------
    def read_table(self, path: str,
                   batch_rows: int = 10_000) -> Iterator[list[dict]]:
        """Stream rows as batches of dicts (json list_fragment)."""
        resp, conn = self._request(
            "GET", "read_table", {"path": path},
            headers={"X-YT-Output-Format": '"json"'}, stream=True)
        try:
            batch: list[dict] = []
            buf = b""
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                buf += chunk
                while True:
                    nl = buf.find(b"\n")
                    if nl < 0:
                        break
                    line = buf[:nl]
                    buf = buf[nl + 1:]
                    if line.strip():
                        batch.append(json.loads(line))
                    if len(batch) >= batch_rows:
                        yield batch
                        batch = []
            if buf.strip():
                batch.append(json.loads(buf))
            if batch:
                yield batch
        finally:
            conn.close()

    def write_table(self, path: str, rows: list[dict],
                    append: bool = True, tx: str = "") -> None:
        """Write rows (json list_fragment).  append=False replaces."""
        ypath = f"<append=%{'true' if append else 'false'}>{path}"
        body = b"".join(
            json.dumps(r, default=str).encode() + b"\n" for r in rows)
        self._request(
            "PUT", "write_table",
            {"path": ypath, "transaction_id": tx or None}, body=body,
            headers={"X-YT-Input-Format": '"json"',
                     "Content-Type": "application/x-ndjson"})

    # -- dynamic tables ------------------------------------------------------
    def mount_table(self, path: str) -> None:
        self._request("POST", "mount_table", {"path": path})

    def unmount_table(self, path: str) -> None:
        self._request("POST", "unmount_table", {"path": path})

    def tablet_state(self, path: str) -> str:
        return self.get(path + "/@tablet_state", "unmounted")

    def pivot_keys(self, path: str) -> list:
        """Per-tablet pivot keys of a mounted sorted dyntable (the first
        tablet's pivot is the empty key)."""
        return self.get(path + "/@pivot_keys", [[]])

    def insert_rows(self, path: str, rows: list[dict],
                    update: bool = False,
                    atomicity: str = "full") -> None:
        """Upsert into a mounted sorted dyntable (ordered tables append)."""
        body = b"".join(
            json.dumps(r, default=str).encode() + b"\n" for r in rows)
        self._request(
            "PUT", "insert_rows",
            {"path": path, "update": update, "atomicity": atomicity},
            body=body,
            headers={"X-YT-Input-Format": '"json"',
                     "Content-Type": "application/x-ndjson"})

    def delete_rows(self, path: str, keys: list[dict],
                    atomicity: str = "full") -> None:
        """Delete by key from a mounted sorted dyntable."""
        body = b"".join(
            json.dumps(k, default=str).encode() + b"\n" for k in keys)
        self._request(
            "PUT", "delete_rows", {"path": path, "atomicity": atomicity},
            body=body,
            headers={"X-YT-Input-Format": '"json"',
                     "Content-Type": "application/x-ndjson"})

    def ping(self) -> None:
        self.exists("//")
