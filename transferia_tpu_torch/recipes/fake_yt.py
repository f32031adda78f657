"""In-memory fake YTsaurus HTTP proxy (api/v4 subset; the port's own
copy of the JAX tests' ``tests/recipes/fake_yt.py``).

Implements what providers/yt/client.py speaks: light cypress commands
(get/list/exists/create/remove/set), no-op transactions, and the heavy
read_table/write_table pair with json list_fragment bodies, rich-YPath
row ranges (``[#lo:#hi]``) and the ``<append=%bool>`` modifier.  Optional
OAuth token enforcement so e2e suites exercise real auth.

Two additions over the JAX tests' fake: a sorted dynamic table's rows
are put in key order when they are read (``sync_rows``), not at every
insert_rows/delete_rows request (a CDC tail of thousands of runs
re-sorted the whole table each time), and ``pivots_on_mount`` gives a
table its tablet pivots when it is mounted, as a cluster's reshard to
explicit pivot keys would.  ``rows_in`` counts the rows each of
insert_rows and delete_rows received.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

RANGE_RE = re.compile(r"^(?P<path>.*?)\[#(?P<lo>\d*):#?(?P<hi>\d*)\]$")
APPEND_RE = re.compile(r"^<append=%(?P<append>true|false)>(?P<path>.*)$")


class FakeYT:
    def __init__(self, token: str = ""):
        self.token = token
        self.lock = threading.Lock()
        # path -> {"type": ..., "attrs": {...}, "rows": [...]}
        self.nodes: dict[str, dict] = {
            "//": {"type": "map_node", "attrs": {}},
        }
        self.port = 0
        self._srv = None
        self.requests: list[str] = []
        self._tx = 0
        # table path -> pivot keys its tablets get at mount
        self.pivots_on_mount: dict[str, list] = {}
        # sorted dynamic tables whose rows changed since the last read
        self._dirty: set[str] = set()
        self.rows_in = {"insert_rows": 0, "delete_rows": 0}

    # -- cypress helpers ----------------------------------------------------
    def add_table(self, path: str, schema: list[dict],
                  rows: list[dict]) -> None:
        with self.lock:
            self._mk_parents(path)
            self.nodes[path] = {
                "type": "table",
                "attrs": {"schema": schema},
                "rows": list(rows),
            }

    def _mk_parents(self, path: str) -> None:
        parts = path.lstrip("/").split("/")
        cur = "/"
        for p in parts[:-1]:
            cur = f"{cur}/{p}"
            self.nodes.setdefault(
                cur, {"type": "map_node", "attrs": {}})

    def _children(self, path: str) -> list[str]:
        prefix = path.rstrip("/") + "/"
        out = set()
        for p in self.nodes:
            if p.startswith(prefix) and p != path:
                rest = p[len(prefix):]
                if rest and "/" not in rest:
                    out.add(rest)
        return sorted(out)

    # -- server -------------------------------------------------------------
    def start(self) -> "FakeYT":
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _auth_ok(self) -> bool:
                if not fake.token:
                    return True
                return (self.headers.get("Authorization", "")
                        == f"OAuth {fake.token}")

            def _send(self, status, obj=None, raw: bytes = b""):
                body = raw if raw else (
                    json.dumps(obj).encode() if obj is not None else b"")
                self.send_response(status)
                self.send_header("Content-Type",
                                 "application/octet-stream" if raw
                                 else "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _handle(self, method: str):
                parsed = urllib.parse.urlparse(self.path)
                command = parsed.path.rsplit("/", 1)[-1]
                fake.requests.append(command)
                q = {k: v[0] for k, v in
                     urllib.parse.parse_qs(parsed.query).items()}
                if not self._auth_ok():
                    return self._send(401, {"message": "unauthorized"})
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                try:
                    out = fake.dispatch(command, q, body)
                except KeyError as e:
                    return self._send(404, {"message": f"missing {e}"})
                except ValueError as e:
                    return self._send(400, {"message": str(e)})
                if isinstance(out, bytes):
                    return self._send(200, raw=out)
                return self._send(200, out)

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

            def do_PUT(self):
                self._handle("PUT")

            def log_message(self, *a):
                pass

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True).start()
        return self

    def stop(self) -> None:
        if self._srv:
            self._srv.shutdown()
            self._srv.server_close()

    # -- command dispatch ---------------------------------------------------
    def dispatch(self, command: str, q: dict, body: bytes):
        with self.lock:
            if command in ("get", "read_table"):
                self._sync_rows()
            if command == "get":
                return {"value": self._get_attr(q["path"])}
            if command == "list":
                node = self._node(q["path"])
                if node["type"] != "map_node":
                    raise ValueError("not a map node")
                return {"value": self._children(q["path"])}
            if command == "exists":
                return {"value": q["path"] in self.nodes}
            if command == "create":
                return self._create(q)
            if command == "remove":
                self.nodes.pop(q["path"], None)
                return {}
            if command == "set":
                path, _, attr = q["path"].rpartition("/@")
                self._node(path)["attrs"][attr] = json.loads(body)
                return {}
            if command == "start_transaction":
                self._tx += 1
                return {"transaction_id": f"tx-{self._tx}"}
            if command in ("commit_transaction", "abort_transaction"):
                return {}
            if command == "read_table":
                return self._read_table(q["path"])
            if command == "write_table":
                return self._write_table(q["path"], body)
            if command == "mount_table":
                node = self._node(q["path"])
                if not node["attrs"].get("dynamic"):
                    raise ValueError("cannot mount a static table")
                node["attrs"]["tablet_state"] = "mounted"
                node["attrs"].setdefault(
                    "pivot_keys",
                    node["attrs"].pop(
                        "_pivot_keys_on_mount",
                        self.pivots_on_mount.get(q["path"], [[]])))
                node.setdefault("keyed_rows", {})
                return {}
            if command == "unmount_table":
                node = self._node(q["path"])
                node["attrs"]["tablet_state"] = "unmounted"
                return {}
            if command == "insert_rows":
                return self._insert_rows(q, body)
            if command == "delete_rows":
                return self._delete_rows(q, body)
        raise ValueError(f"unknown command {command}")

    # -- dynamic tables -----------------------------------------------------
    def _dyn_node(self, path: str) -> dict:
        node = self._node(path)
        if not node["attrs"].get("dynamic"):
            raise ValueError(f"{path} is not dynamic")
        if node["attrs"].get("tablet_state") != "mounted":
            raise ValueError(f"{path} is not mounted")
        return node

    def _key_names(self, node: dict) -> list[str]:
        return [c["name"] for c in node["attrs"].get("schema", [])
                if c.get("sort_order")]

    def _insert_rows(self, q: dict, body: bytes):
        node = self._dyn_node(q["path"])
        rows = [json.loads(line) for line in body.splitlines()
                if line.strip()]
        schema = {c["name"] for c in node["attrs"].get("schema", [])}
        for r in rows:
            unknown = set(r) - schema
            if unknown:
                raise ValueError(
                    f"columns {sorted(unknown)} not in schema")
        self.rows_in["insert_rows"] += len(rows)
        keys = self._key_names(node)
        if keys:  # sorted dyntable: upsert by key
            update = json.loads(q.get("update", "false"))
            store = node.setdefault("keyed_rows", {})
            for r in rows:
                k = tuple(r.get(n) for n in keys)
                if update and k in store:
                    store[k].update(r)
                else:
                    store[k] = dict(r)
            self._dirty.add(q["path"])
        else:     # ordered dyntable: append-only log
            node["rows"].extend(rows)
        return {}

    def _delete_rows(self, q: dict, body: bytes):
        node = self._dyn_node(q["path"])
        keys = self._key_names(node)
        if not keys:
            raise ValueError("delete_rows needs a sorted table")
        store = node.setdefault("keyed_rows", {})
        for line in body.splitlines():
            if not line.strip():
                continue
            r = json.loads(line)
            self.rows_in["delete_rows"] += 1
            store.pop(tuple(r.get(n) for n in keys), None)
        self._dirty.add(q["path"])
        return {}

    def sync_rows(self) -> None:
        """Put each changed sorted dynamic table's rows in key order."""
        with self.lock:
            self._sync_rows()

    def _sync_rows(self) -> None:
        for path in self._dirty:
            node = self.nodes.get(path)
            if node is None:
                continue
            store = node.get("keyed_rows", {})
            node["rows"] = [store[k] for k in sorted(
                store, key=lambda t: tuple((v is None, v) for v in t))]
        self._dirty.clear()

    def _node(self, path: str) -> dict:
        node = self.nodes.get(path)
        if node is None:
            raise KeyError(path)
        return node

    def _get_attr(self, path: str):
        if "/@" in path:
            base, _, attr = path.rpartition("/@")
            node = self._node(base)
            if attr == "type":
                return node["type"]
            if attr == "row_count":
                return len(node.get("rows", []))
            if attr in node["attrs"]:
                return node["attrs"][attr]
            raise KeyError(attr)
        node = self._node(path)
        if node["type"] == "map_node":
            return {c: {} for c in self._children(path)}
        return None

    def _create(self, q: dict):
        path = q["path"]
        if path in self.nodes:
            if json.loads(q.get("ignore_existing", "false")):
                return {}
            raise ValueError(f"node {path} already exists")
        if json.loads(q.get("recursive", "false")):
            self._mk_parents(path)
        attrs = json.loads(q.get("attributes", "{}"))
        node = {"type": q["type"], "attrs": attrs}
        if q["type"] == "table":
            node["rows"] = []
        self.nodes[path] = node
        return {}

    def _read_table(self, ypath: str) -> bytes:
        m = RANGE_RE.match(ypath)
        lo = hi = None
        if m:
            ypath = m.group("path")
            lo = int(m.group("lo")) if m.group("lo") else None
            hi = int(m.group("hi")) if m.group("hi") else None
        node = self._node(ypath)
        rows = node.get("rows", [])
        rows = rows[lo:hi]
        return b"".join(json.dumps(r).encode() + b"\n" for r in rows)

    def _write_table(self, ypath: str, body: bytes):
        append = True
        m = APPEND_RE.match(ypath)
        if m:
            append = m.group("append") == "true"
            ypath = m.group("path")
        node = self.nodes.get(ypath)
        if node is None or node["type"] != "table":
            raise KeyError(ypath)
        rows = [json.loads(line) for line in body.splitlines()
                if line.strip()]
        schema = {c["name"] for c in node["attrs"].get("schema", [])}
        if schema:
            for r in rows:
                unknown = set(r) - schema
                if unknown:
                    raise ValueError(
                        f"columns {sorted(unknown)} not in schema")
        if append:
            node["rows"].extend(rows)
        else:
            node["rows"] = rows
        return {}
