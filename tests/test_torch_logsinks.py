"""The port's log-shipping sinks (Coralogix, Datadog;
`transferia_tpu_torch/providers/misc_providers.py`) against the JAX
package's, on the CPU.  Every comparison is exact.

- The request each sink makes, captured at `_http_post_json` in both
  packages: host, path, body, headers and the TLS flag, for columnar
  blocks, row items with control and DDL items among them, and an empty
  batch (no request).
- `_http_post_json` itself against a local HTTP server: the request on
  the wire, and an HTTP error raised as the same CategorizedError.
- The providers through the registries and the CLI's YAML; `bigquery`
  refused naming its blocked ROADMAP.md item.
"""

import http.server
import json
import threading

import numpy as np
import pytest

from transferia_tpu.abstract import change_item as ref_ci
from transferia_tpu.abstract.errors import \
    CategorizedError as RefCategorizedError
from transferia_tpu.abstract.kinds import Kind as RefKind
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import \
    new_table_schema as ref_new_schema
from transferia_tpu.cli import config as ref_config
from transferia_tpu.columnar.batch import ColumnBatch as RefColumnBatch
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.providers import misc_providers as ref_misc
from transferia_tpu.providers import registry as ref_registry
from transferia_tpu_torch.abstract import change_item as port_ci
from transferia_tpu_torch.abstract.errors import CategorizedError
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.cli import config as port_config
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.providers import misc_providers as port_misc
from transferia_tpu_torch.providers import registry as port_registry

PKG = {
    "port": dict(misc=port_misc, ci=port_ci, Kind=Kind, TableID=TableID,
                 schema=new_table_schema, CB=ColumnBatch,
                 Transfer=Transfer, registry=port_registry,
                 err=CategorizedError),
    "jax": dict(misc=ref_misc, ci=ref_ci, Kind=RefKind, TableID=RefTableID,
                schema=ref_new_schema, CB=RefColumnBatch,
                Transfer=RefTransfer, registry=ref_registry,
                err=RefCategorizedError),
}
COLS = [("id", "int64", True), ("msg", "utf8"), ("level", "int32"),
        ("ok", "boolean")]


def columnar(pkg: str, seed: int, n: int = 17):
    m = PKG[pkg]
    rng = np.random.default_rng(seed)
    return m["CB"].from_pydict(m["TableID"]("logs", "app"),
                               m["schema"](COLS), {
        "id": [int(v) for v in rng.integers(0, 1 << 40, n)],
        "msg": [None if v == 0 else f"event {int(v)} ü"
                for v in rng.integers(0, 9, n)],
        "level": [int(v) for v in rng.integers(0, 5, n)],
        "ok": [bool(v) for v in rng.integers(0, 2, n)]})


def items(pkg: str, seed: int) -> list:
    """Row items with a control and a DDL item among them."""
    m = PKG[pkg]
    schema = m["schema"](COLS)
    tid = m["TableID"]("logs", "app")
    out = [m["ci"].init_table_load(tid, schema)]
    for r in columnar(pkg, seed, 5).to_rows():
        out.append(r)
    out.append(m["ci"].ChangeItem(kind=m["Kind"]("ddl"), schema="logs",
                                  table="app", column_names=("sql",),
                                  column_values=("ALTER ...",)))
    out.append(m["ci"].done_table_load(tid, schema))
    return out


SINKS = {
    "coralogix": lambda misc: misc.CoralogixSinker(misc.CoralogixTargetParams(
        domain="eu2.coralogix.com", private_key="cx-key",
        application="app", subsystem="sub")),
    "coralogix_plain": lambda misc: misc.CoralogixSinker(
        misc.CoralogixTargetParams(secure=False)),
    "datadog": lambda misc: misc.DatadogSinker(misc.DatadogTargetParams(
        site="datadoghq.eu", api_key="dd-key", service="svc",
        source="src")),
    "datadog_plain": lambda misc: misc.DatadogSinker(
        misc.DatadogTargetParams(secure=False)),
}


def captured(pkg: str, sink: str, batches, monkeypatch) -> list:
    misc = PKG[pkg]["misc"]
    calls = []

    def capture(host, path, body, headers, secure=True, timeout=60.0):
        calls.append((host, path, json.dumps(body, default=str), headers,
                      secure, timeout))

    monkeypatch.setattr(misc, "_http_post_json", capture)
    s = SINKS[sink](misc)
    for b in batches:
        s.push(b)
    s.close()
    return calls


@pytest.mark.parametrize("sink", sorted(SINKS))
@pytest.mark.parametrize("seed", [1, 2])
def test_requests_equal_jax(sink, seed, monkeypatch):
    got = captured("port", sink, [columnar("port", seed), items("port", seed),
                                  columnar("port", seed, 0), []],
                   monkeypatch)
    want = captured("jax", sink, [columnar("jax", seed), items("jax", seed),
                                  columnar("jax", seed, 0), []],
                    monkeypatch)
    assert got == want
    assert len(got) == 2   # empty batches make no request
    body = json.loads(got[0][2])
    entries = body["logEntries"] if sink.startswith("coralogix") else body
    assert len(entries) == 17


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True


def log_server(status: int):
    """A local HTTP server answering every POST with `status`; records
    (path, headers, body)."""
    seen = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            seen.append((self.path, self.headers.get("Content-Type"),
                         self.headers.get("DD-API-KEY"),
                         self.headers.get("Authorization"), body))
            out = b'{"error": "quota"}' if status >= 300 else b"{}"
            self.send_response(status)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *a):
            pass

    srv = _Server(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, seen


@pytest.mark.parametrize("status", [200, 202, 429, 500])
def test_http_post_json_on_the_wire_equals_jax(status):
    got = {}
    for pkg in ("port", "jax"):
        srv, seen = log_server(status)
        host = f"127.0.0.1:{srv.server_address[1]}"
        try:
            try:
                PKG[pkg]["misc"]._http_post_json(
                    host, "/api/v2/logs", [{"message": "x", "n": 1}],
                    {"DD-API-KEY": "k"}, secure=False, timeout=10)
                err = None
            except PKG[pkg]["err"] as e:
                err = (e.category, str(e))
        finally:
            srv.shutdown()
            srv.server_close()
        got[pkg] = (seen, err)
    assert got["port"] == got["jax"]
    seen, err = got["port"]
    assert seen[0][:3] == ("/api/v2/logs", "application/json", "k")
    if status >= 300:
        assert err == ("target", f"(target) log sink HTTP {status}: "
                                 "b'{\"error\": \"quota\"}'")
    else:
        assert err is None


def test_sink_error_reaches_the_caller(monkeypatch):
    srv, seen = log_server(503)
    real = port_misc._http_post_json
    host = f"127.0.0.1:{srv.server_address[1]}"
    monkeypatch.setattr(
        port_misc, "_http_post_json",
        lambda _h, path, body, headers, secure=True, timeout=60.0:
        real(host, path, body, headers, secure, timeout))
    try:
        s = port_misc.DatadogSinker(port_misc.DatadogTargetParams(
            secure=False))
        with pytest.raises(CategorizedError, match="HTTP 503"):
            s.push(columnar("port", 3))
    finally:
        srv.shutdown()
        srv.server_close()
    assert len(seen) == 1


@pytest.mark.parametrize("name,params", [
    ("coralogix", {"private_key": "k", "domain": "coralogix.us"}),
    ("datadog", {"api_key": "k", "site": "us5.datadoghq.com"}),
])
def test_providers_and_yaml_endpoints_equal_jax(name, params):
    text = (f"id: logs\nsrc: {{type: memory, params: {{}}}}\n"
            f"dst: {{type: {name}, params: {json.dumps(params)}}}\n")
    got = port_config.parse_transfer_yaml(text)
    want = ref_config.parse_transfer_yaml(text)
    assert got.to_dict() == want.to_dict()
    kinds = []
    for pkg, t in (("port", got), ("jax", want)):
        kw = {"device": "cpu"} if pkg == "port" else {}
        prov = PKG[pkg]["registry"].get_provider(name, t, **kw)
        kinds.append((type(prov).__name__, type(prov.sinker()).__name__,
                      prov.storage()))
    assert kinds[0] == kinds[1]
    assert kinds[0][1].endswith("Sinker")


@pytest.mark.parametrize("role", ["dst", "src"])
def test_bigquery_is_refused_by_name(role):
    other = "src" if role == "dst" else "dst"
    text = (f"id: bq\n{role}: {{type: bigquery, params: {{project: p}}}}\n"
            f"{other}: {{type: memory, params: {{}}}}\n")
    with pytest.raises(port_config.ConfigError,
                       match=r"bigquery.*google-cloud-bigquery.*"
                             r"ROADMAP\.md A7, blocked"):
        port_config.parse_transfer_yaml(text)
