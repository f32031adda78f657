"""NET001 — resource safety for sockets, HTTP connections and files.

Zero egress + single-core workers mean a hung connect/read blocks a
whole pipeline stage forever; the rule makes the timeout explicit at
every wire touchpoint:

  - `socket.create_connection(addr)` without a timeout (2nd positional
    arg or `timeout=` kwarg) — blocks in SYN retry for minutes;
  - `http.client.HTTP(S)Connection(host)` without `timeout=`;
  - `urllib.request.urlopen(url)` without `timeout=`;
  - `open(...)` consumed inline (argument of another call, or
    method-chained) — the file object is never closed; use `with`.

`timeout=None` is treated as deliberate (it reads as an explicit
choice at the call site) and is not flagged.
"""

from __future__ import annotations

import ast
from typing import Sequence

from transferia_tpu_torch.analysis.engine import Finding, Rule
from transferia_tpu_torch.analysis.engine import dotted_name as _dotted


def _has_timeout_kwarg(call: ast.Call) -> bool:
    return any(kw.arg == "timeout" or kw.arg is None  # **kwargs: assume yes
               for kw in call.keywords)


class ResourceSafetyRule(Rule):
    id = "NET001"
    severity = "warning"
    description = ("socket/HTTP call without an explicit timeout, or a "
                   "file opened outside a context manager")

    def check_file(self, relpath: str, tree: ast.AST,
                   lines: Sequence[str]) -> list[Finding]:
        findings: list[Finding] = []
        parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func) or ""
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("socket.create_connection") \
                    or name == "create_connection":
                if len(node.args) < 2 and not _has_timeout_kwarg(node):
                    findings.append(self.finding(
                        relpath, node,
                        "socket.create_connection() without a timeout "
                        "blocks in SYN retransmit for minutes on a "
                        "dead host", lines))
            elif leaf in ("HTTPConnection", "HTTPSConnection"):
                if not _has_timeout_kwarg(node):
                    findings.append(self.finding(
                        relpath, node,
                        f"{leaf}() without timeout= hangs the stage on "
                        f"an unresponsive endpoint", lines))
            elif leaf == "urlopen":
                if not _has_timeout_kwarg(node):
                    findings.append(self.finding(
                        relpath, node,
                        "urlopen() without timeout= can block forever",
                        lines))
            elif name == "open":
                parent = parents.get(node)
                inline = (isinstance(parent, ast.Call)
                          or isinstance(parent, ast.Attribute))
                if inline:
                    findings.append(self.finding(
                        relpath, node,
                        "open() consumed inline leaks the file handle "
                        "on error — use `with open(...)`", lines))
        return findings
