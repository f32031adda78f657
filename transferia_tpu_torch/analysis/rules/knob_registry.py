"""KNB001 — env-knob drift between code and the README knob table (the
port's copy of the reference's rule).

Every tuning knob in this tree is an environment variable prefixed
``TRANSFERIA_TPU_`` or ``BENCH_``.  Three kinds of drift accumulate
silently: a module growing its own ``os.environ.get`` (bypassing the
:mod:`transferia_tpu_torch.runtime.knobs` registry, so the knob is invisible
to runtime enumeration), a knob added to code but never documented, and
a README row outliving the knob it described.  This rule pins all
three:

- **direct read** — ``os.environ[...]`` / ``os.environ.get`` /
  ``os.getenv`` of a matching name anywhere except
  ``runtime/knobs.py`` itself (writes are fine: tests and launchers
  *set* knobs);
- **undocumented knob** — a name passed to a ``knobs.env_*`` helper
  that never appears in README.md;
- **dead doc row** — a matching name in the README's port section that
  no code of the scanned tree reads.

The README documents both packages.  The port reads most of the
reference's knobs under the same names, so a knob counts as documented
wherever the README names it.  The dead-doc-row check is scoped to the
README's port section (from its ``## PyTorch / H100 port`` heading to
the next ``## `` heading): a knob named only outside it may be one that
only the JAX package reads, which the port's lint neither scans nor
reports.

Knob names are resolved statically: string literals, or module-level
``ENV_FOO = "TRANSFERIA_TPU_FOO"`` constants referenced by name.
``chip_smoke.py`` sits outside the default scan path but is the port's
own smoke script, so the rule reads it from disk explicitly.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Optional

from transferia_tpu_torch.analysis.engine import Finding, ProjectRule

_KNOB_RE = re.compile(r"\b(?:TRANSFERIA_TPU|BENCH)_[A-Z][A-Z0-9_]*\b")
_HELPER_NAMES = frozenset(
    {"env_raw", "env_str", "env_int", "env_float", "env_bool"})
_EXEMPT_FILES = frozenset({"transferia_tpu_torch/runtime/knobs.py"})
_EXTRA_FILES = ("chip_smoke.py",)
_DOC_FILE = "README.md"
# the README section whose knob mentions must be read by the port
_DOC_SECTION = "## PyTorch / H100 port"


def _is_knob(name: object) -> bool:
    return isinstance(name, str) and bool(_KNOB_RE.fullmatch(name))


class _FileScan(ast.NodeVisitor):
    """Direct env reads + knobs.env_* uses for one module."""

    def __init__(self, relpath: str):
        self.relpath = relpath
        self.consts: dict[str, str] = {}     # ENV_FOO -> literal
        self.direct: list[tuple[str, ast.AST]] = []
        self.via_knobs: list[tuple[str, ast.AST]] = []
        self._store_subscripts: set[int] = set()

    def _resolve(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and _is_knob(node.value):
            return node.value
        if isinstance(node, ast.Name):
            return self.consts.get(node.id)
        return None

    def scan(self, tree: ast.AST) -> None:
        # module-level string constants first (forward refs are rare
        # but cheap to support)
        for node in tree.body if isinstance(tree, ast.Module) else []:
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Constant) and \
                    _is_knob(node.value.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.consts[t.id] = node.value.value
        self.visit(tree)

    # -- env access patterns ------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            # os.environ.get(K) / environ.get(K)
            if fn.attr in ("get", "setdefault", "pop") and \
                    self._is_environ(fn.value):
                name = self._resolve(node.args[0]) if node.args else None
                if name and fn.attr == "get":
                    self.direct.append((name, node))
            elif fn.attr == "getenv" and \
                    isinstance(fn.value, ast.Name) and \
                    fn.value.id == "os":
                name = self._resolve(node.args[0]) if node.args else None
                if name:
                    self.direct.append((name, node))
            elif fn.attr in _HELPER_NAMES:
                self._note_helper(node)
        elif isinstance(fn, ast.Name) and fn.id in _HELPER_NAMES:
            self._note_helper(node)
        self.generic_visit(node)

    def _note_helper(self, node: ast.Call) -> None:
        # knobs.env_int("KEY", ...) puts the key first; the
        # coordinator.interface.env_float shim takes the environ
        # mapping first and the key second — accept either slot
        for arg in node.args[:2]:
            name = self._resolve(arg)
            if name:
                self.via_knobs.append((name, node))
                return

    def visit_Assign(self, node: ast.Assign) -> None:
        # environ[K] = v is a write — exempt its Subscript target
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                self._store_subscripts.add(id(t))
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if id(node) not in self._store_subscripts and \
                self._is_environ(node.value):
            name = self._resolve(node.slice)
            if name:
                self.direct.append((name, node))
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                self._store_subscripts.add(id(t))
        self.generic_visit(node)

    @staticmethod
    def _is_environ(node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute) and node.attr == "environ":
            return True
        return isinstance(node, ast.Name) and node.id == "environ"


class KnobRegistryRule(ProjectRule):
    id = "KNB001"
    severity = "error"
    description = ("env knob bypasses the runtime.knobs registry or "
                   "drifts from the README knob table")

    def check_project(self, root: str,
                      files: dict[str, tuple[ast.AST, list[str]]]
                      ) -> list[Finding]:
        scans: dict[str, tuple[_FileScan, list[str]]] = {}
        for rel in sorted(files):
            tree, lines = files[rel]
            sc = _FileScan(rel)
            sc.scan(tree)
            scans[rel] = (sc, lines)
        for rel in _EXTRA_FILES:
            if rel in scans:
                continue
            abspath = os.path.join(root, rel)
            try:
                with open(abspath, encoding="utf-8") as fh:
                    source = fh.read()
                tree = ast.parse(source, filename=rel)
            except (OSError, SyntaxError, UnicodeDecodeError):
                continue
            sc = _FileScan(rel)
            sc.scan(tree)
            scans[rel] = (sc, source.splitlines())

        documented = self._doc_names(root)
        findings: list[Finding] = []
        read_anywhere: set[str] = set()
        reported_undoc: set[str] = set()

        for rel in sorted(scans):
            sc, lines = scans[rel]
            for name, node in sc.direct:
                read_anywhere.add(name)
                if rel in _EXEMPT_FILES:
                    continue
                findings.append(self._at(
                    rel, node, lines,
                    f"env knob {name} read directly from the "
                    f"environment; route it through "
                    f"transferia_tpu_torch.runtime.knobs so it registers "
                    f"and stays enumerable"))
            for name, node in sc.via_knobs:
                read_anywhere.add(name)
                if name not in documented and \
                        name not in reported_undoc:
                    reported_undoc.add(name)
                    findings.append(self._at(
                        rel, node, lines,
                        f"env knob {name} is not documented in the "
                        f"README knob table"))

        for name, line_no, text in documented.get("__rows__", []):
            if name not in read_anywhere:
                findings.append(Finding(
                    rule=self.id, severity=self.severity,
                    path=_DOC_FILE, line=line_no, col=1,
                    message=(f"README documents env knob {name} "
                             f"but no code reads it (dead doc row)"),
                    snippet=text.strip()))
        return findings

    def _at(self, rel: str, node: ast.AST, lines,
            message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        snippet = lines[line - 1].strip() if 0 < line <= len(lines) \
            else ""
        return Finding(rule=self.id, severity=self.severity, path=rel,
                       line=line, col=getattr(node, "col_offset", 0) + 1,
                       message=message, snippet=snippet)

    @staticmethod
    def _doc_names(root: str) -> dict:
        """{name} membership dict over the whole README + '__rows__' ->
        (name, line, text) for the first mention of each knob inside the
        port's section."""
        out: dict = {}
        rows: list[tuple[str, int, str]] = []
        in_rows: set[str] = set()
        in_section = False
        path = os.path.join(root, _DOC_FILE)
        try:
            with open(path, encoding="utf-8") as fh:
                for i, line in enumerate(fh, start=1):
                    if line.startswith("## "):
                        in_section = line.startswith(_DOC_SECTION)
                    for m in _KNOB_RE.finditer(line):
                        name = m.group(0)
                        out[name] = True
                        if in_section and name not in in_rows:
                            in_rows.add(name)
                            rows.append((name, i, line))
        except OSError:
            pass
        out["__rows__"] = rows
        return out
