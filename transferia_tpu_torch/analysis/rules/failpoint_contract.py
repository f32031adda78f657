"""FPT001 — failpoint site contract (chaos/).

The chaos plane's whole value is that `chaos/sites.py` is the complete
map of injection sites: `trtpu chaos` schedules over it, operators grep
it, and spec strings validate against it.  That only holds if call
sites can't drift from the catalog.  This rule (REG001-style project
rule) asserts, tree-wide:

  1. every `failpoint(...)` / `torn_rows(...)` call passes a string
     LITERAL site name (a variable would defeat spec validation and
     grep-ability);
  2. every such literal is registered in `chaos/sites.py`;
  3. every site name is owned by exactly ONE call site (two sites
     sharing a name would merge their hit counters and make per-site
     fire sequences ambiguous);
  4. every catalog entry is referenced by some call site (a dead
     catalog entry silently accepts specs that can never fire) — this
     pass only runs when the analyzed file set includes the catalog
     itself (`chaos/sites.py`): a narrowed `trtpu check some/dir` can't
     conclude anything about call sites it didn't parse.

The catalog itself is read via import (like REG001's load pass); unit
tests inject a synthetic catalog via `known_sites`.  Call sites inside
the chaos package itself and in tests are exempt — they exercise the
machinery, they aren't injection sites.
"""

from __future__ import annotations

import ast
from typing import Optional

from transferia_tpu_torch.analysis.engine import Finding, ProjectRule

_CALL_NAMES = ("failpoint", "torn_rows")
# the catalog's sites whose call sites are in modules the port does not
# have yet (ROADMAP.md A7; pyarrow-blocked or no YDB provider)
WAITING_SITES = frozenset({
    "flight.pool_ship", "flight.substream", "interchange.flight.do_get",
    "interchange.flight.do_put", "interchange.ipc.read",
    "interchange.shm.attach", "mvcc.rebuild", "mvcc.spill",
    "region.seal", "sink.ydb.publish",
})
_EXEMPT_FRAGMENTS = ("transferia_tpu_torch/chaos/", "tests/")


def _call_leaf(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


class FailpointContractRule(ProjectRule):
    id = "FPT001"
    severity = "error"
    description = ("failpoint site not a string literal, unregistered "
                   "in chaos/sites.py, claimed by multiple call sites, "
                   "or registered but never instrumented")
    # unit tests inject a synthetic catalog; None = import the real one
    known_sites: Optional[frozenset] = None
    # site names legitimately without an in-tree call site: the catalog
    # keeps the reference's whole site list, so a reference spec parses
    # in the port, but these sites' modules wait under ROADMAP.md A7
    # (interchange/, the flight and ydb providers, mvcc/spill.py)
    allow_unreferenced: frozenset = WAITING_SITES

    def _catalog(self) -> Optional[frozenset]:
        if self.known_sites is not None:
            return self.known_sites
        try:
            from transferia_tpu_torch.chaos.sites import site_names

            return site_names()
        except Exception:
            return None

    def check_project(self, root: str,
                      files: dict[str, tuple[ast.AST, list[str]]]
                      ) -> list[Finding]:
        findings: list[Finding] = []
        catalog = self._catalog()
        if catalog is None:
            findings.append(Finding(
                rule=self.id, severity="error", path="<catalog>",
                line=1, col=1,
                message="chaos/sites.py failed to import — the site "
                        "catalog is unreadable",
                snippet="chaos/sites.py"))
            return findings
        owners: dict[str, tuple[str, int]] = {}
        for relpath, (tree, lines) in sorted(files.items()):
            if any(frag in relpath for frag in _EXEMPT_FRAGMENTS):
                continue
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                if _call_leaf(node) not in _CALL_NAMES:
                    continue
                if not node.args:
                    findings.append(self.finding(
                        relpath, node,
                        f"{_call_leaf(node)}() call without a site "
                        f"name argument", lines))
                    continue
                arg = node.args[0]
                if not (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)):
                    findings.append(self.finding(
                        relpath, node,
                        f"failpoint site name must be a string "
                        f"literal, not an expression — spec "
                        f"validation and FPT001 itself depend on "
                        f"greppable literals", lines))
                    continue
                name = arg.value
                if name not in catalog:
                    findings.append(self.finding(
                        relpath, node,
                        f"failpoint site {name!r} is not registered "
                        f"in chaos/sites.py", lines))
                    continue
                prev = owners.get(name)
                if prev is not None:
                    findings.append(self.finding(
                        relpath, node,
                        f"failpoint site {name!r} already "
                        f"instrumented at {prev[0]}:{prev[1]} — one "
                        f"site name, one call site (shared names "
                        f"merge hit counters)", lines))
                else:
                    owners[name] = (relpath, node.lineno)
        full_tree = any(rel.endswith("chaos/sites.py") for rel in files)
        if not full_tree:
            return findings
        for name in sorted(catalog - set(owners)
                           - self.allow_unreferenced):
            findings.append(Finding(
                rule=self.id, severity="error", path="<catalog>",
                line=1, col=1,
                message=f"site {name!r} is registered in "
                        f"chaos/sites.py but no call site references "
                        f"it — dead catalog entries accept specs that "
                        f"can never fire",
                snippet=name))
        return findings
