"""LCK002 — whole-program lock-order cycle detection (potential deadlock).

Builds the interprocedural lock-order graph from
:mod:`transferia_tpu_torch.analysis.callgraph`: an edge ``A -> B`` whenever
lock B is acquired — directly or through any resolvable call chain —
while lock A is held.  A cycle in that graph means two call paths
acquire the same pair (or ring) of locks in opposite orders: the static
analog of the runtime inversion that
:mod:`transferia_tpu_torch.runtime.lockwatch` reports, using the same lock
identities (``lockwatch.named_lock`` names where present, otherwise
``module.Class.attr``).

Each finding prints one witness path per direction as ``file:line ->
file:line`` chains so the two conflicting acquisition orders can be
read straight out of the message.  Reentrant locks (RLock /
``named_lock(kind="rlock")``) never contribute self-edges; cycles
between *distinct* locks are reported regardless of kind — reentrancy
does not save an ABBA deadlock.

Suppress with ``# trtpu: ignore[LCK002]`` on the first witness line
when a cycle is protected by an external invariant the analysis cannot
see (e.g. the two paths are proven never concurrent).
"""

from __future__ import annotations

import ast
from typing import Sequence

from transferia_tpu_torch.analysis import callgraph
from transferia_tpu_torch.analysis.engine import Finding, ProjectRule


def _snippet(files, path: str, line: int) -> str:
    entry = files.get(path)
    if not entry:
        return ""
    lines = entry[1]
    if 0 < line <= len(lines):
        return lines[line - 1].strip()
    return ""


class LockOrderRule(ProjectRule):
    id = "LCK002"
    severity = "error"
    description = ("cycle in the whole-program acquired-while-holding "
                   "lock graph (potential deadlock)")

    def check_project(self, root: str,
                      files: dict[str, tuple[ast.AST, list[str]]]
                      ) -> list[Finding]:
        ix = callgraph.build_index(files)
        findings: list[Finding] = []
        for cycle in callgraph.find_cycles(ix):
            findings.append(self._cycle_finding(ix, cycle, files))
        return findings

    def _cycle_finding(self, ix: callgraph.ProjectIndex,
                       cycle: Sequence[str], files) -> Finding:
        ring = list(cycle) + [cycle[0]]
        edges = [ix.edges[(ring[i], ring[i + 1])]
                 for i in range(len(cycle))]
        order = " -> ".join(ring)
        witnesses = "; ".join(
            f"[{e.src} before {e.dst}] "
            f"{callgraph.format_witness(e)}" for e in edges)
        anchor_path, anchor_line, _ = edges[0].witness[0]
        msg = (f"potential deadlock: lock-order cycle {order}; "
               f"witnesses: {witnesses}")
        return Finding(rule=self.id, severity=self.severity,
                       path=anchor_path, line=anchor_line, col=1,
                       message=msg,
                       snippet=_snippet(files, anchor_path,
                                        anchor_line))
