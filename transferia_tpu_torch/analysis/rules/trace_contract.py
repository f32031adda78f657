"""TRC001 — chaos sites must be visible in causal traces (stats/trace.py).

When a failpoint fires, `chaos/failpoints.py:_record_fire` lands a
`chaos_fire` instant ON the active span — which is only useful if the
function hosting the injection site actually runs under a span (or
emits its own instant): otherwise the fire floats trace-less and a kill
trial's Perfetto timeline shows the *consequences* of a fault but never
the fault itself.  This rule keeps the contract as new sites land: any
`failpoint(...)` / `torn_rows(...)` call site (the same call set FPT001
polices) whose innermost enclosing function neither opens a span nor
emits a trace instant/complete is flagged.

"Opens a span" is syntactic on purpose: a call whose leaf name is
`span`, `instant`, or `complete` anywhere in the enclosing function
(the project idiom is `trace.span(...)` / `trace.instant(...)`; a
local alias like `sp = span(...)` also counts).  Attribute calls only
count when the receiver is a `trace` module reference (`trace.span`,
`stats.trace.instant`): an unrelated `.span()` — e.g. `re.Match.span`
— must not satisfy the contract.  Functions that only
*adopt* a context (`trace.adopted(...)`) do not pass — adoption makes
someone else's span current but records nothing, so a fire inside
still needs a local span/instant for the timeline to show where it
landed.

Call sites inside the chaos package and tests are exempt exactly as in
FPT001 — they exercise the machinery.  `allow_untraced` whitelists
site names whose host function is deliberately span-free (none today).
"""

from __future__ import annotations

import ast

from transferia_tpu_torch.analysis.engine import Finding, ProjectRule

_CALL_NAMES = ("failpoint", "torn_rows")
_TRACE_LEAVES = ("span", "instant", "complete")
_EXEMPT_FRAGMENTS = ("transferia_tpu_torch/chaos/", "tests/")


def _call_leaf(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _functions(tree: ast.AST) -> list[ast.AST]:
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _innermost_enclosing(funcs: list[ast.AST],
                         node: ast.AST) -> ast.AST | None:
    best = None
    for fn in funcs:
        end = getattr(fn, "end_lineno", fn.lineno)
        if fn.lineno <= node.lineno <= end:
            if best is None or fn.lineno > best.lineno:
                best = fn
    return best


def _receiver_dotted(fn: ast.Attribute) -> str:
    parts = []
    node = fn.value
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_trace_call(node: ast.Call) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        if fn.attr not in _TRACE_LEAVES:
            return False
        recv = _receiver_dotted(fn)
        return recv == "trace" or recv.endswith(".trace")
    if isinstance(fn, ast.Name):
        return fn.id in _TRACE_LEAVES
    return False


def _opens_trace(fn: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and _is_trace_call(n)
               for n in ast.walk(fn))


class TraceContractRule(ProjectRule):
    id = "TRC001"
    severity = "error"
    description = ("failpoint site whose enclosing function opens no "
                   "span and emits no trace instant — the chaos fire "
                   "would be invisible in causal timelines")
    # site names whose host function is deliberately span-free
    allow_untraced: frozenset = frozenset()

    def check_project(self, root: str,
                      files: dict[str, tuple[ast.AST, list[str]]]
                      ) -> list[Finding]:
        findings: list[Finding] = []
        for relpath, (tree, lines) in sorted(files.items()):
            if any(frag in relpath for frag in _EXEMPT_FRAGMENTS):
                continue
            funcs = _functions(tree)
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                if _call_leaf(node) not in _CALL_NAMES:
                    continue
                if not node.args:
                    continue  # FPT001's finding; nothing to add here
                arg = node.args[0]
                if not (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)):
                    continue  # ditto
                site = arg.value
                if site in self.allow_untraced:
                    continue
                encl = _innermost_enclosing(funcs, node)
                if encl is None:
                    findings.append(self.finding(
                        relpath, node,
                        f"failpoint site {site!r} at module level — "
                        f"fires can never land on a span", lines))
                    continue
                if not _opens_trace(encl):
                    findings.append(self.finding(
                        relpath, node,
                        f"failpoint site {site!r}: enclosing function "
                        f"{encl.name}() opens no span and emits no "
                        f"trace instant — a chaos fire here is "
                        f"invisible in the causal timeline (open a "
                        f"span or land an instant near the site)",
                        lines))
        return findings
