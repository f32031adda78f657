"""THD001 — thread-lifecycle lint (leaked threads, executors, timers).

A non-daemon `threading.Thread` that is never joined keeps the
interpreter alive after `main` returns; a `ThreadPoolExecutor` that is
neither a context manager nor explicitly shut down leaks its workers;
a `threading.Timer` that is never cancelled fires into torn-down state
during shutdown.  All three have bitten long-running fleet processes.

- ``threading.Thread(...)`` must pass ``daemon=True``, or the bound
  name must see ``.join(...)`` (or ``.daemon = True``) in scope;
- ``ThreadPoolExecutor(...)`` must be entered as a context manager, or
  the bound name must see ``.shutdown(...)`` in scope;
- ``threading.Timer(...)`` must be daemonized or the bound name must
  see ``.cancel()`` in scope.

Scoping matches ownership, not the raw file: a local variable's
lifecycle must resolve inside its function (nested closures included);
a ``self._thread`` attribute's lifecycle may live in any method of the
same class (``start()`` spawns, ``join()``/``close()`` reaps).  A list
of threads built by a comprehension is credited when the loop variable
iterating that list is joined (``for t in threads: t.join()``).
Lifecycle management split across *modules* is itself the hazard this
rule exists to surface — suppress a considered exception with
``# trtpu: ignore[THD001]`` on the constructor line.
"""

from __future__ import annotations

import ast
from typing import Optional, Sequence

from transferia_tpu_torch.analysis.engine import Finding, Rule

_THREAD_CTORS = {"Thread": "thread", "Timer": "timer"}
_EXECUTOR_CTORS = {"ThreadPoolExecutor", "ProcessPoolExecutor"}
_LIFECYCLE_ATTRS = {"join", "shutdown", "cancel"}


def _leaf(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _bind_name(target: ast.AST) -> Optional[str]:
    """'t' for `t = ...`, '_pool' for `self._pool = ...`."""
    if isinstance(target, ast.Name):
        return target.id
    if isinstance(target, ast.Attribute) and \
            isinstance(target.value, ast.Name) and \
            target.value.id == "self":
        return target.attr
    return None


def _has_true_kw(call: ast.Call, kw_name: str) -> bool:
    for kw in call.keywords:
        if kw.arg == kw_name and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return False


def _ctor_calls(value: ast.AST) -> list[ast.Call]:
    """Constructor Call nodes a binding hands its target: the direct
    call, or the element of a list/set comprehension / literal."""
    if isinstance(value, ast.Call):
        return [value]
    if isinstance(value, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
        if isinstance(value.elt, ast.Call):
            return [value.elt]
    if isinstance(value, (ast.List, ast.Tuple, ast.Set)):
        return [e for e in value.elts if isinstance(e, ast.Call)]
    return []


class _Scope:
    """Lifecycle evidence for one ownership scope (a function's locals
    or a class's `self.*` attributes)."""

    def __init__(self):
        self.lifecycle: dict[str, set[str]] = {}   # name -> attrs seen
        self.daemonized: set[str] = set()
        self.aliases: dict[str, set[str]] = {}     # loop var -> sources

    def saw(self, name: str, attr: str) -> None:
        self.lifecycle.setdefault(name, set()).add(attr)

    def has(self, names: set, attr: str) -> bool:
        expanded = set(names)
        for var, sources in self.aliases.items():
            if sources & expanded:
                expanded.add(var)
        return any(attr in self.lifecycle.get(n, ()) for n in expanded)

    def daemon(self, names: set) -> bool:
        return bool(names & self.daemonized)


def _collect(scope_nodes, scope: _Scope, self_attrs: bool) -> None:
    """Fill `scope` from the statements of one ownership scope.

    `self_attrs=True` records `self.X` evidence (class scope);
    otherwise local-Name evidence (function scope, nested functions
    included — closures commonly own the reaping)."""

    def name_of(node: ast.AST) -> Optional[str]:
        if self_attrs:
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "self":
                return node.attr
            return None
        return node.id if isinstance(node, ast.Name) else None

    for top in scope_nodes:
        for node in ast.walk(top):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _LIFECYCLE_ATTRS:
                base = name_of(node.func.value)
                if base:
                    scope.saw(base, node.func.attr)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            t.attr == "daemon":
                        base = name_of(t.value)
                        if base:
                            scope.daemonized.add(base)
            elif isinstance(node, (ast.For, ast.AsyncFor)) and \
                    not self_attrs:
                # `for t in threads:` — credit t's lifecycle calls to
                # the iterated collection
                if isinstance(node.target, ast.Name) and \
                        isinstance(node.iter, ast.Name):
                    scope.aliases.setdefault(
                        node.target.id, set()).add(node.iter.id)


class ThreadLifecycleRule(Rule):
    id = "THD001"
    severity = "error"
    description = ("thread/executor/timer created without a visible "
                   "shutdown path (daemon/join/shutdown/cancel)")

    def check_file(self, relpath: str, tree: ast.AST,
                   lines: Sequence[str]) -> list[Finding]:
        findings: list[Finding] = []
        with_ctxs: set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if isinstance(item.context_expr, ast.Call):
                        with_ctxs.add(id(item.context_expr))

        body = tree.body if isinstance(tree, ast.Module) else []
        module_stmts = [s for s in body if not isinstance(
            s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
        self._check_scope(relpath, module_stmts, False, with_ctxs,
                          lines, findings)
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_scope(relpath, [node], False, with_ctxs,
                                  lines, findings)
            elif isinstance(node, ast.ClassDef):
                # class scope owns self.* bindings across all methods
                self._check_scope(relpath, [node], True, with_ctxs,
                                  lines, findings)
                for meth in node.body:
                    if isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._check_scope(relpath, [meth], False,
                                          with_ctxs, lines, findings)
        findings.sort(key=lambda f: (f.line, f.col))
        return findings

    def _check_scope(self, relpath, scope_nodes, self_attrs: bool,
                     with_ctxs, lines, findings) -> None:
        scope = _Scope()
        _collect(scope_nodes, scope, self_attrs)
        for top in scope_nodes:
            for node in ast.walk(top):
                if isinstance(node, (ast.Assign, ast.AnnAssign)):
                    targets = node.targets if isinstance(
                        node, ast.Assign) else [node.target]
                    names = set()
                    for t in targets:
                        if self_attrs:
                            if isinstance(t, ast.Attribute) and \
                                    isinstance(t.value, ast.Name) and \
                                    t.value.id == "self":
                                names.add(t.attr)
                        elif isinstance(t, ast.Name):
                            names.add(t.id)
                    if not names or node.value is None:
                        continue
                    for call in _ctor_calls(node.value):
                        f = self._check_ctor(relpath, call, names,
                                             scope, with_ctxs, lines)
                        if f:
                            findings.append(f)
                elif not self_attrs and isinstance(node, ast.Expr) \
                        and isinstance(node.value, ast.Call):
                    call = node.value
                    inner = call
                    if isinstance(call.func, ast.Attribute) and \
                            isinstance(call.func.value, ast.Call):
                        inner = call.func.value  # Thread(...).start()
                    f = self._check_ctor(relpath, inner, set(),
                                         scope, with_ctxs, lines)
                    if f:
                        findings.append(f)

    def _check_ctor(self, relpath, call: ast.Call, names: set,
                    scope: _Scope, with_ctxs,
                    lines) -> Optional[Finding]:
        leaf = _leaf(call.func)
        if leaf in _THREAD_CTORS:
            kind = _THREAD_CTORS[leaf]
            if _has_true_kw(call, "daemon") or scope.daemon(names):
                return None
            if kind == "thread" and scope.has(names, "join"):
                return None
            if kind == "timer" and (scope.has(names, "cancel")
                                    or scope.has(names, "join")):
                return None
            what = "Thread" if kind == "thread" else "Timer"
            fix = ("pass daemon=True or join it on every exit path"
                   if kind == "thread"
                   else "pass daemon=True or cancel it on shutdown")
            bound = f" bound to {sorted(names)[0]!r}" if names else \
                " (never bound — cannot be joined)"
            return self.finding(
                relpath, call,
                f"{what}{bound} has no visible lifecycle in its "
                f"owning scope: {fix}", lines)
        if leaf in _EXECUTOR_CTORS:
            if id(call) in with_ctxs:
                return None
            if scope.has(names, "shutdown"):
                return None
            bound = f" bound to {sorted(names)[0]!r}" if names else \
                " (never bound — cannot be shut down)"
            return self.finding(
                relpath, call,
                f"{leaf}{bound} is neither a context manager nor "
                f"shut down in its owning scope; worker threads leak",
                lines)
        return None
