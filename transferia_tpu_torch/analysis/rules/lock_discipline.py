"""LCK001 — lock discipline in classes that own a threading lock.

Two hazards across the ~30 threaded modules:

1. a field written both under `with self._lock:` and outside it — the
   unlocked write races every locked reader (the lock is decoration);
2. a blocking call (time.sleep, socket/HTTP I/O) made while holding a
   lock — every other thread on that lock stalls behind the wire.

Scope is per-class: a class "owns" a lock when any method assigns
`self.<attr> = threading.Lock()/RLock()/Condition()`.  `__init__`,
`__new__` and `__del__` writes are constructor/teardown-time (object
not yet/no longer shared) and don't count as unlocked writes.
"""

from __future__ import annotations

import ast
from typing import Optional, Sequence

from transferia_tpu_torch.analysis.engine import Finding, Rule

_LOCK_CTORS = {"Lock", "RLock", "Condition", "named_lock"}
_INIT_METHODS = {"__init__", "__new__", "__del__", "__init_subclass__"}
_BLOCKING_SIMPLE = {"time.sleep", "socket.create_connection",
                    "urllib.request.urlopen", "recv_exact"}
_BLOCKING_METHODS = {"recv", "recv_into", "sendall", "connect",
                     "accept", "getresponse", "urlopen"}


def _lock_attrs(cls: ast.ClassDef) -> set[str]:
    """self.<attr> names assigned a threading lock anywhere in the
    class."""
    out: set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        if not (isinstance(v, ast.Call) and _ctor_name(v.func)):
            continue
        for t in node.targets:
            if isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                out.add(t.attr)
    return out


def _ctor_name(fn: ast.AST) -> bool:
    if isinstance(fn, ast.Attribute):
        return fn.attr in _LOCK_CTORS
    if isinstance(fn, ast.Name):
        return fn.id in _LOCK_CTORS
    return False


def _is_self_lock(expr: ast.AST, locks: set[str]) -> bool:
    return (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self" and expr.attr in locks)


def _call_name(node: ast.Call) -> Optional[str]:
    fn = node.func
    parts = []
    while isinstance(fn, ast.Attribute):
        parts.append(fn.attr)
        fn = fn.value
    if isinstance(fn, ast.Name):
        parts.append(fn.id)
    elif parts:
        parts.append("<expr>")
    return ".".join(reversed(parts)) if parts else None


class _MethodScan(ast.NodeVisitor):
    """Walk one method, tracking whether we're inside `with self.<lock>`.

    Nested function defs are skipped: they execute later, under whatever
    lock state holds at call time, not here.
    """

    def __init__(self, locks: set[str]):
        self.locks = locks
        self.depth = 0  # >0 while holding a lock
        # attr -> list[(node, held)] in source order
        self.writes: list[tuple[str, ast.AST, bool]] = []
        self.blocking: list[tuple[ast.Call, str]] = []

    def visit_With(self, node: ast.With) -> None:
        # items enter left-to-right: `with self._lock, connect():` runs
        # connect() while already holding the lock, but
        # `with connect(), self._lock:` does not
        entered = 0
        for item in node.items:
            self.visit(item.context_expr)
            if _is_self_lock(item.context_expr, self.locks):
                self.depth += 1
                entered += 1
        for stmt in node.body:
            self.visit(stmt)
        self.depth -= entered

    visit_AsyncWith = visit_With

    def visit_FunctionDef(self, node):  # nested defs: skip
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def _record_target(self, target: ast.AST) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._record_target(el)
            return
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self" \
                and target.attr not in self.locks:
            self.writes.append((target.attr, target, self.depth > 0))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_target(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_target(node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_target(node.target)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if self.depth > 0:
            name = _call_name(node) or ""
            leaf = name.rsplit(".", 1)[-1]
            # `self.recv()` is a call into our own class (scanned on its
            # own), but `self.sock.recv()` is real socket I/O
            own_method = name == f"self.{leaf}"
            if name in _BLOCKING_SIMPLE or (
                    "." in name and leaf in _BLOCKING_METHODS
                    and not own_method):
                self.blocking.append((node, name))
        self.generic_visit(node)


class LockDisciplineRule(Rule):
    id = "LCK001"
    severity = "error"
    description = ("field written both under and outside the owning "
                   "lock, or blocking I/O while holding a lock")

    def check_file(self, relpath: str, tree: ast.AST,
                   lines: Sequence[str]) -> list[Finding]:
        findings: list[Finding] = []
        for cls in ast.walk(tree):
            if isinstance(cls, ast.ClassDef):
                self._check_class(relpath, cls, lines, findings)
        return findings

    def _check_class(self, relpath: str, cls: ast.ClassDef,
                     lines: Sequence[str],
                     findings: list[Finding]) -> None:
        locks = _lock_attrs(cls)
        if not locks:
            return
        locked_attrs: set[str] = set()
        unlocked: list[tuple[str, ast.AST]] = []
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            scan = _MethodScan(locks)
            # `_locked` suffix = caller-holds-the-lock convention
            # (asynchronizer._flush_locked et al.): treat the whole
            # method body as a held region
            if meth.name.endswith("_locked"):
                scan.depth += 1
            for stmt in meth.body:
                scan.visit(stmt)
            init_like = meth.name in _INIT_METHODS
            for attr, node, held in scan.writes:
                if held:
                    locked_attrs.add(attr)
                elif not init_like:
                    unlocked.append((attr, node))
            for call, name in scan.blocking:
                findings.append(self.finding(
                    relpath, call,
                    f"blocking call {name}() while holding "
                    f"{cls.name}.{'/'.join(sorted(locks))} — other "
                    f"threads stall behind the I/O", lines,
                    severity="warning"))
        for attr, node in unlocked:
            if attr in locked_attrs:
                findings.append(self.finding(
                    relpath, node,
                    f"{cls.name}.{attr} is written under "
                    f"{'/'.join(sorted(locks))} elsewhere but written "
                    f"here without it — racy", lines))
