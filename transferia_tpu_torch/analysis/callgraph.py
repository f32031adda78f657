"""Interprocedural infrastructure for `trtpu check` project rules.

The per-function rules (LCK001 et al.) see one method at a time; the
concurrency rules need the *whole-program* picture: which qualified
function acquires which lock, who calls whom while holding what, and
therefore which global lock order the tree implies.  This module builds
that picture once per run:

- **module-qualified symbol index** — every class/function keyed as
  ``package.module.Class.method``;
- **lock alias resolution** — a lock is identified by its owning
  class/field (``module.Class.attr``) or, when created through
  ``lockwatch.named_lock("name")``, by that runtime name, so static
  findings and runtime lockwatch findings agree on identity;
  ``threading.Condition(self._lock)`` aliases to the wrapped lock;
- **held-region tracking** — ``with self._lock:`` blocks, bare
  ``.acquire()``/``.release()`` pairs, and the ``*_locked``
  caller-holds convention (a ``_locked`` method's body is *not* an
  acquisition — the edge is charged to the caller that actually holds
  the lock);
- **conservative call resolution** — ``self.m()``, module-local and
  imported functions, constructors, and attribute chains typed via
  ``self.x = Class(...)`` assignments, parameter annotations, and
  return annotations (``def _op(...) -> _OpState``);
- the **lock-order graph**: edge ``A -> B`` when B is acquired
  (possibly through calls) while A is held, each edge carrying its
  first witness chain of ``file:line`` steps.

Resolution is deliberately conservative: an unresolvable callee or lock
expression contributes nothing (no guessed edges), so every edge in the
graph is backed by a concrete witness chain.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Optional, Sequence

_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}
_NAMED_LOCK = "named_lock"
_MAX_CHAIN = 8          # witness chain length cap
_MAX_FIXPOINT = 25      # transitive-acquire iterations cap


def _mod_name(relpath: str) -> str:
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def _dotted(node: ast.AST) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class LockDef:
    """One lock identity (owning class/field or lockwatch name)."""

    qual: str
    kind: str           # lock | rlock | condition
    path: str
    line: int


@dataclass
class Event:
    """One acquisition or resolvable call inside a function body."""

    kind: str           # "acquire" | "call"
    target: str         # lock qual | callee qual
    line: int
    held: tuple         # ((lock_qual, line_of_acquisition), ...)


@dataclass
class FuncInfo:
    qual: str
    path: str
    line: int
    cls: Optional[str] = None       # owning class qual
    returns: Optional[str] = None   # resolved return class qual
    events: list = field(default_factory=list)


@dataclass
class ClassInfo:
    qual: str
    path: str
    line: int
    lock_attrs: dict = field(default_factory=dict)  # attr -> lock qual
    attr_types: dict = field(default_factory=dict)  # attr -> class qual
    methods: set = field(default_factory=set)


@dataclass
class Edge:
    """Lock-order edge A -> B with its first witness chain."""

    src: str
    dst: str
    witness: tuple      # ((path, line, note), ...)


class ProjectIndex:
    """The whole-tree symbol/lock/call index (built once per run)."""

    def __init__(self):
        self.classes: dict[str, ClassInfo] = {}
        self.functions: dict[str, FuncInfo] = {}
        self.locks: dict[str, LockDef] = {}
        self.module_locks: dict[str, dict[str, str]] = {}  # mod -> name -> qual
        self.imports: dict[str, dict[str, str]] = {}       # mod -> alias -> target
        self.module_symbols: dict[str, dict[str, str]] = {}  # mod -> name -> qual
        self.edges: dict[tuple, Edge] = {}
        # func qual -> lock qual -> witness chain to the acquire
        self.acquires: dict[str, dict[str, tuple]] = {}

    # -- name resolution ------------------------------------------------
    def resolve_symbol(self, module: str, name: str) -> Optional[str]:
        """A bare name in `module` -> fully qualified symbol, when the
        target exists in the parsed tree."""
        local = self.module_symbols.get(module, {})
        if name in local:
            return local[name]
        imp = self.imports.get(module, {})
        if name in imp:
            tgt = imp[name]
            if tgt in self.classes or tgt in self.functions:
                return tgt
            # `import x.y as z` -> z maps to a module
            return tgt
        return None

    def resolve_class(self, module: str, name: str) -> Optional[str]:
        q = self.resolve_symbol(module, name)
        if q in self.classes:
            return q
        # dotted: mod_alias.Class
        if "." in name:
            head, _, rest = name.partition(".")
            base = self.imports.get(module, {}).get(head)
            if base:
                cand = f"{base}.{rest}"
                if cand in self.classes:
                    return cand
        return None

    def resolve_annotation(self, module: str,
                           ann: Optional[ast.AST]) -> Optional[str]:
        """Class qual from a return/param annotation; unwraps
        Optional[...] and string annotations."""
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.Subscript):
            base = _dotted(ann.slice) if not isinstance(
                ann.slice, ast.Tuple) else None
            if base:
                return self.resolve_class(module, base)
            return None
        name = _dotted(ann)
        return self.resolve_class(module, name) if name else None


def _lock_ctor(call: ast.Call) -> Optional[tuple[str, Optional[str],
                                                 Optional[ast.AST]]]:
    """(kind, explicit_name, alias_expr) when `call` constructs a lock.

    alias_expr is the wrapped lock for `threading.Condition(other)`.
    """
    fn = call.func
    leaf = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None)
    if leaf in _LOCK_CTORS:
        alias = call.args[0] if (leaf == "Condition" and call.args) \
            else None
        return _LOCK_CTORS[leaf], None, alias
    if leaf == _NAMED_LOCK:
        name = None
        if call.args and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            name = call.args[0].value
        kind = "lock"
        for kw in call.keywords:
            if kw.arg == "kind" and isinstance(kw.value, ast.Constant):
                kind = str(kw.value.value)
        return kind, name, None
    return None


class _BodyScan:
    """Walk one function body tracking the held-lock stack and
    recording acquire/call events (engine of the lock-order graph)."""

    def __init__(self, index: ProjectIndex, module: str, path: str,
                 func: FuncInfo, cls: Optional[ClassInfo]):
        self.ix = index
        self.module = module
        self.path = path
        self.func = func
        self.cls = cls
        self.local_types: dict[str, str] = {}
        self.held: list[tuple[str, int]] = []

    # -- typing ---------------------------------------------------------
    def _type_of(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Name):
            if expr.id == "self":
                return self.cls.qual if self.cls else None
            return self.local_types.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = self._type_of(expr.value)
            if base and base in self.ix.classes:
                return self.ix.classes[base].attr_types.get(expr.attr)
            return None
        if isinstance(expr, ast.Call):
            callee = self._callee(expr)
            if callee is None:
                return None
            if callee in self.ix.classes:
                return callee
            fi = self.ix.functions.get(callee)
            return fi.returns if fi else None
        return None

    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Name):
            q = self.ix.module_locks.get(self.module, {}).get(expr.id)
            if q:
                return q
            tgt = self.ix.imports.get(self.module, {}).get(expr.id)
            if tgt and tgt in self.ix.locks:
                return tgt
            return None
        if isinstance(expr, ast.Attribute):
            base = self._type_of(expr.value)
            if base and base in self.ix.classes:
                return self.ix.classes[base].lock_attrs.get(expr.attr)
        return None

    def _callee(self, call: ast.Call) -> Optional[str]:
        fn = call.func
        if isinstance(fn, ast.Name):
            q = self.ix.resolve_symbol(self.module, fn.id)
            if q and (q in self.ix.functions or q in self.ix.classes):
                return q
            return None
        if isinstance(fn, ast.Attribute):
            # self.m() / typed_expr.m() / module_alias.f()
            base_t = self._type_of(fn.value)
            if base_t and base_t in self.ix.classes:
                ci = self.ix.classes[base_t]
                if fn.attr in ci.methods:
                    return f"{base_t}.{fn.attr}"
                return None
            name = _dotted(fn)
            if name:
                head, _, rest = name.partition(".")
                base = self.ix.imports.get(self.module, {}).get(head)
                if base and rest:
                    cand = f"{base}.{rest}"
                    if cand in self.ix.functions or \
                            cand in self.ix.classes:
                        return cand
        return None

    # -- events ---------------------------------------------------------
    def _emit_acquire(self, qual: str, line: int) -> None:
        self.func.events.append(Event("acquire", qual, line,
                                      tuple(self.held)))

    def _emit_call(self, qual: str, line: int) -> None:
        if qual in self.ix.classes:
            ctor = f"{qual}.__init__"
            if ctor not in self.ix.functions:
                return
            qual = ctor
        self.func.events.append(Event("call", qual, line,
                                      tuple(self.held)))

    def _scan_expr(self, expr: Optional[ast.AST]) -> None:
        """Record calls (and bare acquire/release) inside an
        expression; nested defs/lambdas execute later — skipped."""
        if expr is None:
            return
        for node in ast.walk(expr):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                # ast.walk is pre-order; prune by ignoring their calls
                for sub in ast.walk(node):
                    sub._cg_skip = True  # type: ignore[attr-defined]
                continue
            if not isinstance(node, ast.Call) or \
                    getattr(node, "_cg_skip", False):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in ("acquire", "release"):
                lq = self._lock_of(fn.value)
                if lq:
                    if fn.attr == "acquire":
                        self._emit_acquire(lq, node.lineno)
                        self.held.append((lq, node.lineno))
                    else:
                        for i in range(len(self.held) - 1, -1, -1):
                            if self.held[i][0] == lq:
                                del self.held[i]
                                break
                    continue
            callee = self._callee(node)
            if callee:
                self._emit_call(callee, node.lineno)

    def _bind_target(self, target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, ast.Name):
            t = self._type_of(value)
            if t:
                self.local_types[target.id] = t
            else:
                self.local_types.pop(target.id, None)

    def scan(self, stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                entered = 0
                for item in stmt.items:
                    lq = self._lock_of(item.context_expr)
                    if lq is None and isinstance(item.context_expr,
                                                 ast.Call):
                        # with self._queue(name).lock: ... is an
                        # Attribute; with pool.guard(): a call we
                        # can't type — scan for nested calls either way
                        pass
                    if lq:
                        self._emit_acquire(lq, item.context_expr.lineno)
                        self.held.append((lq, item.context_expr.lineno))
                        entered += 1
                    else:
                        self._scan_expr(item.context_expr)
                self.scan(stmt.body)
                for _ in range(entered):
                    self.held.pop()
                continue
            if isinstance(stmt, ast.Assign):
                self._scan_expr(stmt.value)
                for t in stmt.targets:
                    self._bind_target(t, stmt.value)
                continue
            if isinstance(stmt, ast.AnnAssign):
                self._scan_expr(stmt.value)
                if stmt.value is not None:
                    self._bind_target(stmt.target, stmt.value)
                elif isinstance(stmt.target, ast.Name):
                    ann_t = self.ix.resolve_annotation(
                        self.module, stmt.annotation)
                    if ann_t:
                        self.local_types[stmt.target.id] = ann_t
                continue
            if isinstance(stmt, ast.AugAssign):
                self._scan_expr(stmt.value)
                continue
            if isinstance(stmt, (ast.If, ast.While)):
                self._scan_expr(stmt.test)
                self.scan(stmt.body)
                self.scan(stmt.orelse)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_expr(stmt.iter)
                self.scan(stmt.body)
                self.scan(stmt.orelse)
                continue
            if isinstance(stmt, ast.Try):
                self.scan(stmt.body)
                for h in stmt.handlers:
                    self.scan(h.body)
                self.scan(stmt.orelse)
                self.scan(stmt.finalbody)
                continue
            # Expr / Return / Raise / Assert / Delete / ...
            for val in ast.iter_child_nodes(stmt):
                if isinstance(val, ast.expr):
                    self._scan_expr(val)


def build_index(files: dict[str, tuple[ast.AST, list[str]]]
                ) -> ProjectIndex:
    """Build the whole-tree index from the engine's parsed-file map."""
    ix = ProjectIndex()
    mods = {rel: _mod_name(rel) for rel in files}

    # pass A: symbols, imports, lock definitions, attribute types -------
    for rel in sorted(files):
        tree, _lines = files[rel]
        mod = mods[rel]
        imp: dict[str, str] = {}
        syms: dict[str, str] = {}
        mlocks: dict[str, str] = {}
        ix.imports[mod] = imp
        ix.module_symbols[mod] = syms
        ix.module_locks[mod] = mlocks
        for node in tree.body if isinstance(tree, ast.Module) else []:
            if isinstance(node, ast.Import):
                for a in node.names:
                    imp[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    imp[a.asname or a.name] = f"{node.module}.{a.name}"
            elif isinstance(node, ast.ClassDef):
                cq = f"{mod}.{node.name}"
                syms[node.name] = cq
                ci = ClassInfo(qual=cq, path=rel, line=node.lineno)
                ci.methods = {m.name for m in node.body if isinstance(
                    m, (ast.FunctionDef, ast.AsyncFunctionDef))}
                ix.classes[cq] = ci
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                fq = f"{mod}.{node.name}"
                syms[node.name] = fq
                ix.functions[fq] = FuncInfo(qual=fq, path=rel,
                                            line=node.lineno)
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                got = _lock_ctor(node.value)
                if got is None:
                    continue
                kind, name, _alias = got
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        q = name or f"{mod}.{t.id}"
                        mlocks[t.id] = q
                        ix.locks.setdefault(q, LockDef(
                            q, kind, rel, node.lineno))

    # pass A2: class lock attrs + attr types (needs symbol table) -------
    for rel in sorted(files):
        tree, _lines = files[rel]
        mod = mods[rel]
        for node in tree.body if isinstance(tree, ast.Module) else []:
            if not isinstance(node, ast.ClassDef):
                continue
            ci = ix.classes[f"{mod}.{node.name}"]
            pending_alias: list[tuple[str, ast.AST, int]] = []
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Assign) or \
                        not isinstance(sub.value, ast.Call):
                    continue
                tgts = [t for t in sub.targets
                        if isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"]
                if not tgts:
                    continue
                got = _lock_ctor(sub.value)
                if got is not None:
                    kind, name, alias = got
                    for t in tgts:
                        if alias is not None:
                            pending_alias.append((t.attr, alias,
                                                  sub.lineno))
                            continue
                        q = name or f"{ci.qual}.{t.attr}"
                        ci.lock_attrs[t.attr] = q
                        ix.locks.setdefault(q, LockDef(
                            q, kind, rel, sub.lineno))
                    continue
                # self.x = ClassName(...) attribute typing
                fn_name = _dotted(sub.value.func)
                if fn_name:
                    cq = ix.resolve_class(mod, fn_name)
                    if cq:
                        for t in tgts:
                            ci.attr_types[t.attr] = cq
            # Condition(self._lock) aliases resolve after lock attrs
            for attr, alias, lineno in pending_alias:
                if isinstance(alias, ast.Attribute) and \
                        isinstance(alias.value, ast.Name) and \
                        alias.value.id == "self" and \
                        alias.attr in ci.lock_attrs:
                    ci.lock_attrs[attr] = ci.lock_attrs[alias.attr]
                else:
                    q = f"{ci.qual}.{attr}"
                    ci.lock_attrs[attr] = q
                    ix.locks.setdefault(q, LockDef(
                        q, "condition", rel, lineno))

    # pass B: function events -------------------------------------------
    for rel in sorted(files):
        tree, _lines = files[rel]
        mod = mods[rel]
        for node in tree.body if isinstance(tree, ast.Module) else []:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _scan_function(ix, mod, rel, node, None)
            elif isinstance(node, ast.ClassDef):
                ci = ix.classes[f"{mod}.{node.name}"]
                for meth in node.body:
                    if isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        _scan_function(ix, mod, rel, meth, ci)

    _propagate_acquires(ix)
    _build_edges(ix)
    return ix


def _scan_function(ix: ProjectIndex, mod: str, rel: str,
                   node, ci: Optional[ClassInfo]) -> None:
    qual = f"{ci.qual}.{node.name}" if ci else f"{mod}.{node.name}"
    fi = ix.functions.get(qual)
    if fi is None:
        fi = ix.functions[qual] = FuncInfo(qual=qual, path=rel,
                                           line=node.lineno)
    fi.cls = ci.qual if ci else None
    fi.returns = ix.resolve_annotation(mod, node.returns)
    scan = _BodyScan(ix, mod, rel, fi, ci)
    for arg in list(node.args.args) + list(node.args.kwonlyargs):
        t = ix.resolve_annotation(mod, arg.annotation)
        if t:
            scan.local_types[arg.arg] = t
    scan.scan(node.body)


def _propagate_acquires(ix: ProjectIndex) -> None:
    """acq[f] = locks f may acquire transitively, with one witness
    chain each (first/shortest found, deterministic)."""
    acq: dict[str, dict[str, tuple]] = {}
    for q in sorted(ix.functions):
        fi = ix.functions[q]
        mine: dict[str, tuple] = {}
        for ev in fi.events:
            if ev.kind == "acquire" and ev.target not in mine:
                mine[ev.target] = ((fi.path, ev.line,
                                    f"acquires {ev.target}"),)
        acq[q] = mine
    for _ in range(_MAX_FIXPOINT):
        changed = False
        for q in sorted(ix.functions):
            fi = ix.functions[q]
            mine = acq[q]
            for ev in fi.events:
                if ev.kind != "call":
                    continue
                for lock, chain in sorted(acq.get(ev.target,
                                                  {}).items()):
                    if lock in mine or len(chain) >= _MAX_CHAIN:
                        continue
                    mine[lock] = ((fi.path, ev.line,
                                   f"calls {ev.target}"),) + chain
                    changed = True
        if not changed:
            break
    ix.acquires = acq


def _build_edges(ix: ProjectIndex) -> None:
    for q in sorted(ix.functions):
        fi = ix.functions[q]
        for ev in fi.events:
            if not ev.held:
                continue
            if ev.kind == "acquire":
                for (held_q, held_line) in ev.held:
                    if held_q == ev.target:
                        continue
                    key = (held_q, ev.target)
                    if key not in ix.edges:
                        ix.edges[key] = Edge(held_q, ev.target, (
                            (fi.path, held_line, f"holds {held_q}"),
                            (fi.path, ev.line,
                             f"acquires {ev.target}")))
            else:
                for lock, chain in sorted(
                        ix.acquires.get(ev.target, {}).items()):
                    for (held_q, held_line) in ev.held:
                        if held_q == lock:
                            continue
                        key = (held_q, lock)
                        if key not in ix.edges:
                            ix.edges[key] = Edge(held_q, lock, (
                                (fi.path, held_line,
                                 f"holds {held_q}"),
                                (fi.path, ev.line,
                                 f"calls {ev.target}")) + chain)


def find_cycles(ix: ProjectIndex) -> list[list[str]]:
    """Deterministic list of lock-order cycles: every 2-cycle, plus one
    shortest representative cycle for any larger SCC not already
    covered by a 2-cycle."""
    adj: dict[str, set[str]] = {}
    for (a, b) in ix.edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())
    cycles: list[list[str]] = []
    seen_pairs: set[frozenset] = set()
    for a in sorted(adj):
        for b in sorted(adj[a]):
            if a < b and a in adj.get(b, ()):  # 2-cycle
                cycles.append([a, b])
                seen_pairs.add(frozenset((a, b)))
    for scc in _sccs(adj):
        if len(scc) < 2:
            continue
        if any(frozenset((a, b)) in seen_pairs
               for a in scc for b in scc if a < b):
            continue
        cyc = _shortest_cycle(adj, sorted(scc)[0], scc)
        if cyc:
            cycles.append(cyc)
    return cycles


def _sccs(adj: dict[str, set[str]]) -> list[set[str]]:
    """Tarjan (iterative), deterministic over sorted nodes."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on: set[str] = set()
    stack: list[str] = []
    out: list[set[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(adj.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                if w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = set()
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.add(w)
                    if w == node:
                        break
                out.append(comp)

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)
    return out


def _shortest_cycle(adj: dict[str, set[str]], start: str,
                    scc: set[str]) -> Optional[list[str]]:
    """BFS within the SCC from `start` back to itself."""
    frontier = [(start, [start])]
    visited = {start}
    while frontier:
        nxt = []
        for node, path in frontier:
            for w in sorted(adj.get(node, ())):
                if w == start:
                    return path
                if w in scc and w not in visited:
                    visited.add(w)
                    nxt.append((w, path + [w]))
        frontier = nxt
    return None


def format_witness(edge: Edge) -> str:
    """`file:line -> file:line` chain for one edge."""
    return " -> ".join(f"{p}:{ln}" for (p, ln, _note) in edge.witness)
