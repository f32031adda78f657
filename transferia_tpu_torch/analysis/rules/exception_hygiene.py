"""EXC001 — exception hygiene (the port's copy of the reference's rule).

Flags silent swallows: `except:` / `except Exception:` /
`except BaseException:` whose body does nothing (pass/.../continue)
and never logs.  A swallowed device-dispatch error is the worst case —
the pipeline keeps pumping batches into a dead card, or carries on on
the CPU — so over-broad excepts whose try-body dispatches to the device
are flagged even when they re-handle, unless they log or re-raise.
The port's dispatch markers are the torch ones: `.to(<device>)`,
`.cuda()`, `synchronize`, and a kernel launch (`_build.library(...)`,
a `trt_*` entry point, `device_dispatch`).

A swallow can be legitimate (best-effort close() on teardown): carry a
justifying comment AND a `# trtpu: ignore[EXC001]` pragma on the
`except` line, or log at debug.
"""

from __future__ import annotations

import ast
from typing import Sequence

from transferia_tpu_torch.analysis.engine import Finding, Rule, dotted_name

_BROAD = {"Exception", "BaseException"}
_LOG_METHODS = {"debug", "info", "warning", "warn", "error",
                "exception", "critical", "log"}
_DISPATCH_MARKERS = {"cuda", "synchronize", "device_dispatch"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        if isinstance(n, ast.Name) and n.id in _BROAD:
            return True
        if isinstance(n, ast.Attribute) and n.attr in _BROAD:
            return True
    return False


def _is_noop_body(body: Sequence[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     ast.Constant):
            continue  # docstring / `...`
        return False
    return True


def _logs_or_raises(body: Sequence[ast.stmt]) -> bool:
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _LOG_METHODS:
                return True
    return False


def _names_a_device(node: ast.AST) -> bool:
    """A `.to(...)` argument that is a device: a name or attribute
    mentioning "dev" (`dev`, `device`, `self.device`), or a "cuda"
    string."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    d = dotted_name(node) or ""
    return "dev" in d.rsplit(".", 1)[-1].lower()


def _is_device_move(node: ast.Call) -> bool:
    fn = node.func
    if not (isinstance(fn, ast.Attribute) and fn.attr == "to"):
        return False
    args = list(node.args[:1]) + [k.value for k in node.keywords
                                  if k.arg == "device"]
    return any(_names_a_device(a) for a in args)


def _dispatches_to_device(try_body: Sequence[ast.stmt]) -> bool:
    for stmt in try_body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Attribute) and (
                    node.attr in _DISPATCH_MARKERS
                    or node.attr.startswith("trt_")):
                return True
            if isinstance(node, ast.Call) and (
                    _is_device_move(node) or (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr == "library"
                        and (dotted_name(node.func.value) or ""
                             ).endswith("_build"))):
                return True
    return False


class ExceptionHygieneRule(Rule):
    id = "EXC001"
    severity = "warning"
    description = ("silent `except Exception: pass` (no logging), or "
                   "an over-broad except wrapping device dispatch")

    def check_file(self, relpath: str, tree: ast.AST,
                   lines: Sequence[str]) -> list[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                if not _is_broad(handler):
                    continue
                if _is_noop_body(handler.body):
                    findings.append(self.finding(
                        relpath, handler,
                        "broad except silently swallows the error — "
                        "log at debug or add a justifying comment + "
                        "`# trtpu: ignore[EXC001]`", lines))
                elif _dispatches_to_device(node.body) \
                        and not _logs_or_raises(handler.body):
                    findings.append(self.finding(
                        relpath, handler,
                        "broad except wraps device dispatch without "
                        "logging or re-raising — a dead mesh keeps "
                        "accepting batches silently", lines))
        return findings
