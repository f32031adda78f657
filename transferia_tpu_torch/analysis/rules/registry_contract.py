"""REG001 — plugin registry contract (providers/transformers/parsers).

The registries bind at import time and break only at transfer time:
a duplicate key silently shadows the earlier registration, and an
abstract class registered by mistake explodes on first instantiation
mid-snapshot.  This rule enforces the contract statically + at load:

  1. AST pass over the whole tree: every `register_transformer("k")` /
     `register_parser("k")` decorator literal and every `NAME = "k"` in
     a `@register_provider` class must be unique tree-wide (the runtime
     dicts can't see collisions — last writer wins silently);
  2. load pass: import the real registries
     (`load_builtin_providers()`, transform + parser plugin packages)
     and assert every registered provider class and every registered
     Transformer/Parser subclass is concrete (no remaining
     `__abstractmethods__`) and, for providers, that NAME matches its
     registry key.

The load pass reports an import failure as a finding rather than
crashing the linter: a registry that can't even import is the contract
violation.
"""

from __future__ import annotations

import ast

from transferia_tpu_torch.analysis.engine import Finding, ProjectRule


def _decorator_key(dec: ast.AST, factory: str) -> str | None:
    """The literal key of `@register_transformer("k")`-style decorators."""
    if isinstance(dec, ast.Call):
        name = dec.func
        leaf = name.attr if isinstance(name, ast.Attribute) else \
            name.id if isinstance(name, ast.Name) else ""
        if leaf == factory and dec.args \
                and isinstance(dec.args[0], ast.Constant) \
                and isinstance(dec.args[0].value, str):
            return dec.args[0].value
    return None


def _has_register_provider(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        leaf = dec.attr if isinstance(dec, ast.Attribute) else \
            dec.id if isinstance(dec, ast.Name) else ""
        if leaf == "register_provider":
            return True
    return False


def _class_name_attr(node: ast.ClassDef) -> str | None:
    for stmt in node.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and t.id == "NAME" \
                        and isinstance(stmt.value, ast.Constant) \
                        and isinstance(stmt.value.value, str):
                    return stmt.value.value
    return None


class RegistryContractRule(ProjectRule):
    id = "REG001"
    severity = "error"
    description = ("duplicate registry key, abstract class registered, "
                   "or provider NAME/key mismatch")
    # set False in unit tests that feed synthetic trees
    do_import_check = True

    def check_project(self, root: str,
                      files: dict[str, tuple[ast.AST, list[str]]]
                      ) -> list[Finding]:
        findings: list[Finding] = []
        self._check_duplicates(files, findings)
        if self.do_import_check:
            findings.extend(self.import_check())
        return findings

    # -- pass 1: tree-wide duplicate keys -----------------------------------
    def _check_duplicates(self, files, findings) -> None:
        seen: dict[tuple[str, str], tuple[str, int]] = {}

        def claim(kind: str, key: str, relpath: str, node, lines):
            prev = seen.get((kind, key))
            if prev is not None:
                findings.append(self.finding(
                    relpath, node,
                    f"duplicate {kind} key {key!r} — already registered "
                    f"at {prev[0]}:{prev[1]} (last registration wins "
                    f"silently)", lines))
            else:
                seen[(kind, key)] = (relpath, node.lineno)

        for relpath, (tree, lines) in sorted(files.items()):
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef):
                    if _has_register_provider(node):
                        key = _class_name_attr(node)
                        if key is None:
                            findings.append(self.finding(
                                relpath, node,
                                f"provider class {node.name} registered "
                                f"without a literal NAME", lines))
                        else:
                            claim("provider", key, relpath, node, lines)
                    for dec in node.decorator_list:
                        for factory, kind in (
                                ("register_transformer", "transformer"),
                                ("register_parser", "parser")):
                            key = _decorator_key(dec, factory)
                            if key is not None:
                                claim(kind, key, relpath, node, lines)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    for dec in node.decorator_list:
                        for factory, kind in (
                                ("register_transformer", "transformer"),
                                ("register_parser", "parser")):
                            key = _decorator_key(dec, factory)
                            if key is not None:
                                claim(kind, key, relpath, node, lines)

    # -- pass 2: load the real registries -----------------------------------
    def import_check(self) -> list[Finding]:
        findings: list[Finding] = []

        def fail(msg: str) -> None:
            findings.append(Finding(
                rule=self.id, severity="error", path="<registry>",
                line=1, col=1, message=msg, snippet=msg))

        try:
            from transferia_tpu_torch.providers import load_builtin_providers
            from transferia_tpu_torch.providers.registry import (
                _PROVIDERS,
                Provider,
            )

            load_builtin_providers()
            for key, cls in sorted(_PROVIDERS.items()):
                if not issubclass(cls, Provider):
                    fail(f"provider {key!r}: {cls.__name__} is not a "
                         f"Provider subclass")
                if getattr(cls, "NAME", "") != key:
                    fail(f"provider {key!r}: class NAME "
                         f"{getattr(cls, 'NAME', '')!r} != registry key")
                missing = sorted(getattr(cls, "__abstractmethods__", ()))
                if missing:
                    fail(f"provider {key!r}: {cls.__name__} is abstract "
                         f"(missing {', '.join(missing)})")
        except Exception as e:  # registry failed to even import
            fail(f"provider registry failed to load: {e!r}")

        try:
            import transferia_tpu_torch.transform  # noqa: F401 (loads plugins)
            from transferia_tpu_torch.transform.base import Transformer

            for cls in _all_subclasses(Transformer):
                if getattr(cls, "TYPE", None) and \
                        getattr(cls, "__abstractmethods__", ()):
                    missing = sorted(cls.__abstractmethods__)
                    fail(f"transformer {cls.TYPE!r}: {cls.__name__} is "
                         f"abstract (missing {', '.join(missing)})")
        except Exception as e:
            fail(f"transformer registry failed to load: {e!r}")

        try:
            import transferia_tpu_torch.parsers  # noqa: F401 (loads plugins)
            from transferia_tpu_torch.parsers.base import Parser

            for cls in _all_subclasses(Parser):
                if getattr(cls, "TYPE", None) and \
                        getattr(cls, "__abstractmethods__", ()):
                    missing = sorted(cls.__abstractmethods__)
                    fail(f"parser {cls.TYPE!r}: {cls.__name__} is "
                         f"abstract (missing {', '.join(missing)})")
        except Exception as e:
            fail(f"parser registry failed to load: {e!r}")
        return findings


def _all_subclasses(base: type) -> list[type]:
    out, stack = [], [base]
    while stack:
        cls = stack.pop()
        for sub in cls.__subclasses__():
            out.append(sub)
            stack.append(sub)
    return out
