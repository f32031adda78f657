"""Rule engine for `trtpu check` — framework-aware static analysis (the
port's copy of ``transferia_tpu/analysis/engine.py``).

The standard toolchain (flake8/mypy) can't see the three hazard classes
this engine exists for: host syncs hidden in kernel-launch code,
shared state mutated across the lock-using threaded modules, and the
compile-time plugin registry whose contract otherwise breaks only at
transfer time.  Rules are small AST visitors (plus one whole-project
rule that imports the real registries); the engine owns file walking,
`# trtpu: ignore[...]` suppressions, the committed baseline, and output
formatting so pre-existing findings never block CI.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

SEVERITIES = ("error", "warning")


def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for an Attribute/Name chain, None when the
    chain roots in anything else (a call result, a subscript) — shared by
    the rules so chain-handling fixes land everywhere at once."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass(frozen=True)
class Finding:
    """One diagnostic: rule id + location + message.

    `snippet` is the stripped source line — it feeds the baseline
    fingerprint so findings survive unrelated line insertions above
    them (fingerprints must not embed absolute line numbers).
    """

    rule: str
    severity: str
    path: str  # repo-relative, posix separators
    line: int
    col: int
    message: str
    snippet: str = ""

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} [{self.severity}] {self.message}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Rule:
    """Per-file AST rule.  Subclasses set `id`, `severity`,
    `description` and implement `check_file`.

    `paths` (optional tuple of path fragments) scopes the rule to files
    whose repo-relative path contains one of the fragments — e.g.
    device-purity only makes sense where jitted kernels live.
    """

    id: str = ""
    severity: str = "warning"
    description: str = ""
    paths: Optional[tuple[str, ...]] = None

    def applies_to(self, relpath: str) -> bool:
        if self.paths is None:
            return True
        return any(frag in relpath for frag in self.paths)

    def check_file(self, relpath: str, tree: ast.AST,
                   lines: Sequence[str]) -> list[Finding]:
        raise NotImplementedError

    def finding(self, relpath: str, node: ast.AST, message: str,
                lines: Sequence[str],
                severity: Optional[str] = None) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0) + 1
        snippet = lines[line - 1].strip() if 0 < line <= len(lines) else ""
        return Finding(rule=self.id, severity=severity or self.severity,
                       path=relpath, line=line, col=col,
                       message=message, snippet=snippet)


class ProjectRule(Rule):
    """Whole-tree rule (sees every parsed file at once; may import the
    package under analysis, e.g. to load the real plugin registries)."""

    def check_file(self, relpath, tree, lines):  # pragma: no cover
        return []

    def check_project(self, root: str,
                      files: dict[str, tuple[ast.AST, list[str]]]
                      ) -> list[Finding]:
        raise NotImplementedError


# -- suppressions -----------------------------------------------------------

_IGNORE_RE = re.compile(
    r"#\s*trtpu:\s*ignore(?P<file>-file)?"
    r"(?:\[(?P<rules>[A-Za-z0-9_,\s]+)\])?")


@dataclass
class Suppressions:
    """`# trtpu: ignore[RULE]` pragmas for one file.

    - on a line: suppresses matching findings reported on that line
      (use the line carrying the flagged expression for multi-line
      statements);
    - `# trtpu: ignore-file[RULE]` anywhere at module level: suppresses
      the rule for the whole file;
    - bare `# trtpu: ignore` (no rule list) suppresses every rule.
    """

    by_line: dict[int, frozenset] = field(default_factory=dict)
    whole_file: frozenset = frozenset()

    ALL = frozenset(["*"])

    @classmethod
    def scan(cls, source: str) -> "Suppressions":
        by_line: dict[int, frozenset] = {}
        whole: set[str] = set()
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(source).readline)
            comments = [(t.start[0], t.string) for t in tokens
                        if t.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # fall back to a line scan; a comment inside a string may
            # produce a stray suppression, which is harmless
            comments = [(i + 1, line) for i, line
                        in enumerate(source.splitlines()) if "#" in line]
        for lineno, text in comments:
            m = _IGNORE_RE.search(text)
            if not m:
                continue
            rules = (frozenset(r.strip().upper() for r in
                               m.group("rules").split(",") if r.strip())
                     if m.group("rules") else cls.ALL)
            if m.group("file"):
                whole |= rules
            else:
                by_line[lineno] = by_line.get(lineno, frozenset()) | rules
        return cls(by_line=by_line, whole_file=frozenset(whole))

    def suppressed(self, finding: Finding) -> bool:
        for rules in (self.whole_file,
                      self.by_line.get(finding.line, frozenset())):
            if "*" in rules or finding.rule.upper() in rules:
                return True
        return False


# -- engine -----------------------------------------------------------------

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules"}


def iter_python_files(paths: Sequence[str], root: str) -> list[str]:
    """Expand files/dirs into a sorted list of repo-relative .py paths."""
    out: set[str] = set()
    for p in paths:
        abs_p = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(abs_p) and abs_p.endswith(".py"):
            out.add(os.path.relpath(abs_p, root))
            continue
        for dirpath, dirnames, filenames in os.walk(abs_p):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for fn in filenames:
                if fn.endswith(".py"):
                    out.add(os.path.relpath(
                        os.path.join(dirpath, fn), root))
    return sorted(p.replace(os.sep, "/") for p in out)


@dataclass
class CheckResult:
    findings: list[Finding]
    parse_errors: list[Finding]
    files_checked: int

    @property
    def all(self) -> list[Finding]:
        return self.parse_errors + self.findings


def run_rules(paths: Sequence[str], rules: Sequence[Rule],
              root: str = ".") -> CheckResult:
    """Parse every file once, run each applicable rule, apply pragmas."""
    root = os.path.abspath(root)
    relpaths = iter_python_files(paths, root)
    findings: list[Finding] = []
    parse_errors: list[Finding] = []
    parsed: dict[str, tuple[ast.AST, list[str]]] = {}
    supps: dict[str, Suppressions] = {}
    for rel in relpaths:
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=rel)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            parse_errors.append(Finding(
                rule="PARSE", severity="error", path=rel,
                line=getattr(e, "lineno", None) or 1, col=1,
                message=f"cannot analyze: {e}"))
            continue
        parsed[rel] = (tree, source.splitlines())
        supps[rel] = Suppressions.scan(source)

    file_rules = [r for r in rules if not isinstance(r, ProjectRule)]
    project_rules = [r for r in rules if isinstance(r, ProjectRule)]
    for rel, (tree, lines) in parsed.items():
        for rule in file_rules:
            if rule.applies_to(rel):
                findings.extend(rule.check_file(rel, tree, lines))
    for rule in project_rules:
        findings.extend(rule.check_project(root, parsed))
    findings = [f for f in findings
                if not supps.get(f.path, Suppressions()).suppressed(f)]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return CheckResult(findings=findings, parse_errors=parse_errors,
                       files_checked=len(parsed))


def format_human(result: CheckResult, new: Iterable[Finding],
                 baselined_count: int) -> str:
    new = list(new)
    out = [f.format() for f in result.parse_errors]
    out += [f.format() for f in new]
    errors = sum(1 for f in new if f.severity == "error")
    out.append(
        f"checked {result.files_checked} files: "
        f"{len(new)} new finding(s) ({errors} error(s)), "
        f"{baselined_count} baselined")
    return "\n".join(out)
