"""A YAML reader for transfer.yaml, without PyYAML.

The reference reads transfer.yaml with `yaml.safe_load`; the port may
not count on PyYAML (the card's machine has none), so it keeps its own
reader of the subset a transfer.yaml uses:

- block mappings and block sequences (a sequence may sit at its key's
  indentation, and `- key: value` opens a mapping in an item);
- flow mappings `{...}` and flow sequences `[...]` on one line;
- plain, single-quoted and double-quoted scalars on one line;
- comments, blank lines and one leading `---`.

Plain scalars resolve as `yaml.safe_load` resolves them (YAML 1.1's
rules, copied from PyYAML's resolver and constructors): ints (decimal,
`0b`, `0x`, a leading `0` for octal, `_` separators, sexagesimal
`1:30`), floats (`1.5`, `.5`, `1.0e+3`, `.inf`, `.nan`), booleans
(`true`/`false`, `yes`/`no`, `on`/`off`, in three casings) and null
(`~`, `null`, an empty value).  Quoted scalars stay strings.

Everything else raises `ConfigError` naming the line: anchors, aliases,
tags, block scalars (`|`, `>`), scalars or flow collections over
several lines, complex and merge keys, dates and timestamps, several
documents, directives.
"""

from __future__ import annotations

import re
from typing import Any


class ConfigError(ValueError):
    """A transfer config the port cannot read or accept."""


# -- scalar resolution (PyYAML's Resolver / SafeConstructor) ----------------

_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_MERGE = re.compile(r"^(?:<<)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_VALUE = re.compile(r"^(?:=)$")

# (tag, regex, first characters), in PyYAML's registration order
_RESOLVERS = (
    ("bool", _BOOL, "yYnNtTfFoO"),
    ("float", _FLOAT, "-+0123456789."),
    ("int", _INT, "-+0123456789"),
    ("merge", _MERGE, "<"),
    ("null", _NULL, "~nN"),
    ("timestamp", _TIMESTAMP, "0123456789"),
    ("value", _VALUE, "="),
)

_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}


def _sexagesimal(value: str, conv) -> Any:
    digits = [conv(part) for part in value.split(":")]
    digits.reverse()
    base, out = 1, 0
    for d in digits:
        out += d * base
        base *= 60
    return out


def _construct_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(text: str, lineno: int = 0) -> Any:
    """A plain scalar's value, as `yaml.safe_load` constructs it."""
    first = text[:1]
    for tag, regex, firsts in _RESOLVERS:
        if text and first not in firsts:
            continue
        if tag == "null" and text == "":
            return None
        if not text or not regex.match(text):
            continue
        try:
            if tag == "bool":
                return _BOOL_VALUES[text.lower()]
            if tag == "float":
                return _construct_float(text)
            if tag == "int":
                return _construct_int(text)
        except ValueError as e:
            raise ConfigError(f"line {lineno}: bad number {text!r}: {e}") \
                from e
        if tag == "null":
            return None
        raise ConfigError(
            f"line {lineno}: {text!r} resolves to a YAML {tag}, which "
            f"the port's transfer.yaml reader does not support")
    return text


# -- the parser ---------------------------------------------------------------

_SPACE = " \t"
_FLOW_IND = ",[]{}"
_NOT_PLAIN_START = "-?:,[]{}#&*!|>'\"%@`"
_DQ_ESCAPES = {
    "0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
    "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
    "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
    "P": "\u2029",
}
_DQ_HEX = {"x": 2, "u": 4, "U": 8}


class _Line:
    """One content line: its number, indentation and text (without the
    indentation), read through a cursor."""

    __slots__ = ("no", "indent", "text", "pos")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text, self.pos = no, indent, text, 0

    def error(self, what: str) -> ConfigError:
        return ConfigError(f"line {self.no}: {what}")

    def peek(self, k: int = 0) -> str:
        i = self.pos + k
        return self.text[i] if i < len(self.text) else ""

    def skip_space(self) -> None:
        while self.peek() and self.peek() in _SPACE:
            self.pos += 1

    def at_end(self) -> bool:
        """True at the end of the line or at a comment (after spaces)."""
        self.skip_space()
        return not self.peek() or self.peek() == "#"

    def expect_end(self) -> None:
        if not self.at_end():
            raise self.error(f"unexpected {self.text[self.pos:]!r}")

    # -- scalars ------------------------------------------------------------
    def single_quoted(self) -> str:
        self.pos += 1
        out = []
        while True:
            ch = self.peek()
            if not ch:
                raise self.error("a quoted scalar must end on its line")
            if ch == "'":
                if self.peek(1) == "'":
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            out.append(ch)
            self.pos += 1

    def double_quoted(self) -> str:
        self.pos += 1
        out = []
        while True:
            ch = self.peek()
            if not ch:
                raise self.error("a quoted scalar must end on its line")
            if ch == '"':
                self.pos += 1
                return "".join(out)
            if ch == "\\":
                esc = self.peek(1)
                if esc in _DQ_ESCAPES:
                    out.append(_DQ_ESCAPES[esc])
                    self.pos += 2
                    continue
                if esc in _DQ_HEX:
                    n = _DQ_HEX[esc]
                    digits = self.text[self.pos + 2:self.pos + 2 + n]
                    if len(digits) != n or not all(
                            c in "0123456789abcdefABCDEF" for c in digits):
                        raise self.error(f"bad escape \\{esc}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.pos += 2 + n
                    continue
                raise self.error(
                    f"unsupported escape \\{esc or '(line end)'}")
            out.append(ch)
            self.pos += 1

    def plain(self, flow: bool) -> str:
        """A plain scalar from the cursor: up to a comment, the line's
        end, a `: ` and, in a flow collection, a flow indicator."""
        ch, nxt = self.peek(), self.peek(1)
        stop_after_colon = _SPACE + (_FLOW_IND if flow else "")
        starters = "-" if flow else "-?:"
        if not ch or (ch in _NOT_PLAIN_START and not (
                ch in starters and nxt and nxt not in stop_after_colon)):
            raise self.error(
                f"{self.text[self.pos:]!r} is outside the port's YAML "
                f"subset (anchors, aliases, tags, block scalars and "
                f"complex keys are not read)")
        start = self.pos
        end = self.pos
        while True:
            ch = self.peek()
            if not ch:
                break
            if ch in _SPACE:
                if self.peek(1) == "#":
                    break
                self.pos += 1
                continue
            if ch == ":" and (not self.peek(1)
                              or self.peek(1) in stop_after_colon):
                break
            if flow and ch in _FLOW_IND:
                break
            if flow and ch == "?":
                raise self.error("'?' in a flow scalar is outside the "
                                 "port's YAML subset")
            self.pos += 1
            end = self.pos
        self.pos = end
        return self.text[start:end]

    def scalar(self, flow: bool) -> tuple[Any, bool]:
        """(value, quoted) of the scalar at the cursor."""
        ch = self.peek()
        if ch == "'":
            return self.single_quoted(), True
        if ch == '"':
            return self.double_quoted(), True
        return resolve_plain(self.plain(flow), self.no), False

    # -- flow collections ---------------------------------------------------
    def flow_node(self) -> Any:
        self.skip_space()
        ch = self.peek()
        if ch == "[":
            return self.flow_seq()
        if ch == "{":
            return self.flow_map()
        if not ch:
            raise self.error("a flow collection must end on its line")
        value, _ = self.scalar(flow=True)
        return value

    def _flow_items(self, close: str, item) -> None:
        self.pos += 1
        while True:
            self.skip_space()
            ch = self.peek()
            if not ch or ch == "#":
                raise self.error("a flow collection must end on its line")
            if ch == close:
                self.pos += 1
                return
            item()
            self.skip_space()
            ch = self.peek()
            if ch == ",":
                self.pos += 1
            elif ch != close:
                raise self.error(
                    f"expected ',' or {close!r} in a flow collection, "
                    f"got {self.text[self.pos:]!r}")

    def flow_seq(self) -> list:
        out: list = []

        def item():
            start = self.pos
            value = self.flow_node()
            self.skip_space()
            if self.peek() == ":":
                self.pos = start
                raise self.error("a single-pair mapping in a flow "
                                  "sequence is outside the port's YAML "
                                  "subset")
            out.append(value)

        self._flow_items("]", item)
        return out

    def flow_map(self) -> dict:
        out: dict = {}

        def item():
            ch = self.peek()
            if ch in "[{":
                raise self.error("a collection as a key is outside the "
                                 "port's YAML subset")
            key, _ = self.scalar(flow=True)
            self.skip_space()
            if self.peek() == ":":
                self.pos += 1
                self.skip_space()
                if self.peek() in (",", "}"):
                    out[key] = None
                else:
                    out[key] = self.flow_node()
            else:
                out[key] = None

        self._flow_items("}", item)
        return out

    # -- a value after `key:` or `- ` -----------------------------------------
    def inline_value(self) -> Any:
        """The value from the cursor to the line's end."""
        self.skip_space()
        ch = self.peek()
        if ch in "[{":
            value = self.flow_seq() if ch == "[" else self.flow_map()
        else:
            value, quoted = self.scalar(flow=False)
            self.skip_space()
            if not quoted and self.peek() == ":":
                raise self.error("a mapping value is not allowed here "
                                 "(a plain scalar holds ': ')")
        self.expect_end()
        return value


def _split_key(line: _Line):
    """(key, found) for a block-mapping line: the key and the cursor just
    after its ':'; found=False (cursor back at the start) when the line
    holds no mapping key."""
    line.pos = 0
    ch = line.peek()
    if ch in ("'", '"'):
        key = line.single_quoted() if ch == "'" else line.double_quoted()
        line.skip_space()
        if line.peek() == ":" and (not line.peek(1)
                                   or line.peek(1) in _SPACE):
            line.pos += 1
            return key, True
        line.pos = 0
        return None, False
    if ch in "[{" or not ch:
        return None, False
    if ch == "?" and (not line.peek(1) or line.peek(1) in _SPACE):
        raise line.error("complex keys ('? ') are outside the port's YAML "
                         "subset")
    text = line.plain(flow=False)
    if line.peek() == ":":
        line.pos += 1
        return resolve_plain(text, line.no), True
    line.pos = 0
    return None, False


def _is_seq_item(line: _Line) -> bool:
    return line.text == "-" or line.text.startswith(("- ", "-\t"))


class _Parser:
    def __init__(self, text: str):
        self.lines: list[_Line] = []
        seen_content = False
        for no, raw in enumerate(text.splitlines(), start=1):
            stripped = raw.lstrip(" ")
            if not stripped.strip() or stripped.startswith("#"):
                continue
            indent = len(raw) - len(stripped)
            if stripped[0] == "\t":
                raise ConfigError(f"line {no}: a tab in the indentation")
            body = stripped.rstrip()
            if indent == 0 and (body == "---" or body.startswith("--- ")
                                or body.startswith("---\t")):
                if seen_content or body != "---":
                    raise ConfigError(
                        f"line {no}: several documents, or content on the "
                        f"'---' line, are outside the port's YAML subset")
                seen_content = True
                continue
            if indent == 0 and (body == "..." or body.startswith("%")):
                raise ConfigError(
                    f"line {no}: document markers and directives are "
                    f"outside the port's YAML subset")
            seen_content = True
            self.lines.append(_Line(no, indent, body))
        self.i = 0

    def cur(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def document(self) -> Any:
        line = self.cur()
        if line is None:
            return None
        value = self.node(line.indent)
        extra = self.cur()
        if extra is not None:
            raise extra.error("unexpected content after the document's "
                              "top-level node (check the indentation)")
        return value

    def node(self, indent: int) -> Any:
        """The block node whose first line is the current one, at
        `indent`."""
        line = self.cur()
        if _is_seq_item(line):
            return self.sequence(indent)
        _, found = _split_key(line)
        if found:
            return self.mapping(indent)
        line.pos = 0
        self.i += 1
        value = line.inline_value()
        nxt = self.cur()
        if nxt is not None and nxt.indent > indent:
            raise nxt.error("a scalar over several lines is outside the "
                            "port's YAML subset")
        return value

    def _nested(self, indent: int, allow_indentless: bool) -> Any:
        """The value of a `key:` or `- ` with nothing after it: the
        block below, deeper than `indent` (or, for a key, a sequence at
        `indent`); null when there is none."""
        nxt = self.cur()
        if nxt is None:
            return None
        if nxt.indent > indent:
            return self.node(nxt.indent)
        if allow_indentless and nxt.indent == indent and _is_seq_item(nxt):
            return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.cur()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise line.error("unexpected indentation (a scalar over "
                                 "several lines is outside the port's "
                                 "YAML subset)")
            if _is_seq_item(line):
                raise line.error("a sequence item where a mapping key was "
                                 "expected")
            key, found = _split_key(line)
            if not found:
                raise line.error(f"expected 'key: value', got "
                                 f"{line.text!r}")
            try:
                hash(key)
            except TypeError:
                raise line.error("an unhashable key") from None
            self.i += 1
            if line.at_end():
                out[key] = self._nested(indent, allow_indentless=True)
            else:
                out[key] = line.inline_value()

    def sequence(self, indent: int) -> list:
        out: list = []
        while True:
            line = self.cur()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise line.error("unexpected indentation in a sequence")
            if not _is_seq_item(line):
                return out
            rest = line.text[1:]
            col = len(rest) - len(rest.lstrip(_SPACE))
            rest = rest.lstrip(_SPACE)
            if not rest or rest.startswith("#"):
                self.i += 1
                out.append(self._nested(indent, allow_indentless=False))
                continue
            # the item's content is a node of its own, one column past
            # the dash and its spaces
            self.lines[self.i] = _Line(line.no, indent + 1 + col, rest)
            out.append(self.node(indent + 1 + col))


def load(text: str) -> Any:
    """`yaml.safe_load` for the subset a transfer.yaml uses; anything
    outside it raises ConfigError naming the line."""
    return _Parser(text).document()
