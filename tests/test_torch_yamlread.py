"""The port's transfer.yaml reader (`transferia_tpu_torch/cli/yamlread.py`)
against `yaml.safe_load`, which the JAX package's CLI reads with.

Held equal: every `examples/*.yaml`, the scalars of YAML 1.1's implicit
resolvers one by one (ints in every base, floats, booleans, null, quoted
look-alikes), and documents hypothesis generates within the subset:
nested block mappings and sequences (sequences at their key's
indentation too, `- key: value` items), flow collections, plain and
quoted scalars and comments.  Input outside the subset raises
ConfigError naming its line.
"""

import math
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from transferia_tpu_torch.cli.yamlread import ConfigError, load

EXAMPLES = sorted(Path(__file__).resolve().parents[1].glob("examples/*.yaml"))


def norm(v):
    """NaN compares unequal to itself: map it to a marker."""
    if isinstance(v, float) and math.isnan(v):
        return "<nan>"
    if isinstance(v, dict):
        return {norm(k): norm(x) for k, x in v.items()}
    if isinstance(v, list):
        return [norm(x) for x in v]
    return v


def same(text: str) -> None:
    got, want = load(text), yaml.safe_load(text)
    assert norm(got) == norm(want), text
    assert type(got) is type(want)


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_examples_equal_safe_load(path):
    same(path.read_text())


SCALARS = [
    "0", "7", "-12", "+3", "017", "-0o17", "0b1011", "0x1F", "-0x_ff",
    "1_000", "1:30", "-2:03:04", "1.5", "-.5", ".5", "1.", "1.0e+3",
    "1e3", "6.02E-23", "1:30.5", ".inf", "-.Inf", "+.INF", ".nan", ".NaN",
    "true", "True", "TRUE", "false", "yes", "No", "ON", "off", "y", "n",
    "~", "null", "Null", "NULL", "nul", "", "abc", "a b  c", "a#b",
    "http://x:80/y", "-x", "?x", ":x", "0x", "0b", "08", "1_", "1__0",
    "'yes'", '"017"', "'a''b'", '"\\t\\u00e9\\x41\\""', '"# not a comment"',
    "'#'", "$5", "x: y".replace(": ", ":"),
]


@pytest.mark.parametrize("scalar", SCALARS)
def test_scalars_resolve_as_safe_load(scalar):
    same(f"k: {scalar}\n")
    same(f"- {scalar}\n")
    if scalar and scalar[0] not in "'\"?:":
        same(f"[{scalar}]\n")


@pytest.mark.parametrize("text", [
    "a: 1\nb:\n  c: [1, 2, {d: e}]\n  f:\n  - x\n  - y: 1\n    z: 2\n",
    "- - 1\n  - 2\n- {a: 1}\n-\n  b: 2\n-\n- ''\n",
    "# head\n---\na: 1   # tail\n\n# gap\nb: 'x'\n",
    "k:\n- 1\n- 2\nz: ~\n",
    "a: {x, y: , z: [ ]}\nb: {}\nc: []\n",
    "'q k': 1\n\"d k\": 2\nplain key: 3\n1: one\ntrue: t\n",
    "a: b\na: c\n",
    "",
    "# only a comment\n",
    "scalar document",
    "[1, 2]\n",
])
def test_documents_equal_safe_load(text):
    same(text)


@pytest.mark.parametrize("text,line", [
    ("a: &x 1\n", 1), ("a: *x\n", 1), ("a: !!str 1\n", 1),
    ("a: |\n  text\n", 1), ("a: >\n  text\n", 1),
    ("a: 1\nb: c: d\n", 2), ("a: [1,\n  2]\n", 1), ("a: {b: 1\n", 1),
    ("a: 2001-12-14\n", 1), ("<<: {a: 1}\n", 1), ("a: 'open\n  on'\n", 1),
    ("a: b\n  c\n", 2), ("a: 1\n---\nb: 2\n", 2), ("? a\n: b\n", 1),
    ("%YAML 1.1\n---\na: 1\n", 1), ("a: 1\n...\n", 2), ("a:\n\t- 1\n", 2),
    ("a: [b: c]\n", 1), ("a: =\n", 1), ('a: "\\q"\n', 1),
    ("a: @x\n", 1), ("a: `x`\n", 1), ("- a\nb: 1\n", 2),
])
def test_outside_the_subset_raises_naming_the_line(text, line):
    with pytest.raises(ConfigError, match=f"line {line}:"):
        load(text)


# -- hypothesis: documents within the subset ----------------------------------

PLAIN = st.sampled_from([
    "a", "abc", "user_email", "x-y", "v1.2", "s3://b/k", "a b", "it's",
    "100%", "a#b", "-x", "0", "12", "-3", "017", "0x1F", "1_000", "1:30",
    "1.5", ".5", "1e3", "1.0e+3", ".inf", "-.inf", ".nan", "yes", "No",
    "on", "OFF", "true", "False", "~", "null", "NULL", "y"])
QUOTED_TEXT = st.text(alphabet=st.characters(
    min_codepoint=32, max_codepoint=0x2FF, blacklist_categories=("Cc",)),
    max_size=12)
KEYS = st.sampled_from(["id", "type", "src", "params", "host", "port",
                        "a", "b", "key one", "x_y", "1", "yes", "null"])


def dq(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def sq(s: str) -> str:
    return "'" + s.replace("'", "''") + "'"


@st.composite
def scalar_text(draw, flow: bool):
    kind = draw(st.sampled_from(["plain", "single", "double"]))
    if kind == "plain":
        s = draw(PLAIN)
        if flow and any(c in s for c in ",[]{}#?") or (flow and " " in s):
            return sq(s)
        return s
    s = draw(QUOTED_TEXT)
    return sq(s) if kind == "single" else dq(s)


@st.composite
def flow_node(draw, depth: int = 0):
    if depth < 2 and draw(st.booleans()):
        if draw(st.booleans()):
            items = draw(st.lists(flow_node(depth + 1), max_size=3))
            return "[" + ", ".join(items) + "]"
        keys = draw(st.lists(KEYS, max_size=3, unique=True))
        pairs = [f"{k if ' ' not in k else sq(k)}: "
                 f"{draw(flow_node(depth + 1))}" for k in keys]
        return "{" + ", ".join(pairs) + "}"
    return draw(scalar_text(flow=True))


def comment(draw) -> str:
    return draw(st.sampled_from(["", "", "  # note", " # x: [y]"]))


@st.composite
def block_mapping(draw, indent: int = 0, depth: int = 0):
    keys = draw(st.lists(KEYS, min_size=1, max_size=4, unique=True))
    lines = []
    pad = " " * indent
    for k in keys:
        key = sq(k) if " " in k and draw(st.booleans()) else k
        choice = draw(st.sampled_from(
            ["scalar", "flow", "map", "seq", "seq_same", "empty"]
            if depth < 3 else ["scalar", "flow", "empty"]))
        if choice == "scalar":
            lines.append(f"{pad}{key}: {draw(scalar_text(flow=False))}"
                         f"{comment(draw)}")
        elif choice == "flow":
            lines.append(f"{pad}{key}: {draw(flow_node())}{comment(draw)}")
        elif choice == "empty":
            lines.append(f"{pad}{key}:{comment(draw)}")
        elif choice == "map":
            lines.append(f"{pad}{key}:")
            lines += draw(block_mapping(indent + 2, depth + 1))
        else:
            lines.append(f"{pad}{key}:")
            lines += draw(block_sequence(
                indent if choice == "seq_same" else indent + 2, depth + 1))
        if draw(st.integers(0, 5)) == 0:
            lines.append(f"{pad}# between")
    return lines


@st.composite
def block_sequence(draw, indent: int = 0, depth: int = 0):
    n = draw(st.integers(1, 3))
    lines = []
    pad = " " * indent
    for _ in range(n):
        choice = draw(st.sampled_from(
            ["scalar", "flow", "map", "nested"] if depth < 3
            else ["scalar", "flow"]))
        if choice == "scalar":
            lines.append(f"{pad}- {draw(scalar_text(flow=False))}"
                         f"{comment(draw)}")
        elif choice == "flow":
            lines.append(f"{pad}- {draw(flow_node())}")
        elif choice == "map":
            sub = draw(block_mapping(indent + 2, depth + 1))
            lines.append(f"{pad}- {sub[0].lstrip()}")
            lines += sub[1:]
        else:
            lines.append(f"{pad}-")
            lines += draw(block_sequence(indent + 2, depth + 1))
    return lines


@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.one_of(block_mapping(), block_sequence()))
def test_generated_documents_equal_safe_load(lines):
    same("\n".join(lines) + "\n")
