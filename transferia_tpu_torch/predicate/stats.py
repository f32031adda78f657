"""Zone-map pruning: disprove a predicate from column min/max statistics
(the port's copy of ``transferia_tpu/predicate/stats.py``).

Parquet row groups (and ORC stripes, CH parts...) carry per-column
min/max.  range_disproves(node, ranges) answers: "can NO row in this
range set satisfy the predicate?" — when True the scan skips the whole
group before decoding a byte.  Conservative by construction: anything
not provably empty returns False (scan normally).  SQL 3VL makes NULL
rows unsatisfiable for every comparison, so null counts never block
pruning (only IS NULL benefits from one).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional

from transferia_tpu_torch.predicate.ast import (
    And,
    Between,
    Cmp,
    InList,
    IsNull,
    Node,
    Not,
    Or,
    TrueNode,
)


@dataclass(frozen=True)
class ColumnRange:
    min: Any = None          # None = unknown bound
    max: Any = None
    null_count: Optional[int] = None  # None = unknown


def _comparable(a, b) -> bool:
    try:
        a < b  # noqa: B015 — probing comparability only
        return True
    except TypeError:
        return False


def _cmp_disproved(rng: ColumnRange, op: str, v) -> bool:
    mn, mx = rng.min, rng.max
    if op == "=":
        return ((mn is not None and _comparable(v, mn) and v < mn)
                or (mx is not None and _comparable(v, mx) and v > mx))
    if op == "<":
        return mn is not None and _comparable(mn, v) and not (mn < v)
    if op == "<=":
        return mn is not None and _comparable(mn, v) and mn > v
    if op == ">":
        return mx is not None and _comparable(mx, v) and not (mx > v)
    if op == ">=":
        return mx is not None and _comparable(mx, v) and mx < v
    # != and LIKE: a range almost never disproves them
    return False


def range_disproves(node: Node,
                    ranges: Mapping[str, ColumnRange]) -> bool:
    """True iff the predicate is definitely false for EVERY row whose
    column values lie within `ranges` (missing columns = unknown)."""
    if isinstance(node, TrueNode):
        return False
    if isinstance(node, Cmp):
        rng = ranges.get(node.column)
        if rng is None or node.value is None:
            return False
        return _cmp_disproved(rng, node.op, node.value)
    if isinstance(node, Between):
        rng = ranges.get(node.column)
        if rng is None or node.low is None or node.high is None:
            return False
        return (_cmp_disproved(rng, ">=", node.low)
                or _cmp_disproved(rng, "<=", node.high))
    if isinstance(node, InList):
        if node.negate:
            return False
        rng = ranges.get(node.column)
        if rng is None:
            return False
        return all(
            v is None or _cmp_disproved(rng, "=", v)
            for v in node.values
        ) and any(v is not None for v in node.values)
    if isinstance(node, IsNull):
        rng = ranges.get(node.column)
        if rng is None or rng.null_count is None:
            return False
        return rng.null_count == 0 if not node.negate else False
    if isinstance(node, And):
        return any(range_disproves(p, ranges) for p in node.parts)
    if isinstance(node, Or):
        return (bool(node.parts)
                and all(range_disproves(p, ranges) for p in node.parts))
    if isinstance(node, Not):
        # disproving NOT(p) needs "p is true for every row" — a
        # different (stronger) proof; stay conservative
        return False
    return False
