"""Canonical type lattice and table schemas.

The PyTorch port's own copy of ``transferia_tpu/abstract/schema.py`` (the
port imports nothing of the JAX package).  Every canonical type carries a
fixed-width numpy dtype; variable-length types (STRING/UTF8/ANY/DECIMAL)
are a flat byte buffer plus int32 offsets.  The schema fingerprint
(`TableSchema.fingerprint`) keys the per-table transformer plan cache,
mirroring the reference's schema-hash keyed plan cache
(pkg/transformer/transformation.go:47-60).
"""

from __future__ import annotations

import enum
import hashlib
import json
from dataclasses import dataclass, replace
from typing import Iterable, Optional

import numpy as np


class CanonicalType(str, enum.Enum):
    """Canonical (provider-independent) column types.

    Mirrors the reference's canonical lattice (typesystem/schema.go:48-68).
    """

    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    FLOAT = "float"      # float32
    DOUBLE = "double"    # float64
    BOOLEAN = "boolean"
    STRING = "string"    # arbitrary bytes
    UTF8 = "utf8"        # validated text
    DATE = "date"        # days since epoch (int32)
    DATETIME = "datetime"    # seconds since epoch (int64)
    TIMESTAMP = "timestamp"  # microseconds since epoch (int64)
    INTERVAL = "interval"    # microseconds (int64)
    DECIMAL = "decimal"      # exact numeric; utf8 on the wire by default
    ANY = "any"          # JSON-ish variant

    @property
    def is_integer(self) -> bool:
        return self in _INTS

    @property
    def is_float(self) -> bool:
        return self in (CanonicalType.FLOAT, CanonicalType.DOUBLE)

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_float

    @property
    def is_variable_width(self) -> bool:
        """True for types stored as bytes+offsets on device."""
        return self in (
            CanonicalType.STRING,
            CanonicalType.UTF8,
            CanonicalType.ANY,
            CanonicalType.DECIMAL,
        )

    @property
    def np_dtype(self) -> np.dtype:
        """Fixed-width numpy dtype of the device representation."""
        return _NP_DTYPES[self]


_INTS = frozenset(
    {
        CanonicalType.INT8,
        CanonicalType.INT16,
        CanonicalType.INT32,
        CanonicalType.INT64,
        CanonicalType.UINT8,
        CanonicalType.UINT16,
        CanonicalType.UINT32,
        CanonicalType.UINT64,
    }
)

_NP_DTYPES = {
    CanonicalType.INT8: np.dtype(np.int8),
    CanonicalType.INT16: np.dtype(np.int16),
    CanonicalType.INT32: np.dtype(np.int32),
    CanonicalType.INT64: np.dtype(np.int64),
    CanonicalType.UINT8: np.dtype(np.uint8),
    CanonicalType.UINT16: np.dtype(np.uint16),
    CanonicalType.UINT32: np.dtype(np.uint32),
    CanonicalType.UINT64: np.dtype(np.uint64),
    CanonicalType.FLOAT: np.dtype(np.float32),
    CanonicalType.DOUBLE: np.dtype(np.float64),
    CanonicalType.BOOLEAN: np.dtype(np.bool_),
    CanonicalType.DATE: np.dtype(np.int32),
    CanonicalType.DATETIME: np.dtype(np.int64),
    CanonicalType.TIMESTAMP: np.dtype(np.int64),
    CanonicalType.INTERVAL: np.dtype(np.int64),
    # Variable-width: dtype of the *byte buffer*
    CanonicalType.STRING: np.dtype(np.uint8),
    CanonicalType.UTF8: np.dtype(np.uint8),
    CanonicalType.ANY: np.dtype(np.uint8),
    CanonicalType.DECIMAL: np.dtype(np.uint8),
}


@dataclass(frozen=True, order=True)
class TableID:
    """Qualified table identity (changeitem TableID: namespace + name)."""

    namespace: str
    name: str

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return f"{self.namespace}.{self.name}" if self.namespace else self.name

    @staticmethod
    def parse(s: str) -> "TableID":
        if "." in s:
            ns, name = s.split(".", 1)
            return TableID(ns, name)
        return TableID("", s)

    def fqtn(self) -> str:
        return f'"{self.namespace}"."{self.name}"' if self.namespace else f'"{self.name}"'

    def include_matches(self, pattern: "TableID") -> bool:
        """Wildcard match: pattern parts of '*' or '' match anything."""
        ns_ok = pattern.namespace in ("", "*") or pattern.namespace == self.namespace
        name_ok = pattern.name in ("", "*") or pattern.name == self.name
        return ns_ok and name_ok


@dataclass(frozen=True)
class ColSchema:
    """Column schema (changeitem/col_schema.go).

    `original_type` preserves the provider-native type string (e.g.
    ``pg:bigint``, ``ch:DateTime64(3)``) for target-side DDL fidelity and for
    the versioned fallback machinery.
    """

    name: str
    data_type: CanonicalType
    primary_key: bool = False
    required: bool = False
    original_type: str = ""
    expression: str = ""
    path: str = ""  # nested-source path (parsers)
    properties: tuple = ()

    def with_type(self, t: CanonicalType) -> "ColSchema":
        return replace(self, data_type=t)


class TableSchema:
    """Ordered column collection with a fast name index and a fingerprint.

    Reference: changeitem/table_schema.go.  Immutable by convention; all
    mutators return new TableSchema instances so the fingerprint can be
    safely used as a plan cache key.
    """

    __slots__ = ("columns", "_index", "_fingerprint")

    def __init__(self, columns: Iterable[ColSchema]):
        self.columns: tuple[ColSchema, ...] = tuple(columns)
        self._index = {c.name: i for i, c in enumerate(self.columns)}
        self._fingerprint: Optional[str] = None

    def __iter__(self):
        return iter(self.columns)

    def __len__(self) -> int:
        return len(self.columns)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, TableSchema) and self.columns == other.columns

    def __hash__(self) -> int:
        return hash(self.columns)

    def __repr__(self) -> str:  # pragma: no cover
        return f"TableSchema({[c.name for c in self.columns]})"

    def names(self) -> list[str]:
        return [c.name for c in self.columns]

    def find(self, name: str) -> Optional[ColSchema]:
        i = self._index.get(name)
        return self.columns[i] if i is not None else None

    def key_columns(self) -> list[ColSchema]:
        return [c for c in self.columns if c.primary_key]

    def has_primary_key(self) -> bool:
        return any(c.primary_key for c in self.columns)

    def fingerprint(self) -> str:
        """Stable hash of the full schema — plan/compile cache key.

        Mirrors the reference's schema hash used to invalidate transformer
        plans (pkg/transformer/transformation.go:47-60).
        """
        if self._fingerprint is None:
            payload = json.dumps(
                [
                    (c.name, c.data_type.value, c.primary_key, c.required,
                     c.original_type, c.expression, c.path, list(c.properties))
                    for c in self.columns
                ],
                separators=(",", ":"),
                default=str,
            ).encode()
            self._fingerprint = hashlib.sha256(payload).hexdigest()[:16]
        return self._fingerprint

    def rename(self, mapping: dict[str, str]) -> "TableSchema":
        """Columns renamed by `mapping` (old -> new); the JAX package's
        `TableSchema.rename` (abstract/schema.py:241)."""
        return TableSchema(
            replace(c, name=mapping.get(c.name, c.name)) for c in self.columns
        )

    def append(self, *cols: ColSchema) -> "TableSchema":
        return TableSchema(self.columns + tuple(cols))

    def with_types(self, mapping: dict[str, CanonicalType]) -> "TableSchema":
        return TableSchema(
            c.with_type(mapping[c.name]) if c.name in mapping else c
            for c in self.columns
        )

    def to_json(self) -> list[dict]:
        """The column list as JSON objects (the native queue serializer's
        `table_schema`)."""
        return [
            {
                "name": c.name,
                "type": c.data_type.value,
                "key": c.primary_key,
                "required": c.required,
                "original_type": c.original_type,
                "expression": c.expression,
                "path": c.path,
            }
            for c in self.columns
        ]


def new_table_schema(cols: list[tuple], **kw) -> TableSchema:
    """Convenience constructor: list of (name, type[, primary_key]) tuples."""
    out = []
    for spec in cols:
        name, ctype = spec[0], spec[1]
        pk = bool(spec[2]) if len(spec) > 2 else False
        if isinstance(ctype, str):
            ctype = CanonicalType(ctype)
        out.append(ColSchema(name=name, data_type=ctype, primary_key=pk, **kw))
    return TableSchema(out)
