"""Parquet file metadata without pyarrow: the footer (`FileMetaData`,
thrift compact protocol) parsed in Python.

The JAX package takes a file's footer, row-group layout, statistics and
schema from pyarrow (`pq.ParquetFile`, `pq.read_schema` with
`arrow_to_table_schema`).  The port may not import pyarrow, so it reads
the footer itself, in the same protocol `csrc/parquetdec.cpp` reads page
headers in, and maps the Parquet schema to the canonical one as pyarrow
would read it from the Parquet schema alone:

- physical type plus logical (or legacy converted) type: INT(8/16/32/64)
  signed or not on INT32/INT64, STRING/ENUM/JSON, TIMESTAMP with its unit
  and UTC flag, DATE, TIME, DECIMAL;
- timestamps in MILLIS (and seconds written as MILLIS) are DATETIME,
  MICROS and NANOS are TIMESTAMP, as `arrow_to_table_schema` maps them.

The `ARROW:schema` blob pyarrow also stores is not read: a column written
from an arrow `large_string` or dictionary type has the canonical type
the JAX package gives it, but `original_type` names the arrow type of
its Parquet schema (`arrow:string`), not the stored arrow one.  A group
(nested) field maps to ANY with `original_type` ``parquet:group``; the
reader refuses it.

Statistics box min/max into the Python objects pyarrow's
`Statistics.min`/`max` give (int, float, bool, str, bytes, Decimal,
date, time, datetime), so zone-map pruning (predicate/stats.py) proves
exactly what it proves over pyarrow's: a value that Python cannot order
against a literal disproves nothing.  Whether a chunk's statistics are
trusted follows parquet-cpp's `HasCorrectStatistics` (sort order and
the writer's `created_by`).

Footers are memoized per (path, mtime_ns, size) under a lock, as are the
files' read-only memory maps (`shared_memmap`): the loader's part
threads share both.
"""

from __future__ import annotations

import datetime
import decimal
import os
import re
import struct
import threading
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableSchema,
)

# parquet.thrift enums
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FLBA = range(8)
PHYSICAL_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE",
                  "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
REQUIRED, OPTIONAL, REPEATED = range(3)
CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO",
               4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE",
                  4: "BIT_PACKED", 5: "DELTA_BINARY_PACKED",
                  6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
                  8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
UNITS = {1: "ms", 2: "us", 3: "ns"}  # LogicalType TimeUnit union fields

MAGIC = b"PAR1"


# -- thrift compact protocol -------------------------------------------------

_T_TRUE, _T_FALSE, _T_BYTE, _T_I16, _T_I32, _T_I64 = 1, 2, 3, 4, 5, 6
_T_DOUBLE, _T_BINARY, _T_LIST, _T_SET, _T_MAP, _T_STRUCT = 7, 8, 9, 10, 11, 12


class ThriftError(ValueError):
    """A footer that is not valid thrift compact protocol."""


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ThriftError("footer ends inside a value")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def uvarint(self) -> int:
        v = shift = 0
        while True:
            b = self.byte()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 70:
                raise ThriftError("varint too long")

    def zigzag(self) -> int:
        v = self.uvarint()
        return (v >> 1) ^ -(v & 1)

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            raise ThriftError("footer ends inside a value")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return bytes(out)

    def value(self, ttype: int) -> Any:
        if ttype == _T_TRUE:
            return True
        if ttype == _T_FALSE:
            return False
        if ttype == _T_BYTE:
            b = self.byte()
            return b - 256 if b > 127 else b
        if ttype in (_T_I16, _T_I32, _T_I64):
            return self.zigzag()
        if ttype == _T_DOUBLE:
            return struct.unpack("<d", self.take(8))[0]
        if ttype == _T_BINARY:
            return self.take(self.uvarint())
        if ttype in (_T_LIST, _T_SET):
            head = self.byte()
            n, et = head >> 4, head & 0x0F
            if n == 15:
                n = self.uvarint()
            if et in (_T_TRUE, _T_FALSE):  # a list's bools are bytes
                return [self.byte() == 1 for _ in range(n)]
            return [self.value(et) for _ in range(n)]
        if ttype == _T_MAP:
            n = self.uvarint()
            if n == 0:
                return {}
            kv = self.byte()
            return {self.value(kv >> 4): self.value(kv & 0x0F)
                    for _ in range(n)}
        if ttype == _T_STRUCT:
            return self.struct()
        raise ThriftError(f"unknown thrift type {ttype}")

    def struct(self) -> dict[int, Any]:
        """A struct as {field id: value}."""
        out: dict[int, Any] = {}
        fid = 0
        while True:
            head = self.byte()
            if head == 0:
                return out
            ttype, delta = head & 0x0F, head >> 4
            fid = fid + delta if delta else self.zigzag()
            out[fid] = self.value(ttype)


def parse_thrift_struct(buf: bytes) -> dict[int, Any]:
    """A thrift compact struct as {field id: value} (nested structs as
    dicts, lists as lists, binary as bytes)."""
    return _Reader(buf).struct()


# -- logical types -----------------------------------------------------------

@dataclass(frozen=True)
class Logical:
    """A column's logical type, from LogicalType or the converted type."""
    kind: str            # STRING, INT, TIMESTAMP, DATE, TIME, DECIMAL,
    #                      ENUM, JSON, BSON, UUID, FLOAT16, MAP, LIST,
    #                      INTERVAL, NULL, ...
    bits: int = 0        # INT
    signed: bool = True  # INT
    unit: str = ""       # TIMESTAMP, TIME: ms/us/ns
    utc: bool = False    # TIMESTAMP, TIME
    scale: int = 0       # DECIMAL
    precision: int = 0   # DECIMAL


_LOGICAL_FIELDS = {1: "STRING", 2: "MAP", 3: "LIST", 4: "ENUM",
                   5: "DECIMAL", 6: "DATE", 7: "TIME", 8: "TIMESTAMP",
                   10: "INT", 11: "NULL", 12: "JSON", 13: "BSON",
                   14: "UUID", 15: "FLOAT16"}


def _logical_from_thrift(lt: dict) -> Optional[Logical]:
    for fid, kind in _LOGICAL_FIELDS.items():
        if fid not in lt:
            continue
        body = lt[fid]
        if kind == "DECIMAL":
            return Logical(kind, scale=body.get(1, 0),
                           precision=body.get(2, 0))
        if kind in ("TIME", "TIMESTAMP"):
            unit = UNITS.get(next(iter(body.get(2, {1: {}})), 1), "ms")
            return Logical(kind, unit=unit, utc=bool(body.get(1, False)))
        if kind == "INT":
            return Logical(kind, bits=body.get(1, 32),
                           signed=bool(body.get(2, True)))
        return Logical(kind)
    return Logical("UNKNOWN")


# ConvertedType -> the logical type parquet-cpp derives from it
_CONVERTED = {
    0: Logical("STRING"), 1: Logical("MAP"), 2: Logical("MAP"),
    3: Logical("LIST"), 4: Logical("ENUM"), 6: Logical("DATE"),
    7: Logical("TIME", unit="ms", utc=True),
    8: Logical("TIME", unit="us", utc=True),
    9: Logical("TIMESTAMP", unit="ms", utc=True),
    10: Logical("TIMESTAMP", unit="us", utc=True),
    11: Logical("INT", 8, False), 12: Logical("INT", 16, False),
    13: Logical("INT", 32, False), 14: Logical("INT", 64, False),
    15: Logical("INT", 8, True), 16: Logical("INT", 16, True),
    17: Logical("INT", 32, True), 18: Logical("INT", 64, True),
    19: Logical("JSON"), 20: Logical("BSON"), 21: Logical("INTERVAL"),
}


@dataclass(frozen=True)
class Leaf:
    """A primitive column of the schema (what a column chunk holds)."""
    path: str              # path_in_schema, dot-joined
    top: str               # its top-level field
    physical: int
    type_length: int
    logical: Optional[Logical]
    max_def: int
    max_rep: int


@dataclass(frozen=True)
class Field:
    """A top-level schema field."""
    name: str
    nullable: bool
    leaf: Optional[Leaf]   # None for a group (nested) field


def arrow_type_name(leaf: Leaf) -> str:
    """The arrow type pyarrow reads a primitive column as, from its
    Parquet schema alone."""
    p, lg = leaf.physical, leaf.logical
    k = lg.kind if lg is not None else ""
    if k == "DECIMAL":
        width = 128 if lg.precision <= 38 else 256
        return f"decimal{width}({lg.precision}, {lg.scale})"
    if p == BOOLEAN:
        return "bool"
    if p in (INT32, INT64):
        if k == "INT":
            return f"{'' if lg.signed else 'u'}int{lg.bits}"
        if k == "DATE" and p == INT32:
            return "date32[day]"
        if k == "TIMESTAMP" and p == INT64:
            tz = ", tz=UTC" if lg.utc else ""
            return f"timestamp[{lg.unit}{tz}]"
        if k == "TIME":
            return f"time{32 if p == INT32 else 64}[{lg.unit}]"
        return "int32" if p == INT32 else "int64"
    if p == INT96:
        return "timestamp[ns]"
    if p == FLOAT:
        return "float"
    if p == DOUBLE:
        return "double"
    if p == BYTE_ARRAY:
        return "string" if k in ("STRING", "ENUM", "JSON") else "binary"
    if k == "FLOAT16":
        return "halffloat"
    return f"fixed_size_binary[{leaf.type_length}]"


_CANONICAL = {
    "int8": CanonicalType.INT8, "int16": CanonicalType.INT16,
    "int32": CanonicalType.INT32, "int64": CanonicalType.INT64,
    "uint8": CanonicalType.UINT8, "uint16": CanonicalType.UINT16,
    "uint32": CanonicalType.UINT32, "uint64": CanonicalType.UINT64,
    "float": CanonicalType.FLOAT, "double": CanonicalType.DOUBLE,
    "bool": CanonicalType.BOOLEAN, "date32[day]": CanonicalType.DATE,
    "string": CanonicalType.UTF8, "binary": CanonicalType.STRING,
}


def canonical_type(arrow_name: str) -> CanonicalType:
    """`arrow_to_table_schema`'s mapping of one arrow type name."""
    if arrow_name in _CANONICAL:
        return _CANONICAL[arrow_name]
    if arrow_name.startswith("timestamp["):
        unit = arrow_name[10:12]
        return (CanonicalType.TIMESTAMP if unit in ("us", "ns")
                else CanonicalType.DATETIME)
    if arrow_name.startswith("decimal"):
        return CanonicalType.DECIMAL
    return CanonicalType.ANY


# -- statistics --------------------------------------------------------------

SIGNED, UNSIGNED, UNKNOWN = "signed", "unsigned", "unknown"


def sort_order(leaf: Leaf) -> str:
    """parquet-cpp's GetSortOrder."""
    lg = leaf.logical
    if lg is not None and lg.kind != "UNKNOWN":
        if lg.kind in ("STRING", "ENUM", "JSON", "BSON", "UUID"):
            return UNSIGNED
        if lg.kind in ("DECIMAL", "DATE", "TIME", "TIMESTAMP", "FLOAT16"):
            return SIGNED
        if lg.kind == "INT":
            return SIGNED if lg.signed else UNSIGNED
        return UNKNOWN
    if leaf.physical in (BOOLEAN, INT32, INT64, FLOAT, DOUBLE):
        return SIGNED
    if leaf.physical in (BYTE_ARRAY, FLBA):
        return UNSIGNED
    return UNKNOWN


_VERSION_RE = re.compile(
    r"^(.*?)\s+version\s*(?:(\d+)(?:\.(\d+))?(?:\.(\d+))?)?")


def _writer_version(created_by: Optional[str]) -> tuple[str, tuple]:
    if not created_by:
        return "unknown", (0, 0, 0)
    m = _VERSION_RE.match(created_by)
    if m is None:
        return created_by.strip().lower(), (0, 0, 0)
    return (m.group(1).strip().lower(),
            tuple(int(g or 0) for g in m.group(2, 3, 4)))


def stats_trusted(created_by: Optional[str], leaf: Leaf, raw_min, raw_max
                  ) -> bool:
    """parquet-cpp's ApplicationVersion::HasCorrectStatistics."""
    order = sort_order(leaf)
    app, ver = _writer_version(created_by)
    if (app == "parquet-cpp" and ver < (1, 3, 0)) or \
            (app == "parquet-mr" and ver < (1, 10, 0)):
        same = raw_min is not None and raw_min == raw_max
        if order != SIGNED and not same:
            return False
        if leaf.physical not in (BYTE_ARRAY, FLBA):
            return True
    if app == "unknown":
        return True
    if order == UNKNOWN:
        return False
    if app == "parquet-mr" and ver < (1, 8, 0):
        return False  # PARQUET-251
    return True


_EPOCH = datetime.datetime(1970, 1, 1)
_PER_SECOND = {"ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}


def box_stat(leaf: Leaf, raw: bytes) -> Any:
    """A raw min/max as the Python object pyarrow's Statistics gives."""
    p, lg = leaf.physical, leaf.logical
    k = lg.kind if lg is not None else ""
    if p == BOOLEAN:
        v: Any = bool(raw[0])
    elif p == INT32:
        v = struct.unpack("<i", raw[:4])[0]
    elif p == INT64:
        v = struct.unpack("<q", raw[:8])[0]
    elif p == FLOAT:
        v = struct.unpack("<f", raw[:4])[0]
    elif p == DOUBLE:
        v = struct.unpack("<d", raw[:8])[0]
    else:
        v = bytes(raw)
    try:
        if k == "INT" and not lg.signed and isinstance(v, int):
            return v & ((1 << (32 if p == INT32 else 64)) - 1)
        if k == "STRING":
            return v.decode("utf8")
        if k == "DATE":
            return datetime.date(1970, 1, 1) + datetime.timedelta(days=v)
        if k == "TIMESTAMP":
            per = _PER_SECOND[lg.unit]
            secs, frac = divmod(v, per)
            out = _EPOCH + datetime.timedelta(
                seconds=secs, microseconds=frac * 1_000_000 // per)
            return out.replace(tzinfo=datetime.timezone.utc) \
                if lg.utc else out
        if k == "TIME":
            per = _PER_SECOND[lg.unit]
            us = v * 1_000_000 // per
            return (datetime.datetime.min
                    + datetime.timedelta(microseconds=us)).time()
        if k == "DECIMAL":
            unscaled = v if isinstance(v, int) \
                else int.from_bytes(v, "big", signed=True)
            return decimal.Decimal(unscaled).scaleb(-lg.scale)
    except (TypeError, ValueError, OverflowError):
        return v
    return v


@dataclass(frozen=True)
class Statistics:
    """A chunk's statistics, boxed as pyarrow's."""
    min: Any
    max: Any
    has_min_max: bool
    null_count: Optional[int]   # None when the writer left it out


def _statistics(st: dict, leaf: Leaf,
                created_by: Optional[str]) -> Optional[Statistics]:
    if sort_order(leaf) == UNKNOWN:
        return None
    if 5 in st or 6 in st:
        raw_max, raw_min = st.get(5), st.get(6)
    else:
        raw_max, raw_min = st.get(1), st.get(2)
    if not stats_trusted(created_by, leaf, raw_min, raw_max):
        return None
    has = raw_min is not None and raw_max is not None
    return Statistics(
        min=box_stat(leaf, raw_min) if has else None,
        max=box_stat(leaf, raw_max) if has else None,
        has_min_max=has, null_count=st.get(3))


# -- file metadata -----------------------------------------------------------

@dataclass(frozen=True)
class ColumnChunk:
    path_in_schema: str
    physical_type: int
    codec: int
    encodings: tuple[int, ...]
    num_values: int
    total_uncompressed_size: int
    total_compressed_size: int
    data_page_offset: int
    dictionary_page_offset: Optional[int]
    statistics: Optional[Statistics]

    @property
    def compression(self) -> str:
        return CODEC_NAMES.get(self.codec, f"CODEC_{self.codec}")

    @property
    def encoding_names(self) -> tuple[str, ...]:
        return tuple(ENCODING_NAMES.get(e, str(e)) for e in self.encodings)


@dataclass(frozen=True)
class RowGroup:
    num_rows: int
    columns: tuple[ColumnChunk, ...]


@dataclass(frozen=True)
class FileMetaData:
    num_rows: int
    row_groups: tuple[RowGroup, ...]
    fields: tuple[Field, ...]
    leaves: tuple[Leaf, ...]
    created_by: Optional[str]

    @property
    def num_row_groups(self) -> int:
        return len(self.row_groups)

    def table_schema(self) -> TableSchema:
        """The canonical schema, as `arrow_to_table_schema` gives it."""
        cols = []
        for f in self.fields:
            if f.leaf is None:
                ct, orig = CanonicalType.ANY, "parquet:group"
            else:
                name = arrow_type_name(f.leaf)
                ct, orig = canonical_type(name), f"arrow:{name}"
            cols.append(ColSchema(name=f.name, data_type=ct,
                                  required=not f.nullable,
                                  original_type=orig))
        return TableSchema(cols)


def _schema(elements: list[dict]) -> tuple[tuple[Field, ...],
                                           tuple[Leaf, ...]]:
    """Walk the flattened schema tree (depth-first, num_children)."""
    fields: list[Field] = []
    leaves: list[Leaf] = []
    pos = 1

    def walk(path: list[str], top: str, max_def: int, max_rep: int
             ) -> Optional[Leaf]:
        nonlocal pos
        el = elements[pos]
        pos += 1
        rep = el.get(3, REQUIRED)
        d = max_def + (rep != REQUIRED)
        r = max_rep + (rep == REPEATED)
        name = el[4].decode()
        here = path + [name]
        kids = el.get(5, 0)
        if kids:
            for _ in range(kids):
                walk(here, top or name, d, r)
            return None
        logical = None
        if 10 in el:
            logical = _logical_from_thrift(el[10])
        elif 6 in el:
            logical = _CONVERTED.get(el[6])
            if el[6] == 5:
                logical = Logical("DECIMAL", scale=el.get(7, 0),
                                  precision=el.get(8, 0))
        leaf = Leaf(path=".".join(here), top=top or name,
                    physical=el.get(1, -1), type_length=el.get(2, 0),
                    logical=logical, max_def=d, max_rep=r)
        leaves.append(leaf)
        return leaf

    root_children = elements[0].get(5, 0)
    for _ in range(root_children):
        el = elements[pos]
        nullable = el.get(3, REQUIRED) != REQUIRED
        leaf = walk([], "", 0, 0)
        fields.append(Field(el[4].decode(), nullable,
                            leaf if not el.get(5, 0) else None))
    return tuple(fields), tuple(leaves)


def parse_file_metadata(footer: bytes) -> FileMetaData:
    """FileMetaData from the footer's thrift bytes."""
    fm = parse_thrift_struct(footer)
    created_by = fm[6].decode("utf8", "replace") if 6 in fm else None
    fields, leaves = _schema(fm.get(2, []))
    by_path = {leaf.path: leaf for leaf in leaves}
    groups = []
    for rg in fm.get(4, []):
        cols = []
        for cc in rg.get(1, []):
            md = cc.get(3)
            if md is None:
                raise NotImplementedError(
                    "parquet: column chunk without inline metadata "
                    "(an external file_path or encrypted metadata)")
            path = ".".join(p.decode() for p in md[3])
            leaf = by_path[path]
            st = md.get(12)
            cols.append(ColumnChunk(
                path_in_schema=path, physical_type=md[1], codec=md[4],
                encodings=tuple(md.get(2, ())), num_values=md[5],
                total_uncompressed_size=md[6],
                total_compressed_size=md[7], data_page_offset=md[9],
                dictionary_page_offset=md.get(11),
                statistics=(_statistics(st, leaf, created_by)
                            if st is not None else None)))
        groups.append(RowGroup(num_rows=rg[3], columns=tuple(cols)))
    return FileMetaData(num_rows=fm.get(3, 0), row_groups=tuple(groups),
                        fields=fields, leaves=leaves, created_by=created_by)


def read_footer(path: str) -> FileMetaData:
    """Parse a Parquet file's footer."""
    with open(path, "rb") as fh:
        fh.seek(0, os.SEEK_END)
        size = fh.tell()
        if size < 12:
            raise ValueError(f"{path}: too small to be a Parquet file")
        fh.seek(size - 8)
        tail = fh.read(8)
        if tail[4:] != MAGIC:
            raise ValueError(f"{path}: not a Parquet file (no PAR1 "
                             f"footer magic)")
        n = struct.unpack("<I", tail[:4])[0]
        if n + 12 > size:
            raise ValueError(f"{path}: footer length {n} exceeds the file")
        fh.seek(size - 8 - n)
        return parse_file_metadata(fh.read(n))


# -- per-file memoization ----------------------------------------------------
#
# A multi-part load opens the same file once per part: the footer and the
# memory map are pure functions of (path, mtime_ns, size), so they are
# shared under that key (a rewritten file gets a fresh entry).  A bounded
# FIFO; the lock guards the loader's part threads.

_FOOTER_CACHE: dict = {}
_MMAP_CACHE: dict = {}
_FILE_CACHE_MAX = 32
_FILE_CACHE_LOCK = threading.Lock()


def file_key(path: str) -> tuple:
    st = os.stat(path)
    return (os.path.abspath(path), st.st_mtime_ns, st.st_size)


def _put_locked(cache: dict, key, value) -> None:
    while len(cache) >= _FILE_CACHE_MAX:
        cache.pop(next(iter(cache)), None)
    cache[key] = value


def parquet_metadata(path: str) -> FileMetaData:
    """The file's footer, parsed at most once per (path, mtime, size)."""
    key = file_key(path)
    with _FILE_CACHE_LOCK:
        meta = _FOOTER_CACHE.get(key)
    if meta is not None:
        return meta
    meta = read_footer(path)
    with _FILE_CACHE_LOCK:
        hit = _FOOTER_CACHE.get(key)
        if hit is not None:
            return hit
        _put_locked(_FOOTER_CACHE, key, meta)
    return meta


def shared_memmap(path: str) -> np.ndarray:
    """One read-only memmap per (path, mtime, size), shared by every
    row-group reader of the file (readers only ever slice it)."""
    key = file_key(path)
    with _FILE_CACHE_LOCK:
        mm = _MMAP_CACHE.get(key)
    if mm is not None:
        return mm
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    with _FILE_CACHE_LOCK:
        hit = _MMAP_CACHE.get(key)
        if hit is not None:
            return hit
        _put_locked(_MMAP_CACHE, key, mm)
    return mm


def reset_file_caches() -> None:
    with _FILE_CACHE_LOCK:
        _FOOTER_CACHE.clear()
        _MMAP_CACHE.clear()
