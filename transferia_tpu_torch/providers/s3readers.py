"""S3 object format readers: the port's copy of
``transferia_tpu/providers/s3readers.py`` (reference: pkg/providers/s3/
reader/registry/, schema inference per reader/abstract.go:40-52).

A Reader turns one object into ColumnBatches.  `fs` is the object store
the object lives in (`providers/s3.py`: a bucket through the port's S3
client, or the local file system) and `path` the object's path in it.

  parquet: the port's own footer parser and row-group decoder
           (providers/parquet_meta.py, parquet_native.py).  A local file
           is memory-mapped; an object in a bucket is read by ranged
           GETs: the footer with one, then each row group's byte span
           with one, inside the decode that RowGroupReadahead runs a
           group ahead of the pushes, so memory holds only the row
           groups in flight.  Batches are `batch_rows` rows across
           row-group boundaries, in file order: the reference's
           `iter_batches(batch_size=batch_rows)`.
  jsonl:   newline-delimited JSON, the schema inferred from the first 100
           lines as `pa.Table.from_pylist(rows).schema` infers it.
  line:    each line one row (utf8) + system columns.
  nginx:   nginx log_format template parsing ($var tokens), typed fields.

line/nginx add the reference's system columns __file_name/__row_index
(reader/abstract.go:16-17) as primary keys so replicated rows stay
addressable.  Parse failures follow unparsed_policy: "route" sends them
to the parsers' `_unparsed` system table, "skip" drops them, "fail"
raises.

Not ported (they raise NotImplementedError naming ROADMAP.md A7): csv,
which waits for a CSV reader of the port's own that infers types as
`pyarrow.csv` does (the `fs` source's CSV needs the same reader), and
proto, whose `protobuf` parser is not ported.
"""

from __future__ import annotations

import abc
import io
import json
import re
import threading
from typing import Callable, Optional

import numpy as np

from transferia_tpu_torch.abstract.errors import CategorizedError
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.parsers.base import Message, unparsed_batch
from transferia_tpu_torch.providers.parquet_meta import (
    FileMetaData,
    read_footer_ranged,
)
from transferia_tpu_torch.providers.parquet_native import (
    NativeParquetReader,
    slice_columns,
)
from transferia_tpu_torch.providers.readahead import RowGroupReadahead
from transferia_tpu_torch.stats import stagetimer, trace

FILE_NAME_COL = "__file_name"
ROW_INDEX_COL = "__row_index"
NOT_PORTED = "not ported to transferia_tpu_torch yet (ROADMAP.md A7)"

Pusher = Callable[[ColumnBatch], None]


class ReaderError(CategorizedError):
    def __init__(self, message: str):
        super().__init__(CategorizedError.SOURCE, message)


class Reader(abc.ABC):
    """One-object reader."""

    @abc.abstractmethod
    def infer_schema(self, fs, path: str) -> TableSchema:
        ...

    @abc.abstractmethod
    def read(self, fs, path: str, tid: TableID, schema: TableSchema,
             batch_rows: int, pusher: Pusher) -> None:
        ...

    def estimate_rows(self, fs, path: str) -> int:
        return 0


def _system_cols() -> list[ColSchema]:
    return [
        ColSchema(FILE_NAME_COL, CanonicalType.UTF8, primary_key=True),
        ColSchema(ROW_INDEX_COL, CanonicalType.INT64, primary_key=True),
    ]


def _lines(data: bytes):
    """An object's lines, each with its newline, as a file yields them."""
    return io.BytesIO(data)


# -- parquet -----------------------------------------------------------------

class RangedObject:
    """An object's bytes through ranged GETs: the byte source of
    NativeParquetReader for an object in a bucket."""

    def __init__(self, fs, path: str, size: int, etag: str):
        self._fs = fs
        self.path = path
        self.size = size
        # names this version of the object for the shared dict pools
        self.key = ("s3", fs.endpoint, path, etag, size)

    def read(self, lo: int, hi: int) -> bytes:
        with stagetimer.stage("s3_range_get"), \
                trace.span("s3_range_get", lo=lo, bytes=hi - lo):
            return self._fs.read_range(self.path, lo, hi)

    def span(self, lo: int, hi: int) -> tuple[np.ndarray, int]:
        return np.frombuffer(self.read(lo, hi), dtype=np.uint8), lo


class ParquetReader(Reader):
    """Parquet objects through the port's decoder.  Footers are parsed
    once per object version (path, etag, size) and shared by the
    storage's part threads."""

    def __init__(self, decode_threads: int = 1, readahead_groups: int = 2):
        self.decode_threads = max(1, decode_threads)
        self.readahead_groups = readahead_groups
        self._meta: dict = {}
        self._lock = threading.Lock()

    def metadata(self, fs, path: str) -> FileMetaData:
        info = fs.info(path)
        key = (path, info.etag, info.size)
        with self._lock:
            meta = self._meta.get(key)
        if meta is None:
            with stagetimer.stage("s3_range_get"):
                meta = read_footer_ranged(
                    lambda lo, hi: fs.read_range(path, lo, hi),
                    info.size, path)
            with self._lock:
                meta = self._meta.setdefault(key, meta)
        return meta

    def infer_schema(self, fs, path: str) -> TableSchema:
        return self.metadata(fs, path).table_schema()

    def estimate_rows(self, fs, path: str) -> int:
        return self.metadata(fs, path).num_rows

    def read(self, fs, path, tid, schema, batch_rows, pusher) -> None:
        meta = self.metadata(fs, path)
        source = fs.byte_source(path)
        reader = NativeParquetReader(path, meta, schema,
                                     decode_threads=self.decode_threads,
                                     source=source)
        groups = [g for g in range(meta.num_row_groups)
                  if meta.row_groups[g].num_rows]
        if not groups:
            return
        def decode(g):
            with stagetimer.stage("source_decode"), \
                    trace.span("source_decode", group=g):
                return reader.read_row_group(g)

        def cols_nbytes(cols):
            return sum(c.nbytes() for c in cols.values())

        pending: list[ColumnBatch] = []
        held = 0
        with RowGroupReadahead(
                groups, decode, max_groups=self.readahead_groups,
                nbytes=cols_nbytes) as ra:
            for g, cols in ra:
                n = meta.row_groups[g].num_rows
                lo = 0
                while lo < n:
                    hi = min(n, lo + batch_rows - held)
                    with stagetimer.stage("pivot"):
                        pending.append(ColumnBatch(
                            tid, schema, slice_columns(cols, lo, hi)))
                    held += hi - lo
                    lo = hi
                    if held == batch_rows:
                        self._push(pending, pusher)
                        pending, held = [], 0
        if pending:
            self._push(pending, pusher)

    @staticmethod
    def _push(pieces: list, pusher: Pusher) -> None:
        with stagetimer.stage("pivot"):
            batch = ColumnBatch.concat(pieces)
            batch.read_bytes = batch.nbytes()
        pusher(batch)


# -- jsonl -------------------------------------------------------------------

_ARROW_CANONICAL = {"int64": CanonicalType.INT64,
                    "double": CanonicalType.DOUBLE,
                    "bool": CanonicalType.BOOLEAN,
                    "string": CanonicalType.UTF8}


def _json_type(values: list) -> str:
    """The arrow type `pa.array(values)` infers for JSON values, by name
    (`int64`, `double`, `bool`, `string`, `null`, `struct<a: int64>`,
    `list<item: string>`); values it cannot hold together raise."""
    kinds = set()
    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            kinds.add("bool")
        elif isinstance(v, int):
            if not -(1 << 63) <= v < (1 << 63):
                raise ReaderError(f"jsonl: integer {v} does not fit int64")
            kinds.add("int64")
        elif isinstance(v, float):
            kinds.add("double")
        elif isinstance(v, str):
            kinds.add("string")
        elif isinstance(v, dict):
            kinds.add("struct")
        elif isinstance(v, list):
            kinds.add("list")
        else:
            raise ReaderError(f"jsonl: value {v!r} has no arrow type")
    if not kinds:
        return "null"
    if kinds == {"int64", "double"}:
        return "double"
    if len(kinds) > 1:
        raise ReaderError(f"jsonl: a column mixes {sorted(kinds)}")
    (kind,) = kinds
    if kind == "struct":
        names: list = []
        for v in values:
            for k in v or {}:
                if k not in names:
                    names.append(k)
        present = [v for v in values if v is not None]
        fields = ", ".join(f"{k}: {_json_type([v.get(k) for v in present])}"
                           for k in names)
        return f"struct<{fields}>"
    if kind == "list":
        items = [x for v in values if v is not None for x in v]
        return f"list<item: {_json_type(items)}>"
    return kind


def infer_json_schema(rows: list[dict]) -> TableSchema:
    """`arrow_to_table_schema(pa.Table.from_pylist(rows).schema)` without
    pyarrow: the first row's keys, in order, each typed over every row;
    what arrow holds as a struct, list or null is ANY."""
    names = list(rows[0]) if rows else []
    cols = []
    for name in names:
        t = _json_type([r.get(name) for r in rows])
        cols.append(ColSchema(name, _ARROW_CANONICAL.get(t, CanonicalType.ANY),
                              original_type=f"arrow:{t}"))
    return TableSchema(cols)


class JsonlReader(Reader):
    def infer_schema(self, fs, path: str) -> TableSchema:
        rows = []
        for i, line in enumerate(_lines(fs.cat(path))):
            if i >= 100:
                break
            if line.strip():
                rows.append(json.loads(line))
        return infer_json_schema(rows)

    def read(self, fs, path, tid, schema, batch_rows, pusher) -> None:
        rows: list[dict] = []
        nbytes = 0
        for line in _lines(fs.cat(path)):
            if not line.strip():
                continue
            rows.append(json.loads(line))
            nbytes += len(line)
            if len(rows) >= batch_rows:
                self._push(rows, nbytes, tid, schema, pusher)
                rows, nbytes = [], 0
        if rows:
            self._push(rows, nbytes, tid, schema, pusher)

    @staticmethod
    def _push(rows, nbytes, tid, schema, pusher):
        data = {c.name: [r.get(c.name) for r in rows] for c in schema}
        batch = ColumnBatch.from_pydict(tid, schema, data)
        batch.read_bytes = nbytes
        pusher(batch)


# -- line / nginx ------------------------------------------------------------

class LineReader(Reader):
    """Each line one row (registry/line): `line` utf8 + system columns."""

    SCHEMA = TableSchema([ColSchema("line", CanonicalType.UTF8)]
                         + _system_cols())

    def infer_schema(self, fs, path: str) -> TableSchema:
        return self.SCHEMA

    def read(self, fs, path, tid, schema, batch_rows, pusher) -> None:
        lines: list[str] = []
        idx0 = 0
        nbytes = 0
        row = 0
        for raw in _lines(fs.cat(path)):
            text = raw.decode("utf-8", errors="replace").rstrip("\r\n")
            if not text.strip():
                row += 1
                continue
            if not lines:
                idx0 = row
            lines.append(text)
            nbytes += len(raw)
            row += 1
            if len(lines) >= batch_rows:
                self._push(lines, idx0, nbytes, path, tid, pusher)
                lines, nbytes = [], 0
        if lines:
            self._push(lines, idx0, nbytes, path, tid, pusher)

    def _push(self, lines, idx0, nbytes, path, tid, pusher):
        # row indices are per-pushed-row dense from the first line of the
        # buffer; blank lines advance the file row counter but aren't rows
        batch = ColumnBatch.from_pydict(tid, self.SCHEMA, {
            "line": lines,
            FILE_NAME_COL: [path] * len(lines),
            ROW_INDEX_COL: list(range(idx0, idx0 + len(lines))),
        })
        batch.read_bytes = nbytes
        pusher(batch)


# default combined log format (nginx docs)
NGINX_COMBINED = (
    '$remote_addr - $remote_user [$time_local] "$request" '
    '$status $body_bytes_sent "$http_referer" "$http_user_agent"'
)

_NGINX_INT = {"status", "body_bytes_sent", "bytes_sent", "request_length",
              "connection", "connection_requests", "content_length"}
_NGINX_FLOAT = {"request_time", "upstream_response_time", "msec",
                "upstream_connect_time", "upstream_header_time"}
_VAR_RE = re.compile(r"\$([A-Za-z0-9_]+)")


class NginxReader(Reader):
    """nginx log_format template parser (registry/nginx): literals match
    exactly, variables capture up to the next literal."""

    def __init__(self, log_format: str = "",
                 unparsed_policy: str = "route"):
        fmt = (log_format or NGINX_COMBINED).strip()
        fmt = re.sub(r"[ \t]*\n[ \t]*", " ", fmt)
        self.tokens: list[tuple[bool, str]] = []
        last = 0
        for m in _VAR_RE.finditer(fmt):
            if m.start() > last:
                self.tokens.append((False, fmt[last:m.start()]))
            self.tokens.append((True, m.group(1)))
            last = m.end()
        if last < len(fmt):
            self.tokens.append((False, fmt[last:]))
        self.fields = [v for is_var, v in self.tokens if is_var]
        if not self.fields:
            raise ReaderError(f"nginx format has no variables: {fmt!r}")
        self.unparsed_policy = unparsed_policy
        cols = []
        for f in self.fields:
            if f in _NGINX_INT:
                t = CanonicalType.INT64
            elif f in _NGINX_FLOAT:
                t = CanonicalType.DOUBLE
            else:
                t = CanonicalType.UTF8
            cols.append(ColSchema(f, t))
        self.schema = TableSchema(cols + _system_cols())

    def infer_schema(self, fs, path: str) -> TableSchema:
        return self.schema

    def parse_line(self, line: str) -> Optional[list]:
        values: list = []
        pos = 0
        n = len(self.tokens)
        for i, (is_var, val) in enumerate(self.tokens):
            if not is_var:
                lit = val
                if line.startswith(lit, pos):
                    pos += len(lit)
                elif i == 0 and line.startswith(lit.lstrip(), pos):
                    pos += len(lit.lstrip())
                else:
                    return None
                continue
            # variable: capture up to the next literal (or line end)
            if i + 1 < n and not self.tokens[i + 1][0]:
                nxt = self.tokens[i + 1][1]
                end = line.find(nxt, pos)
                if end < 0:
                    return None
            else:
                end = len(line)
            values.append(line[pos:end])
            pos = end
        out: list = []
        for f, raw in zip(self.fields, values):
            if f in _NGINX_INT:
                try:
                    out.append(int(raw))
                except ValueError:
                    out.append(None)
            elif f in _NGINX_FLOAT:
                try:
                    out.append(float(raw))
                except ValueError:
                    out.append(None)  # e.g. '-' for upstream times
            else:
                out.append(raw)
        return out

    def read(self, fs, path, tid, schema, batch_rows, pusher) -> None:
        good: list[list] = []
        good_idx: list[int] = []
        bad: list[Message] = []
        reasons: list[str] = []
        nbytes = 0
        for row, raw in enumerate(_lines(fs.cat(path))):
            text = raw.decode("utf-8", errors="replace").rstrip("\r\n")
            if not text.strip():
                continue
            nbytes += len(raw)
            vals = self.parse_line(text)
            if vals is None:
                if self.unparsed_policy == "fail":
                    raise ReaderError(
                        f"nginx parse failed at {path}:{row}: "
                        f"{text[:200]!r}")
                if self.unparsed_policy == "route":
                    bad.append(Message(value=raw, topic=path, offset=row))
                    reasons.append("nginx format mismatch")
                    if len(bad) >= batch_rows:
                        # flush: a fully-mismatched multi-GB log must
                        # not accumulate in memory
                        pusher(unparsed_batch(bad, reasons))
                        bad, reasons = [], []
                continue
            good.append(vals)
            good_idx.append(row)
            if len(good) >= batch_rows:
                self._push(good, good_idx, nbytes, path, tid, pusher)
                good, good_idx, nbytes = [], [], 0
        if good:
            self._push(good, good_idx, nbytes, path, tid, pusher)
        if bad:
            pusher(unparsed_batch(bad, reasons))

    def _push(self, rows, idx, nbytes, path, tid, pusher):
        data = {f: [r[i] for r in rows]
                for i, f in enumerate(self.fields)}
        data[FILE_NAME_COL] = [path] * len(rows)
        data[ROW_INDEX_COL] = idx
        batch = ColumnBatch.from_pydict(tid, self.schema, data)
        batch.read_bytes = nbytes
        pusher(batch)


def make_reader(fmt: str, *, nginx_format: str = "",
                unparsed_policy: str = "route",
                decode_threads: int = 1,
                readahead_groups: int = 2) -> Reader:
    if fmt == "parquet":
        return ParquetReader(decode_threads, readahead_groups)
    if fmt == "jsonl":
        return JsonlReader()
    if fmt == "line":
        return LineReader()
    if fmt == "nginx":
        return NginxReader(nginx_format, unparsed_policy)
    if fmt == "csv":
        raise NotImplementedError(
            f"s3 format 'csv' (a reader that infers types as pyarrow.csv "
            f"does): {NOT_PORTED}")
    if fmt == "proto":
        raise NotImplementedError(
            f"s3 format 'proto' (the protobuf parser): {NOT_PORTED}")
    raise ReaderError(f"unknown s3 format {fmt!r} (parquet/csv/jsonl/"
                      f"line/nginx/proto)")
