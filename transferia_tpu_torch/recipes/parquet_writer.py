"""A small Parquet writer for generated datasets, with no pyarrow.

The port does not depend on pyarrow, so where pyarrow is absent the
ClickBench snapshot's file is written here: bench.py's
`generate_dataset` columns, laid out as pyarrow writes them
(`pq.write_table(..., row_group_size=131_072, compression="snappy")`):

- row groups of `row_group_rows` rows; SNAPPY pages;
- every column OPTIONAL (pyarrow's nullable fields), its definition
  levels one RLE run (the columns hold no nulls);
- pyarrow's physical and logical types: INT8/INT16 as INT32 with an
  INT(8/16) annotation, DATETIME (seconds) as INT64 TIMESTAMP(MILLIS),
  TIMESTAMP (microseconds) as INT64 TIMESTAMP(MICROS), UTF8 as BYTE_ARRAY
  STRING, STRING as plain BYTE_ARRAY;
- a chunk whose distinct values, PLAIN-encoded, stay under
  `dictionary_limit` (1 MiB, pyarrow's dictionary page limit) gets a
  dictionary page and RLE_DICTIONARY data pages; any other chunk gets
  PLAIN pages and no dictionary (pyarrow starts such a chunk with a
  dictionary and falls back to PLAIN part way; the decoder reads both);
- data pages of at most `data_page_bytes` (1 MiB) of values;
- chunk statistics (min, max, null count) as pyarrow writes them.

Snappy pages come from `csrc/snappy_compress.cpp`, a greedy hash
matcher built by the port's host build (`native.build_host_library`),
so repetitive data really compresses and the reader really decodes it.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path
from typing import Optional, Union

import numpy as np

from transferia_tpu_torch import native
from transferia_tpu_torch.abstract.schema import CanonicalType, TableSchema
from transferia_tpu_torch.columnar.batch import _gather_varwidth

SNAPPY = 1  # parquet CompressionCodec

_SNAPPY_SRC = Path(__file__).resolve().parent / "csrc" / \
    "snappy_compress.cpp"
_snappy: Optional[ctypes.CDLL] = None

# canonical type -> (physical, schema element extras, numpy storage dtype)
# physical: 1 INT32, 2 INT64, 4 FLOAT, 5 DOUBLE, 6 BYTE_ARRAY; extras:
# 6 the converted type, 10 the logical type
_TYPES = {
    CanonicalType.INT8: (1, {6: 15, 10: ("int", 8)}, np.int32),
    CanonicalType.INT16: (1, {6: 16, 10: ("int", 16)}, np.int32),
    CanonicalType.INT32: (1, {}, np.int32),
    CanonicalType.INT64: (2, {}, np.int64),
    CanonicalType.FLOAT: (4, {}, np.float32),
    CanonicalType.DOUBLE: (5, {}, np.float64),
    CanonicalType.DATETIME: (2, {6: 9, 10: ("ts", 1)}, np.int64),
    CanonicalType.TIMESTAMP: (2, {6: 10, 10: ("ts", 2)}, np.int64),
    CanonicalType.UTF8: (6, {6: 0, 10: ("string",)}, None),
    CanonicalType.STRING: (6, {}, None),
}

VarColumn = tuple  # (flat uint8 bytes, (n+1,) offsets)
ColumnData = Union[np.ndarray, VarColumn]


def _snappy_lib() -> ctypes.CDLL:
    global _snappy
    if _snappy is None:
        lib = ctypes.CDLL(str(native.build_host_library(
            "snappy_compress", (_SNAPPY_SRC,))))
        lib.snappy_max_compressed_length.argtypes = [ctypes.c_int64]
        lib.snappy_max_compressed_length.restype = ctypes.c_int64
        lib.snappy_compress.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_void_p]
        lib.snappy_compress.restype = ctypes.c_int64
        _snappy = lib
    return _snappy


def snappy_compress(data: bytes) -> bytes:
    """Raw-format snappy of a buffer."""
    lib = _snappy_lib()
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(lib.snappy_max_compressed_length(len(src)),
                   dtype=np.uint8)
    n = lib.snappy_compress(src.ctypes.data, len(src), out.ctypes.data)
    return out[:n].tobytes()


# -- thrift compact protocol (writer) ----------------------------------------
#
# A struct is a list of (field id, thrift type, value); a list value is
# (element type, [values]).  Types: 1/2 BOOL, 3 BYTE, 5 I32, 6 I64,
# 8 BINARY, 9 LIST, 12 STRUCT.

_BOOL, _BYTE, _I32, _I64, _BIN, _LIST, _STRUCT = 1, 3, 5, 6, 8, 9, 12


def _uvarint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _zigzag(v: int) -> bytes:
    return _uvarint((v << 1) ^ (v >> 63))


def _value(ttype: int, v) -> bytes:
    if ttype == _BYTE:
        return bytes([v & 0xFF])
    if ttype in (_I32, _I64):
        return _zigzag(v)
    if ttype == _BIN:
        return _uvarint(len(v)) + v
    if ttype == _STRUCT:
        return thrift_struct(v)
    if ttype == _LIST:
        et, items = v
        head = (bytes([(len(items) << 4) | et]) if len(items) < 15
                else bytes([0xF0 | et]) + _uvarint(len(items)))
        return head + b"".join(_value(et, x) for x in items)
    raise ValueError(f"thrift type {ttype} is not written here")


def thrift_struct(fields: list) -> bytes:
    """Encode (field id, type, value) triples, ids ascending."""
    out = bytearray()
    last = 0
    for fid, ttype, v in fields:
        wire = (_BOOL if v else 2) if ttype == _BOOL else ttype
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | wire)
        else:
            out.append(wire)
            out += _zigzag(fid)
        if ttype != _BOOL:
            out += _value(ttype, v)
        last = fid
    out.append(0)
    return bytes(out)


# -- encodings ---------------------------------------------------------------

def _plain_var(data: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """PLAIN BYTE_ARRAY: a 4-byte little-endian length before each value."""
    n = len(offsets) - 1
    off = offsets.astype(np.int64)
    lens = np.diff(off)
    out = np.empty(4 * n + int(lens.sum()), dtype=np.uint8)
    starts = np.arange(n, dtype=np.int64) * 4 + off[:-1] - off[0]
    out.reshape(-1)[(starts[:, None] + np.arange(4)).reshape(-1)] = \
        lens.astype("<u4").view(np.uint8)
    if len(lens):
        body = np.repeat(starts + 4 - (off[:-1] - off[0]), lens) + \
            np.arange(int(lens.sum()), dtype=np.int64)
        out[body] = data[off[0]:off[-1]]
    return out


def _bitpack(values: np.ndarray, width: int) -> bytes:
    """RLE/bit-packed hybrid of values < 2**width as one bit-packed run
    (groups of 8, zero padded)."""
    n = len(values)
    groups = -(-n // 8)
    padded = np.zeros(groups * 8, dtype=np.uint32)
    padded[:n] = values
    bits = ((padded[:, None] >> np.arange(width, dtype=np.uint32)) & 1)
    packed = np.packbits(bits.astype(np.uint8).reshape(-1),
                         bitorder="little")
    return _uvarint((groups << 1) | 1) + packed.tobytes()


def _def_levels(n: int) -> bytes:
    """Definition levels of n present values (max level 1): one RLE run,
    4-byte length first (data page v1)."""
    run = _uvarint(n << 1) + b"\x01"
    return struct.pack("<I", len(run)) + run


def _var_keys(data: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Each value as one fixed-size void key (its length, then its bytes
    zero padded), for np.unique."""
    off = offsets.astype(np.int64)
    lens = np.diff(off)
    width = int(lens.max()) if len(lens) else 0
    mat = np.zeros((len(lens), 4 + width), dtype=np.uint8)
    mat[:, :4] = lens.astype("<u4").view(np.uint8).reshape(-1, 4)
    if len(lens) and width:
        rows = np.repeat(np.arange(len(lens)), lens)
        cols = 4 + np.arange(int(lens.sum())) - np.repeat(
            off[:-1] - off[0], lens)
        mat[rows, cols] = data[off[0]:off[-1]]
    return mat.view(np.dtype((np.void, 4 + width))).reshape(-1)


class _Chunk:
    """One column chunk's pages, ready to write."""

    def __init__(self, pages: bytes, dict_len: int, encodings: list[int],
                 uncompressed: int, stats: list, n: int):
        self.pages = pages
        self.dict_len = dict_len   # bytes of the dictionary page (or 0)
        self.encodings = encodings
        self.uncompressed = uncompressed
        self.stats = stats
        self.n = n


class ParquetWriter:
    """Write a TableSchema's columns to one Parquet file, row group by
    row group (see the module docstring for the layout)."""

    def __init__(self, path: str, schema: TableSchema,
                 row_group_rows: int = 131_072,
                 dictionary_limit: int = 1 << 20,
                 data_page_bytes: int = 1 << 20):
        for cs in schema:
            if cs.data_type not in _TYPES:
                raise ValueError(f"parquet writer: column {cs.name!r} of "
                                 f"type {cs.data_type.name} is not written")
        self.path = path
        self.schema = schema
        self.row_group_rows = row_group_rows
        self.dictionary_limit = dictionary_limit
        self.data_page_bytes = data_page_bytes

    @staticmethod
    def _page(header: list, raw: bytes) -> tuple[bytes, int]:
        body = snappy_compress(raw)
        head = thrift_struct([(1, _I32, header[0]), (2, _I32, len(raw)),
                              (3, _I32, len(body))] + header[1:])
        return head + body, len(head) + len(raw)

    def _data_pages(self, values: list[tuple[int, bytes]], encoding: int
                    ) -> tuple[bytes, int]:
        out, raw_total = [], 0
        for n, payload in values:
            page, raw = self._page([0, (5, _STRUCT, [
                (1, _I32, n), (2, _I32, encoding), (3, _I32, 3),
                (4, _I32, 3)])], _def_levels(n) + payload)
            out.append(page)
            raw_total += raw
        return b"".join(out), raw_total

    def _chunk(self, cs, col: ColumnData) -> _Chunk:
        physical, _, dtype = _TYPES[cs.data_type]
        if physical == 6:
            data, offsets = col
            offsets = np.asarray(offsets, dtype=np.int64)
            n = len(offsets) - 1
            keys = _var_keys(data, offsets)
            uniq, first, codes = np.unique(keys, return_index=True,
                                           return_inverse=True)
            lens = np.diff(offsets)
            dict_bytes = int((lens[first] + 4).sum())
            order = np.argsort(first, kind="stable")  # first occurrence
            lo_i, hi_i = self._var_min_max(data, offsets, first)
            stats = [(3, _I64, 0),
                     (5, _BIN, self._value_bytes(data, offsets, hi_i)),
                     (6, _BIN, self._value_bytes(data, offsets, lo_i))]

            def plain(sel: np.ndarray) -> bytes:
                return _plain_var(*_gather_varwidth(data, offsets,
                                                    sel)).tobytes()

            row_bytes = lens + 4
        else:
            arr = np.ascontiguousarray(col)
            if cs.data_type == CanonicalType.DATETIME:
                arr = arr.astype(np.int64) * 1000  # stored as MILLIS
            arr = arr.astype(dtype)
            n = len(arr)
            uniq, first, codes = np.unique(arr, return_index=True,
                                           return_inverse=True)
            dict_bytes = len(uniq) * arr.itemsize
            order = np.argsort(first, kind="stable")
            stats = [(3, _I64, 0), (5, _BIN, arr.max().tobytes()),
                     (6, _BIN, arr.min().tobytes())] if n else \
                [(3, _I64, 0)]

            def plain(sel: np.ndarray) -> bytes:
                return arr[sel].tobytes()

            row_bytes = np.full(n, arr.itemsize, dtype=np.int64)
        if dict_bytes < self.dictionary_limit:
            # dictionary in first-occurrence order; codes remapped to it
            rank = np.empty(len(order), dtype=np.uint32)
            rank[order] = np.arange(len(order), dtype=np.uint32)
            idx = rank[codes.reshape(-1)]
            dict_raw = plain(first[order])
            dict_page, dict_raw_len = self._page([2, (7, _STRUCT, [
                (1, _I32, len(order)), (2, _I32, 0)])], dict_raw)
            width = max(1, int(len(order) - 1).bit_length())
            per_page = max(8, (self.data_page_bytes * 8 // width) // 8 * 8)
            pages, raw = self._data_pages(
                [(len(idx[lo:lo + per_page]),
                  bytes([width]) + _bitpack(idx[lo:lo + per_page], width))
                 for lo in range(0, n, per_page)], encoding=8)
            return _Chunk(dict_page + pages, len(dict_page), [0, 3, 8],
                          dict_raw_len + raw, stats, n)
        bounds = self._page_bounds(row_bytes)
        pages, raw = self._data_pages(
            [(hi - lo, plain(np.arange(lo, hi))) for lo, hi in bounds],
            encoding=0)
        return _Chunk(pages, 0, [0, 3], raw, stats, n)

    def _page_bounds(self, row_bytes: np.ndarray) -> list[tuple[int, int]]:
        """Row ranges of at most data_page_bytes of values each."""
        cum = np.cumsum(row_bytes)
        bounds, lo, base = [], 0, 0
        n = len(row_bytes)
        while lo < n:
            hi = int(np.searchsorted(cum, base + self.data_page_bytes,
                                     side="right"))
            hi = max(hi, lo + 1)
            bounds.append((lo, hi))
            base = int(cum[hi - 1])
            lo = hi
        return bounds

    @staticmethod
    def _value_bytes(data, offsets, i: int) -> bytes:
        return data[offsets[i]:offsets[i + 1]].tobytes()

    @staticmethod
    def _var_min_max(data, offsets, candidates) -> tuple[int, int]:
        """Indices of the bytewise-least and -greatest values (of the
        distinct ones, by their first occurrence)."""
        vals = [data[offsets[i]:offsets[i + 1]].tobytes()
                for i in candidates]
        lo = min(range(len(vals)), key=vals.__getitem__)
        hi = max(range(len(vals)), key=vals.__getitem__)
        return int(candidates[lo]), int(candidates[hi])

    def _schema_elements(self) -> list:
        out = [[(4, _BIN, b"schema"), (5, _I32, len(self.schema))]]
        for cs in self.schema:
            physical, extra, _ = _TYPES[cs.data_type]
            el = [(1, _I32, physical), (3, _I32, 1),
                  (4, _BIN, cs.name.encode())]
            if 6 in extra:
                el.append((6, _I32, extra[6]))
            if 10 in extra:
                kind = extra[10]
                if kind[0] == "int":
                    lt = [(10, _STRUCT, [(1, _BYTE, kind[1]),
                                         (2, _BOOL, True)])]
                elif kind[0] == "ts":
                    lt = [(8, _STRUCT, [(1, _BOOL, False),
                                        (2, _STRUCT, [(kind[1], _STRUCT,
                                                       [])])])]
                else:
                    lt = [(1, _STRUCT, [])]
                el.append((10, _STRUCT, lt))
            out.append(el)
        return out

    def write(self, columns: dict[str, ColumnData], n_rows: int) -> int:
        """Write the file; returns its size in bytes."""
        groups = []
        with open(self.path, "wb") as fh:
            fh.write(b"PAR1")
            pos = 4
            for lo in range(0, n_rows, self.row_group_rows):
                hi = min(n_rows, lo + self.row_group_rows)
                cols, total_raw, total_comp = [], 0, 0
                group_start = pos
                for cs in self.schema:
                    col = columns[cs.name]
                    if isinstance(col, tuple):
                        data, off = col
                        col = (data, np.asarray(off[lo:hi + 1]))
                    else:
                        col = col[lo:hi]
                    chunk = self._chunk(cs, col)
                    fh.write(chunk.pages)
                    md = [(1, _I32, _TYPES[cs.data_type][0]),
                          (2, _LIST, (_I32, chunk.encodings)),
                          (3, _LIST, (_BIN, [cs.name.encode()])),
                          (4, _I32, SNAPPY), (5, _I64, chunk.n),
                          (6, _I64, chunk.uncompressed),
                          (7, _I64, len(chunk.pages)),
                          (9, _I64, pos + chunk.dict_len)]
                    if chunk.dict_len:
                        md.append((11, _I64, pos))
                    md.append((12, _STRUCT, chunk.stats))
                    cols.append([(2, _I64, pos), (3, _STRUCT, md)])
                    pos += len(chunk.pages)
                    total_raw += chunk.uncompressed
                    total_comp += len(chunk.pages)
                groups.append([(1, _LIST, (_STRUCT, cols)),
                               (2, _I64, total_raw), (3, _I64, hi - lo),
                               (5, _I64, group_start),
                               (6, _I64, total_comp)])
            footer = thrift_struct([
                (1, _I32, 2),
                (2, _LIST, (_STRUCT, self._schema_elements())),
                (3, _I64, n_rows),
                (4, _LIST, (_STRUCT, groups)),
                (6, _BIN, b"transferia_tpu_torch parquet_writer"),
                (7, _LIST, (_STRUCT, [[(1, _STRUCT, [])]
                                      for _ in self.schema])),
            ])
            fh.write(footer)
            fh.write(struct.pack("<I", len(footer)) + b"PAR1")
            return pos + len(footer) + 8


def write_parquet(path: str, schema: TableSchema,
                  columns: dict[str, ColumnData], n_rows: int,
                  **kw) -> int:
    """Write columns (fixed: numpy arrays; var-width: (bytes, offsets))
    as one Parquet file; returns its size in bytes."""
    return ParquetWriter(path, schema, **kw).write(columns, n_rows)
