"""Decoder of a Postgres `COPY ... TO STDOUT (FORMAT csv)` chunk into
ColumnBatches, with the stdlib `csv` module and numpy.

The reference reads each chunk with pyarrow's CSV reader
(``transferia_tpu/providers/postgres/provider.py``, `_flush_csv` and
`_arrow_read_type`), which the port may not import.  This module gives
the same batches:

- the same values: an empty field, quoted or not, is NULL for every type
  (`null_values=[""]`, strings and quoted strings can be null); integers
  take optional blanks around a decimal or `0x` hex literal and no `+`;
  floats take blanks, a sign, `inf`/`infinity`/`nan` in any case;
  booleans only `1/0/true/false/True/False/TRUE/FALSE` (so Postgres'
  own `t`/`f` raise, as pyarrow's defaults refuse them); dates
  `YYYY-MM-DD` with blanks; timestamps `YYYY-MM-DD[( |T)hh[:mm[:ss
  [.ffffff]]]]` without blanks and without a zone offset (a `timestamptz`
  value such as `...+00` raises); strings must be UTF-8.  A NULL holds 0
  (False, empty bytes) under its validity bit, as `ColumnBatch.from_arrow`
  fills it;
- the same batches: pyarrow cuts the chunk into blocks of `BLOCK_SIZE`
  bytes and a row belongs to the block that holds its terminating
  newline; each block is one table chunk, split into `batch_rows`
  slices.  Empty lines are skipped;
- the same `read_bytes`: the Arrow buffer bytes each slice references
  (`RecordBatch.nbytes`): a validity bitmap only where its block held a
  NULL, booleans as bits, strings as 4 bytes a row plus their bytes.

A value the reference would refuse raises `CopyCSVError`.  A quoted
field may hold a newline (a row ends only at a newline outside quotes);
pyarrow reads such a row the same unless that newline is the last of
its block, where pyarrow raises and this decoder does not.
"""

from __future__ import annotations

import csv
import io
import re
from typing import Iterator, Optional

import numpy as np

from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import Column, ColumnBatch

# pyarrow.csv.ReadOptions().block_size
BLOCK_SIZE = 1 << 20


class CopyCSVError(ValueError):
    """A COPY CSV chunk the reference's reader refuses."""


_INT = {
    CanonicalType.INT8: (np.int8, 8, True),
    CanonicalType.INT16: (np.int16, 16, True),
    CanonicalType.INT32: (np.int32, 32, True),
    CanonicalType.INT64: (np.int64, 64, True),
    CanonicalType.UINT8: (np.uint8, 8, False),
    CanonicalType.UINT16: (np.uint16, 16, False),
    CanonicalType.UINT32: (np.uint32, 32, False),
    CanonicalType.UINT64: (np.uint64, 64, False),
}
_FLOAT = {CanonicalType.FLOAT: np.float32, CanonicalType.DOUBLE: np.float64}
# canonical types pyarrow reads as a fixed-width Arrow type: bytes a value
_FIXED_WIDTH = {
    **{t: np.dtype(dt).itemsize for t, (dt, _, _) in _INT.items()},
    CanonicalType.FLOAT: 4, CanonicalType.DOUBLE: 8,
    CanonicalType.DATE: 4, CanonicalType.TIMESTAMP: 8,
    CanonicalType.DATETIME: 8,
}

_SIGNED = r"[ \t]*(?:-?[0-9]+|0[xX][0-9a-fA-F]+)[ \t]*"
_UNSIGNED = r"[ \t]*(?:[0-9]+|0[xX][0-9a-fA-F]+)[ \t]*"
_FLOATS = (r"[ \t]*[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
           r"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?|[nN][aA][nN])[ \t]*")
_BOOLS = {"1": True, "True": True, "TRUE": True, "true": True,
          "0": False, "False": False, "FALSE": False, "false": False}
_DATE = re.compile(r"[ \t]*([0-9]{4})-([0-9]{2})-([0-9]{2})[ \t]*")
_TS = {
    CanonicalType.TIMESTAMP: re.compile(
        r"([0-9]{4})-([0-9]{2})-([0-9]{2})(?:[ T]([0-9]{2})(?::([0-9]{2})"
        r"(?::([0-9]{2})(?:\.([0-9]{1,6}))?)?)?)?"),
    CanonicalType.DATETIME: re.compile(
        r"([0-9]{4})-([0-9]{2})-([0-9]{2})(?:[ T]([0-9]{2})(?::([0-9]{2})"
        r"(?::([0-9]{2}))?)?)?"),
}
_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _refuse(ctype: CanonicalType, value: str) -> CopyCSVError:
    return CopyCSVError(
        f"COPY CSV conversion error to {ctype.value}: invalid value "
        f"{value!r}")


def _check_all(pattern: str, values: list[str], ctype: CanonicalType
               ) -> None:
    """Every value matches `pattern` (one regex over the joined values),
    else raise naming the first that does not."""
    if not values:
        return
    if re.fullmatch(f"(?:{pattern}\n)*{pattern}", "\n".join(values)):
        return
    one = re.compile(pattern)
    for v in values:
        if "\n" in v or not one.fullmatch(v):
            raise _refuse(ctype, v)


def _days_from_civil(y: int, m: int, d: int) -> int:
    """Days since 1970-01-01 of a proleptic Gregorian date."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _valid_date(y: int, m: int, d: int) -> bool:
    if not 1 <= m <= 12 or d < 1:
        return False
    leap = y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)
    return d <= _MONTH_DAYS[m - 1] + (1 if m == 2 and leap else 0)


def _ints(values: list[str], ctype: CanonicalType) -> np.ndarray:
    dt, bits, signed = _INT[ctype]
    _check_all(_SIGNED if signed else _UNSIGNED, values, ctype)
    lo, hi = (-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed \
        else (0, (1 << bits) - 1)
    out = []
    for v in values:
        s = v.strip(" \t")
        if s[1:2] in ("x", "X"):
            # hex is read as the type's unsigned bits
            n = int(s, 16)
            if n >> bits:
                raise _refuse(ctype, v)
            if signed and n > hi:
                n -= 1 << bits
        else:
            n = int(s)
            if not lo <= n <= hi:
                raise _refuse(ctype, v)
        out.append(n)
    return np.array(out, dtype=dt)


def _floats(values: list[str], ctype: CanonicalType) -> np.ndarray:
    _check_all(_FLOATS, values, ctype)
    out = np.array([float(v) for v in values], dtype=np.float64)
    with np.errstate(over="ignore"):
        return out.astype(_FLOAT[ctype])


def _bools(values: list[str], ctype: CanonicalType) -> np.ndarray:
    try:
        return np.array([_BOOLS[v] for v in values], dtype=np.bool_)
    except KeyError as e:
        raise _refuse(ctype, e.args[0]) from None


def _dates(values: list[str], ctype: CanonicalType) -> np.ndarray:
    out = []
    for v in values:
        m = _DATE.fullmatch(v)
        if m is None:
            raise _refuse(ctype, v)
        y, mo, d = (int(g) for g in m.groups())
        if not _valid_date(y, mo, d):
            raise _refuse(ctype, v)
        out.append(_days_from_civil(y, mo, d))
    return np.array(out, dtype=np.int32)


def _timestamps(values: list[str], ctype: CanonicalType) -> np.ndarray:
    """Microseconds (TIMESTAMP) or seconds (DATETIME) since the epoch."""
    pat = _TS[ctype]
    out = []
    for v in values:
        m = pat.fullmatch(v)
        if m is None:
            raise _refuse(ctype, v)
        y, mo, d = int(m[1]), int(m[2]), int(m[3])
        hh, mi, ss = (int(g) if g else 0 for g in m.groups()[3:6])
        if not _valid_date(y, mo, d) or hh > 23 or mi > 59 or ss > 59:
            raise _refuse(ctype, v)
        secs = _days_from_civil(y, mo, d) * 86400 + hh * 3600 + mi * 60 + ss
        if ctype == CanonicalType.DATETIME:
            out.append(secs)
        else:
            frac = m[7] or ""
            out.append(secs * 1_000_000 + int(frac.ljust(6, "0") or 0))
    return np.array(out, dtype=np.int64)


_FIXED_DECODERS = {
    **{t: _ints for t in _INT},
    **{t: _floats for t in _FLOAT},
    CanonicalType.BOOLEAN: _bools,
    CanonicalType.DATE: _dates,
    CanonicalType.TIMESTAMP: _timestamps,
    CanonicalType.DATETIME: _timestamps,
}


class _Decoded:
    """One block's column: values with NULLs filled, var-width bytes and
    offsets, the block's NULL mask (None = no NULL in the block)."""

    __slots__ = ("data", "offsets", "nulls")

    def __init__(self, data, offsets, nulls):
        self.data = data
        self.offsets = offsets
        self.nulls = nulls


def _decode_column(ctype: CanonicalType, values: tuple) -> _Decoded:
    n = len(values)
    nulls = np.fromiter((v == "" for v in values), dtype=np.bool_, count=n)
    any_null = bool(nulls.any())
    decode = _FIXED_DECODERS.get(ctype)
    if decode is None:
        # read as an Arrow string: UTF8, STRING, ANY, DECIMAL and INTERVAL
        raw = [v.encode() for v in values]
        offsets = np.zeros(n + 1, dtype=np.int32)
        offsets[1:] = np.cumsum(
            np.fromiter(map(len, raw), dtype=np.int64, count=n))
        data = np.frombuffer(b"".join(raw), dtype=np.uint8).copy()
        return _Decoded(data, offsets, nulls if any_null else None)
    present = [v for v in values if v != ""] if any_null else list(values)
    vals = decode(present, ctype)
    if any_null:
        full = np.zeros(n, dtype=vals.dtype)
        full[~nulls] = vals
        vals = full
    return _Decoded(vals, None, nulls if any_null else None)


def _covering_bytes(offset: int, length: int) -> int:
    """Bytes of a bitmap that bits [offset, offset + length) touch."""
    return (offset % 8 + length + 7) // 8


def _slice_nbytes(ctype: CanonicalType, col: _Decoded, lo: int, hi: int
                  ) -> int:
    n = hi - lo
    out = _covering_bytes(lo, n) if col.nulls is not None else 0
    if ctype == CanonicalType.BOOLEAN:
        return out + _covering_bytes(lo, n)
    width = _FIXED_WIDTH.get(ctype)
    if width is not None:
        return out + width * n
    return out + 4 * n + int(col.offsets[hi] - col.offsets[lo])


def _row_blocks(raw: np.ndarray, block_size: int) -> np.ndarray:
    """Block index of each non-empty row, in order: the block holding the
    row's terminator (a newline outside quotes; `\\r\\n` ends at its
    `\\n`), the last block for an unterminated last row."""
    n = len(raw)
    is_nl = raw == 10
    is_cr = raw == 13
    cr_alone = is_cr.copy()
    cr_alone[:-1] &= ~is_nl[1:]
    term = np.flatnonzero(is_nl | cr_alone)
    if len(term):
        quotes = np.cumsum(raw == 34)
        term = term[quotes[term] % 2 == 0]
    # each row's content [start, end)
    starts = np.concatenate(([0], term + 1))
    ends = np.concatenate((term, [n]))
    crlf = np.zeros(len(term), dtype=np.bool_)
    inner = term > 0
    crlf[inner] = is_nl[term[inner]] & is_cr[term[inner] - 1]
    ends[:-1] -= crlf
    blocks = np.concatenate((term // block_size, [(n - 1) // block_size]))
    keep = ends > starts
    return blocks[keep]


def decode_copy_csv(data: bytes, tid: TableID, schema: TableSchema,
                    batch_rows: int, block_size: int = BLOCK_SIZE
                    ) -> Iterator[ColumnBatch]:
    """The ColumnBatches (with `read_bytes`) of one COPY CSV chunk."""
    if not data:
        raise CopyCSVError("Empty CSV file")
    try:
        text = data.decode("utf-8")
    except UnicodeDecodeError as e:
        raise CopyCSVError(f"COPY CSV: invalid UTF8 data: {e}") from None
    rows = [r for r in csv.reader(io.StringIO(text, newline="")) if r]
    blocks = _row_blocks(np.frombuffer(data, dtype=np.uint8), block_size)
    if len(blocks) != len(rows):
        raise CopyCSVError(
            f"COPY CSV: {len(rows)} rows parsed against {len(blocks)} row "
            f"ends")
    width = len(schema)
    for i, r in enumerate(rows):
        if len(r) != width:
            raise CopyCSVError(
                f"CSV parse error: Expected {width} columns, got {len(r)} "
                f"(row {i})")
    counts = np.bincount(blocks) if len(blocks) else np.zeros(0, np.int64)
    lo = 0
    for count in counts:
        count = int(count)
        if count == 0:
            continue
        block = rows[lo:lo + count]
        lo += count
        cols = list(zip(*block))
        decoded = [_decode_column(c.data_type, cols[j])
                   for j, c in enumerate(schema)]
        for s in range(0, count, batch_rows):
            e = min(s + batch_rows, count)
            yield _slice_batch(tid, schema, decoded, s, e)


def _slice_batch(tid: TableID, schema: TableSchema, decoded: list,
                 lo: int, hi: int) -> ColumnBatch:
    cols = {}
    nbytes = 0
    for c, d in zip(schema, decoded):
        validity: Optional[np.ndarray] = None
        if d.nulls is not None and d.nulls[lo:hi].any():
            validity = ~d.nulls[lo:hi]
        if d.offsets is not None:
            off = d.offsets[lo:hi + 1]
            data = d.data
            if off[0] != 0:
                # as `from_arrow` adopts a slice: rebased when it starts
                # past the block's first byte, else the block's whole
                # buffer stands behind the offsets
                data = data[int(off[0]):int(off[-1])]
                off = off - off[0]
            cols[c.name] = Column(c.name, c.data_type,
                                  np.ascontiguousarray(data),
                                  np.ascontiguousarray(off), validity)
        else:
            cols[c.name] = Column(c.name, c.data_type,
                                  np.ascontiguousarray(d.data[lo:hi]), None,
                                  validity)
        nbytes += _slice_nbytes(c.data_type, d, lo, hi)
    batch = ColumnBatch(tid, schema, cols)
    batch.read_bytes = nbytes
    return batch
