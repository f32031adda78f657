"""Vectorized RowBinary encoder (the port's copy of the encoder of
``transferia_tpu/providers/clickhouse/rowbinary.py``).

RowBinary is row-major (per row: each column's fixed-width value or
varint-length-prefixed bytes).  The encoder never loops over rows in
Python: per column it computes each row's field byte-length, derives
global row offsets with cumsums, and scatters column bytes into the
output with flat numpy gathers.  As in the JAX package, the varints and
the final scatter run in the host library (`leb128_encode`,
`scatter_bytes`); the numpy routes (`_encode_varints_plain`,
`_scatter_plain`) give the same bytes and are what tests hold them
against.  The decoder (the reference's per-row parser) serves the
ClickHouse storage, which the checksum task reads a target through.

Type wire formats (ClickHouse RowBinary):
  ints/floats: little-endian fixed width
  String:      LEB128 varint length + bytes
  Date32:      int32 days; DateTime: uint32 seconds;
  DateTime64(6): int64 microseconds
  Bool:        uint8
  Nullable(T): 0x00 value-follows / 0x01 null (no value)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from transferia_tpu_torch import native
from transferia_tpu_torch.abstract.schema import CanonicalType
from transferia_tpu_torch.columnar.batch import Column, ColumnBatch


def _leb128_lengths(values: np.ndarray) -> np.ndarray:
    """Byte count of each value's LEB128 varint."""
    out = np.ones(len(values), dtype=np.int64)
    v = values.astype(np.int64)
    thresh = 128
    while (v >= thresh).any():
        out += v >= thresh
        thresh <<= 7
    return out


def _encode_varints(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """values -> (flat varint bytes, per-value byte length), one pass in
    the host library."""
    n = len(values)
    out = np.empty(n * 10, dtype=np.uint8)
    lens = np.empty(n, dtype=np.int32)
    total = native.lib().leb128_encode(
        np.ascontiguousarray(values, dtype=np.uint64), n, out, lens)
    return out[:total].copy(), lens.astype(np.int64)


def _encode_varints_plain(values: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray]:
    """_encode_varints in numpy, multi-pass."""
    n = len(values)
    vlens = _leb128_lengths(values)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(vlens, out=offsets[1:])
    out = np.zeros(int(offsets[-1]), dtype=np.uint8)
    v = values.astype(np.uint64).copy()
    max_bytes = int(vlens.max()) if n else 0
    for b in range(max_bytes):
        active = vlens > b
        last = vlens == b + 1
        byte = (v & 0x7F).astype(np.uint8)
        byte = np.where(last, byte, byte | 0x80)
        idx = (offsets[:-1] + b)[active]
        out[idx] = byte[active]
        v >>= np.uint64(7)
    return out, vlens


def _fixed_width(ctype: CanonicalType) -> Optional[tuple[np.dtype, int]]:
    """Wire dtype for fixed-width canonical types."""
    table = {
        CanonicalType.INT8: np.dtype("<i1"),
        CanonicalType.INT16: np.dtype("<i2"),
        CanonicalType.INT32: np.dtype("<i4"),
        CanonicalType.INT64: np.dtype("<i8"),
        CanonicalType.UINT8: np.dtype("<u1"),
        CanonicalType.UINT16: np.dtype("<u2"),
        CanonicalType.UINT32: np.dtype("<u4"),
        CanonicalType.UINT64: np.dtype("<u8"),
        CanonicalType.FLOAT: np.dtype("<f4"),
        CanonicalType.DOUBLE: np.dtype("<f8"),
        CanonicalType.BOOLEAN: np.dtype("<u1"),
        CanonicalType.DATE: np.dtype("<i4"),      # as Date32
        CanonicalType.DATETIME: np.dtype("<u4"),
        CanonicalType.TIMESTAMP: np.dtype("<i8"),  # DateTime64(6)
        CanonicalType.INTERVAL: np.dtype("<i8"),
    }
    dt = table.get(ctype)
    return (dt, dt.itemsize) if dt is not None else None


class _EncodedColumn:
    """Per-row encoded field bytes for one column."""

    __slots__ = ("data", "lens")

    def __init__(self, data: np.ndarray, lens: np.ndarray):
        self.data = data   # flat uint8
        self.lens = lens   # (n,) int64 per-row field length


def _encode_column(col: Column, nullable: bool) -> _EncodedColumn:
    n = col.n_rows
    null_mask = None
    if col.validity is not None:
        null_mask = ~col.validity
    fixed = _fixed_width(col.ctype)
    if fixed is not None:
        dt, width = fixed
        vals = col.data.astype(dt.base, copy=False).astype(dt)
        body = np.ascontiguousarray(vals).view(np.uint8).reshape(n, width)
        if nullable:
            prefix = np.zeros((n, 1), dtype=np.uint8)
            if null_mask is not None:
                prefix[null_mask, 0] = 1
                body = body.copy()
                body[null_mask] = 0
                data = np.concatenate([prefix, body], axis=1)
                lens = np.where(null_mask, 1, 1 + width).astype(np.int64)
                # null rows carry only the prefix byte: compact via gather
                flat = data.reshape(-1)
                keep = np.ones((n, 1 + width), dtype=bool)
                keep[null_mask, 1:] = False
                return _EncodedColumn(flat[keep.reshape(-1)], lens)
            data = np.concatenate([prefix, body], axis=1)
            return _EncodedColumn(
                data.reshape(-1), np.full(n, 1 + width, dtype=np.int64)
            )
        if null_mask is not None and null_mask.any():
            body = body.copy()
            body[null_mask] = 0  # non-nullable target: nulls become zero
        return _EncodedColumn(
            body.reshape(-1), np.full(n, width, dtype=np.int64)
        )
    # var-width: varint(len) + bytes
    lens = (col.offsets[1:] - col.offsets[:-1]).astype(np.int64)
    if null_mask is not None:
        lens = np.where(null_mask, 0, lens)
    varint_bytes, varint_lens = _encode_varints(lens)
    field_lens = varint_lens + lens
    prefix_len = 0
    if nullable:
        field_lens = field_lens + 1
        prefix_len = 1
        if null_mask is not None:
            field_lens = np.where(null_mask, 1, field_lens)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(field_lens, out=out_offsets[1:])
    out = np.zeros(int(out_offsets[-1]), dtype=np.uint8)
    pos = out_offsets[:-1]
    if nullable:
        if null_mask is not None:
            out[pos[null_mask]] = 1
        pos = pos + prefix_len
        if null_mask is not None:
            # null rows: only the prefix byte, stop here for them
            active = ~null_mask
        else:
            active = np.ones(n, dtype=bool)
    else:
        active = np.ones(n, dtype=bool) if null_mask is None else ~null_mask
        if null_mask is not None and null_mask.any():
            # non-nullable target: null strings encode as empty
            pass
    # scatter varints
    vo = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(varint_lens, out=vo[1:])
    if nullable and null_mask is not None:
        write_varint = active
    else:
        write_varint = np.ones(n, dtype=bool)
    sel = np.nonzero(write_varint)[0]
    if len(sel):
        vl = varint_lens[sel]
        total_v = int(vl.sum())
        dst = np.repeat(pos[sel], vl) + (
            np.arange(total_v) - np.repeat(
                np.concatenate([[0], np.cumsum(vl)[:-1]]), vl
            )
        )
        src = np.repeat(vo[:-1][sel], vl) + (
            np.arange(total_v) - np.repeat(
                np.concatenate([[0], np.cumsum(vl)[:-1]]), vl
            )
        )
        out[dst] = varint_bytes[src]
    # scatter string bodies
    body_sel = np.nonzero(active & (lens > 0))[0]
    if len(body_sel):
        bl = lens[body_sel]
        total_b = int(bl.sum())
        inner = np.arange(total_b) - np.repeat(
            np.concatenate([[0], np.cumsum(bl)[:-1]]), bl
        )
        dst = np.repeat(pos[body_sel] + varint_lens[body_sel], bl) + inner
        src = np.repeat(col.offsets[:-1][body_sel].astype(np.int64), bl) \
            + inner
        out[dst] = col.data[src]
    return _EncodedColumn(out, field_lens)


def encode_rowbinary(batch: ColumnBatch,
                     nullable: Optional[dict[str, bool]] = None) -> bytes:
    """ColumnBatch -> RowBinary bytes (column order = batch.columns order)."""
    n = batch.n_rows
    if n == 0:
        return b""
    nullable = nullable or {}
    encoded = [
        _encode_column(col, nullable.get(name,
                                         col.validity is not None))
        for name, col in batch.columns.items()
    ]
    row_lens = np.zeros(n, dtype=np.int64)
    for e in encoded:
        row_lens += e.lens
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_lens, out=row_offsets[1:])
    out = np.zeros(int(row_offsets[-1]), dtype=np.uint8)
    field_start = row_offsets[:-1].copy()
    for e in encoded:
        lens = e.lens
        total = int(lens.sum())
        if total:
            src_off = np.zeros(n, dtype=np.int64)
            np.cumsum(lens[:-1], out=src_off[1:])
            native.lib().scatter_bytes(
                np.ascontiguousarray(e.data), src_off,
                np.ascontiguousarray(field_start),
                np.ascontiguousarray(lens), n, out)
        field_start += lens
    return out.tobytes()


def _scatter_plain(src: np.ndarray, src_off: np.ndarray,
                   dst_off: np.ndarray, lens: np.ndarray,
                   out: np.ndarray) -> None:
    """scatter_bytes in numpy: row i's lens[i] bytes from src_off[i]
    land at dst_off[i] in out."""
    total = int(lens.sum())
    inner = np.arange(total) - np.repeat(src_off, lens)
    out[np.repeat(dst_off, lens) + inner] = src[np.repeat(src_off, lens)
                                                 + inner]


# -- decoder (the ClickHouse storage) -----------------------------------------

class _NeedMore(Exception):
    """A row parse ran off the end of the buffer (a partial chunk)."""


def _wire_fixed(cs) -> Optional[tuple[np.dtype, int]]:
    """Per-column wire format, honoring the ClickHouse-native type: a
    `Date` column is uint16 days on the wire, the canonical DATE Date32."""
    if cs.original_type == "ch:Date":
        return np.dtype("<u2"), 2
    return _fixed_width(cs.data_type)


def _parse_row(buf: memoryview, pos: int, schema, nullable: dict,
               fixed: dict, out: dict) -> int:
    """Parse one row into `out`'s column lists; returns the position after
    it.  The row's values are appended only once the whole row parsed:
    a row cut at a chunk boundary raises _NeedMore leaving `out` as it
    was, and is parsed again from its start with the next chunk.  (The
    reference appends column by column, so such a row leaves its first
    columns one value long and the batch fails as ragged.)"""
    n = len(buf)
    row = []
    for c in schema:
        if nullable.get(c.name, False):
            if pos >= n:
                raise _NeedMore()
            flag = buf[pos]
            pos += 1
            if flag == 1:
                row.append(None)
                continue
        fx = fixed[c.name]
        if fx is not None:
            dt, width = fx
            if pos + width > n:
                raise _NeedMore()
            v = np.frombuffer(buf[pos:pos + width], dtype=dt)[0]
            if c.data_type == CanonicalType.BOOLEAN:
                row.append(bool(v))
            elif c.data_type.is_float:
                row.append(float(v))
            else:
                row.append(int(v))
            pos += width
        else:
            ln = 0
            shift = 0
            while True:
                if pos >= n:
                    raise _NeedMore()
                b = buf[pos]
                pos += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            if pos + ln > n:
                raise _NeedMore()
            raw = bytes(buf[pos:pos + ln])
            pos += ln
            if c.data_type == CanonicalType.STRING:
                row.append(raw)
            else:
                row.append(raw.decode("utf-8", "replace"))
    for c, v in zip(schema, row):
        out[c.name].append(v)
    return pos


def decode_rowbinary_stream(read_fn, schema,
                            nullable: Optional[dict[str, bool]] = None,
                            batch_rows: int = 131_072,
                            chunk_bytes: int = 8 << 20):
    """Incremental decode: read_fn(n) -> bytes (b"" = EOF).  Yields
    ColumnBatches of up to batch_rows rows in constant memory; a partial
    row at a chunk boundary carries over to the next chunk."""
    from transferia_tpu_torch.abstract.schema import TableID

    nullable = nullable or {}
    fixed = {c.name: _wire_fixed(c) for c in schema}
    leftover = b""
    cols: dict[str, list] = {c.name: [] for c in schema}
    rows = 0
    eof = False
    while not eof:
        chunk = read_fn(chunk_bytes)
        if not chunk:
            eof = True
        data = leftover + chunk if leftover else chunk
        buf = memoryview(data)
        pos = 0
        while pos < len(buf):
            row_start = pos
            try:
                pos = _parse_row(buf, pos, schema, nullable, fixed, cols)
            except _NeedMore:
                if eof:
                    raise ValueError(
                        "rowbinary stream truncated mid-row") from None
                pos = row_start
                break
            rows += 1
            if rows >= batch_rows:
                yield ColumnBatch.from_pydict(
                    TableID("", "decoded"), schema, cols)
                cols = {c.name: [] for c in schema}
                rows = 0
        leftover = bytes(buf[pos:])
    if rows:
        yield ColumnBatch.from_pydict(TableID("", "decoded"), schema, cols)
