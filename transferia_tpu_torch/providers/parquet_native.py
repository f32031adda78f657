"""Parquet row-group reader: column chunks -> Columns directly (the
port's copy of ``transferia_tpu/providers/parquet_native.py``).

The footer, row-group layout and schema come from the port's own parser
(providers/parquet_meta.py); the pages decode in the host library's
chunk decoder (`csrc/parquetdec.cpp`, `pq_decode_rowgroup`) straight into
the engine's columnar layout: flat (data, offsets) buffers, or int32
codes plus a pool adopted as a DictEnc.

The decode envelope: DataPage v1+v2; UNCOMPRESSED/SNAPPY/GZIP/ZSTD codecs
(GZIP and ZSTD ride dlopen'd system zlib/libzstd, SNAPPY the system
libsnappy or the decoder's own); PLAIN, RLE_DICTIONARY,
DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY
encodings; BOOLEAN/INT32/INT64/FLOAT/DOUBLE/BYTE_ARRAY physical types;
flat schemas (max_def <= 1, no repetition).  The JAX package reads what
falls outside through arrow, column by column; the port has no arrow, so
such a column raises NotImplementedError naming it and the reason.

All columns of a row group decode in one ctypes call, or column-parallel
over `decode_threads` threads (byte-identical either way).  ctypes
releases the GIL for the call, so upload threads overlap decode with
sink pushes.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from transferia_tpu_torch import native
from transferia_tpu_torch.abstract.schema import CanonicalType, TableSchema
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.columnar.batch import Column, DictEnc, DictPool
from transferia_tpu_torch.providers.parquet_meta import (
    BOOLEAN,
    BYTE_ARRAY,
    DOUBLE,
    FLOAT,
    INT32,
    INT64,
    PHYSICAL_NAMES,
    ColumnChunk,
    FileMetaData,
    file_key,
    shared_memmap,
)
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.stats.trace import TELEMETRY

# one decoded dict page -> one DictPool, shared by every reader of it: a
# part re-decoding the same page reuses the pool, keyed by (path, mtime,
# size, column, dictionary_page_offset).  The JAX package also interns
# pools by content across row groups; that sharing is not ported.
_PAGE_POOL_CACHE: dict = {}
_PAGE_POOL_CACHE_MAX = 256
_PAGE_POOL_LOCK = threading.Lock()

# copy-vs-view economics for the pool slice out of the cap-sized decode
# buffer: keeping a view pins the whole buffer (cap covers the code pages
# too) for as long as the pool lives; keep the view only when the pinned
# remainder is small both relatively AND absolutely
_POOL_PIN_MAX_WASTE = 256 * 1024

# parquet CompressionCodec values the decoder knows (GZIP and ZSTD also
# need the system zlib/libzstd, probed at run time)
_CODECS = {"UNCOMPRESSED": 0, "SNAPPY": 1, "GZIP": 2, "ZSTD": 6}
_FIXED_WIDTH = {INT32: 4, INT64: 8, FLOAT: 4, DOUBLE: 8}

# (physical width, output width, output view dtype) per canonical type.
# Narrow logical ints (int8/16) truncate during the native decode
# (little-endian low bytes == two's-complement truncation).
_VIEW_DTYPES = {
    CanonicalType.INT8: (4, 1, np.int8),
    CanonicalType.INT16: (4, 2, np.int16),
    CanonicalType.INT32: (4, 4, np.int32),
    CanonicalType.INT64: (8, 8, np.int64),
    CanonicalType.UINT8: (4, 1, np.uint8),
    CanonicalType.UINT16: (4, 2, np.uint16),
    CanonicalType.UINT32: (4, 4, np.uint32),
    CanonicalType.UINT64: (8, 8, np.uint64),
    CanonicalType.FLOAT: (4, 4, np.float32),
    CanonicalType.DOUBLE: (8, 8, np.float64),
    CanonicalType.DATE: (4, 4, np.int32),
    CanonicalType.DATETIME: (8, 8, np.int64),
    CanonicalType.TIMESTAMP: (8, 8, np.int64),
}

# task-array columns for pq_decode_rowgroup (csrc/parquetdec_ba.inc)
_T_OFF, _T_LEN, _T_CODEC, _T_KIND, _T_WIDTH, _T_NVAL, _T_MAXDEF = range(7)
_T_VALUES, _T_CAP, _T_OFFSETS, _T_CODES, _T_VALIDITY = range(7, 12)
_T_RESULT, _T_OUTKIND, _T_NEEDED, _T_NULLS = range(12, 16)
_T_FIELDS = 16

_E_GROW = -2

_TO_SECONDS = {"s": 1, "ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}
_TO_MICROS = {"s": 1_000_000, "ms": 1_000}


def _unsupported(name: str, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"parquet column {name!r}: {why}; the port's reader has no arrow "
        f"route for it (ROADMAP.md A10)")


class NativeParquetReader:
    """One file's row-group reader over the host library's decoder."""

    def __init__(self, path: str, meta: FileMetaData, schema: TableSchema,
                 decode_threads: int = 1):
        self._meta = meta
        self._schema = schema
        self._cdll = native.lib()
        self._decode_threads = max(1, int(decode_threads))
        self._mm = shared_memmap(path)
        self._file_key = file_key(path)
        self._fields = {f.name: f for f in meta.fields}
        self._col_idx = {c.path_in_schema: i for i, c in
                         enumerate(meta.row_groups[0].columns)} \
            if meta.row_groups else {}
        self._leaves = {leaf.path: leaf for leaf in meta.leaves}
        self._codec_ok_cache: dict[int, bool] = {}
        # (tasks template, specs) per row group
        self._task_cache: dict[int, tuple] = {}
        self._cache_lock = threading.Lock()

    def _codec_ok(self, codec: int) -> bool:
        ok = self._codec_ok_cache.get(codec)
        if ok is None:
            ok = bool(self._cdll.pq_codec_supported(codec))
            self._codec_ok_cache[codec] = ok
        return ok

    # -- row-group task preparation -----------------------------------------
    @staticmethod
    def _chunk_range(col: ColumnChunk) -> tuple[int, int]:
        start = col.data_page_offset
        if (col.dictionary_page_offset is not None
                and col.dictionary_page_offset >= 0):
            start = min(start, col.dictionary_page_offset)
        return start, col.total_compressed_size

    def _column(self, g: int, cs) -> Optional[tuple[int, ColumnChunk]]:
        """The column chunk of a schema column (None when the file lacks
        the column); a nested column raises."""
        field = self._fields.get(cs.name)
        if field is None:
            return None
        if field.leaf is None:
            raise _unsupported(cs.name, "a nested (group) column")
        leaf = field.leaf
        if leaf.max_rep > 0 or leaf.max_def > 1:
            raise _unsupported(cs.name, f"repetition level {leaf.max_rep}, "
                                        f"definition level {leaf.max_def}")
        idx = self._col_idx[leaf.path]
        return idx, self._meta.row_groups[g].columns[idx]

    def _rg_tasks(self, g: int) -> tuple:
        with self._cache_lock:
            cached = self._task_cache.get(g)
        if cached is not None:
            return cached
        specs: list[tuple] = []
        rows: list[list[int]] = []
        for cs in self._schema:
            found = self._column(g, cs)
            if found is None:
                continue  # column absent from the file entirely
            _, col = found
            codec = _CODECS.get(col.compression)
            if codec is None or not self._codec_ok(codec):
                raise _unsupported(cs.name, f"codec {col.compression} is "
                                            f"not decodable here")
            leaf = self._leaves[col.path_in_schema]
            ptype = col.physical_type
            view_dt = None
            if ptype in _FIXED_WIDTH:
                spec = _VIEW_DTYPES.get(cs.data_type)
                if spec is None or spec[0] != _FIXED_WIDTH[ptype]:
                    raise _unsupported(
                        cs.name, f"{PHYSICAL_NAMES[ptype]} as "
                                 f"{cs.data_type.name}")
                kind, (width, ow, view_dt) = 0, spec
            elif ptype == BOOLEAN and cs.data_type == CanonicalType.BOOLEAN:
                kind, width, ow, view_dt = 2, 1, 1, np.bool_
            elif ptype == BYTE_ARRAY and cs.data_type.is_variable_width:
                kind, width, ow = 1, 0, 0
            else:
                name = PHYSICAL_NAMES[ptype] if 0 <= ptype < 8 else ptype
                raise _unsupported(cs.name, f"physical type {name} as "
                                            f"{cs.data_type.name}")
            start, length = self._chunk_range(col)
            if start < 0 or start + length > len(self._mm):
                raise ValueError(f"parquet column {cs.name!r}: chunk "
                                 f"[{start}, {start + length}) lies outside "
                                 f"the {len(self._mm)}-byte file")
            n = col.num_values
            max_def = leaf.max_def
            # field 8: data cap for byte arrays, output width for fixed
            cap = (max(col.total_uncompressed_size, 4096)
                   if kind == 1 else ow)
            rows.append([start, length, codec, kind, width, n, max_def,
                         0, cap, 0, 0, 0, 0, 0, 0, 0])
            dict_off = (col.dictionary_page_offset
                        if col.dictionary_page_offset is not None else -1)
            unit = (leaf.logical.unit if leaf.logical is not None
                    and leaf.logical.kind == "TIMESTAMP" else "us")
            specs.append((cs, kind, ow, n, max_def, cap, view_dt,
                          dict_off, unit))
        tasks = (np.array(rows, dtype=np.int64)
                 if rows else np.zeros((0, _T_FIELDS), dtype=np.int64))
        out = (tasks, specs)
        with self._cache_lock:
            self._task_cache[g] = out
        return out

    # -- per-column post-processing -----------------------------------------
    @staticmethod
    def _finish_fixed(cs, vals: np.ndarray, validity: Optional[np.ndarray],
                      unit: str) -> Column:
        """The canonical column; DATETIME counts seconds and TIMESTAMP
        microseconds, whatever unit the file stores."""
        v = validity.astype(np.bool_) if validity is not None else None
        ct = cs.data_type
        if ct == CanonicalType.DATETIME:
            vals = vals.astype(np.int64, copy=False) // _TO_SECONDS[unit]
        elif ct == CanonicalType.TIMESTAMP:
            vals = vals.astype(np.int64, copy=False)
            vals = (vals * _TO_MICROS[unit] if unit in _TO_MICROS
                    else vals // (1000 if unit == "ns" else 1))
        elif ct.np_dtype != vals.dtype:
            vals = vals.astype(ct.np_dtype)
        return Column(cs.name, ct, np.ascontiguousarray(vals), None, v)

    def _finish_bytearray(self, cs, rc: int, out_kind: int,
                          data: np.ndarray, offsets: np.ndarray,
                          codes: np.ndarray,
                          validity: Optional[np.ndarray],
                          dict_off: int) -> Column:
        v = validity.astype(np.bool_) if validity is not None else None
        if out_kind == 1:
            # dict result: rc == n_pool; codes hold n_pool for nulls
            pool = self._adopt_dict_page(cs, rc, data, offsets, dict_off)
            return Column(cs.name, cs.data_type, validity=v,
                          dict_enc=DictEnc(codes, pool=pool))
        flat = data[:rc]
        if rc * 2 < data.nbytes:
            flat = flat.copy()
        return Column(cs.name, cs.data_type, flat, offsets, v)

    def _adopt_dict_page(self, cs, n_pool: int, data: np.ndarray,
                         offsets: np.ndarray, dict_off: int) -> DictPool:
        """A decoded dict page as a DictPool (one per page, shared)."""
        failpoint("decode.dict_adopt")
        page_key = (self._file_key + (cs.name, dict_off)
                    if dict_off >= 0 else None)
        if page_key is not None:
            with _PAGE_POOL_LOCK:
                hit = _PAGE_POOL_CACHE.get(page_key)
            if hit is not None:
                TELEMETRY.record_pool_share_hit()
                return hit
        # a trailing empty slot is the null sentinel (null rows decode
        # to code n_pool)
        pool_off = np.append(offsets[:n_pool + 1],
                             offsets[n_pool]).astype(np.int32)
        pool_bytes = int(offsets[n_pool])
        trace.instant("dict_adopt", col=cs.name, values=n_pool,
                      bytes=pool_bytes)
        pool_data = data[:pool_bytes]
        waste = int(data.nbytes) - pool_bytes
        if pool_bytes * 2 < data.nbytes or waste > _POOL_PIN_MAX_WASTE:
            TELEMETRY.record_pool_buffer(copied=pool_bytes)
            pool_data = pool_data.copy()
        else:
            TELEMETRY.record_pool_buffer(pinned=waste)
        pool = DictPool(pool_data, pool_off, null_code=n_pool)
        if page_key is not None:
            with _PAGE_POOL_LOCK:
                while len(_PAGE_POOL_CACHE) >= _PAGE_POOL_CACHE_MAX:
                    _PAGE_POOL_CACHE.pop(next(iter(_PAGE_POOL_CACHE)), None)
                pool = _PAGE_POOL_CACHE.setdefault(page_key, pool)
        return pool

    def _retry_bytearray(self, g: int, cs, cap: int,
                         dict_off: int) -> Column:
        """GROW retry: single-column decode with an enlarged data cap."""
        _, col = self._column(g, cs)
        codec = _CODECS[col.compression]
        max_def = self._leaves[col.path_in_schema].max_def
        n = col.num_values
        start, length = self._chunk_range(col)
        chunk = np.ascontiguousarray(self._mm[start:start + length])
        # the single-column entry point seeds validity all-defined itself
        validity = np.empty(n, dtype=np.uint8) if max_def else None
        offsets = np.empty(n + 1, dtype=np.int32)
        codes = np.empty(n, dtype=np.int32)
        for _attempt in range(4):
            data = np.empty(cap, dtype=np.uint8)
            kind = ctypes.c_int32(-1)
            needed = ctypes.c_int64(0)
            rc = self._cdll.pq_decode_bytearray(
                chunk, length, codec, n, max_def,
                data, cap, offsets, codes.ctypes.data,
                validity.ctypes.data if validity is not None else None,
                ctypes.byref(kind), ctypes.byref(needed))
            if rc == _E_GROW:
                cap = max(needed.value, cap * 2)
                continue
            if rc < 0:
                raise _unsupported(cs.name, f"the decoder refused the "
                                            f"chunk of row group {g} ({rc})")
            v = validity
            if v is not None and v.all():
                v = None
            return self._finish_bytearray(cs, rc, kind.value, data,
                                          offsets, codes, v, dict_off)
        raise _unsupported(cs.name, f"row group {g} outgrew {cap} bytes "
                                    f"after four retries")

    def _all_null_column(self, g: int, cs) -> Column:
        """A fixed-width chunk with a dictionary page that the fixed-width
        decoder refused.  A writer gives a column whose every value is
        null an empty dictionary page, which that decoder cannot load.
        The byte-array decoder walks the same pages and loads an empty
        dictionary, so it reads the definition levels: the column is all
        nulls only if they say so, and is refused otherwise."""
        _, col = self._column(g, cs)
        n = col.num_values
        start, length = self._chunk_range(col)
        chunk = np.ascontiguousarray(self._mm[start:start + length])
        validity = np.ones(n, dtype=np.uint8)
        codes = np.empty(n, dtype=np.int32)
        rc = self._cdll.pq_decode_bytearray(
            chunk, length, _CODECS[col.compression], n,
            self._leaves[col.path_in_schema].max_def,
            np.empty(1, dtype=np.uint8), 1, np.empty(n + 1, dtype=np.int32),
            codes.ctypes.data, validity.ctypes.data,
            ctypes.byref(ctypes.c_int32(-1)), ctypes.byref(ctypes.c_int64(0)))
        if rc != 0 or validity.any():
            raise _unsupported(cs.name, f"the decoder refused the chunk of "
                                        f"row group {g} (its dictionary "
                                        f"page, or a corrupt page)")
        return Column(cs.name, cs.data_type,
                      np.zeros(n, dtype=cs.data_type.np_dtype), None,
                      np.zeros(n, dtype=np.bool_))

    def _decode_tasks(self, tasks: np.ndarray, n: int) -> None:
        """Run the native decoder over the task rows, column-parallel
        when decode_threads > 1.  Task rows are independent (each
        decodes one column chunk into buffers only it points at) and
        pq_decode_rowgroup releases the GIL, so K threads decode K
        columns genuinely in parallel.  K=1 is one batched call.

        Work is handed out one column at a time, largest compressed
        chunk first (one long string column must not serialize behind
        already-claimed narrow ones)."""
        k = min(self._decode_threads, n)
        if k <= 1:
            if n:
                self._cdll.pq_decode_rowgroup(self._mm, len(self._mm),
                                              tasks, n)
            return
        order = iter(np.argsort(-tasks[:, _T_LEN], kind="stable"))
        errors: list[BaseException] = []

        def run() -> None:
            try:
                while True:
                    # next() on a shared iterator is atomic under the GIL
                    i = next(order, None)
                    if i is None:
                        return
                    self._cdll.pq_decode_rowgroup(
                        self._mm, len(self._mm), tasks[i:i + 1], 1)
            except BaseException as e:  # ctypes arg errors: re-raise below
                errors.append(e)

        threads = [threading.Thread(target=run, name=f"pq-decode-{j}",
                                    daemon=True) for j in range(k - 1)]
        for t in threads:
            t.start()
        run()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    # -- public --------------------------------------------------------------
    def read_row_group(self, g: int) -> dict[str, Column]:
        """All schema columns of one row group."""
        failpoint("decode.native.rowgroup")
        template, specs = self._rg_tasks(g)
        tasks = template.copy()
        holds: list[tuple] = []
        for i, (cs, kind, ow, n, max_def, cap, view_dt, _dict_off,
                _unit) in enumerate(specs):
            if kind == 1:
                data = np.empty(cap, dtype=np.uint8)
                offsets = np.empty(n + 1, dtype=np.int32)
                codes = np.empty(n, dtype=np.int32)
                tasks[i, _T_VALUES] = data.ctypes.data
                tasks[i, _T_OFFSETS] = offsets.ctypes.data
                tasks[i, _T_CODES] = codes.ctypes.data
                bufs = (data, offsets, codes)
            else:
                out = np.empty(n, dtype=view_dt)
                tasks[i, _T_VALUES] = out.ctypes.data
                bufs = (out,)
            if max_def:
                val = np.empty(n, dtype=np.uint8)
                tasks[i, _T_VALIDITY] = val.ctypes.data
            else:
                val = None
            holds.append((bufs, val))
        with trace.span("native_rowgroup_decode", group=g,
                        cols=len(specs)):
            self._decode_tasks(tasks, len(specs))
        cols: dict[str, Column] = {}
        refused_with_dict: list = []
        for i, (cs, kind, ow, n, max_def, cap, view_dt, dict_off,
                unit) in enumerate(specs):
            rc = int(tasks[i, _T_RESULT])
            nulls = int(tasks[i, _T_NULLS])
            bufs, val = holds[i]
            validity = val if (max_def and nulls > 0) else None
            if kind == 1 and rc == _E_GROW:
                cols[cs.name] = self._retry_bytearray(
                    g, cs, max(int(tasks[i, _T_NEEDED]), cap * 2), dict_off)
            elif kind == 0 and rc < 0 and dict_off >= 0:
                refused_with_dict.append(cs)
            elif rc < 0 or (kind != 1 and rc != n):
                raise _unsupported(cs.name, f"the decoder refused the "
                                            f"chunk of row group {g} ({rc}: "
                                            f"an encoding outside its "
                                            f"envelope, or a corrupt page)")
            elif kind == 1:
                cols[cs.name] = self._finish_bytearray(
                    cs, rc, int(tasks[i, _T_OUTKIND]), bufs[0], bufs[1],
                    bufs[2], validity, dict_off)
            elif kind == 2:
                cols[cs.name] = Column(
                    cs.name, cs.data_type, bufs[0], None,
                    validity.astype(np.bool_) if validity is not None
                    else None)
            else:
                cols[cs.name] = self._finish_fixed(cs, bufs[0], validity,
                                                   unit)
        # after the decoded columns, where the JAX package appends the
        # columns it reads through arrow
        for cs in refused_with_dict:
            cols[cs.name] = self._all_null_column(g, cs)
        return cols


def dict_encoded_columns(meta: FileMetaData, names) -> tuple:
    """The subset of `names` whose chunks carry a dictionary encoding
    (RLE/PLAIN_DICTIONARY) in EVERY row group.  A writer whose dictionary
    page overflowed partway leaves later pages (or row groups) PLAIN."""
    if meta.num_row_groups == 0:
        return ()
    by_name = {c.path_in_schema: i
               for i, c in enumerate(meta.row_groups[0].columns)}
    out = []
    for name in names:
        idx = by_name.get(name)
        if idx is None:
            continue
        if all({"RLE_DICTIONARY", "PLAIN_DICTIONARY"}
               & set(rg.columns[idx].encoding_names)
               for rg in meta.row_groups):
            out.append(name)
    return tuple(sorted(out))


def slice_columns(cols: dict[str, Column], lo: int,
                  hi: int) -> dict[str, Column]:
    """Row-range views over decoded columns (no gathers).

    Fixed-width slices are numpy views; var-width rebases offsets (small
    copy); dictionary columns slice codes and share the pool — which is
    what makes per-batch slicing of a decoded row group nearly free."""
    out = {}
    for name, c in cols.items():
        validity = c.validity[lo:hi] if c.validity is not None else None
        if c.is_lazy_dict:
            out[name] = Column(
                name, c.ctype, validity=validity,
                dict_enc=DictEnc(c.dict_enc.indices[lo:hi],
                                 pool=c.dict_enc.pool))
        elif c.offsets is not None:
            base = int(c.offsets[lo])
            if base == 0 and c.offsets.dtype == np.int32:
                # first batch of every group: offsets are already
                # zero-based — the view costs nothing, the astype copies
                off = c.offsets[lo:hi + 1]
            else:
                off = (c.offsets[lo:hi + 1] - base).astype(np.int32)
            out[name] = Column(name, c.ctype,
                               c.data[base:int(c.offsets[hi])], off,
                               validity)
        else:
            out[name] = Column(name, c.ctype, c.data[lo:hi], None,
                               validity)
    return out
