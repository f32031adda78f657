"""The port's Parquet route — footer parser, native reader, `fs` storage,
null sink and the recipe writer — against the JAX package's and pyarrow,
on the CPU.  Every comparison is exact.

- The footer's canonical schema equals `arrow_to_table_schema(
  pq.read_schema(f))` for every type the JAX package's reader tests
  write, and the statistics equal pyarrow's.
- `NativeParquetReader` equals the JAX package's on every file case of
  tests/unit/test_parquet_native.py: each type and codec, dictionary
  fallback mid-chunk, all-null columns, data page v2, BOOLEAN PLAIN, the
  DELTA encodings, the grow retry, and column-parallel decode (byte
  identical at every thread count).  A codec the system lacks, an
  unsupported codec and a nested column raise in the port.
- Zone maps prune the same row groups as the JAX package's.
- Whole `fs` -> memory snapshots under bench.py's chain deliver the same
  rows, `completed_rows` and `scan_rows_pruned` as the JAX package.
- The recipe writer's file reads back through pyarrow equal to the data,
  within 1.5x of pyarrow's size for bench.py's columns.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.table import TableDescription as RefDesc
from transferia_tpu.columnar.batch import arrow_to_table_schema
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.factories import make_sinker as ref_make_sinker
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models.transfer import Runtime as RefRuntime
from transferia_tpu.models.transfer import (
    ShardingUploadParams as RefSharding,
)
from transferia_tpu.predicate import parse as ref_parse
from transferia_tpu.providers import file as ref_file
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers import stdout as ref_stdout
from transferia_tpu.providers.parquet_native import (
    NativeParquetReader as RefReader,
)
from transferia_tpu.tasks import SnapshotLoader as RefLoader
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu_torch import native
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.factories import make_sinker
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.models.transfer import (
    Runtime,
    ShardingUploadParams,
)
from transferia_tpu_torch.predicate import parse
from transferia_tpu_torch.providers import file as port_file
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers import stdout as port_stdout
from transferia_tpu_torch.providers.parquet_meta import (
    parquet_metadata,
    reset_file_caches,
    shared_memmap,
)
from transferia_tpu_torch.providers.parquet_native import (
    NativeParquetReader,
    dict_encoded_columns,
    slice_columns,
)
from transferia_tpu_torch.providers.readahead import RowGroupReadahead
from transferia_tpu_torch.recipes.clickbench import (
    clickbench_rows,
    write_clickbench,
)
from transferia_tpu_torch.recipes.parquet_writer import (
    snappy_compress,
    write_parquet,
)
from transferia_tpu_torch.transform import fused as port_tfused

BENCH_CHAIN = {"transformers": [
    {"mask_field": {"columns": ["URL"], "salt": "bench-salt"}},
    {"filter_rows": {"filter": "RegionID < 400 AND ResolutionWidth >= 390"}},
]}
CODEC_IDS = {"NONE": 0, "snappy": 1, "gzip": 2, "zstd": 6}


@pytest.fixture(autouse=True)
def device_placement():
    """Both packages' fused steps take their device strategy (the port's
    on the CPU runs the kernels' plain versions)."""
    for mod in (ref_tfused, port_tfused):
        mod.set_placement("device")
    yield
    for mod in (ref_tfused, port_tfused):
        mod.set_placement(None)


# -- files -------------------------------------------------------------------

def types_table(n: int = 20_000) -> pa.Table:
    """tests/unit/test_parquet_native.py's every-type table."""
    rng = np.random.default_rng(3)
    pool = ["alpha", "", "котики", "x" * 200, "middling"]
    return pa.table({
        "i64": pa.array(rng.integers(0, 2**60, n), type=pa.int64()),
        "i32": pa.array(rng.integers(0, 100, n).astype(np.int32)),
        "i8": pa.array(rng.integers(0, 3, n).astype(np.int8)),
        "i16": pa.array(rng.integers(0, 999, n).astype(np.int16)),
        "f32": pa.array(rng.random(n).astype(np.float32)),
        "f64": pa.array(rng.random(n)),
        "ts_s": pa.array((1_700_000_000 + rng.integers(0, 1000, n)).astype(
            "datetime64[s]")),
        "ts_us": pa.array((1_700_000_000_000_000
                           + rng.integers(0, 1000, n)).astype(
                               "datetime64[us]")),
        "low_str": pa.array([pool[i % 5] for i in range(n)]),
        "hi_str": pa.array([f"url-{i}-{'x' * (i % 37)}" for i in range(n)]),
        "null_str": pa.array([None if i % 11 == 0 else pool[i % 3]
                              for i in range(n)]),
        "null_int": pa.array([None if i % 13 == 0 else i
                              for i in range(n)], type=pa.int64()),
    })


def more_types_table(n: int = 3000) -> pa.Table:
    """Types the reader tests do not write, for the schema mapping."""
    import datetime

    rng = np.random.default_rng(4)
    return pa.table({
        "u8": pa.array(rng.integers(0, 200, n).astype(np.uint8)),
        "u16": pa.array(rng.integers(0, 60_000, n).astype(np.uint16)),
        "u32": pa.array(rng.integers(0, 2**32, n, dtype=np.uint64)
                        .astype(np.uint32)),
        "u64": pa.array(rng.integers(0, 2**63, n, dtype=np.uint64)
                        + np.uint64(2**63)),
        "ts_ms": pa.array((1_700_000_000_000 + np.arange(n)).astype(
            "datetime64[ms]")),
        "ts_ns": pa.array((1_700_000_000_000_000_000 + np.arange(n))
                          .astype("datetime64[ns]")),
        "ts_utc": pa.array(np.arange(n), type=pa.timestamp("us", tz="UTC")),
        "d32": pa.array([datetime.date(2020, 1, 1)
                         + datetime.timedelta(days=i % 400)
                         for i in range(n)]),
        "b": pa.array(rng.random(n) < 0.5),
        "bin": pa.array([bytes([i % 256]) * (i % 5) for i in range(n)]),
        "dec": pa.array([i for i in range(n)], type=pa.decimal128(12, 3)),
        "dict": pa.array([f"d{i % 7}" for i in range(n)])
        .dictionary_encode(),
    })


def write(table: pa.Table, path, **kw) -> str:
    pq.write_table(table, str(path), **kw)
    return str(path)


def reader_pair(path: str, threads: int = 1):
    pf = pq.ParquetFile(path)
    ref = RefReader.open(path, pf, arrow_to_table_schema(pf.schema_arrow),
                         decode_threads=threads)
    assert ref is not None
    meta = parquet_metadata(path)
    return ref, NativeParquetReader(path, meta, meta.table_schema(),
                                    decode_threads=threads), meta


def col_bytes(c) -> dict:
    """A decoded column's buffers (codes and pool, or flat data)."""
    out = {"validity": None if c.validity is None else c.validity.tobytes()}
    if c.is_lazy_dict:
        pool = c.dict_enc.pool
        out.update(codes=c.dict_enc.indices.tobytes(),
                   pool=pool.values_data.tobytes(),
                   pool_off=pool.values_offsets.tobytes())
    else:
        out["data"] = np.asarray(c.data).tobytes()
        if c.offsets is not None:
            out["offsets"] = c.offsets.tobytes()
    return out


def assert_reader_equals_jax(path: str, threads: int = 1) -> None:
    ref, port, meta = reader_pair(path, threads)
    assert meta.num_row_groups == pq.ParquetFile(path).num_row_groups
    for g in range(meta.num_row_groups):
        want = ref.read_row_group(g)
        got = port.read_row_group(g)
        assert list(got) == list(want)
        for name, col in got.items():
            assert col.ctype.value == want[name].ctype.value, name
            assert col.is_lazy_dict == want[name].is_lazy_dict, name
            assert col.to_pylist() == want[name].to_pylist(), (g, name)
            if not col.is_lazy_dict:
                # the JAX package may re-map a pool's codes onto another
                # row group's pool: flat buffers are compared byte for
                # byte, dictionary ones by value (above)
                assert col_bytes(col) == col_bytes(want[name]), (g, name)


def codec_decodable(codec: str) -> bool:
    return bool(native.lib().pq_codec_supported(CODEC_IDS[codec]))


# -- the footer --------------------------------------------------------------

@pytest.mark.parametrize("make", [types_table, more_types_table],
                         ids=["reader_types", "more_types"])
def test_schema_and_statistics_equal_pyarrow(tmp_path, make):
    path = write(make(), tmp_path / "t.parquet", row_group_size=1024)
    meta = parquet_metadata(path)
    want = arrow_to_table_schema(pq.read_schema(path))
    got = meta.table_schema()
    assert [c.name for c in got] == [c.name for c in want]
    for g, w in zip(got, want):
        assert (g.data_type.value, g.required) == \
            (w.data_type.value, w.required), g.name
        assert g.original_type == w.original_type, g.name
    pm = pq.ParquetFile(path).metadata
    assert meta.num_rows == pm.num_rows
    for r, rg in enumerate(meta.row_groups):
        assert rg.num_rows == pm.row_group(r).num_rows
        for i, col in enumerate(rg.columns):
            ref = pm.row_group(r).column(i)
            assert col.path_in_schema == ref.path_in_schema
            assert col.compression == ref.compression
            assert col.encoding_names == ref.encodings
            assert (col.data_page_offset, col.dictionary_page_offset,
                    col.total_compressed_size, col.num_values) == \
                (ref.data_page_offset, ref.dictionary_page_offset,
                 ref.total_compressed_size, ref.num_values)
            st, rst = col.statistics, ref.statistics
            assert (st is None) == (rst is None or not rst.has_min_max) \
                or st.has_min_max == rst.has_min_max
            if st is not None and st.has_min_max:
                if col.path_in_schema == "ts_ns":  # pandas Timestamps
                    assert st.min == rst.min.to_pydatetime(warn=False)
                else:
                    assert (st.min, st.max) == (rst.min, rst.max)
                    assert type(st.min) is type(rst.min)
                assert st.null_count == rst.null_count


def test_arrow_schema_blob_types(tmp_path):
    """large_string (and other types pyarrow restores from its stored
    arrow schema) keep the JAX package's canonical type; original_type
    names the Parquet schema's arrow type."""
    t = pa.table({"ls": pa.array(["a", "b"], type=pa.large_string())})
    path = write(t, tmp_path / "ls.parquet")
    (got,) = parquet_metadata(path).table_schema()
    (want,) = arrow_to_table_schema(pq.read_schema(path))
    assert (got.data_type.value, got.required) == \
        (want.data_type.value, want.required)
    assert (got.original_type, want.original_type) == \
        ("arrow:string", "arrow:large_string")


def test_footer_and_memmap_memoized(tmp_path):
    path = write(pa.table({"i": pa.array([1, 2, 3])}), tmp_path / "m.parquet")
    reset_file_caches()
    meta = parquet_metadata(path)
    assert parquet_metadata(path) is meta
    assert shared_memmap(path) is shared_memmap(path)
    st = os.stat(path)
    write(pa.table({"i": pa.array([1, 2, 3, 4])}), path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert parquet_metadata(path).num_rows == 4


def test_not_parquet_raises(tmp_path):
    bad = tmp_path / "x.parquet"
    bad.write_bytes(b"PAR1" + b"\0" * 20)
    with pytest.raises(ValueError, match="not a Parquet file"):
        parquet_metadata(str(bad))


# -- the reader --------------------------------------------------------------

@pytest.mark.parametrize("codec", ["snappy", "NONE", "zstd", "gzip"])
def test_every_type_and_codec_equals_jax(tmp_path, codec):
    path = write(types_table(), tmp_path / "t.parquet",
                 row_group_size=8192, compression=codec)
    if codec_decodable(codec):
        assert_reader_equals_jax(path)
        return
    # without the system library the JAX package reads through arrow;
    # the port has no arrow route and says so
    with pytest.raises(NotImplementedError, match=codec.upper()):
        reader_pair(path)[1].read_row_group(0)


def fallback_table(n: int = 30_000) -> pa.Table:
    return pa.table({
        "s": pa.array([f"value-{i % 5000}-{'y' * (i % 23)}"
                       for i in range(n)]),
        "k": pa.array(list(range(n)), type=pa.int64()),
    })


def v2_table(n: int = 25_000) -> pa.Table:
    rng = np.random.default_rng(5)
    return pa.table({
        "i": pa.array(rng.integers(0, 10**12, n), type=pa.int64()),
        "s": pa.array([f"v{i % 3000}" for i in range(n)]),
        "f": pa.array(rng.random(n).astype(np.float32)),
        "ni": pa.array([None if i % 7 == 0 else i for i in range(n)],
                       type=pa.int32()),
        "ns": pa.array([None if i % 5 == 0 else f"s{i % 11}"
                        for i in range(n)]),
        "b": pa.array((rng.random(n) < 0.5)),
    })


def delta_table(n: int = 30_000) -> pa.Table:
    rng = np.random.default_rng(7)
    return pa.table({
        "di64": pa.array(np.cumsum(rng.integers(-50, 50, n)),
                         type=pa.int64()),
        "di32": pa.array(rng.integers(-10**6, 10**6, n).astype(np.int32)),
        "ni": pa.array([None if i % 13 == 0 else i * 7 for i in range(n)],
                       type=pa.int64()),
        "dlba": pa.array([f"row-{i}-{'p' * (i % 29)}" for i in range(n)]),
        "dba": pa.array(sorted(f"key-{i % 4096:08d}-{i}" for i in range(n))),
        "nstr": pa.array([None if i % 6 == 0 else f"x{i % 17}"
                          for i in range(n)]),
    })


DELTA_ENCODINGS = {"di64": "DELTA_BINARY_PACKED",
                   "di32": "DELTA_BINARY_PACKED",
                   "ni": "DELTA_BINARY_PACKED",
                   "dlba": "DELTA_LENGTH_BYTE_ARRAY",
                   "dba": "DELTA_BYTE_ARRAY",
                   "nstr": "DELTA_BYTE_ARRAY"}


def bench_envelope_table(n: int = 40_000) -> pa.Table:
    rng = np.random.default_rng(8)
    pool = [f"https://e.test/{i}" for i in range(997)]
    return pa.table({
        "URL": pa.array([pool[i % 997] for i in range(n)]),
        "RegionID": pa.array(rng.integers(0, 1000, n).astype(np.int32)),
        "Age": pa.array(rng.integers(0, 100, n).astype(np.int8)),
        "Interests": pa.array(rng.integers(0, 3000, n).astype(np.int16)),
        "EventTime": pa.array((1_700_000_000 + rng.integers(0, 10**6, n))
                              .astype("datetime64[s]")),
    })


def mixed_table(n: int = 24_000) -> pa.Table:
    rng = np.random.default_rng(11)
    return pa.table({
        "i64": pa.array(rng.integers(0, 2**60, n), type=pa.int64()),
        "i32": pa.array(rng.integers(0, 9, n).astype(np.int32)),
        "f64": pa.array(rng.random(n)),
        "s": pa.array([None if i % 7 == 0 else f"row-{i}-{'x' * (i % 31)}"
                       for i in range(n)]),
        "low": pa.array([f"v{i % 5}" for i in range(n)]),
        "b": pa.array((rng.random(n) < 0.5).tolist()),
    })


FILE_CASES = {
    "dict_fallback_mid_chunk": (fallback_table, dict(
        row_group_size=30_000, compression="snappy",
        dictionary_pagesize_limit=4096, data_page_size=8192)),
    "all_null": (lambda: pa.table({
        "s": pa.array([None] * 1000, type=pa.string()),
        "i": pa.array([None] * 1000, type=pa.int64())}), {}),
    "page_v2_snappy": (v2_table, dict(row_group_size=8192,
                                      compression="snappy",
                                      data_page_version="2.0")),
    "page_v2_none": (v2_table, dict(row_group_size=8192, compression="NONE",
                                    data_page_version="2.0")),
    "page_v2_zstd": (v2_table, dict(row_group_size=8192, compression="zstd",
                                    data_page_version="2.0")),
    "boolean_plain": (lambda: pa.table({
        "b": pa.array(np.random.default_rng(6).random(10_000) < 0.3),
        "nb": pa.array([None if i % 9 == 0 else bool(i % 2)
                        for i in range(10_000)])}),
        dict(row_group_size=4096)),
    "delta_v1": (delta_table, dict(
        row_group_size=8192, compression="snappy", use_dictionary=False,
        data_page_version="1.0", column_encoding=DELTA_ENCODINGS)),
    "delta_v2": (delta_table, dict(
        row_group_size=8192, compression="snappy", use_dictionary=False,
        data_page_version="2.0", column_encoding=DELTA_ENCODINGS)),
    "bench_envelope": (bench_envelope_table, dict(row_group_size=8192,
                                                  compression="snappy")),
    "grow_retry": (lambda: pa.table({
        "s": pa.array([f"{'pad' * (i % 67)}-{i}" for i in range(20_000)]),
        "i": pa.array(list(range(20_000)), type=pa.int64())}),
        dict(row_group_size=20_000, compression="snappy",
             dictionary_pagesize_limit=2048, data_page_size=4096)),
    "slice_views": (lambda: pa.table({
        "s": pa.array([f"row-{i}" for i in range(6000)]),
        "i": pa.array(list(range(6000)), type=pa.int64())}),
        dict(row_group_size=6000, use_dictionary=False)),
}


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("case", sorted(FILE_CASES))
def test_file_case_equals_jax(tmp_path, case, threads):
    make, kw = FILE_CASES[case]
    codec = kw.get("compression", "snappy")
    path = write(make(), tmp_path / f"{case}.parquet", **kw)
    if not codec_decodable(codec):
        with pytest.raises(NotImplementedError):
            reader_pair(path)[1].read_row_group(0)
        return
    assert_reader_equals_jax(path, threads)


@pytest.mark.parametrize("page", ["1.0", "2.0"])
@pytest.mark.parametrize("codec", ["snappy", "NONE", "zstd", "gzip"])
def test_all_null_fixed_chunks_equal_jax(tmp_path, codec, page):
    """Fixed-width chunks whose every value is null carry an empty
    dictionary page, which the fixed-width decoder refuses; the nulls
    come from the pages' definition levels, in every codec and page
    version, beside a row group where the same columns hold values."""
    n = 1000
    t = pa.table({
        "i": pa.array([None] * n + list(range(n)), type=pa.int64()),
        "j": pa.array([None] * n + list(range(n)), type=pa.int32()),
        "d": pa.array([None] * n + [i / 7 for i in range(n)],
                      type=pa.float64()),
        "s": pa.array([None] * 2 * n, type=pa.string()),
    })
    path = write(t, tmp_path / "t.parquet", row_group_size=n,
                 compression=codec, data_page_version=page)
    if not codec_decodable(codec):
        with pytest.raises(NotImplementedError):
            reader_pair(path)[1].read_row_group(0)
        return
    assert_reader_equals_jax(path)


def test_refused_dictionary_chunk_with_values_raises(tmp_path):
    """The all-null check reads the definition levels, not the footer's
    statistics: a chunk holding one value is refused, not emptied."""
    path = write(pa.table({"i": pa.array([None] * 999 + [5],
                                         type=pa.int64())}),
                 tmp_path / "t.parquet")
    meta = parquet_metadata(path)
    schema = meta.table_schema()
    reader = NativeParquetReader(path, meta, schema)
    with pytest.raises(NotImplementedError, match="'i'"):
        reader._all_null_column(0, schema.find("i"))
    assert reader.read_row_group(0)["i"].to_pylist() == [None] * 999 + [5]


def test_column_parallel_decode_byte_identical(tmp_path):
    path = write(mixed_table(), tmp_path / "t.parquet",
                 row_group_size=8192, compression="snappy")
    meta = parquet_metadata(path)
    schema = meta.table_schema()
    readers = {k: NativeParquetReader(path, meta, schema, decode_threads=k)
               for k in (1, 2, 4, 8)}
    for g in range(meta.num_row_groups):
        serial = readers[1].read_row_group(g)
        for k, rdr in readers.items():
            cols = rdr.read_row_group(g)
            assert {n: col_bytes(c) for n, c in cols.items()} == \
                {n: col_bytes(c) for n, c in serial.items()}, (k, g)


def test_slice_columns_views(tmp_path):
    n = 5000
    t = pa.table({
        "s": pa.array([f"s{i % 7}" for i in range(n)]),
        "i": pa.array(list(range(n)), type=pa.int64()),
        "ns": pa.array([None if i % 3 == 0 else f"v{i % 11}"
                        for i in range(n)]),
    })
    path = write(t, tmp_path / "t.parquet", row_group_size=n)
    cols = reader_pair(path)[1].read_row_group(0)
    sl = slice_columns(cols, 100, 164)
    assert sl["i"].to_pylist() == list(range(100, 164))
    assert sl["s"].to_pylist() == [f"s{i % 7}" for i in range(100, 164)]
    assert sl["ns"].to_pylist() == [
        None if i % 3 == 0 else f"v{i % 11}" for i in range(100, 164)]
    if cols["s"].is_lazy_dict:
        assert sl["s"].dict_enc.pool is cols["s"].dict_enc.pool
    first = slice_columns(cols, 0, 128)
    assert sl["i"].data.base is not None
    assert first["ns"].to_pylist()[:3] == [None, "v1", "v2"]


def test_unsupported_codec_raises(tmp_path):
    path = write(pa.table({"i": pa.array(list(range(100)),
                                          type=pa.int64())}),
                 tmp_path / "z.parquet", compression="lz4")
    meta = parquet_metadata(path)
    assert meta.table_schema().names() == ["i"]
    reader = NativeParquetReader(path, meta, meta.table_schema())
    with pytest.raises(NotImplementedError, match="'i'.*LZ4"):
        reader.read_row_group(0)


@pytest.mark.parametrize("column", [
    pa.array([{"a": 1, "b": "x"}] * 10),
    pa.array([[1, 2]] * 10),
], ids=["struct", "list"])
def test_nested_column_raises(tmp_path, column):
    path = write(pa.table({"i": pa.array(range(10)), "n": column}),
                 tmp_path / "n.parquet")
    meta = parquet_metadata(path)
    schema = meta.table_schema()
    assert [c.data_type.value for c in schema] == \
        [c.data_type.value
         for c in arrow_to_table_schema(pq.read_schema(path))]
    with pytest.raises(NotImplementedError, match="'n'"):
        NativeParquetReader(path, meta, schema).read_row_group(0)


def test_dict_encoded_columns(tmp_path):
    path = write(fallback_table(), tmp_path / "f.parquet",
                 row_group_size=10_000, dictionary_pagesize_limit=4096)
    meta = parquet_metadata(path)
    assert dict_encoded_columns(meta, ["s", "k", "absent"]) == ("k", "s")
    schema, fixed, var = clickbench_rows(300_000)
    size, _ = write_clickbench(str(tmp_path / "cb.parquet"), 300_000,
                               (schema, fixed, var))
    cb = parquet_metadata(str(tmp_path / "cb.parquet"))
    # URL and Title never fit a 1 MiB dictionary: they reach the chain flat
    assert dict_encoded_columns(cb, ["URL", "Title", "SearchPhrase"]) == \
        ("SearchPhrase",)


# -- the fs storage ----------------------------------------------------------

def sorted_file(tmp_path) -> str:
    n = 4000
    return write(pa.table({
        "id": pa.array(range(n), type=pa.int64()),
        "region": pa.array(range(n), type=pa.int32()),
        "name": pa.array([f"k-{i:04d}" for i in range(n)]),
        "f": pa.array(np.linspace(0, 1, n)),
        "ts": pa.array((1_700_000_000 + np.arange(n)).astype(
            "datetime64[s]")),
        "maybe": pa.array([None if i < 2000 else i for i in range(n)],
                          type=pa.int64()),
    }), tmp_path / "sorted.parquet", row_group_size=500)


PRUNE_PREDICATES = [
    "region < 750", "region >= 3000 AND region < 3100",
    "region = 1234 OR region > 3900", "region IN (5, 3500)",
    "name < 'k-0100'", "name >= 'k-3990'", "f > 0.9", "ts < 5",
    "maybe IS NULL", "maybe IS NOT NULL", "region BETWEEN 10 AND 20",
    "NOT region < 750", "region != 3",
]


@pytest.mark.parametrize("pred", PRUNE_PREDICATES)
def test_zone_maps_prune_as_jax(tmp_path, pred):
    path = sorted_file(tmp_path)
    out = []
    for mod, desc, tid, prs in ((port_file, TableDescription, TableID,
                                 parse),
                                (ref_file, RefDesc, RefTableID, ref_parse)):
        st = mod.FileStorage(mod.FileSourceParams(
            path=path, format="parquet", table="s", batch_rows=500))
        st.set_scan_predicate(st.table, prs(pred))
        rows = []
        st.load_table(desc(id=st.table),
                      lambda b: rows.extend(b.column("id").to_pylist()))
        out.append((st.scan_rows_pruned, rows))
    assert out[0] == out[1]
    assert out[0][0] + len(out[0][1]) == 4000


def test_shards_and_row_counts_equal_jax(tmp_path):
    path = write(mixed_table(), tmp_path / "t.parquet", row_group_size=1000)
    for workers in (1, 4):
        for per_part in (0, 1, 3):
            got, want = (
                (mod.FileStorage(mod.FileSourceParams(
                    path=path, rowgroups_per_part=per_part),
                    upload_workers=workers), desc, tid)
                for mod, desc, tid in ((port_file, TableDescription,
                                        TableID),
                                       (ref_file, RefDesc, RefTableID)))
            parts = [(d.filter, d.eta_rows) for d in got[0].shard_table(
                got[1](id=got[2]("fs", "data")))]
            assert parts == [(d.filter, d.eta_rows)
                             for d in want[0].shard_table(
                                 want[1](id=want[2]("fs", "data")))]
            assert got[0].estimate_table_rows_count(got[0].table) == \
                want[0].estimate_table_rows_count(want[0].table) == 24_000


def test_unported_routes_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="A7"):
        port_file.FileStorage(port_file.FileSourceParams(format="csv"))
    t = Transfer(id="fs-sink", src=port_file.FileSourceParams(),
                 dst=port_file.FileTargetParams(path=str(tmp_path)))
    # the fs sink's parquet writer is pyarrow's; its jsonl route is
    # ported (tests/test_torch_partitioned.py)
    with pytest.raises(NotImplementedError, match="fs sink.*A7"):
        make_sinker(t, device="cpu")
    t.dst.format = "jsonl"
    assert make_sinker(t, device="cpu") is not None
    path = write(pa.table({"i": pa.array(range(2_000_000))}),
                 tmp_path / "huge.parquet", row_group_size=2_000_000)
    st = port_file.FileStorage(port_file.FileSourceParams(path=path))
    with pytest.raises(NotImplementedError, match="row groups over"):
        st.load_table(TableDescription(id=st.table), lambda b: None)


def test_readahead_order_errors_and_cancel():
    seen = []

    def decode(g):
        if g == 7:
            raise KeyError(g)
        return g * 10

    with RowGroupReadahead(range(5), decode, max_groups=2) as ra:
        for g, item in ra:
            seen.append((g, item))
    assert seen == [(g, g * 10) for g in range(5)]
    with pytest.raises(KeyError):
        with RowGroupReadahead(range(10), decode, max_groups=3) as ra:
            list(ra)
    with RowGroupReadahead(range(100), decode, max_groups=2) as ra:
        assert next(ra) == (0, 0)  # leaving early cancels the rest
    assert list(RowGroupReadahead([3], decode, max_groups=0)) == [(3, 30)]


# -- whole snapshots ---------------------------------------------------------

def pyarrow_clickbench(path: str, n: int) -> str:
    schema, fixed, var = clickbench_rows(n)
    cols = {}
    for cs in schema:
        if cs.name in var:
            data, off = var[cs.name]
            cols[cs.name] = pa.array([data[off[i]:off[i + 1]].tobytes()
                                      .decode() for i in range(n)])
        elif cs.name == "EventTime":
            cols[cs.name] = pa.array(fixed[cs.name].astype("datetime64[s]"))
        else:
            cols[cs.name] = pa.array(fixed[cs.name])
    return write(pa.table(cols), path, row_group_size=8192,
                 compression="snappy")


def run_snapshot(pkg: str, path: str, workers: int, sid: str):
    """bench.py's make_transfer shape into the memory sink; returns
    (completed rows, scan_rows_pruned, the sink's rows by WatchID)."""
    if pkg == "port":
        mod, mem, transfer, runtime, sharding, coord, loader, kw = (
            port_file, port_memory, Transfer, Runtime, ShardingUploadParams,
            MemoryCoordinator, lambda t, cp, **k: port_loader(t, cp, **k),
            {"device": "cpu"})
    else:
        mod, mem, transfer, runtime, sharding, coord, loader, kw = (
            ref_file, ref_memory, RefTransfer, RefRuntime, RefSharding,
            RefCoordinator, RefLoader, {})
    storages = []
    storage = mod.FileProvider.storage

    def capture(provider):
        st = storage(provider)
        storages.append(st)
        return st

    mem.get_store(sid).clear()
    t = transfer(id=sid, src=mod.FileSourceParams(
        path=path, format="parquet", table="hits", batch_rows=4096),
        dst=mem.MemoryTargetParams(sink_id=sid),
        transformation=BENCH_CHAIN,
        runtime=runtime(sharding=sharding(process_count=workers)))
    cp = coord()
    mod.FileProvider.storage = capture
    try:
        loader(t, cp, operation_id=f"op-{sid}", **kw).upload_tables()
    finally:
        mod.FileProvider.storage = storage
    rows = sorted((tuple(it.as_dict().items())
                   for it in mem.get_store(sid).rows()),
                  key=lambda r: r[0][1])
    mem.get_store(sid).clear()
    return (cp.operation_progress(f"op-{sid}").completed_rows,
            sum(st.scan_rows_pruned for st in storages), rows)


def port_loader(t, cp, **kw):
    from transferia_tpu_torch.tasks import SnapshotLoader

    return SnapshotLoader(t, cp, **kw)


@pytest.mark.parametrize("writer", ["pyarrow", "recipe"])
@pytest.mark.parametrize("workers", [1, 4])
def test_fs_snapshot_equals_jax(tmp_path, writer, workers):
    n = 40_000
    path = str(tmp_path / f"{writer}.parquet")
    if writer == "pyarrow":
        pyarrow_clickbench(path, n)
        kept = None
    else:
        _, kept = write_clickbench(path, n)
    got = run_snapshot("port", path, workers, f"port-{writer}-{workers}")
    want = run_snapshot("jax", path, workers, f"jax-{writer}-{workers}")
    assert got[:2] == want[:2]
    assert got[2] == want[2]
    schema, fixed, _ = clickbench_rows(n)
    keep = (fixed["RegionID"] < 400) & (fixed["ResolutionWidth"] >= 390)
    assert got[0] == int(keep.sum()) == len(got[2])
    assert got[0] + got[1] == n
    if kept is not None:
        assert kept == got[0]
    assert sorted(dict(r)["WatchID"] for r in got[2]) == \
        sorted(fixed["WatchID"][keep].tolist())
    assert all(len(dict(r)["URL"]) == 64 for r in got[2])


def test_null_and_stdout_sinks_equal_jax(capsys):
    from tests.test_torch_replication import typed_columns
    from transferia_tpu.abstract.schema import new_table_schema as ref_schema
    from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
    from transferia_tpu_torch.columnar.batch import ColumnBatch

    cols = typed_columns(np.random.default_rng(9), 50)
    spec = [(name, t) for name, (t, _) in cols.items()
            if t not in ("any",)]
    data = {name: cols[name][1] for name, _ in spec}
    batch = ColumnBatch.from_pydict(TableID("", "t"),
                                    new_table_schema(spec), data)
    ref = RefBatch.from_pydict(RefTableID("", "t"), ref_schema(spec), data)
    null, ref_null = port_stdout.NullSinker(), ref_stdout.NullSinker()
    null.push(batch)
    ref_null.push(ref)
    assert (null.total_rows, null.total_bytes) == \
        (ref_null.total_rows, ref_null.total_bytes)
    out = []
    for mod, b in ((port_stdout, batch), (ref_stdout, ref)):
        mod.StdoutSinker(mod.StdoutTargetParams(verbose=True,
                                                max_rows_printed=3)).push(b)
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    for mod, mk, kw in ((port_stdout, make_sinker, {"device": "cpu"}),
                        (ref_stdout, ref_make_sinker, {})):
        tr = Transfer if mod is port_stdout else RefTransfer
        src = port_file if mod is port_stdout else ref_file
        sink = mk(tr(id="null", src=src.FileSourceParams(),
                     dst=mod.NullTargetParams()), **kw)
        sink.push(batch if mod is port_stdout else ref)
        sink.close()


# -- the recipe writer -------------------------------------------------------

def test_recipe_writer_read_back_by_pyarrow(tmp_path):
    n = 262_144
    schema, fixed, var = clickbench_rows(n)
    path = str(tmp_path / "cb.parquet")
    size, kept = write_clickbench(path, n, (schema, fixed, var))
    assert size == os.path.getsize(path)
    t = pq.read_table(path)
    assert [str(f.type) for f in t.schema] == [
        "int64", "int64", "int32", "int32", "timestamp[ms]", "int32",
        "int8", "string", "string", "string"]
    for name, arr in fixed.items():
        got = t.column(name).to_numpy()
        if name == "EventTime":
            got = got.astype("datetime64[s]").astype(np.int64)
        assert np.array_equal(got, arr), name
    for name, (data, off) in var.items():
        assert t.column(name).to_pylist() == [
            data[off[i]:off[i + 1]].tobytes().decode() for i in range(n)]
    pf = pq.ParquetFile(path)
    assert pf.metadata.num_row_groups == 2
    assert {pf.metadata.row_group(0).column(i).compression
            for i in range(10)} == {"SNAPPY"}
    # the same columns as pyarrow writes them
    ref = pyarrow_clickbench(str(tmp_path / "pa.parquet"), n)
    pq.write_table(pq.read_table(ref), ref, row_group_size=131_072,
                   compression="snappy")
    assert size <= 1.5 * os.path.getsize(ref)
    # statistics pyarrow trusts, as it reads its own
    st = pf.metadata.row_group(0).column(3).statistics
    assert st.has_min_max and (st.min, st.max) == (0, 499)
    assert kept == int(((fixed["RegionID"] < 400)
                        & (fixed["ResolutionWidth"] >= 390)).sum())


@pytest.mark.parametrize("row_group_rows", [1000, 3000])
def test_recipe_writer_edges(tmp_path, row_group_rows):
    n = 3000
    rng = np.random.default_rng(12)
    schema = new_table_schema([("i16", "int16"), ("f", "double"),
                               ("ts", "timestamp"), ("s", "utf8"),
                               ("e", "utf8")])
    strings = [("é" * (i % 9)).encode() for i in range(n)]
    data = np.frombuffer(b"".join(strings), dtype=np.uint8)
    off = np.zeros(n + 1, dtype=np.int32)
    np.cumsum([len(s) for s in strings], out=off[1:])
    cols = {"i16": rng.integers(-30_000, 30_000, n).astype(np.int16),
            "f": rng.random(n),
            "ts": rng.integers(0, 2**50, n, dtype=np.int64),
            "s": (data, off),
            "e": (np.zeros(0, dtype=np.uint8), np.zeros(n + 1, np.int32))}
    path = str(tmp_path / "e.parquet")
    # a dictionary limit of 64 bytes: s and ts go PLAIN, i16 too
    write_parquet(path, schema, cols, n, row_group_rows=row_group_rows,
                  dictionary_limit=64, data_page_bytes=4096)
    t = pq.read_table(path)
    assert t.column("i16").to_numpy().tolist() == cols["i16"].tolist()
    assert t.column("f").to_numpy().tolist() == cols["f"].tolist()
    assert t.column("ts").cast(pa.int64()).to_numpy().tolist() == \
        cols["ts"].tolist()
    assert t.column("s").to_pylist() == [s.decode() for s in strings]
    assert t.column("e").to_pylist() == [""] * n
    meta = parquet_metadata(path)
    assert meta.table_schema() == arrow_to_table_schema_port(path)
    ref, port, _ = reader_pair(path)
    for g in range(meta.num_row_groups):
        a, b = ref.read_row_group(g), port.read_row_group(g)
        assert {k: c.to_pylist() for k, c in a.items()} == \
            {k: c.to_pylist() for k, c in b.items()}


def arrow_to_table_schema_port(path: str):
    """The JAX package's schema of a file, as the port's TableSchema."""
    from transferia_tpu_torch.abstract.schema import ColSchema, TableSchema
    from transferia_tpu_torch.abstract.schema import CanonicalType

    return TableSchema([
        ColSchema(name=c.name, data_type=CanonicalType(c.data_type.value),
                  required=c.required, original_type=c.original_type)
        for c in arrow_to_table_schema(pq.read_schema(path))])


@pytest.mark.parametrize("size", [0, 1, 7, 100, 70_000, 300_000])
def test_snappy_compressor_round_trips_and_matches(size):
    rng = np.random.default_rng(size)
    words = [b"https://example-", b".com/page/", b"Title ", b"0123456789"]
    data = b"".join(words[int(i)] for i in rng.integers(0, 4, size // 8 + 1)
                    )[:size]
    noise = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    for raw in (data, noise):
        comp = snappy_compress(raw)
        assert pa.decompress(comp, codec="snappy",
                             decompressed_size=len(raw)).to_pybytes() == raw
        assert len(comp) <= 32 + len(raw) + len(raw) // 6
    if size >= 70_000:
        # repetitive text compresses: copies, not literals only
        assert len(snappy_compress(data)) < len(data) // 2
