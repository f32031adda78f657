"""The port's C++ host library (`transferia_tpu_torch.native`) against the
JAX package's library and against the port's pure Python/numpy routes,
on the CPU.  Every comparison is exact (bytes and integers equal).

Covered: every bound entry point on random and edge inputs (empty, one
byte, the 55/56/64-byte SHA padding boundaries, keys longer than a
block, nulls), the routed callers (Kafka CRC32C and record batches,
RowBinary varints and scatter, the host HMAC, the gathers under
`ColumnBatch.take`/`filter`, the fused step's SHA-block pack; the
RowBinary batch bytes are held in tests/test_torch_replication.py),
corrupted Kafka batches, the Parquet chunk entry points, and the build:
verbatim
sources, a digest-named output, concurrent first builds, and a failed
build or a missing symbol raising.
"""

import ctypes
import functools
import gzip
import hashlib
import hmac
import struct
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from transferia_tpu import native as ref_native
from transferia_tpu.providers.kafka import protocol as ref_protocol
from transferia_tpu.transform.plugins import mask as ref_mask
from transferia_tpu_torch import native
from transferia_tpu_torch.abstract.schema import CanonicalType
from transferia_tpu_torch.columnar.batch import (
    Column,
    _gather_fixed,
    _gather_varwidth,
    _gather_varwidth_plain,
)
from transferia_tpu_torch.ops.fused import (
    pack_hmac_blocks,
    pack_hmac_blocks_plain,
)
from transferia_tpu_torch.providers.clickhouse import rowbinary
from transferia_tpu_torch.providers.kafka import protocol
from transferia_tpu_torch.transform.plugins import mask
from tests.torch_reflib import build_reference_library

EDGE_LENS = (0, 1, 54, 55, 56, 57, 63, 64, 65, 119, 120, 200)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    ref = build_reference_library(tmp_path_factory.mktemp("reflib"))
    assert ref is not None, "the JAX package's host library must load"
    return native.lib(), ref


def flat(values: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(values) + 1, dtype=np.int32)
    np.cumsum([len(v) for v in values], out=offsets[1:])
    data = np.frombuffer(b"".join(values), dtype=np.uint8).copy()
    return data, offsets


def random_values(rng, n: int, max_len: int = 90) -> list[bytes]:
    return [rng.integers(0, 256, int(rng.integers(0, max_len)),
                         dtype=np.uint8).tobytes() for _ in range(n)]


def test_sources_are_the_jax_packages(tmp_path):
    """hostops.cpp, parquetdec.cpp and parquetdec_ba.inc are verbatim
    copies, and the library's name digests every one of them."""
    for name in ("hostops.cpp", "parquetdec.cpp", "parquetdec_ba.inc"):
        assert (native.CSRC / name).read_bytes() == \
            (ref_native._DIR / name).read_bytes(), name
    path = native.library_path("hostops", native.HOSTOPS_SOURCES,
                               native.HOSTOPS_DEPS)
    inc = tmp_path / "parquetdec_ba.inc"
    inc.write_bytes(native.HOSTOPS_DEPS[0].read_bytes() + b"\n")
    assert native.library_path("hostops", native.HOSTOPS_SOURCES,
                               (inc,)) != path


def test_the_port_maps_its_own_build(libs):
    port, _ = libs
    assert str(native.BUILD_DIR) in port._name
    assert "transferia_tpu/native" not in port._name


# -- the plain entry points --------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 1000])
def test_leb128_equals_jax_and_numpy(libs, n):
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 2**63, n, dtype=np.uint64) >> \
        rng.integers(0, 63, n, dtype=np.uint64)
    if n:
        vals[:4 if n >= 4 else n] = [0, 127, 128, 2**64 - 1][:min(n, 4)]
    outs = []
    for lib in libs:
        out = np.zeros(n * 10, dtype=np.uint8)
        lens = np.zeros(n, dtype=np.int32)
        total = lib.leb128_encode(vals, n, out, lens)
        outs.append((out[:total].tobytes(), lens.tolist()))
    assert outs[0] == outs[1]
    got = rowbinary._encode_varints(vals)
    assert got[0].tobytes() == outs[0][0]
    assert got[1].tolist() == outs[0][1]
    # the numpy route sizes varints in int64: the caller's values (byte
    # lengths) stay far below 2**63
    small = vals[vals < 2**63]
    got = rowbinary._encode_varints(small)
    plain = rowbinary._encode_varints_plain(small)
    assert got[0].tobytes() == plain[0].tobytes()
    assert got[1].tolist() == plain[1].tolist()


@pytest.mark.parametrize("n", [0, 1, 500])
def test_scatter_bytes_equals_jax_and_numpy(libs, n):
    rng = np.random.default_rng(10 + n)
    lens = rng.integers(0, 30, n).astype(np.int64)
    src = rng.integers(0, 256, int(lens.sum()) or 1, dtype=np.uint8)
    src_off = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=src_off[1:]) if n > 1 else None
    gaps = rng.integers(0, 5, n).astype(np.int64)
    dst_off = np.zeros(n, dtype=np.int64)
    np.cumsum((lens + gaps)[:-1], out=dst_off[1:]) if n > 1 else None
    size = int((lens + gaps).sum()) + 1
    outs = []
    for lib in libs:
        out = np.zeros(size, dtype=np.uint8)
        lib.scatter_bytes(src, src_off, dst_off, lens, n, out)
        outs.append(out)
    plain = np.zeros(size, dtype=np.uint8)
    rowbinary._scatter_plain(src, src_off, dst_off, lens, plain)
    assert outs[0].tobytes() == outs[1].tobytes() == plain.tobytes()


@pytest.mark.parametrize("n", [0, 1, 400])
def test_gathers_equal_jax_and_numpy(libs, n):
    rng = np.random.default_rng(20 + n)
    data, offsets = flat(random_values(rng, max(n, 1)))
    k = len(offsets) - 1
    idx = rng.integers(0, k, n).astype(np.int64)
    outs = []
    for lib in libs:
        o1 = np.zeros(n + 1, dtype=np.int32)
        total = lib.gather_var_offsets(offsets, idx, n, o1)
        b1 = np.zeros(total, dtype=np.uint8)
        lib.gather_var_bytes(data, offsets, idx, n, o1, b1)
        b2 = np.zeros(total, dtype=np.uint8)
        o2 = np.zeros(n + 1, dtype=np.int32)
        assert lib.gather_varwidth(data, offsets, idx, n, b2, o2) == total
        outs.append((o1.tobytes(), b1.tobytes(), o2.tobytes(),
                     b2.tobytes()))
    assert outs[0] == outs[1]
    got = _gather_varwidth(data, offsets, idx)
    plain = _gather_varwidth_plain(data, offsets, idx)
    assert got[0].tobytes() == plain[0].tobytes() == outs[0][1]
    assert got[1].tobytes() == plain[1].tobytes() == outs[0][0]
    for dtype in (np.bool_, np.int8, np.int16, np.int32, np.int64,
                  np.float32, np.float64):
        fixed = rng.integers(0, 100, k).astype(dtype)
        want = fixed[idx]
        got = _gather_fixed(fixed, idx)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        out = [np.zeros(n, dtype=dtype) for _ in libs]
        for lib, o in zip(libs, out):
            lib.gather_fixed(fixed.view(np.uint8), idx, n,
                             fixed.dtype.itemsize, o.view(np.uint8))
        assert out[0].tobytes() == out[1].tobytes() == want.tobytes()


def test_gathers_keep_numpy_index_semantics():
    data = np.arange(10, dtype=np.int64)
    assert _gather_fixed(data, np.array([-1, 0, -10])).tolist() == \
        data[[-1, 0, -10]].tolist()
    assert _gather_fixed(data, []).tolist() == []
    for bad in ([10], [-11], [3, 99]):
        with pytest.raises(IndexError):
            _gather_fixed(data, np.array(bad))
        with pytest.raises(IndexError):
            data[np.array(bad)]
    vd, vo = flat([b"a", b"bc", b"def"])
    got = _gather_varwidth(vd, vo, np.array([-1, 0]))
    assert got[0].tobytes() == b"defa"
    with pytest.raises(IndexError):
        _gather_varwidth(vd, vo, np.array([3]))
    col = Column("s", CanonicalType.UTF8, vd, vo)
    assert col.take(np.array([2, 2, 0])).to_pylist() == ["def", "def", "a"]


@pytest.mark.parametrize("max_blocks", [1, 2, 4])
def test_pack_sha_blocks_equals_jax_and_numpy(libs, max_blocks):
    rng = np.random.default_rng(max_blocks)
    cap = max_blocks * 64 - 9
    values = [bytes(rng.integers(0, 256, min(n, cap), dtype=np.uint8))
              for n in EDGE_LENS] + random_values(rng, 50, cap + 1)
    data, offsets = flat(values)
    n = len(values)
    outs = []
    for lib in libs:
        out = np.zeros((n, max_blocks * 64), dtype=np.uint8)
        nb = np.zeros(n, dtype=np.int32)
        lib.pack_sha_blocks(data, offsets, n, max_blocks * 64, 64, out, nb)
        outs.append((out.tobytes(), nb.tobytes()))
    assert outs[0] == outs[1]
    got = pack_hmac_blocks(data, offsets, max_blocks)
    plain = pack_hmac_blocks_plain(data, offsets, max_blocks)
    assert got[0].tobytes() == plain[0].tobytes() == outs[0][0]
    assert got[1].tobytes() == plain[1].tobytes() == outs[0][1]
    # a row that does not fit the bucket raises, as the numpy pack does
    long_data, long_off = flat([b"x" * (cap + 1)])
    for pack in (pack_hmac_blocks, pack_hmac_blocks_plain):
        with pytest.raises(ValueError, match="SHA blocks"):
            pack(long_data, long_off, max_blocks)


@pytest.mark.parametrize("key", [b"", b"k", b"bench-salt", b"K" * 64,
                                 b"L" * 65, b"M" * 100])
def test_hmac_equals_jax_hashlib_and_python(libs, key):
    rng = np.random.default_rng(len(key))
    values = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
              for n in EDGE_LENS] + random_values(rng, 40, 300)
    data, offsets = flat(values)
    validity = rng.random(len(values)) < 0.8
    for valid in (None, validity):
        got = mask._host_hmac_hex(key, data, offsets, valid)
        plain = mask._host_hmac_hex_py(key, data, offsets, valid)
        ref = ref_mask._host_hmac_hex(key, data, offsets, valid)
        assert got[0].tobytes() == plain[0].tobytes() == ref[0].tobytes()
        assert got[1].tolist() == plain[1].tolist() == ref[1].tolist()
    want = [hmac.new(key, v, hashlib.sha256).hexdigest().encode()
            for v in values]
    got, off = mask._host_hmac_hex(key, data, offsets, None)
    assert [got[off[i]:off[i + 1]].tobytes()
            for i in range(len(values))] == want
    empty = mask._host_hmac_hex(key, np.zeros(0, np.uint8),
                                np.zeros(1, np.int32), None)
    assert empty[0].size == 0 and empty[1].tolist() == [0]
    # the key states and the raw entry point, both libraries
    states = mask.hmac_key_states(key)
    block = np.zeros(64, dtype=np.uint8)
    k = hashlib.sha256(key).digest() if len(key) > 64 else key
    block[:len(k)] = np.frombuffer(k, dtype=np.uint8)
    outs = []
    for lib in libs:
        st = np.zeros(8, dtype=np.uint32)
        lib.sha256_block_state(np.ascontiguousarray(block ^ 0x36), st)
        assert st.tolist() == states[0].tolist()
        hexes = np.zeros((len(values), 64), dtype=np.uint8)
        lib.hmac_sha256_hex(data, offsets, len(values), states[0],
                            states[1], None, hexes)
        outs.append(hexes.tobytes())
    assert outs[0] == outs[1] == b"".join(want)


def test_rowhash_entry_points_equal_jax(libs):
    rng = np.random.default_rng(30)
    n = 777
    values = random_values(rng, n, 150)
    data, offsets = flat(values)
    width = 64 * ((150 + 9 + 63) // 64)
    pw1 = rng.integers(0, 2**32, width + 1, dtype=np.uint32)
    pw2 = rng.integers(0, 2**32, width + 1, dtype=np.uint32)
    u = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(4)]
    codes = rng.integers(0, n, n).astype(np.int32)
    outs = []
    for lib in libs:
        got = []
        o = [np.zeros(n, dtype=np.uint32) for _ in range(2)]
        lib.polyhash_varcol(data, offsets, n, pw1, pw2, *o)
        got += [x.tobytes() for x in o]
        for fn, extra in (("rowhash_mix_fixed", ()), ("rowhash_mix_var", ())):
            o = [np.zeros(n, dtype=np.uint32) for _ in range(2)]
            getattr(lib, fn)(u[0], u[1], n, 0x9E3779B9, 0x7F4A7C15, *o)
            got += [x.tobytes() for x in o]
        o = [np.zeros(n, dtype=np.uint32) for _ in range(2)]
        lib.rowhash_dict_lanes(u[0], u[1], codes, n, 1, 2, *o)
        got += [x.tobytes() for x in o]
        r = [u[2].copy(), u[3].copy()]
        lib.rowhash_accum(u[0], u[1], n, *r)
        got += [x.tobytes() for x in r]
        outs.append(got)
    assert outs[0] == outs[1]


# -- the Kafka wire ----------------------------------------------------------

@pytest.mark.parametrize("data", [b"", b"\x00", b"123456789",
                                  bytes(range(256)) * 9])
def test_crc32c_equals_jax_and_python(libs, data):
    assert protocol.crc32c(data) == protocol.crc32c_py(data) == \
        ref_protocol.crc32c(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    assert libs[0].crc32c_buf(arr, len(data), 7) == \
        libs[1].crc32c_buf(arr, len(data), 7)


def test_crc32c_batch_equals_jax(libs):
    rng = np.random.default_rng(40)
    keys = [b""] + random_values(rng, 60) + [b"x"]
    got = protocol.crc32c_batch(keys)
    assert got.tolist() == [protocol.crc32c_py(k) for k in keys]
    data, offsets = flat(keys)
    ref = np.zeros(len(keys), dtype=np.uint32)
    libs[1].crc32c_batch(data, offsets.astype(np.int64), len(keys), ref)
    assert got.tolist() == ref.tolist()
    assert protocol.crc32c_batch([]).tolist() == []


def kafka_records(rec_cls, rng, n: int, headers: bool = False):
    out = []
    for i in range(n):
        key = None if i % 7 == 3 else f"k{i}".encode()
        value = None if i % 11 == 5 else rng.integers(
            0, 256, int(rng.integers(0, 200)), dtype=np.uint8).tobytes()
        out.append(rec_cls(key=key, value=value,
                           timestamp_ms=1_700_000_000_000 + (i % 5) * 3,
                           headers=[(b"h", b"v")] if headers and i == 2
                           else []))
    return out


@pytest.mark.parametrize("headers", [False, True])
@pytest.mark.parametrize("compression", ["", "gzip"])
def test_record_batches_equal_jax_and_python(headers, compression,
                                             monkeypatch):
    # gzip stamps the current second into its header: pin it, or two
    # encodes a second apart differ
    monkeypatch.setattr(gzip, "compress",
                        functools.partial(gzip.compress, mtime=0))
    rng = np.random.default_rng(50)
    recs = kafka_records(protocol.Record, rng, 120, headers)
    rng = np.random.default_rng(50)
    ref_recs = kafka_records(ref_protocol.Record, rng, 120, headers)
    blob = protocol.encode_record_batch(recs, base_offset=9,
                                        compression=compression)
    assert blob == ref_protocol.encode_record_batch(
        ref_recs, base_offset=9, compression=compression)
    if not headers:
        now = 1_700_000_000_000
        assert protocol._encode_records_native(recs, now, now) == \
            protocol.encode_records_py(recs, now, now)
    two = blob + protocol.encode_record_batch(recs[:3], base_offset=200)
    got = protocol.decode_record_batches(two)
    plain = protocol.decode_record_batches_py(two)
    ref = ref_protocol.decode_record_batches(two)
    state = [(r.key, r.value, r.offset, r.timestamp_ms, r.headers)
             for r in got]
    assert state == [(r.key, r.value, r.offset, r.timestamp_ms, r.headers)
                     for r in plain]
    assert state == [(r.key, r.value, r.offset, r.timestamp_ms, r.headers)
                     for r in ref]
    assert len(got) == 123


def test_kafka_scan_and_encode_entry_points_equal_jax(libs):
    rng = np.random.default_rng(51)
    recs = kafka_records(protocol.Record, rng, 64)
    blob = protocol.encode_record_batch(recs, base_offset=3)
    arr = np.frombuffer(blob, dtype=np.uint8)
    outs = []
    for lib in libs:
        o = np.zeros(64 * 6, dtype=np.int64)
        assert lib.kafka_scan_records(arr, len(blob), o, 64) == 64
        outs.append(o.tobytes())
    assert outs[0] == outs[1]
    assert protocol.decode_record_batches(b"") == []
    assert protocol.decode_record_batches(blob[:40]) == []  # partial frame


def test_corrupted_batches_raise_or_stay_well_formed():
    """As tests/unit/test_native_corruption.py holds the JAX scanner:
    a flipped byte is a ValueError (CRC or framing) or a decode whose
    records are well formed, and the port agrees with the JAX package
    on which."""
    rng = np.random.default_rng(78)
    recs = [protocol.Record(key=f"k{i}".encode(), value=(b"v%d" % i) * 9,
                            timestamp_ms=1_753_000_000_000)
            for i in range(300)]
    clean = protocol.encode_record_batch(recs, base_offset=5)
    for trial in range(120):
        buf = bytearray(clean)
        buf[int(rng.integers(0, len(buf)))] ^= int(rng.integers(1, 256))
        outcome = []
        for decode in (protocol.decode_record_batches,
                       ref_protocol.decode_record_batches):
            try:
                out = decode(bytes(buf))
            except (ValueError, struct.error, IndexError) as e:
                outcome.append(type(e).__name__)
                continue
            for r in out:
                assert r.value is None or isinstance(r.value, bytes)
                assert r.offset >= 0
            outcome.append([(r.key, r.value, r.offset) for r in out])
        assert outcome[0] == outcome[1], trial


def test_kafka_encode_entry_point_equals_jax(libs):
    keys = [b"a", b"", b"bcd"]
    vals = [b"1", b"22", b""]
    key_data, key_off = flat(keys)
    val_data, val_off = flat(vals)
    key_null = np.array([0, 1, 0], dtype=np.uint8)
    val_null = np.array([0, 0, 1], dtype=np.uint8)
    ts = np.array([0, 5, 9], dtype=np.int64)
    outs = []
    for lib in libs:
        out = np.zeros(512, dtype=np.uint8)
        rc = lib.kafka_encode_records(
            key_data, key_off.astype(np.int64), key_null.ctypes.data,
            val_data, val_off.astype(np.int64), val_null.ctypes.data,
            ts.ctypes.data, 3, out, 512)
        outs.append(out[:rc].tobytes())
    assert outs[0] == outs[1] and len(outs[0]) > 0


def test_avro_decode_flat_equals_jax(libs):
    def zz(v):
        u = (v << 1) ^ (v >> 63)
        out = bytearray()
        while True:
            b = u & 0x7F
            u >>= 7
            out.append(b | (0x80 if u else 0))
            if not u:
                return bytes(out)

    # fields: long id, ["null", string] name, double score, boolean flag
    msgs = []
    for i in range(50):
        body = zz(i * 1_000_003)
        body += zz(0) if i % 4 == 0 else zz(1) + zz(6) + f"n{i:05d}".encode()
        body += struct.pack("<d", i * 1.5) + bytes([i % 2])
        msgs.append(body)
    msgs.append(b"\x01")  # malformed: returns -(51)
    ftypes = np.array([2, 5, 4, 1], dtype=np.uint8)
    nullable = np.array([0, 1, 0, 0], dtype=np.uint8)
    nullbranch = np.array([0, 0, 0, 0], dtype=np.uint8)
    for count in (50, 51):
        data, offs = flat(msgs[:count])
        outs = []
        for lib in libs:
            ids = np.zeros(count, dtype=np.int64)
            sdata = np.zeros(4096, dtype=np.uint8)
            soff = np.zeros(count + 1, dtype=np.int32)
            sval = np.zeros(count, dtype=np.uint8)
            score = np.zeros(count, dtype=np.float64)
            flag = np.zeros(count, dtype=np.uint8)
            tasks = np.zeros((4, 6), dtype=np.int64)
            tasks[0, 0] = ids.ctypes.data
            tasks[1, 1:5] = [sdata.ctypes.data, soff.ctypes.data, 4096,
                             sval.ctypes.data]
            tasks[2, 0] = score.ctypes.data
            tasks[3, 0] = flag.ctypes.data
            rc = lib.avro_decode_flat(data, offs.astype(np.int64), count,
                                      ftypes, nullable, nullbranch, 4,
                                      tasks)
            outs.append((rc, ids.tobytes(), sdata.tobytes(), soff.tobytes(),
                         sval.tobytes(), score.tobytes(), flag.tobytes()))
        assert outs[0] == outs[1]
        assert outs[0][0] == (50 if count == 50 else -51)


# -- the Parquet chunk entry points ------------------------------------------

def test_parquet_entry_points_equal_jax(libs, tmp_path):
    from transferia_tpu_torch.providers.parquet_meta import parquet_metadata

    n = 3000
    t = pa.table({
        "i": pa.array(np.arange(n) * 7, type=pa.int64()),
        "s": pa.array([None if i % 9 == 0 else f"v{i % 50}"
                       for i in range(n)]),
    })
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path, compression="snappy")
    meta = parquet_metadata(path)
    raw = np.fromfile(path, dtype=np.uint8)
    ci, cs = meta.row_groups[0].columns
    for codec in range(8):
        assert libs[0].pq_codec_supported(codec) == \
            libs[1].pq_codec_supported(codec)

    def chunk(c):
        start = min(c.data_page_offset, c.dictionary_page_offset
                    if c.dictionary_page_offset is not None
                    else c.data_page_offset)
        return np.ascontiguousarray(raw[start:start
                                        + c.total_compressed_size])

    outs = []
    for lib in libs:
        ch = chunk(ci)
        vals = np.zeros(n, dtype=np.int64)
        valid = np.zeros(n, dtype=np.uint8)
        rc1 = lib.pq_decode_fixed(ch, len(ch), 1, 8, n, 1, vals.ctypes.data,
                                  valid.ctypes.data)
        ch = chunk(cs)
        data = np.zeros(1 << 16, dtype=np.uint8)
        off = np.zeros(n + 1, dtype=np.int32)
        codes = np.zeros(n, dtype=np.int32)
        sval = np.zeros(n, dtype=np.uint8)
        kind, needed = ctypes.c_int32(-1), ctypes.c_int64(0)
        rc2 = lib.pq_decode_bytearray(ch, len(ch), 1, n, 1, data, len(data),
                                      off, codes.ctypes.data,
                                      sval.ctypes.data, ctypes.byref(kind),
                                      ctypes.byref(needed))
        outs.append((rc1, vals.tobytes(), valid.tobytes(), rc2, kind.value,
                     data[:max(rc2, 0)].tobytes(), off.tobytes(),
                     codes.tobytes(), sval.tobytes()))
    assert outs[0] == outs[1]
    assert outs[0][0] == n
    assert np.frombuffer(outs[0][1], np.int64).tolist() == \
        (np.arange(n) * 7).tolist()


# -- the build ---------------------------------------------------------------

def test_no_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build_host_library("hostops", native.HOSTOPS_SOURCES,
                                  native.HOSTOPS_DEPS)


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "broken.cpp"
    src.write_text("extern \"C\" int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="build failed"):
        native.build_host_library("broken", (src,))
    assert not list((tmp_path / "build").glob("*.so*"))


def test_missing_symbol_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    src = tmp_path / "partial.cpp"
    src.write_text("extern \"C\" int leb128_encode() { return 0; }\n")
    path = native.build_host_library("partial", (src,))
    with pytest.raises(AttributeError, match="scatter_bytes"):
        native._bind(ctypes.CDLL(str(path)))


def test_concurrent_first_builds_agree(monkeypatch, tmp_path):
    """Six first uses at once (as six test workers may) each build to a
    temporary name and rename it into place: every one ends with the
    same loadable library and no temporary is left."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    src = tmp_path / "tiny.cpp"
    src.write_text("extern \"C\" int answer() { return 42; }\n")
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build_host_library("tiny", (src,)))
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
        assert not th.is_alive()
    assert not errors
    assert len(set(paths)) == 1 and len(paths) == 6
    assert ctypes.CDLL(str(paths[0])).answer() == 42
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        sorted(["tiny.cpp", paths[0].name])
