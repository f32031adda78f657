"""The table fingerprint (ops/rowhash.py, kernel K10's plain version)
against the JAX package.

The same numpy columns, made from a seed, go into a batch of each
package.  The port's `fingerprint_host`, `TableFingerprinter(backend=
"device", device="cpu")` (and "auto", the measured choice) and
`batch_row_keys(..., device="cpu")` must equal the JAX package's `fingerprint_host`, `DeviceFingerprintProgram`
(JAX on the CPU) and `batch_row_keys`, digest for digest and key for key.
Exact: digests and keys are integers.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from transferia_tpu.abstract import schema as ref_schema
from transferia_tpu.columnar import batch as ref_batch
from transferia_tpu.ops import rowhash as ref
from transferia_tpu_torch.abstract import schema as port_schema
from transferia_tpu_torch.columnar import batch as port_batch
from transferia_tpu_torch.ops import rowhash as port
from transferia_tpu_torch.weights import accs_from_jax

CPU = "cpu"


def _flat(values):
    """bytes values -> (uint8 data, int32 offsets)."""
    data = np.frombuffer(b"".join(values), dtype=np.uint8).copy()
    offsets = np.zeros(len(values) + 1, dtype=np.int32)
    offsets[1:] = np.cumsum([len(v) for v in values])
    return data, offsets


def build(spec, arrays, n):
    """spec: [(name, type)]; arrays: name -> (data, offsets or None,
    validity or None).  Returns (port batch, JAX-package batch)."""
    out = []
    for sch, bat in ((port_schema, port_batch), (ref_schema, ref_batch)):
        schema = sch.new_table_schema(spec)
        cols = {}
        for cs in schema:
            data, offsets, validity = arrays[cs.name]
            cols[cs.name] = bat.Column(
                cs.name, cs.data_type, data.copy(),
                None if offsets is None else offsets.copy(),
                None if validity is None else validity.copy())
        out.append(bat.ColumnBatch(sch.TableID("db", "t"), schema, cols))
    return out


def reference_schema_case(n, seed):
    """tests/unit/test_rowhash.py's schema: id, name, score, flag."""
    idx = np.random.default_rng(seed).permutation(n)
    names = [f"name-{i}".encode() for i in idx]
    spec = [("id", "int64", True), ("name", "utf8"), ("score", "double"),
            ("flag", "boolean")]
    arrays = {
        "id": (idx.astype(np.int64), None, None),
        "name": (*_flat([b"" if i % 7 == 0 else v
                         for i, v in zip(idx, names)]), idx % 7 != 0),
        "score": (idx * 1.5, None, idx % 5 != 0),
        "flag": (idx % 2 == 0, None, None),
    }
    return spec, arrays


FIXED_KINDS = [("int8", np.int8), ("int16", np.int16), ("int32", np.int32),
               ("int64", np.int64), ("uint8", np.uint8),
               ("uint16", np.uint16), ("uint32", np.uint32),
               ("uint64", np.uint64), ("float", np.float32),
               ("double", np.float64), ("boolean", np.bool_),
               ("date", np.int32), ("datetime", np.int64),
               ("timestamp", np.int64), ("interval", np.int64)]


def fixed_kinds_case(n, seed):
    """Every canonical fixed kind over its full range, with nulls."""
    rng = np.random.default_rng(seed)
    spec, arrays = [], {}
    for name, dt in FIXED_KINDS:
        if dt == np.bool_:
            data = rng.integers(0, 2, n).astype(np.bool_)
        elif np.dtype(dt).kind == "f":
            data = (rng.standard_normal(n) * 1e6).astype(dt)
        else:
            info = np.iinfo(dt)
            data = rng.integers(info.min, info.max, n, dtype=dt,
                                endpoint=True)
            data[:2] = (info.min, info.max)  # -1 sign-extends, u64 keeps
        spec.append((f"c_{name}", name))
        arrays[f"c_{name}"] = (data, None, rng.random(n) > 0.2)
    return spec, arrays


def float_edges_case(n, seed):
    """+-0.0 and NaNs of several bit patterns, in float32 and float64."""
    rng = np.random.default_rng(seed)
    edges64 = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5,
                        np.uint64(0x7FF0000000000001).view(np.float64),
                        np.uint64(0xFFF8000000000123).view(np.float64)])
    edges32 = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, 2.5,
                        np.uint32(0x7F800001).view(np.float32)],
                       dtype=np.float32)
    spec = [("f64", "double"), ("f32", "float")]
    arrays = {"f64": (rng.choice(edges64, n), None, None),
              "f32": (rng.choice(edges32, n), None, rng.random(n) > 0.1)}
    return spec, arrays


BOUNDARY_LENS = [0, 1, 54, 55, 56, 57, 63, 64, 65, 119, 120, 127, 128,
                 1500]


def strings_case(n, seed):
    """Nulls, empty strings and the 64-byte block boundaries, one row
    over 1 KB, in every var-width type."""
    rng = np.random.default_rng(seed)
    lens = rng.choice(BOUNDARY_LENS, n)
    lens[:len(BOUNDARY_LENS)] = BOUNDARY_LENS[:n]
    values = [rng.integers(0, 256, ln, dtype=np.uint8).tobytes()
              for ln in lens]
    spec = [("s", "string"), ("u", "utf8"), ("a", "any"), ("d", "decimal"),
            ("k", "int32")]
    arrays = {"k": (np.arange(n, dtype=np.int32), None, None)}
    for name in ("s", "u", "a", "d"):
        perm = rng.permutation(n)
        arrays[name] = (*_flat([values[i] for i in perm]),
                        rng.random(n) > 0.25)
    return spec, arrays


CASES = {
    "reference_schema": reference_schema_case,
    "fixed_kinds": fixed_kinds_case,
    "float_edges": float_edges_case,
    "strings": strings_case,
}


def ref_device_digest(batch):
    prog = ref.DeviceFingerprintProgram()
    prog.dispatch(*ref.prep_batch(batch))
    return prog.collect().digest()


def port_device_digest(batches):
    fp = port.TableFingerprinter(backend="device", device=CPU)
    for b in batches:
        fp.push(b)
    return fp.result().digest()


@pytest.mark.parametrize("n", [300, 1024 + 17, 2 * 1024 + 17])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fingerprint_equals_jax(case, n):
    pb, rb = build(*CASES[case](n, seed=n), n)
    want = ref.fingerprint_host(*ref.prep_batch(rb)).digest()
    assert port.fingerprint_host(*port.prep_batch(pb)).digest() == want
    assert port_device_digest([pb]) == want
    assert ref_device_digest(rb) == want


@pytest.mark.parametrize("n", [300, 1024 + 17])
@pytest.mark.parametrize("case", sorted(CASES))
def test_row_keys_equal_jax(case, n):
    pb, rb = build(*CASES[case](n, seed=n + 1), n)
    want = ref.batch_row_keys(rb, backend="host")
    np.testing.assert_array_equal(ref.batch_row_keys(rb, backend="device"),
                                  want)
    for backend in ("host", "device"):
        got = port.batch_row_keys(pb, backend=backend, device=CPU)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, want)
    r1, r2 = ref.row_lanes(*ref.prep_batch(rb))
    p1, p2 = port.row_lanes(*port.prep_batch(pb))
    np.testing.assert_array_equal(p1, r1)
    np.testing.assert_array_equal(p2, r2)


def test_empty_table():
    spec, arrays = reference_schema_case(0, seed=1)
    pb, rb = build(spec, arrays, 0)
    want = ref.fingerprint_host(*ref.prep_batch(rb)).digest()
    assert want.endswith(":0")
    assert port.fingerprint_host(*port.prep_batch(pb)).digest() == want
    fp = port.TableFingerprinter(backend="device", device=CPU)
    fp.push(pb)
    assert fp.result().digest() == want
    assert port.TableFingerprinter(backend="host").result().count == 0
    for backend in ("host", "device"):
        assert port.batch_row_keys(pb, backend=backend, device=CPU).size == 0


@pytest.mark.parametrize("cut", [71, 1024, 1024 + 17])
def test_order_and_batching_independence(cut):
    n = 3 * 1024 + 17
    spec, arrays = reference_schema_case(n, seed=5)
    pb, rb = build(spec, arrays, n)
    want = ref.fingerprint_host(*ref.prep_batch(rb)).digest()
    shuffled = pb.take(np.random.default_rng(cut).permutation(n))
    parts = [shuffled.slice(lo, lo + cut) for lo in range(0, n, cut)]
    assert port_device_digest(parts) == want
    fp = port.TableFingerprinter(backend="host")
    for p in parts:
        fp.push(p)
    assert fp.result().digest() == want


def test_shard_merge_equals_whole():
    n = 800
    pb, rb = build(*reference_schema_case(n, seed=7), n)
    whole = ref.fingerprint_host(*ref.prep_batch(rb))
    agg = port.FingerprintAggregate()
    for lo in range(0, n, 200):
        agg.merge(port.fingerprint_host(
            *port.prep_batch(pb.slice(lo, lo + 200))))
    assert agg.digest() == whole.digest()
    # a digest the JAX package recorded parses in the port and is equal
    assert port.FingerprintAggregate.parse(whole.digest()) == agg
    with pytest.raises(ValueError, match="malformed"):
        port.FingerprintAggregate.parse("abc:1")


def test_column_swap_changes_the_digest():
    spec = [("a", "int64"), ("b", "int64")]
    x = {"a": (np.array([1, 2]), None, None),
         "b": (np.array([3, 4]), None, None)}
    y = {"a": (np.array([3, 4]), None, None),
         "b": (np.array([1, 2]), None, None)}
    digests = []
    for arrays in (x, y):
        pb, rb = build(spec, arrays, 2)
        d = port.fingerprint_host(*port.prep_batch(pb)).digest()
        assert d == ref.fingerprint_host(*ref.prep_batch(rb)).digest()
        digests.append(d)
    assert digests[0] != digests[1]


def test_single_value_change_detected():
    n = 300
    spec, arrays = reference_schema_case(n, seed=3)
    a, _ = build(spec, arrays, n)
    score = arrays["score"][0].copy()
    score[123] += 1.0
    b, _ = build(spec, {**arrays, "score": (score, None, arrays["score"][2])},
                 n)
    assert (port.fingerprint_host(*port.prep_batch(a)).digest()
            != port.fingerprint_host(*port.prep_batch(b)).digest())


def test_accs_from_jax_seed_the_pool_memo():
    values = [b"alpha", b"", b"gamma-longer-value" * 4, b"d" * 56]
    data, offsets = _flat(values + [b""])
    ref_pool = ref_batch.DictPool(data.copy(), offsets.copy(),
                                  null_code=len(values))
    port_pool = port_batch.DictPool(data.copy(), offsets.copy(),
                                    null_code=len(values))
    seeded = accs_from_jax(*ref.pool_accumulators(ref_pool), device=CPU)
    port_pool.memo_set(port._ACC_MEMO_KEY, seeded)
    got = port.pool_accumulators(port_pool, CPU)
    assert got[0] is seeded[0] and got[1] is seeded[1]
    fresh = port_batch.DictPool(data.copy(), offsets.copy())
    for a, b in zip(port.pool_accumulators(fresh, CPU), seeded):
        assert torch.equal(a, b)
    codes = np.random.default_rng(2).integers(0, len(values), 500)
    digests = []
    for bat, sch, mod, pool in (
            (port_batch, port_schema, port, port_pool),
            (ref_batch, ref_schema, ref, ref_pool)):
        col = bat.Column("s", sch.CanonicalType.UTF8, dict_enc=bat.DictEnc(
            codes.astype(np.int32), pool=pool))
        batch = bat.ColumnBatch(sch.TableID("d", "t"), sch.TableSchema(
            (sch.ColSchema("s", sch.CanonicalType.UTF8),)), {"s": col})
        digests.append(mod.fingerprint_host(*mod.prep_batch(batch)).digest())
    assert digests[0] == digests[1]


def test_var_accumulators_equal_the_block_matrix_sum():
    """The byte-pass accumulators equal the canonical block layout of
    `_pack_var` times the power table, and that layout is the JAX
    package's padded block matrix."""
    spec, arrays = strings_case(200, seed=11)
    pb, rb = build(spec, arrays, 200)
    pcols, _ = port.prep_batch(pb)
    rcols, _ = ref.prep_batch(rb)
    for pc, rc in zip(pcols, rcols):
        if pc.kind != "var":
            continue
        width = rc.width
        blocks = port._pack_var(pc.data, pc.offsets, width)
        np.testing.assert_array_equal(blocks.numpy(), rc.ensure_blocks())
        accs = port._var_accs_host(pc.data, pc.offsets)
        for acc, base in zip(accs, (port._P1, port._P2)):
            want = port._mul32(blocks.to(torch.int64),
                               port._powers(width, base)[None, :]
                               ).sum(1) & port.M32
            assert torch.equal(port._to_u32(acc), want)


def test_auto_row_keys_take_the_device_route(monkeypatch):
    n = 100
    pb, rb = build(*reference_schema_case(n, seed=9), n)
    want = ref.batch_row_keys(rb, backend="host")
    routes = []
    device_keys = port.batch_row_keys_device
    monkeypatch.setattr(port, "batch_row_keys_device", lambda b, d: (
        routes.append(d), device_keys(b, d))[1])
    np.testing.assert_array_equal(port.batch_row_keys(pb, device=CPU), want)
    assert routes == [CPU]
    with pytest.raises(ValueError, match="backend"):
        port.batch_row_keys(pb, backend="gpu")
    with pytest.raises(ValueError, match="backend"):
        port.TableFingerprinter(backend="gpu", device=CPU)


def test_auto_backend_takes_the_device_program(monkeypatch):
    """Auto is the reference's measured choice: the host lanes for the
    first two batches, then the device program once the link model
    predicts it faster per row (an accelerator stand-in and a pinned
    fast link here; the host's ns/row pinned slow).  The digest over
    both placements equals the reference's."""
    from transferia_tpu_torch.ops import linkprobe

    n = 500
    pb, rb = build(*reference_schema_case(n, seed=13), n)
    monkeypatch.setenv("TRANSFERIA_TPU_LINK", "0.001,1000000,1000000")
    monkeypatch.setattr(linkprobe, "_cached", {})
    fp = port.TableFingerprinter(device=CPU)
    monkeypatch.setattr(fp, "_accel_available", lambda: True)
    assert fp._device is None
    for lo in range(0, n, 100):
        fp.push(pb.slice(lo, lo + 100))
        if fp._host_samples == 2:
            fp._host_ns_row = 1e6  # the host measured slow
    assert fp.choices == ["host", "host", "device", "device", "device"]
    assert isinstance(fp._device, port.DeviceFingerprintProgram)
    assert fp._device._count == 300
    assert fp.result().digest() == ref.fingerprint_host(
        *ref.prep_batch(rb)).digest()
    assert port.TableFingerprinter(backend="host")._device is None


@pytest.mark.parametrize("offsets", [[0, 2, 9], [0, 3, 2], [-1, 1, 4]])
def test_prep_batch_rejects_offsets_outside_the_bytes(offsets):
    """The kernels read var rows through offsets unchecked, so the host
    refuses offsets that leave the byte buffer or run backwards."""
    data = np.frombuffer(b"abcd", dtype=np.uint8).copy()
    col = port_batch.Column("s", port_schema.CanonicalType.UTF8, data,
                            np.array(offsets, dtype=np.int32))
    batch = port_batch.ColumnBatch(
        port_schema.TableID("d", "t"), port_schema.TableSchema(
            (port_schema.ColSchema("s", port_schema.CanonicalType.UTF8),)),
        {"s": col})
    with pytest.raises(ValueError, match="offsets"):
        port.prep_batch(batch)
    pool = port_batch.DictPool(data, np.array(offsets, dtype=np.int32))
    with pytest.raises(ValueError, match="offsets"):
        port.pool_accumulators(pool, CPU)


# -- kernel K10's launch arguments and var-row decomposition (host side) ------

RH_SOURCE = (Path(port.__file__).resolve().parent.parent / "csrc"
             / "rowhash.cu").read_text()


def _source_int(pattern):
    return int(re.search(pattern, RH_SOURCE).group(1))


def test_lane_args_layout_matches_the_source():
    """The ctypes twins of ColDesc and LaneArgs have the sizes and
    offsets csrc/rowhash.cu static_asserts, and fit a kernel's 32,764
    parameter bytes with room for 128 columns (ClickBench's hits has
    105)."""
    assert port.BY_VALUE_COLS == _source_int(r"kByValueCols = (\d+);") == 128
    assert ctypes.sizeof(port.ColDesc) == _source_int(
        r"sizeof\(ColDesc\) == (\d+)") == 48
    assert ctypes.sizeof(port.LaneArgs) == _source_int(
        r"sizeof\(LaneArgs\) == (\d+)") <= 32_764
    for field in ("dev_cols", "n", "n_var"):
        assert getattr(port.LaneArgs, field).offset == _source_int(
            rf"offsetof\(LaneArgs, {field}\) == (\d+)")
    assert port.LaneArgs.cols.size == 48 * port.BY_VALUE_COLS


@pytest.mark.parametrize("n_cols,route", [
    (0, "by_value"), (1, "by_value"), (10, "by_value"), (105, "by_value"),
    (128, "by_value"), (129, "device"), (300, "device")])
def test_descriptor_route_by_column_count(n_cols, route):
    assert port.descriptor_route(n_cols) == route


# where len + 9 crosses a 64-byte block (the kernel's constant length-term
# powers end at 64 bytes), and rows whose q = (len + 8) >> 6 needs one, two
# and three bits of square-and-multiply
VAR_EDGE_LENS = (0, 1, 15, 16, 17, 54, 55, 56, 63, 64, 65, 119, 120, 300,
                 100_000)


@pytest.mark.parametrize("length", VAR_EDGE_LENS)
def test_var_accumulators_at_edge_lengths_match_jax(length):
    """`var_accumulators` (its plain version here) over rows of one edge
    length at every start offset mod 16 of the flat buffer, with
    multi-byte UTF-8 between them, equals the JAX package's pool
    accumulators."""
    rng = np.random.default_rng(21 + length)
    values = []
    for k in range(16):
        values += [bytes(k), rng.integers(0, 256, length,
                                          dtype=np.uint8).tobytes()]
    values.append("наушники ☃ 𝄞".encode())
    data, offsets = _flat(values)
    got = port.var_accumulators(torch.from_numpy(data),
                                torch.from_numpy(offsets))
    want = ref.pool_accumulators(ref_batch.DictPool(data, offsets))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))
