"""Dictionary columns and the dict decode (kernel K11's plain version)
against the JAX package.

- `DictPool` / `DictEnc` / `Column`'s dict half behave as the reference's
  (materialize, take, slice, null sentinel, a sentinel-less pool with
  validity), mirroring tests/unit/test_dict_reduction.py;
- a dict column's fingerprint and row keys equal the flat column's and
  the JAX package's, with zero flat materializations;
- `pool_accumulators` equals the reference's;
- `unpack_bits`, `decode_dict_run` and `decode_dict_loop` equal the JAX
  functions at every width the reference tests, with codes >= 2^31 at
  width 32 and codes past the pool.
Exact: everything compared is an integer.
"""

import numpy as np
import pytest
import torch

from transferia_tpu.abstract import schema as ref_schema
from transferia_tpu.columnar import batch as ref_batch
from transferia_tpu.ops import decode as ref_decode
from transferia_tpu.ops import rowhash as ref_rowhash
from transferia_tpu_torch.abstract import schema as port_schema
from transferia_tpu_torch.columnar import batch as port_batch
from transferia_tpu_torch.ops import decode as port_decode
from transferia_tpu_torch.ops import rowhash as port_rowhash

CPU = "cpu"
PACKAGES = {
    "port": (port_schema, port_batch, port_rowhash),
    "ref": (ref_schema, ref_batch, ref_rowhash),
}
VAR_TYPES = ["utf8", "string", "any", "decimal"]


def make_pool(pkg, values, sentinel=True):
    _, bat, _ = PACKAGES[pkg]
    data = np.frombuffer(b"".join(values), dtype=np.uint8).copy()
    lens = [len(v) for v in values] + ([0] if sentinel else [])
    return bat.DictPool(data, bat._offsets_from_lengths(lens),
                        null_code=len(values) if sentinel else None)


def dict_batch(pkg, ctype, pool, codes, validity=None, extra_int=True,
               flat=False):
    """A batch of one dict column (or its flat twin) plus an int64."""
    sch, bat, _ = PACKAGES[pkg]
    ct = sch.CanonicalType(ctype)
    enc = bat.DictEnc(np.asarray(codes, dtype=np.int32), pool=pool)
    col = (bat.Column("s", ct, *enc.materialize(), validity) if flat
           else bat.Column("s", ct, validity=validity, dict_enc=enc))
    cols = {"s": col}
    schema_cols = [sch.ColSchema("s", ct)]
    if extra_int:
        ints = np.arange(len(codes), dtype=np.int64)
        cols["i"] = bat.Column("i", sch.CanonicalType.INT64, ints)
        schema_cols.append(sch.ColSchema("i", sch.CanonicalType.INT64))
    return bat.ColumnBatch(sch.TableID("d", "t"),
                           sch.TableSchema(tuple(schema_cols)), cols)


def digests_and_keys(pkg, batch):
    _, _, rh = PACKAGES[pkg]
    digest = rh.fingerprint_host(*rh.prep_batch(batch)).digest()
    if pkg == "ref":
        return digest, rh.batch_row_keys(batch, backend="host")
    return digest, rh.batch_row_keys(batch, backend="device", device=CPU)


def dict_cases():
    """name -> (values, sentinel, ctype, codes, validity) from a seed."""
    rng = np.random.default_rng(3)
    cases = {}
    for ctype in VAR_TYPES:
        cases[f"all_types_{ctype}"] = (
            [b"alpha", b"", b"gamma-longer-value" * 4, b"d"], True, ctype,
            rng.integers(0, 4, 500), None)
    codes = rng.integers(0, 3, 300)
    validity = rng.random(300) > 0.2
    cases["null_code_rows"] = ([b"v0", b"v1", b"v2"], True, "utf8",
                               np.where(validity, codes, 3), validity)
    cases["all_null"] = ([b"only"], True, "utf8", np.full(64, 1),
                         np.zeros(64, dtype=bool))
    cases["sentinel_less_with_validity"] = (
        [b"x", b"yy"], False, "utf8", np.array([0, 1, 0, 1]),
        np.array([True, False, True, True]))
    boundary = [bytes([65 + i % 26]) * ln
                for i, ln in enumerate((0, 55, 56, 63, 64, 119, 1100))]
    cases["block_boundaries"] = (boundary, True, "string",
                                 rng.integers(0, 8, 1024 + 17),
                                 rng.random(1024 + 17) > 0.1)
    return cases


CASES = dict_cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_dict_digest_equals_flat_and_jax(case):
    values, sentinel, ctype, codes, validity = CASES[case]
    results = {}
    for pkg in PACKAGES:
        pool = make_pool(pkg, values, sentinel)
        for flat in (False, True):
            batch = dict_batch(pkg, ctype, pool, codes, validity, flat=flat)
            port_batch.reset_flat_materializations()
            results[pkg, flat] = digests_and_keys(pkg, batch)
            if pkg == "port" and not flat:
                assert batch.column("s").is_lazy_dict
                assert port_batch.flat_materializations() == 0
    want_digest, want_keys = results["ref", True]
    for (pkg, flat), (digest, keys) in results.items():
        assert digest == want_digest, (pkg, flat)
        np.testing.assert_array_equal(keys, want_keys)
    # the device route (JAX on the CPU) of the dict batch agrees too
    ref_pool = make_pool("ref", values, sentinel)
    prog = ref_rowhash.DeviceFingerprintProgram()
    prog.dispatch(*ref_rowhash.prep_batch(
        dict_batch("ref", ctype, ref_pool, codes, validity)))
    assert prog.collect().digest() == want_digest


def test_empty_pool_empty_batch():
    digests = []
    for pkg in PACKAGES:
        batch = dict_batch(pkg, "utf8", make_pool(pkg, [], sentinel=False),
                           np.zeros(0, dtype=np.int32), extra_int=False)
        digests.append(digests_and_keys(pkg, batch)[0])
    assert digests[0] == digests[1] and digests[0].endswith(":0")


@pytest.mark.parametrize("values", [
    [b"short", b"a-much-longer-value-here" * 3, b""],
    [bytes([i % 251]) * ln for i, ln in enumerate(range(0, 200, 7))],
])
def test_pool_accumulators_equal_jax(values):
    port_pool = make_pool("port", values, sentinel=False)
    a1, a2 = port_rowhash.pool_accumulators(port_pool, CPU)
    r1, r2 = ref_rowhash.pool_accumulators(make_pool("ref", values, False))
    np.testing.assert_array_equal(a1.numpy().view(np.uint32), r1)
    np.testing.assert_array_equal(a2.numpy().view(np.uint32), r2)
    # memoized once per pool, and equal to a flat row of the same bytes
    b1, b2 = port_rowhash.pool_accumulators(port_pool, CPU)
    assert b1 is a1 and b2 is a2
    flat = port_batch.Column.from_pylist(
        "v", port_schema.CanonicalType.STRING, values)
    f1, f2 = port_rowhash._var_accs_host(
        torch.from_numpy(flat.data), torch.from_numpy(flat.offsets))
    assert torch.equal(f1, a1) and torch.equal(f2, a2)


def test_take_slice_and_materialize_match_jax():
    values = [b"aa", b"bbb", b"cccc", b""]
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, 400).astype(np.int32)
    validity = rng.random(400) > 0.2
    idx = rng.permutation(400)[:123]
    out = {}
    for pkg in PACKAGES:
        sch, bat, _ = PACKAGES[pkg]
        col = bat.Column("s", sch.CanonicalType.UTF8, validity=validity,
                         dict_enc=bat.DictEnc(codes, pool=make_pool(
                             pkg, values)))
        assert col.is_lazy_dict and col.n_rows == 400
        sliced = col._take_contiguous(37, 311)
        taken = col.take(idx)
        assert sliced.is_lazy_dict and taken.is_lazy_dict
        assert taken.dict_enc.pool is col.dict_enc.pool
        data, offsets = col.dict_enc.materialize()
        out[pkg] = (sliced.to_pylist(), taken.to_pylist(),
                    taken.dict_enc.indices.tolist(), data.tobytes(),
                    offsets.tolist(), col.value(5))
        # a consumer that asks for flat buffers gets them, lazily
        assert col.data is not None and not col.is_lazy_dict
    assert out["port"] == out["ref"]


def test_flat_access_counts_one_materialization():
    pool = make_pool("port", [b"x", b"yy"])
    batch = dict_batch("port", "utf8", pool, [0, 1, 0])
    port_batch.reset_flat_materializations()
    assert bytes(batch.column("s").data) == b"xyyx"
    batch.column("s").offsets  # already flat: no second count
    assert port_batch.flat_materializations() == 1
    port_batch.reset_flat_materializations()
    assert port_batch.flat_materializations() == 0


@pytest.mark.parametrize("bad", [[0, 99], [0, -2]])
def test_prep_batch_rejects_out_of_range_codes(bad):
    for pkg in PACKAGES:
        _, _, rh = PACKAGES[pkg]
        batch = dict_batch(pkg, "utf8", make_pool(pkg, [b"aa", b"bb"]),
                           bad, extra_int=False)
        with pytest.raises(IndexError, match="out of range"):
            rh.prep_batch(batch)


# -- the dict decode ------------------------------------------------------------

BIT_WIDTHS = (1, 3, 7, 8, 9, 16, 17, 20, 31, 32)


def pack(values: np.ndarray, bw: int) -> np.ndarray:
    """Little-endian bit stream of non-negative values into uint32."""
    n = len(values)
    out = np.zeros((n * bw + 31) // 32 + 1, dtype=np.uint64)
    starts = np.arange(n, dtype=np.uint64) * np.uint64(bw)
    wi = (starts >> np.uint64(5)).astype(np.int64)
    off = starts & np.uint64(31)
    v = values.astype(np.uint64)
    np.bitwise_or.at(out, wi, (v << off) & np.uint64(0xFFFFFFFF))
    spill = off + np.uint64(bw) > np.uint64(32)
    np.bitwise_or.at(out, wi[spill] + 1,
                     v[spill] >> (np.uint64(32) - off[spill]))
    return out[:(n * bw + 31) // 32].astype(np.uint32)


def codes_for(bw, n, k, seed):
    """Codes at width bw: most inside a pool of k, some past it and, at
    width 32, some >= 2^31 (negative as int32, so they clamp to 0)."""
    rng = np.random.default_rng(seed)
    hi = min(1 << bw, 1 << 32)
    codes = rng.integers(0, min(k, hi), n, dtype=np.uint64)
    past = rng.random(n) < 0.1
    codes[past] = rng.integers(0, hi, int(past.sum()), dtype=np.uint64)
    if bw == 32:
        codes[::7] = rng.integers(1 << 31, 1 << 32, len(codes[::7]),
                                  dtype=np.uint64)
    return codes


def words_tensor(words):
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("n", [1000, 1024])
@pytest.mark.parametrize("bw", BIT_WIDTHS)
def test_unpack_and_decode_dict_run_equal_jax(bw, n):
    k = 300
    codes = codes_for(bw, n, k, seed=bw * n)
    words = pack(codes, bw)
    pool = np.random.default_rng(bw).integers(-10**9, 10**9, k,
                                              dtype=np.int32)
    got = port_decode.unpack_bits(words_tensor(words), bw, n)
    want = np.asarray(ref_decode.unpack_bits(words, bw, n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  codes.astype(np.uint32))
    got = port_decode.decode_dict_run(words_tensor(words),
                                      torch.from_numpy(pool), bw, n)
    want = np.asarray(ref_decode.decode_dict_run(words, pool, bw, n))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bw", BIT_WIDTHS)
def test_decode_dict_loop_equals_jax(bw):
    n, k, iters = 1024 + 17, 257, 3
    codes = codes_for(bw, n, k, seed=bw)
    words = pack(codes, bw)
    pool = np.random.default_rng(bw + 1).integers(-10**9, 10**9, k,
                                                  dtype=np.int32)
    got = port_decode.decode_dict_loop(words_tensor(words),
                                       torch.from_numpy(pool), bw, n, iters)
    want = int(ref_decode.decode_dict_loop(words, pool, bw, n, iters))
    assert got.dim() == 0 and got.dtype == torch.int32
    assert int(got) & 0xFFFFFFFF == want


def test_gather_pool_accumulators_clamps_like_jnp_take():
    accs = np.arange(10, 20, dtype=np.uint32)
    codes = np.array([-5, 0, 3, 9, 10, 2**31 - 1], dtype=np.int32)
    got = port_decode.gather_pool_accumulators(
        torch.from_numpy(accs.view(np.int32)), torch.from_numpy(codes))
    want = np.asarray(ref_decode.gather_pool_accumulators(accs, codes))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_decode_rejects_bad_shapes():
    words = words_tensor(np.zeros(4, dtype=np.uint32))
    pool = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="bit_width"):
        port_decode.unpack_bits(words, 0, 8)
    with pytest.raises(ValueError, match="bit_width"):
        port_decode.decode_dict_run(words, pool, 33, 8)
    with pytest.raises(ValueError, match="words"):
        port_decode.decode_dict_run(words, pool, 32, 5)
    with pytest.raises(ValueError, match="pool"):
        port_decode.decode_dict_run(words, pool[:0], 8, 4)


@pytest.mark.parametrize("k", [1, 131_072])
@pytest.mark.parametrize("bw", range(1, 33))
def test_decode_dict_run_every_width_ragged_equals_jax(bw, k):
    """n not a multiple of 32 (the reference's gather path), a pool of
    one entry and one of 131,072 (the decode path's), codes past the
    pool and, at width 32, negative ones."""
    n = 32 * 31 + 13
    codes = codes_for(bw, n, k, seed=bw * 7 + k)
    words = pack(codes, bw)
    pool = np.random.default_rng(k + bw).integers(-2**31, 2**31, k,
                                                  dtype=np.int64)
    pool = pool.astype(np.int32)
    got = port_decode.decode_dict_run(words_tensor(words),
                                      torch.from_numpy(pool), bw, n)
    want = np.asarray(ref_decode.decode_dict_run(words, pool, bw, n))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,staged", [
    (1, 1),
    (31, 31),
    (4096, 4096),
    (port_decode.POOL_PREFIX_ENTRIES - 1, port_decode.POOL_PREFIX_ENTRIES - 1),
    (port_decode.POOL_PREFIX_ENTRIES, port_decode.POOL_PREFIX_ENTRIES),
    # past the prefix: its first 40,960 entries, one block an SM
    (port_decode.POOL_PREFIX_ENTRIES + 1, port_decode.POOL_PREFIX_ENTRIES),
    (56_000, 40_960),
    (131_072, 40_960),
    (262_144, 40_960),
    (2**31 - 1, 40_960),
])
def test_dict_staged_entries_by_size(k, staged):
    assert port_decode.dict_staged_entries(k) == staged
    # the staged entries (and the kernel's 64 bytes) fit a block's 227 KB
    assert 4 * staged + 64 <= 232_448 and staged <= k
