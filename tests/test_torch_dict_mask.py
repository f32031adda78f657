"""The dictionary-encoded mask+filter path of the port against the JAX package.

One pool's content, made with numpy from a seed, goes to both packages
(`weights.pool_from_jax`):

- `mask_dict_column` gives the reference's codes, hexed pool bytes and
  encoding for a pool with a null sentinel, a sentinel-less pool with
  null rows, an all-null column and the subset route (pool > 2x rows);
- `device_hmac_dict_pool(..., device="cpu")` (kernel K-A's plain
  version over the pool) gives hmac/hashlib's digests and the JAX
  package's pool, shares its memo with the host path, hashes a pool
  once under 8 racing threads, refuses a pool too large for the batch,
  and counts the bytes it stages;
- the chain `mask URL + filter RegionID < 400` through
  `build_chain(cfg, device="cpu")` gives the JAX chain's bytes under
  device and host placement, URL stays dict-encoded, nothing flattens;
- `DeviceFusedStep._estimate_link_bytes` equals the JAX step's on the
  single-device branches.
Exact: everything compared is bytes or integers.
"""

import hashlib
import hmac
import sys
import threading
import time

import numpy as np
import pytest

from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.columnar import batch as ref_batch
from transferia_tpu.ops import dispatch as ref_dispatch
from transferia_tpu.ops import fused as ref_fused
from transferia_tpu.transform import build_chain as ref_build_chain
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu.transform.plugins import mask as ref_mask
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.columnar import batch as port_batch
from transferia_tpu_torch.ops import dispatch as port_dispatch
from transferia_tpu_torch.ops import fused as port_fused
from transferia_tpu_torch.transform import build_chain
from transferia_tpu_torch.transform import fused as port_tfused
from transferia_tpu_torch.transform.plugins import mask as port_mask
from transferia_tpu_torch.weights import pool_from_jax

KEY = b"bench-salt"
CONFIG = {"transformers": [  # bench.py measure_dispatch
    {"mask_field": {"columns": ["URL"], "salt": "bench-salt"}},
    {"filter_rows": {"filter": "RegionID < 400"}},
]}
ROWS = 1024 * 3 + 17  # below the JAX step's mesh threshold (8 devices)


def bench_values(k):
    """bench.py measure_dispatch's URL values."""
    return [f"https://bench{i}.example/path/{i % 97}/{i}".encode()
            for i in range(k)]


def ref_pool(values, sentinel=True):
    data = np.frombuffer(b"".join(values), dtype=np.uint8).copy()
    lens = [len(v) for v in values] + ([0] if sentinel else [])
    return ref_batch.DictPool(data, ref_batch._offsets_from_lengths(lens),
                              null_code=len(values) if sentinel else None)


def both_pools(values, sentinel=True):
    ref = ref_pool(values, sentinel)
    return ref, pool_from_jax(ref.values_data, ref.values_offsets,
                              ref.null_code)


def dict_cols(pools, codes, validity, name="URL"):
    """The same dict column in both packages (ref, port)."""
    codes = np.asarray(codes, dtype=np.int32)
    out = []
    for bat, sch, pool in ((ref_batch, ref_schema, pools[0]),
                           (port_batch, new_table_schema, pools[1])):
        ct = sch([(name, "utf8")]).find(name).data_type
        out.append(bat.Column(name, ct, validity=validity,
                              dict_enc=bat.DictEnc(codes.copy(), pool=pool)))
    return out


def encoded(col):
    """A dict column's codes and pool, compared exactly (no flattening)."""
    assert col.is_lazy_dict
    pool = col.dict_enc.pool
    return (col.dict_enc.indices.astype(np.int32).tobytes(),
            pool.values_data.tobytes(),
            pool.values_offsets.astype(np.int32).tobytes(), pool.null_code,
            None if col.validity is None else col.validity.tobytes())


def hex_values(values, key=KEY):
    return [hmac.new(key, v, hashlib.sha256).hexdigest().encode()
            for v in values]


def mask_cases():
    """name -> (values, sentinel, codes, validity), from a seed."""
    rng = np.random.default_rng(21)
    vals = bench_values(300)
    n = 1000
    cases = {}
    valid = rng.random(n) > 0.2
    codes = np.where(valid, rng.integers(0, 300, n), 300)
    cases["null_sentinel"] = (vals, True, codes, valid)
    codes = rng.integers(0, 300, n)
    cases["no_sentinel_null_rows"] = (vals, False, codes, valid)
    cases["no_sentinel_all_valid"] = (vals, False, codes, None)
    cases["all_null"] = (vals, True, np.full(n, 300),
                         np.zeros(n, dtype=bool))
    big = bench_values(2 * 400 + 50)
    valid = rng.random(400) > 0.25
    codes = np.where(valid, rng.integers(0, len(big), 400), len(big))
    cases["subset"] = (big, True, codes, valid)  # pool > 2x rows
    return cases


MASK_CASES = mask_cases()


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_mask_dict_column_matches_jax(case):
    values, sentinel, codes, validity = MASK_CASES[case]
    pools = both_pools(values, sentinel)
    ref_col, col = dict_cols(pools, codes, validity)
    port_batch.reset_flat_materializations()
    want = ref_mask.mask_dict_column(KEY, ref_col)
    got = port_mask.mask_dict_column(KEY, col)
    assert encoded(got) == encoded(want)
    assert port_batch.flat_materializations() == 0
    memo = pools[1].memo_get(("hmac_hex", KEY))
    assert (memo is None) == (case == "subset")
    # the bytes are the flat path's: hex per valid row, empty per null
    data, offsets = got.dict_enc.materialize()
    flat = ref_mask._host_hmac_hex(KEY, *ref_col.dict_enc.materialize(),
                                   validity)
    assert data.tobytes() == flat[0].tobytes()
    assert offsets.tobytes() == flat[1].tobytes()


def test_mask_field_keeps_dict_columns_encoded():
    values, sentinel, codes, validity = MASK_CASES["null_sentinel"]
    pools = both_pools(values, sentinel)
    ref_col, col = dict_cols(pools, codes, validity)
    step = port_mask.MaskField(["URL"], salt="bench-salt")
    ref_step = ref_mask.MaskField(["URL"], salt="bench-salt")
    assert encoded(step._mask_column(col)) == \
        encoded(ref_step._mask_column(ref_col))


def test_device_pool_hash_matches_hashlib_and_jax():
    values = bench_values(500)
    ref, pool = both_pools(values)
    port_dispatch.reset_dispatch_bytes()
    hexed = port_dispatch.device_hmac_dict_pool(KEY, pool, 1000,
                                                device="cpu")
    want = hex_values(values) + [b""]  # the sentinel's slot emptied
    assert [hexed.value_bytes(i) for i in range(hexed.n_values)] == want
    assert hexed.null_code == pool.null_code
    ref_hexed = ref_dispatch.device_hmac_dict_pool(KEY, ref, 1000)
    assert hexed.values_data.tobytes() == ref_hexed.values_data.tobytes()
    assert hexed.values_offsets.tobytes() == \
        ref_hexed.values_offsets.tobytes()
    # the digest rows the mesh route gathers from, memoized beside it
    rows = port_dispatch.device_hmac_pool_digests(KEY, pool, 1000)
    ref_rows = ref_dispatch.device_hmac_pool_digests(KEY, ref, 1000)
    np.testing.assert_array_equal(rows, ref_rows)
    # one pool upload staged (blocks + counts), and the raw wire's
    # bucket-padded blocks for the 1000-row batch credited beside it
    staged = port_dispatch.dispatch_bytes()
    upload = len(values) + 1
    assert staged["encoded"] == upload * 64 + upload * 4
    assert staged["raw_equiv"] == staged["encoded"] + (64 + 4) * 1024


def test_device_and_host_share_the_memo(monkeypatch):
    values, _, codes, validity = MASK_CASES["null_sentinel"]
    _, pool = both_pools(values)
    _, col = dict_cols((ref_pool(values), pool), codes, validity)
    hexed = port_dispatch.device_hmac_dict_pool(KEY, pool, col.n_rows,
                                                device="cpu")

    def no_host_hash(*a):
        raise AssertionError("the host hashed a memoized pool")

    monkeypatch.setattr(port_mask, "_host_hmac_hex", no_host_hash)
    assert port_mask.mask_dict_column(KEY, col).dict_enc.pool is hexed
    # and the other way round: the host pays first, the device rides
    _, pool2 = both_pools(values)
    monkeypatch.undo()
    _, col2 = dict_cols((ref_pool(values), pool2), codes, validity)
    host = port_mask.mask_dict_column(KEY, col2).dict_enc.pool

    def no_device_hash(*a):
        raise AssertionError("the device hashed a memoized pool")

    monkeypatch.setattr(port_dispatch, "_pool_digest_rows_locked",
                        no_device_hash)
    assert port_dispatch.device_hmac_dict_pool(
        KEY, pool2, col2.n_rows, device="cpu") is host


def test_racing_threads_hash_a_pool_once(monkeypatch):
    _, pool = both_pools(bench_values(200))
    calls = []
    real = port_dispatch._pool_digest_rows_locked

    def counted(*args):
        calls.append(1)
        time.sleep(0.05)  # hold the lock while the others arrive
        return real(*args)

    monkeypatch.setattr(port_dispatch, "_pool_digest_rows_locked", counted)
    start = threading.Barrier(8)
    results = [None] * 8

    def worker(i):
        start.wait()
        results[i] = port_dispatch.device_hmac_dict_pool(KEY, pool, 1000,
                                                         device="cpu")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert all(r is results[0] for r in results)


def test_pool_too_large_for_the_batch_is_refused():
    values = bench_values(2 * 100 + 1)
    ref, pool = both_pools(values, sentinel=False)
    assert port_dispatch.device_hmac_dict_pool(KEY, pool, 100,
                                               device="cpu") is None
    assert ref_dispatch.device_hmac_dict_pool(KEY, ref, 100) is None
    assert port_dispatch.device_hmac_pool_digests(KEY, pool, 100) is None
    assert pool.memo_get(("hmac_hex", KEY)) is None
    # at exactly twice the rows it still pays
    assert port_dispatch.device_hmac_dict_pool(KEY, pool, 101,
                                               device="cpu") is not None


@pytest.fixture
def knobs():
    """Pin both packages' knobs; restore them afterwards."""
    def pin(encoding, placement):
        for mod in (ref_dispatch, port_dispatch):
            mod.set_dispatch_encoding(encoding)
        for mod in (ref_fused, port_fused):
            mod.set_chunk_rows(1024)
        for mod in (ref_tfused, port_tfused):
            mod.set_placement(placement)
        ref_tfused.set_device_fusion(True)

    yield pin
    for mod in (ref_dispatch, port_dispatch):
        mod.set_dispatch_encoding(None)
    for mod in (ref_fused, port_fused):
        mod.set_chunk_rows(None)
    for mod in (ref_tfused, port_tfused):
        mod.set_placement(None)
    ref_tfused.set_device_fusion(None)


def dispatch_batches(n_values, seed=11):
    """bench.py measure_dispatch's batch at ROWS rows (URL over
    `n_values` values with a sentinel, 10 % null; RegionID in [0, 500)):
    (ref batch, port batch)."""
    rng = np.random.default_rng(seed)
    values = bench_values(n_values)
    valid = rng.random(ROWS) > 0.1
    codes = np.where(valid, rng.integers(0, n_values, ROWS), n_values)
    region = rng.integers(0, 500, ROWS).astype(np.int32)
    pools = both_pools(values)
    url = dict_cols(pools, codes, valid)
    out = []
    for bat, sch, col in ((ref_batch, ref_schema, url[0]),
                          (port_batch, new_table_schema, url[1])):
        schema = sch([("URL", "utf8"), ("RegionID", "int32")])
        reg = bat.Column("RegionID", schema.find("RegionID").data_type,
                         region.copy())
        out.append(bat.ColumnBatch(TableID("bench", "dispatch"), schema,
                                   {"URL": col, "RegionID": reg}))
    return out


def column_bytes(col):
    if col.is_lazy_dict:
        data, offsets = col.dict_enc.materialize()
    else:
        data, offsets = col.data, col.offsets
    return (col.ctype.value, np.asarray(data).tobytes(),
            None if offsets is None else offsets.tobytes(),
            None if col.validity is None else col.validity.tobytes())


@pytest.mark.parametrize("pool_size", ["shared", "too_large"])
@pytest.mark.parametrize("placement,encoding", [
    ("device", "auto"), ("device", "raw"), ("host", "auto")])
def test_chain_matches_jax(placement, encoding, pool_size, knobs):
    n_values = 2048 if pool_size == "shared" else 2 * ROWS + 1
    ref_b, batch = dispatch_batches(n_values)
    knobs(encoding, placement)
    chain = build_chain(CONFIG, device="cpu")
    ref_chain = ref_build_chain(CONFIG)
    steps = chain.plan_for(batch.table_id, batch.schema).steps
    assert len(steps) == 1 and isinstance(steps[0],
                                          port_tfused.DeviceFusedStep)
    port_batch.reset_flat_materializations()
    out = chain.apply(batch)
    ref_out = ref_chain.apply(ref_b)
    flattens = placement == "device" and encoding == "raw"
    assert out.column("URL").is_lazy_dict == (not flattens)
    assert ref_out.column("URL").is_lazy_dict == (not flattens)
    assert port_batch.flat_materializations() == (1 if flattens else 0)
    assert 0 < out.n_rows < ROWS
    assert out.schema.names() == ref_out.schema.names()
    for name in out.schema.names():
        assert column_bytes(out.column(name)) == \
            column_bytes(ref_out.column(name)), name
    if not flattens:
        assert encoded(out.column("URL")) == encoded(ref_out.column("URL"))


@pytest.mark.parametrize("encoding", ["auto", "raw"])
@pytest.mark.parametrize("state", ["memoized", "unmemoized", "rejected",
                                   "flat"])
def test_estimate_link_bytes_matches_jax(state, encoding, knobs):
    n_values = 2 * ROWS + 1 if state == "rejected" else 2048
    ref_b, batch = dispatch_batches(n_values)
    knobs(encoding, "device")
    if state == "memoized":
        for b in (ref_b, batch):
            b.column("URL").dict_enc.pool.memo_set(("hmac_hex", KEY),
                                                   object())
    step = build_chain(CONFIG, device="cpu").plan_for(
        batch.table_id, batch.schema).steps[0]
    ref_step = ref_build_chain(CONFIG).plan_for(
        ref_b.table_id, ref_b.schema).steps[0]
    if state == "flat":
        assert step._estimate_link_bytes(ROWS) == \
            ref_step._estimate_link_bytes(ROWS)
        return
    assert step._estimate_link_bytes(ROWS, batch) == \
        ref_step._estimate_link_bytes(ROWS, ref_b)
