"""The port's mesh and its sharded transform step (K13) against the JAX package.

The JAX package runs on conftest's virtual 8-device CPU mesh; the port
on `testing.force_virtual_mesh(8)` over the CPU, where kernel K13's
wrapper runs its plain PyTorch version.  Inputs are made with numpy from
a seed and fed to both.  Exact equality throughout: digests, keep masks,
histograms and counts are integers, and `scores_f32` is compared bit for
bit (the JAX package runs without x64, so its scores are float32 from
placement on; the port casts to float32 before the finite test, so 1e300
is not kept in either).

- `make_mesh` shapes for 1-8 devices, as tests/unit/test_parallel.py
  pins them;
- `sharded_transform_step` on the 8-shard mesh against JAX's on its
  8-device mesh (2 and 4 columns, 8 and 13 target shards, a 1e300, an
  inf, a NaN score and negative ages), and against the port's 1-shard
  mesh;
- K13/K14's plain histogram against the JAX expressions
  (`.at[shard].add(keep)` over `digest % n_shards`), n_shards 8, 16, 13,
  with the keep mask packed and as bools;
- the chain's mesh route: `build_chain(...).apply` on an 8*1024+17-row
  batch (bench.py measure_dispatch's columns), where both packages take
  their mesh route (K14, parallel/fusedmesh.py): byte-identical, a
  dictionary column still dictionary-encoded, the same cross-shard
  histogram; and the link model's mesh branches equal the reference's.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.columnar import batch as ref_batch
from transferia_tpu.ops import dispatch as ref_dispatch
from transferia_tpu.parallel import fusedmesh as ref_fm
from transferia_tpu.parallel import make_mesh as ref_make_mesh
from transferia_tpu.parallel import sharded_transform_step as ref_step
from transferia_tpu.parallel.mesh import example_step_args as ref_args
from transferia_tpu.transform import build_chain as ref_build_chain
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.columnar import batch as port_batch
from transferia_tpu_torch.ops import dispatch as port_dispatch
from transferia_tpu_torch.parallel import fusedmesh as port_fm
from transferia_tpu_torch.parallel import make_mesh, sharded_transform_step
from transferia_tpu_torch.parallel.mesh import (
    BALLOT_SHARDS,
    MAX_SHARDS,
    HistOutputs,
    example_step_args,
    shard_hist_fused,
    shard_hist_step,
)
from transferia_tpu_torch.runtime.device import mesh_devices
from transferia_tpu_torch.testing import force_virtual_mesh
from transferia_tpu_torch.transform import build_chain
from transferia_tpu_torch.transform import fused as port_tfused
from transferia_tpu_torch.weights import pool_from_jax

KEY = b"bench-salt"
N_CHAIN = 8 * 1024 + 17      # >= the mesh route's 1024 rows per shard
CONFIG = {"transformers": [   # bench.py measure_dispatch
    {"mask_field": {"columns": ["URL"], "salt": "bench-salt"}},
    {"filter_rows": {"filter": "RegionID < 400"}},
]}


@pytest.fixture
def mesh8():
    force_virtual_mesh(8)
    yield make_mesh(device="cpu")
    force_virtual_mesh(None)


def test_virtual_mesh_is_resettable():
    assert mesh_devices("cpu") == 1
    force_virtual_mesh(8)
    try:
        assert mesh_devices("cpu") == 8
    finally:
        force_virtual_mesh(None)
    assert mesh_devices("cpu") == 1
    with pytest.raises(ValueError):
        force_virtual_mesh(0)


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shapes_match_jax(n, mesh8):
    ref = ref_make_mesh(n_devices=n)
    mesh = make_mesh(n_devices=n, device="cpu")
    assert mesh.shape == dict(ref.shape)
    assert mesh.axis_names == tuple(ref.axis_names)
    assert mesh.size == ref.devices.size == n
    if n == 8:
        assert mesh8.shape == {"data": 4, "model": 2}


def step_inputs(mesh, rows_per_device, n_cols):
    blocks, n_blocks, ages, scores = example_step_args(
        mesh, rows_per_device, n_cols)
    # per-row block counts below the maximum, and the edge cases of the
    # keep rule: a negative age, a score that overflows float32, +inf
    # and NaN
    n_blocks[:, ::3] = 1
    ages[[3, 40]] = -1
    scores[[5, 41]] = 1e300
    scores[7] = np.inf
    scores[11] = np.nan
    return blocks, n_blocks, ages, scores


def host(t):
    a = t.cpu().numpy()
    return a.view(np.uint32) if a.dtype in (np.int32, np.float32) else a


@pytest.mark.parametrize("n_cols,n_shards", [(2, 8), (4, 13)])
def test_step_matches_jax(n_cols, n_shards, mesh8):
    args = step_inputs(mesh8, 32, n_cols)
    out = sharded_transform_step(mesh8, max_blocks=2,
                                 n_shards=n_shards)(*args)
    with np.errstate(over="ignore"):  # JAX places 1e300 as float32 inf
        ref = ref_step(ref_make_mesh(), max_blocks=2,
                       n_shards=n_shards)(*args)
    names = ("digests", "keep", "scores_f32", "hist", "total")
    for name, got, want in zip(names, out, ref):
        want = np.asarray(want)
        if want.dtype in (np.int32, np.float32):
            want = want.view(np.uint32)
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(host(got), want, err_msg=name)
    keep = out[1].numpy()
    assert not keep[[3, 5, 7, 11, 40, 41]].any()
    assert int(out[3].sum()) == int(keep.sum()) * n_cols
    assert int(out[4]) == int(keep.sum())


def test_example_args_are_the_reference_draws(mesh8):
    ref = [np.asarray(a) for a in ref_args(ref_make_mesh(),
                                           rows_per_device=16)]
    port = example_step_args(mesh8, rows_per_device=16)
    for got, want in zip(port[:3], ref[:3]):
        np.testing.assert_array_equal(got, want)
    # the reference's float64 scores become float32 when placed
    np.testing.assert_array_equal(port[3].astype(np.float32), ref[3])


def test_step_sharded_equals_one_shard(mesh8):
    args = step_inputs(mesh8, 32, 2)
    out8 = sharded_transform_step(mesh8, n_shards=8)(*args)
    out1 = sharded_transform_step(make_mesh(n_devices=1, device="cpu"),
                                  n_shards=8)(*args)
    for a, b in zip(out8, out1):  # bit for bit (a NaN score is there)
        np.testing.assert_array_equal(host(a), host(b))


def test_step_rejects_columns_that_do_not_split(mesh8):
    args = step_inputs(mesh8, 16, 3)
    with pytest.raises(ValueError, match="do not split"):
        sharded_transform_step(mesh8)(*args)


def jax_hist(digests, keep, n_shards):
    """The reference's histogram expression (parallel/mesh.py:72-75,
    parallel/fusedmesh.py:191-194) over (C, N) word-0 values."""
    shard = (jnp.asarray(digests) % jnp.uint32(n_shards)).astype(jnp.int32)
    return np.asarray(jnp.zeros((n_shards,), dtype=jnp.int32).at[
        shard.reshape(-1)].add(jnp.broadcast_to(
            jnp.asarray(keep).astype(jnp.int32), shard.shape).reshape(-1)))


def pack_words(bits):
    return torch.from_numpy(np.packbits(bits.astype(np.uint8),
                                        bitorder="little").view(np.int32))


@pytest.mark.parametrize("n_shards", [8, 16, 13])
@pytest.mark.parametrize("layout", ["packed", "bool"])
def test_fused_hist_matches_jax_expression(n_shards, layout):
    rng = np.random.default_rng(n_shards)
    n = 1024
    words = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    valid = np.arange(n) < 1000
    pred = rng.random(n) > 0.4
    as_t = pack_words if layout == "packed" else torch.from_numpy
    dig = torch.from_numpy(words.view(np.int32))
    got = shard_hist_fused(dig, n_shards, as_t(valid), as_t(pred)).numpy()
    keep = valid & pred
    np.testing.assert_array_equal(
        got[:n_shards], jax_hist(words[None, :, 0], keep, n_shards))
    assert got[n_shards] == keep.sum()
    # no predicate: the run validity alone
    got = shard_hist_fused(dig, n_shards, as_t(valid)).numpy()
    np.testing.assert_array_equal(
        got[:n_shards], jax_hist(words[None, :, 0], valid, n_shards))
    assert got[n_shards] == valid.sum()


@pytest.mark.parametrize("n_shards", [8, 16, 13])
def test_step_hist_matches_jax_expression(n_shards):
    rng = np.random.default_rng(100 + n_shards)
    c, n = 3, 512
    words = rng.integers(0, 2**32, (c, n, 8), dtype=np.uint64).astype(
        np.uint32)
    ages = rng.integers(-5, 99, n).astype(np.int32)
    scores = rng.uniform(0, 100, n)
    scores[::17] = 1e300
    part, keep, s32 = shard_hist_step(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(ages),
        torch.from_numpy(scores), n_shards)
    with np.errstate(over="ignore"):  # 1e300 overflows to inf
        want_s32 = np.asarray(jnp.asarray(scores.astype(np.float32)))
    want_keep = np.asarray((jnp.asarray(ages) >= 0)
                           & jnp.isfinite(jnp.asarray(want_s32)))
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(s32.numpy().view(np.uint32),
                                  want_s32.view(np.uint32))
    np.testing.assert_array_equal(part.numpy()[:n_shards],
                                  jax_hist(words[:, :, 0], want_keep,
                                           n_shards))
    assert part[n_shards] == want_keep.sum()


@pytest.mark.parametrize("n_shards", [0, MAX_SHARDS + 1])
def test_shard_count_limits(n_shards):
    dig = torch.zeros((32, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="n_shards"):
        shard_hist_fused(dig, n_shards, torch.ones(32, dtype=torch.bool))
    with pytest.raises(ValueError, match="n_shards"):
        sharded_transform_step(make_mesh(device="cpu"), n_shards=n_shards)


# -- the chain -------------------------------------------------------------------------

@pytest.fixture
def encoding():
    def pin(mode):
        for mod in (ref_dispatch, port_dispatch):
            mod.set_dispatch_encoding(mode)

    yield pin
    pin(None)


def bench_values(k):
    """bench.py measure_dispatch's URL values."""
    return [f"https://bench{i}.example/path/{i % 97}/{i}".encode()
            for i in range(k)]


def both_pools(values):
    """One pool (values + an empty null sentinel) in both packages."""
    data = np.frombuffer(b"".join(values), dtype=np.uint8).copy()
    offsets = ref_batch._offsets_from_lengths(
        [len(v) for v in values] + [0])
    ref = ref_batch.DictPool(data, offsets, null_code=len(values))
    return ref, pool_from_jax(ref.values_data, ref.values_offsets,
                              ref.null_code)


def chain_batches(case):
    """The same batch in both packages: bench.py measure_dispatch's
    columns (URL, RegionID), URL flat or dictionary-encoded."""
    rng = np.random.default_rng(11)
    n = N_CHAIN
    regions = rng.integers(0, 500, n).astype(np.int32)
    k = 3 * n if case == "big_pool" else 4096
    values = bench_values(k)
    validity = rng.random(n) > 0.05
    codes = np.where(validity, rng.integers(0, k, n), k).astype(np.int32)
    spec = [("URL", "utf8"), ("RegionID", "int32")]
    out = []
    pools = both_pools(values)
    for bat, sch, pool in ((ref_batch, ref_schema, pools[0]),
                           (port_batch, new_table_schema, pools[1])):
        schema = sch(spec)
        enc = bat.DictEnc(codes.copy(), pool=pool)
        url = (bat.Column("URL", schema.find("URL").data_type,
                          *enc.materialize(), validity.copy())
               if case == "flat" else
               bat.Column("URL", schema.find("URL").data_type,
                          validity=validity.copy(), dict_enc=enc))
        region = bat.Column("RegionID", schema.find("RegionID").data_type,
                            regions.copy())
        out.append(bat.ColumnBatch(TableID("bench", "dispatch"), schema,
                                   {"URL": url, "RegionID": region}))
    return out


def column_bytes(col):
    return (np.asarray(col.data).tobytes(),
            None if col.offsets is None else col.offsets.tobytes(),
            None if col.validity is None else col.validity.tobytes())


def encoded_column(col):
    pool = col.dict_enc.pool
    return (col.dict_enc.indices.astype(np.int32).tobytes(),
            pool.values_data.tobytes(), pool.values_offsets.tobytes(),
            pool.null_code,
            None if col.validity is None else col.validity.tobytes())


@pytest.fixture
def device_placement():
    ref_tfused.set_device_fusion(True)
    for mod in (ref_tfused, port_tfused):
        mod.set_placement("device")
    yield
    ref_tfused.set_device_fusion(None)
    for mod in (ref_tfused, port_tfused):
        mod.set_placement(None)


@pytest.mark.parametrize("case,mode", [("flat", "auto"), ("dict", "auto"),
                                       ("big_pool", "auto")])
def test_chain_mesh_route_matches_jax(case, mode, mesh8, encoding,
                                      device_placement):
    ref_in, port_in = chain_batches(case)
    encoding(mode)
    chain = build_chain(CONFIG, device="cpu")
    ref_chain = ref_build_chain(CONFIG)
    step = chain.plan_for(port_in.table_id, port_in.schema).steps[0]
    ref_step = ref_chain.plan_for(ref_in.table_id, ref_in.schema).steps[0]
    assert isinstance(step, port_tfused.DeviceFusedStep)
    assert step._sharded_min_rows == ref_step._sharded_min_rows == 8 * 1024
    port_batch.reset_flat_materializations()
    out = chain.apply(port_in)
    ref_out = ref_chain.apply(ref_in)
    # both took the mesh route, and their cross-shard sums agree
    assert step.sharded_program.last_shard_hist is not None
    np.testing.assert_array_equal(step.sharded_program.last_shard_hist,
                                  ref_step.sharded_program.last_shard_hist)
    assert step.sharded_program.last_kept == \
        ref_step.sharded_program.last_kept == out.n_rows
    assert out.n_rows == ref_out.n_rows
    url, ref_url = out.column("URL"), ref_out.column("URL")
    stays_dict = case == "dict" and mode == "auto"
    assert url.is_lazy_dict == ref_url.is_lazy_dict == stays_dict
    if stays_dict:
        assert encoded_column(url) == encoded_column(ref_url)
        assert port_batch.flat_materializations() == 0
    else:
        assert column_bytes(url) == column_bytes(ref_url)
    assert column_bytes(out.column("RegionID")) == \
        column_bytes(ref_out.column("RegionID"))


@pytest.mark.parametrize("state", ["fresh", "hashed", "big_pool", "flat"])
def test_link_model_mesh_branches_match_jax(state, mesh8):
    ref_in, port_in = chain_batches("big_pool" if state == "big_pool"
                                    else "flat" if state == "flat"
                                    else "dict")
    ref_tfused.set_device_fusion(True)
    try:
        step = build_chain(CONFIG, device="cpu").plan_for(
            port_in.table_id, port_in.schema).steps[0]
        ref_step = ref_build_chain(CONFIG).plan_for(
            ref_in.table_id, ref_in.schema).steps[0]
    finally:
        ref_tfused.set_device_fusion(None)
    if state == "hashed":
        port_fm.dict_mask_input(KEY, port_in.column("URL"), "cpu")
        ref_fm.dict_mask_input(KEY, ref_in.column("URL"))
    for n in (N_CHAIN, 1000):  # the mesh route, and below its threshold
        assert step._estimate_link_bytes(n, port_in) == \
            ref_step._estimate_link_bytes(n, ref_in)


def test_virtual_jax_mesh_present():
    assert len(jax.devices()) == 8  # conftest's virtual CPU mesh


# -- kernel K13/K14's counting routes and scratch (host side) ----------------

MESH_SOURCE = (Path(port_fm.__file__).resolve().parent.parent / "csrc"
               / "mesh.cu").read_text()


def test_hist_limits_match_the_source():
    """Up to BALLOT_SHARDS bins the kernel counts by warp ballots, above
    by shared-memory adds, up to MAX_SHARDS."""
    assert BALLOT_SHARDS == int(re.search(
        r"kBallotShards = (\d+);", MESH_SOURCE).group(1)) == 32
    assert MAX_SHARDS == int(re.search(
        r"kMaxShards = (\d+);", MESH_SOURCE).group(1))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 31, 32, 33, MAX_SHARDS])
def test_fused_hist_at_the_route_edges_matches_jax(n_shards):
    """The bin counts on each side of the kernel's route edge (ballots up
    to BALLOT_SHARDS bins, shared-memory adds above) and at its limit,
    over a row count no multiple of 32, in both layouts."""
    rng = np.random.default_rng(300 + n_shards)
    n = 1000
    words = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    valid = rng.random(n) > 0.1
    pred = rng.random(n) > 0.3
    dig = torch.from_numpy(words.view(np.int32))
    want = jax_hist(words[None, :, 0], valid & pred, n_shards)
    def packed(bits):  # whole words, the pad bits clear
        return pack_words(np.pad(bits, (0, -n % 32)))

    for as_t in (packed, torch.from_numpy):
        got = shard_hist_fused(dig, n_shards, as_t(valid), as_t(pred))
        np.testing.assert_array_equal(got.numpy()[:n_shards], want)
        assert got[n_shards] == (valid & pred).sum()


def test_hist_outputs_one_pending_buffer_per_stream():
    """Each launch adds into its stream's pending zeros and hands the
    next launch the buffer it zeroes; a raising launch leaves its stream
    no pending buffer."""
    outputs = HistOutputs()
    cpu = torch.device("cpu")
    with outputs.launch(cpu, 7, 17) as (out1, next1):
        assert not out1.any() and out1.numel() == HistOutputs.MIN_WORDS
        assert next1.numel() == out1.numel() and next1 is not out1
        next1.zero_()  # what the kernel does
    with outputs.launch(cpu, 9, 5) as (other, _):
        assert other is not next1  # another stream, another buffer
    with pytest.raises(RuntimeError):
        with outputs.launch(cpu, 7, 17) as (out2, _):
            assert out2 is next1
            raise RuntimeError("launch refused")
    with outputs.launch(cpu, 7, MAX_SHARDS + 1) as (out3, next3):
        # more bins than the pending buffer holds: a new one, zeros
        assert out3 is not next1 and out3.numel() == MAX_SHARDS + 1
        assert not out3.any() and next3.numel() == MAX_SHARDS + 1
    with outputs.launch(cpu, 7, MAX_SHARDS + 1) as (out4, _):
        assert out4 is next3


def test_hist_outputs_after_a_raising_launch():
    """A launch can run and then report an error: it has added into its
    output and zeroed nothing that can be trusted, so the stream's next
    launch must start from new zeros, not from either buffer."""
    outputs = HistOutputs()
    cpu = torch.device("cpu")
    with outputs.launch(cpu, 3, 5) as (_, nxt):
        nxt.zero_()
    with pytest.raises(RuntimeError):
        with outputs.launch(cpu, 3, 5) as (out, nxt2):
            assert out is nxt
            out += 7  # the kernel ran: the output holds counts
            nxt2.fill_(-1)  # and the next buffer was not zeroed
            raise RuntimeError("an error reported after the launch")
    with outputs.launch(cpu, 3, 5) as (out, _):
        assert out is not nxt and out is not nxt2
        assert not out.any() and out.numel() == HistOutputs.MIN_WORDS
