"""The port's mesh-sharded fused program (K14) against the JAX package.

The JAX package runs on conftest's virtual 8-device CPU mesh, the port
on `testing.force_virtual_mesh(8)` over the CPU (every kernel's plain
PyTorch version).  Inputs are made with numpy from a seed and fed to
both; a dictionary pool's content goes to both (`weights.pool_from_jax`).
Exact equality throughout: hex digests, keep masks, histograms, counts,
encoded arrays and staged byte counts are integers or bytes.

- `digest_gather` (K14's gather) against `jnp.take(mode="clip")`, with
  negative and out-of-range codes;
- the per-shard encoders' specs and arrays against the reference's, and
  their decode (`decode_pred_device_sharded`) against the source rows;
- `ShardedFusedProgram.run` against the reference's for flat, dict,
  mixed-route and no-predicate inputs on a ragged 8*1024+37-row batch,
  the port with the encoding `auto` and `raw` (the reference's outputs
  do not depend on it; it runs once per case): hexes, keep, `last_kept`,
  `last_shard_hist` and the raw-wire byte count; JAX key states through
  `run(states=...)` against hmac/hashlib;
The chain's mesh route is held against the reference in
tests/test_torch_mesh.py.
"""

import hashlib
import hmac

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.columnar import batch as ref_batch
from transferia_tpu.ops import dispatch as ref_dispatch
from transferia_tpu.ops.sha256 import _hmac_key_states as ref_key_states
from transferia_tpu.parallel import fusedmesh as ref_fm
from transferia_tpu.predicate import parse as ref_parse
from transferia_tpu.stats.trace import TELEMETRY
from transferia_tpu_torch.abstract.schema import new_table_schema
from transferia_tpu_torch.columnar import batch as port_batch
from transferia_tpu_torch.ops import dispatch as port_dispatch
from transferia_tpu_torch.parallel import fusedmesh as port_fm
from transferia_tpu_torch.predicate import parse
from transferia_tpu_torch.testing import force_virtual_mesh
from transferia_tpu_torch.weights import pool_from_jax

KEY = b"bench-salt"
N_RAGGED = 8 * 1024 + 37     # not a multiple of the shard count
PRED = "region < 400 OR event_id < 200"


@pytest.fixture
def mesh8():
    force_virtual_mesh(8)
    yield
    force_virtual_mesh(None)


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


def flat(values):
    data = np.frombuffer(b"".join(values), dtype=np.uint8).copy()
    return data, ref_batch._offsets_from_lengths([len(v) for v in values])


# -- K14's digest gather -----------------------------------------------------------

@pytest.mark.parametrize("k", [1, 7, 64])
def test_digest_gather_clips_as_jnp_take(k):
    rng = np.random.default_rng(k)
    table = rng.integers(0, 2**32, (k, 8), dtype=np.uint64).astype(np.uint32)
    codes = rng.integers(-3, k + 3, 500).astype(np.int32)
    codes[:6] = [-5, -1, k, k + 100, 2**31 - 1, -2**31]
    got = port_fm.digest_gather(torch.from_numpy(table.view(np.int32)),
                                torch.from_numpy(codes))
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(codes),
                               axis=0, mode="clip"))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert port_fm.digest_gather(
        torch.from_numpy(table.view(np.int32)),
        torch.zeros(0, dtype=torch.int32)).shape == (0, 8)


# -- per-shard encoders --------------------------------------------------------------

def encoder_columns():
    """name -> (data, validity): one column per encoding kind."""
    rng = np.random.default_rng(8)
    n = 4 * 1024 - 100  # pads into 4 shards of 1024
    frames = np.repeat(np.where(np.arange(n // 256 + 1) % 2, 2**30, -2**30),
                       256)[:n]
    return {
        "int32": (rng.integers(0, 500, n).astype(np.int32),
                  rng.random(n) > 0.2),
        "int64_sorted": (np.arange(n, dtype=np.int64) * 3 + 100, None),
        "for": ((frames + rng.integers(0, 200, n)).astype(np.int32), None),
        "wide": (rng.integers(-2**31, 2**31, n).astype(np.int64),
                 rng.random(n) > 0.5),
        "bool": (rng.random(n) > 0.5, rng.random(n) > 0.1),
        "float": (rng.random(n).astype(np.float32), None),
    }


ENC_COLS = encoder_columns()
KINDS = {"int32": "delta", "int64_sorted": "delta", "for": "for",
         "wide": "for", "bool": "bits", "float": "raw"}


def spec_fields(spec):
    return (spec.name, spec.dtype, spec.kind, spec.bit_width,
            spec.valid_mode, spec.frame)


@pytest.mark.parametrize("encoded", [True, False])
@pytest.mark.parametrize("name", sorted(ENC_COLS))
def test_sharded_encoders_match_jax(name, encoded):
    data, validity = ENC_COLS[name]
    n = len(data)
    args = (name, data, validity, n, 4, 1024, encoded)
    spec, arrays, raw = port_dispatch.encode_pred_column_sharded(*args)
    ref_spec, ref_arrays, ref_raw = \
        ref_dispatch.encode_pred_column_sharded(*args)
    assert spec_fields(spec) == spec_fields(ref_spec)
    assert spec.kind == (KINDS[name] if encoded else "raw")
    assert raw == ref_raw
    assert len(arrays) == len(ref_arrays)
    for got, want in zip(arrays, ref_arrays):
        assert got.shape[0] == 4
        np.testing.assert_array_equal(got, want)
    # each shard decodes alone (kernel K-B's plain version) to its rows
    padded = np.pad(data, (0, 4 * 1024 - n), mode="edge")
    valid = (np.ones(4 * 1024, dtype=bool) if validity is None
             else np.pad(validity, (0, 4 * 1024 - n)))
    staged = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                               if a.dtype == np.uint32 else a)
              for a in arrays]
    if spec.kind == "delta":
        staged[1] = tuple(int(b) for b in arrays[1])
    for s in range(4):
        local = tuple(a[s:s + 1] for a in staged)
        got, got_valid = port_dispatch.decode_pred_device_sharded(
            spec, local, 1024)
        rows = slice(s * 1024, (s + 1) * 1024)
        want = padded[rows]
        if spec.kind in ("delta", "for"):
            want = want.astype(np.int32)
        np.testing.assert_array_equal(got.numpy(), want)
        if got_valid is None:
            assert spec.valid_mode == "none" and valid[rows].all()
        else:
            np.testing.assert_array_equal(got_valid.numpy(), valid[rows])


def test_validity_words_match_jax():
    v2 = np.random.default_rng(9).random((8, 256)) > 0.3
    np.testing.assert_array_equal(port_dispatch.encode_validity_sharded(v2),
                                  ref_dispatch.encode_validity_sharded(v2))


# -- the program -----------------------------------------------------------------------

def program_inputs(case):
    """(mask keys, port mask cols, reference mask cols, pred cols, pred)."""
    rng = np.random.default_rng(31)
    n = N_RAGGED
    pred_cols = {
        "region": (rng.integers(0, 500, n).astype(np.int32),
                   rng.random(n) > 0.15),
        "event_id": (np.arange(n, dtype=np.int32) * 3 + 100, None),
    }
    ref_pool, pool = both_pools(bench_values(700))
    codes = np.where(rng.random(n) > 0.1, rng.integers(0, 700, n), 700)
    ref_col = ref_batch.Column("URL", ref_schema([("URL", "utf8")]).find(
        "URL").data_type, dict_enc=ref_batch.DictEnc(codes.astype(np.int32),
                                                     pool=ref_pool))
    col = port_batch.Column("URL", new_table_schema([("URL", "utf8")]).find(
        "URL").data_type, dict_enc=port_batch.DictEnc(codes.astype(np.int32),
                                                      pool=pool))
    dict_port = port_fm.dict_mask_input(KEY, col, "cpu")
    dict_ref = ref_fm.dict_mask_input(KEY, ref_col)
    np.testing.assert_array_equal(dict_port.digests, dict_ref.digests)
    assert dict_port.raw_block_bytes_per_row == \
        dict_ref.raw_block_bytes_per_row
    fl = flat([f"v{i}-{'x' * (i % 40)}".encode() for i in range(n)])
    port_cols = {"flat": [fl], "dict": [dict_port],
                 "mixed": [dict_port, fl], "nopred": [fl]}[case]
    ref_cols = {"flat": [fl], "dict": [dict_ref],
                "mixed": [dict_ref, fl], "nopred": [fl]}[case]
    keys = [KEY, b"second-key"][:len(port_cols)]
    pred = None if case == "nopred" else PRED
    return keys, port_cols, ref_cols, pred_cols, pred


_REFERENCE: dict = {}


def reference(case):
    """The JAX program's results for a case, computed once (encoding
    auto; the reference's outputs do not depend on the encoding,
    tests/unit/test_parallel_fused.py): (hexes, keep, kept, hist,
    telemetry)."""
    if case not in _REFERENCE:
        keys, _, ref_cols, pred_cols, pred = program_inputs(case)
        ref = ref_fm.ShardedFusedProgram(keys,
                                         ref_parse(pred) if pred else None)
        assert ref.n_dev == 8
        ref_dispatch.set_dispatch_encoding("auto")
        TELEMETRY.reset()
        try:
            hexes, keep = ref.run(ref_cols, pred_cols, N_RAGGED)
        finally:
            ref_dispatch.set_dispatch_encoding(None)
        _REFERENCE[case] = (hexes, keep, ref.last_kept, ref.last_shard_hist,
                            TELEMETRY.snapshot())
    return _REFERENCE[case]


@pytest.mark.parametrize("mode", ["auto", "raw"])
@pytest.mark.parametrize("case", ["flat", "dict", "mixed", "nopred"])
def test_program_matches_jax(case, mode, mesh8, encoding):
    ref_hexes, ref_keep, ref_kept, ref_hist, snap = reference(case)
    keys, port_cols, _, pred_cols, pred = program_inputs(case)
    encoding(mode)
    prog = port_fm.ShardedFusedProgram(
        keys, parse(pred) if pred else None, device="cpu")
    assert prog.n_dev == 8
    port_dispatch.reset_dispatch_bytes()
    hexes, keep = prog.run(port_cols, pred_cols, N_RAGGED)
    assert len(hexes) == len(ref_hexes)
    for got, want in zip(hexes, ref_hexes):
        assert got.shape == (N_RAGGED, 64)
        np.testing.assert_array_equal(got, want)
    if pred is None:
        assert keep is None and ref_keep is None
        assert prog.last_kept == N_RAGGED
    else:
        np.testing.assert_array_equal(keep, ref_keep)
        assert 0 < keep.sum() < N_RAGGED
    assert prog.last_kept == ref_kept
    np.testing.assert_array_equal(prog.last_shard_hist, ref_hist)
    assert prog.last_shard_hist.sum() == prog.last_kept
    staged = port_dispatch.dispatch_bytes()
    assert staged["raw_equiv"] == snap["h2d_raw_equiv_bytes"]
    if mode == "raw":
        # a dict column ships codes, but is charged the flat wire
        assert (staged["encoded"] == staged["raw_equiv"]) == \
            (case in ("flat", "nopred"))
    else:
        # a shard's delta base is a kernel argument, not staged bytes
        assert staged["encoded"] <= snap["h2d_encoded_bytes"] \
            < staged["raw_equiv"]


def test_program_takes_jax_key_states(mesh8):
    _, port_cols, _, pred_cols, _ = program_inputs("flat")
    other = b"another-key"
    prog = port_fm.ShardedFusedProgram([KEY], None, device="cpu")
    hexes, _ = prog.run(port_cols, pred_cols, N_RAGGED,
                        states=[ref_key_states(other)])
    data, offsets = port_cols[0]
    for i in (0, 1, 4321, N_RAGGED - 1):
        value = data[offsets[i]:offsets[i + 1]].tobytes()
        assert bytes(hexes[0][i]).decode() == \
            hmac.new(other, value, hashlib.sha256).hexdigest()


def test_program_needs_a_masked_column(mesh8):
    prog = port_fm.ShardedFusedProgram([], parse(PRED), device="cpu")
    with pytest.raises(ValueError, match="masked column"):
        prog.run([], {}, 10)
