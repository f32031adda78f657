"""K-B (predicate decode) and the dispatch encoders against the JAX package.

Both directions: the port's encoders followed by the port's plain decode
(what a CPU tensor runs) equal the JAX package's `encode_pred_column`
followed by its `decode_pred_device`, and each side decodes the other's
wire.  Exact: the outputs are integers and bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transferia_tpu.ops import decode as ref_decode
from transferia_tpu.ops import dispatch as ref_dispatch
from transferia_tpu_torch.ops import decode as port_decode
from transferia_tpu_torch.ops import dispatch as port_dispatch


def to_words(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy())


def port_decode_column(spec, arrays, bucket):
    """Stage host arrays as CPU tensors and decode with the port."""
    staged, _ = port_dispatch.stage_h2d(tuple(arrays), torch.device("cpu"),
                                        None)
    data, valid = port_dispatch.decode_pred_device(spec, staged, bucket)
    data = data.numpy().astype(spec.dtype)
    valid = (np.ones(bucket, dtype=np.bool_) if valid is None
             else valid.numpy())
    return data, valid


def ref_decode_column(spec, arrays, bucket):
    data, valid = ref_dispatch.decode_pred_device(
        spec, tuple(jnp.asarray(a) for a in arrays), bucket)
    return np.asarray(data), np.asarray(valid)


def columns(n, seed):
    rng = np.random.default_rng(seed)
    sorted_ids = np.sort(rng.integers(-10**6, 10**6, n)).astype(np.int32)
    # each 256-row frame sits near its own base: frame-of-reference wins
    # where the jumps between frames are too wide for the delta wire
    frame_base = rng.integers(-2**30, 2**30, n // 256 + 1)
    clustered = (frame_base[np.arange(n) // 256]
                 + rng.integers(0, 1000, n)).astype(np.int32)
    return {
        "sorted_i32": sorted_ids,
        "clustered_i32": clustered,
        "random_i32": rng.integers(-2**31, 2**31, n).astype(np.int32),
        "region_i32": rng.integers(0, 500, n).astype(np.int32),
        "i16": rng.integers(-300, 300, n).astype(np.int16),
        "u16": rng.integers(0, 65536, n).astype(np.uint16),
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "u8": rng.integers(0, 256, n).astype(np.uint8),
        "flag": rng.integers(0, 2, n).astype(np.bool_),
        "f32": rng.random(n).astype(np.float32),
    }


@pytest.mark.parametrize("encoded", [True, False])
@pytest.mark.parametrize("with_nulls", [True, False])
@pytest.mark.parametrize("n_rows,bucket", [(4096, 4096), (3000, 4096),
                                           (200, 256)])
def test_encode_then_decode_matches_jax(encoded, with_nulls, n_rows,
                                        bucket):
    rng = np.random.default_rng(n_rows)
    kinds = set()
    for name, data in columns(n_rows, seed=n_rows).items():
        validity = rng.random(n_rows) > 0.1 if with_nulls else None
        spec, arrs = port_dispatch.encode_pred_column(
            name, data, validity, n_rows, bucket, encoded)
        rspec, rarrs, _raw = ref_dispatch.encode_pred_column(
            name, data, validity, n_rows, bucket, encoded)
        assert (spec.name, spec.dtype, spec.kind, spec.bit_width,
                spec.valid_mode, spec.frame) == (
            rspec.name, rspec.dtype, rspec.kind, rspec.bit_width,
            rspec.valid_mode, rspec.frame)
        assert len(arrs) == len(rarrs)
        for a, b in zip(arrs, rarrs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        kinds.add(spec.kind)
        want = ref_decode_column(rspec, rarrs, bucket)
        # the port decodes its own wire and the reference's
        for got in (port_decode_column(spec, arrs, bucket),
                    port_decode_column(spec, rarrs, bucket)):
            np.testing.assert_array_equal(got[0], want[0], err_msg=name)
            np.testing.assert_array_equal(got[1], want[1], err_msg=name)
        # and the reference decodes the port's wire
        back = ref_decode_column(rspec, arrs, bucket)
        np.testing.assert_array_equal(back[0], want[0], err_msg=name)
    if encoded and n_rows >= 256:
        assert {"delta", "for", "bits", "raw"} <= kinds


@pytest.mark.parametrize("bw", range(1, 33))
def test_unpack_every_width_matches_jax(bw):
    rng = np.random.default_rng(bw)
    for n in (1024, 999):
        vals = rng.integers(0, 2**bw, n, dtype=np.uint64)
        words = port_dispatch.pack_bits_host(vals, bw)
        np.testing.assert_array_equal(
            words, ref_dispatch.pack_bits_host(vals, bw))
        want = np.asarray(ref_decode._unpack_core(jnp.asarray(words), bw, n))
        got = port_decode.unpack_plain(to_words(words), bw, n)
        np.testing.assert_array_equal(
            port_decode._wrap_i32(got).numpy(), want)
        if n % 256:
            continue  # row buckets are multiples of the FOR frame
        base = int(rng.integers(-2**31, 2**31))
        mins = rng.integers(-2**31, 2**31, n // 256).astype(np.int32)
        np.testing.assert_array_equal(
            port_decode.delta_prefix_sum(to_words(words), base, bw,
                                         n).numpy(),
            np.asarray(ref_decode.delta_prefix_sum(
                jnp.asarray(words), jnp.int32(base), bw, n)))
        np.testing.assert_array_equal(
            port_decode.for_frame_decode(
                to_words(words), torch.from_numpy(mins), bw, 256,
                n).numpy(),
            np.asarray(ref_decode.for_frame_decode(
                jnp.asarray(words), jnp.asarray(mins), bw, 256, n)))


def test_delta_cap_and_for_span():
    n = 4096
    step = 2**29 - 2001  # zigzag codes of these deltas need exactly 30 bits
    vals = ((np.arange(n) % 2) * step).astype(np.int32)
    enc = port_dispatch.encode_delta(vals)
    assert enc is not None and enc[2] == 30
    assert ref_dispatch.encode_delta(vals)[2] == 30
    base, words, bw = enc
    np.testing.assert_array_equal(
        port_decode.delta_prefix_sum(to_words(words), base, bw, n).numpy(),
        vals)
    # one step more needs 31 bits: both encoders refuse the delta wire
    wide = ((np.arange(n) % 2) * 2**30).astype(np.int32)
    assert port_dispatch.encode_delta(wide) is None
    assert ref_dispatch.encode_delta(wide) is None
    # a 32-bit frame-of-reference span wraps int32 exactly
    span = np.tile(np.array([-2**31, 2**31 - 1], dtype=np.int64), 128)
    rel = (span - span.min()).astype(np.uint64)
    words = port_dispatch.pack_bits_host(rel, 32)
    mins = np.array([-2**31], dtype=np.int32)
    got = port_decode.for_frame_decode(to_words(words),
                                       torch.from_numpy(mins), 32, 256, 256)
    np.testing.assert_array_equal(got.numpy(), span.astype(np.int32))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_decode.for_frame_decode(
            jnp.asarray(words), jnp.asarray(mins), 32, 256, 256)))


@pytest.mark.parametrize("n", [32, 256, 4096])
def test_keep_mask_pack_roundtrip_matches_jax(n):
    bits = np.random.default_rng(n).random(n) > 0.5
    got = port_decode.pack_mask_words(torch.from_numpy(bits), n)
    want = np.asarray(ref_decode.pack_mask_words(jnp.asarray(bits), n))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    for k in (n, n - 5):
        np.testing.assert_array_equal(
            port_dispatch.unpack_mask_host(got.numpy().view(np.uint32), k),
            ref_dispatch.unpack_mask_host(want, k))
        np.testing.assert_array_equal(
            port_dispatch.unpack_mask_host(want, k), bits[:k])


def test_validity_bitmap_matches_jax():
    valid = np.random.default_rng(5).random(1000) > 0.3
    words = port_dispatch.encode_validity(valid)
    np.testing.assert_array_equal(words,
                                  ref_dispatch.encode_validity(valid))
    np.testing.assert_array_equal(
        port_decode.unpack_validity(to_words(words), 1000).numpy(), valid)
    np.testing.assert_array_equal(
        np.asarray(ref_decode.unpack_validity(jnp.asarray(words), 1000)),
        valid)


@pytest.mark.parametrize("bad", ["mode", "width", "short", "frame"])
def test_wrapper_rejects_bad_arguments(bad):
    words = torch.zeros(8, dtype=torch.int32)
    kw = dict(mode=port_decode.MODE_DELTA, words=words, n=64, bit_width=4)
    if bad == "mode":
        kw["mode"] = 7
    elif bad == "width":
        kw["bit_width"] = 33
    elif bad == "short":
        kw["n"] = 1000
    else:
        kw.update(mode=port_decode.MODE_FOR, frame=48)
    with pytest.raises(ValueError):
        port_decode.pred_decode(**kw)


# -- the delta scan at its tile edges --------------------------------------------

TILE = port_decode.DELTA_TILE


@pytest.mark.parametrize("n", [1, 31, 33, TILE - 1, TILE, TILE + 1,
                               3 * TILE + 5, 65536])
@pytest.mark.parametrize("bw", [1, 17, 30, 32])
def test_delta_at_tile_edges_matches_jax(bw, n):
    """Deltas of every width, whose running sum wraps int32 again and
    again (a base near the top, codes up to 2^bw - 1), across tiles."""
    rng = np.random.default_rng(bw * 100_003 + n)
    vals = rng.integers(0, 2**bw, n, dtype=np.uint64)
    if bw >= 30:
        # large positive deltas (even zigzag codes): the sum wraps at
        # least once a tile
        vals[::2] = (vals[::2] | np.uint64(2**(bw - 1))) & ~np.uint64(1)
    words = port_dispatch.pack_bits_host(vals, bw)
    base = 2**31 - 7
    got = port_decode.delta_prefix_sum(to_words(words), base, bw, n)
    want = np.asarray(ref_decode.delta_prefix_sum(
        jnp.asarray(words), jnp.int32(base), bw, n))
    np.testing.assert_array_equal(got.numpy(), want)


def test_delta_tiles():
    assert [port_decode.delta_tiles(n) for n in
            (1, TILE - 1, TILE, TILE + 1, 65536, 1 << 20)] == [
        1, 1, 1, 2, 65536 // TILE, (1 << 20) // TILE]
    # the scratch made first holds the largest row bucket's tiles
    assert port_decode.ScanScratch.MIN_TILES == (1 << 20) // TILE


def test_scan_scratch_epochs_and_tickets_per_stream():
    scratch = port_decode.ScanScratch()
    cpu = torch.device("cpu")
    seen = []
    for stream, tiles in ((7, 16), (7, 32), (9, 2), (7, 1)):
        with scratch.launch(cpu, stream, tiles) as (buf, epoch, base):
            seen.append((stream, id(buf), epoch, base))
            assert buf.dtype == torch.int64 and not buf.any()
            assert buf.numel() == scratch.MIN_TILES + 1
    (_, b7, e1, t1), (_, b7b, e2, t2), (_, b9, e9, t9), (_, b7c, e3, t3) = seen
    assert b7 == b7b == b7c != b9          # one buffer a stream
    assert (e1, e2, e3, e9) == (1, 2, 3, 1)  # a new epoch every launch
    assert (t1, t2, t3, t9) == (0, 16, 48, 0)  # the counter's value


def test_scan_scratch_grows_wraps_and_skips_failed_launches():
    scratch = port_decode.ScanScratch()
    cpu = torch.device("cpu")
    with scratch.launch(cpu, 1, 4) as (buf, epoch, base):
        buf[0] = 4  # the kernel's ticket counter after 4 tiles
    with pytest.raises(RuntimeError):
        with scratch.launch(cpu, 1, 4) as (_, epoch, base):
            assert (epoch, base) == (2, 4)
            raise RuntimeError("launch refused")
    with scratch.launch(cpu, 1, 4) as (_, epoch, base):
        assert (epoch, base) == (2, 4)     # the refused launch took nothing
    big = scratch.MIN_TILES + 10
    with scratch.launch(cpu, 1, big) as (buf, epoch, base):
        # a larger scan gets a new zeroed buffer, its counter at 0
        assert buf.numel() == big + 1 and not buf.any()
        assert (epoch, base) == (1, 0)
    scratch._slots[(cpu, 1)].epoch = scratch.EPOCH_MAX
    with scratch.launch(cpu, 1, 1) as (buf, epoch, base):
        # the epoch field is full: a new buffer, the epochs start again
        assert (epoch, base) == (1, 0) and buf.numel() == big + 1
