"""K12 (the device ragged pack) of the PyTorch port against the JAX package.

The port's plain PyTorch version of kernel K12 (what a CPU tensor runs)
must give, byte for byte, the JAX package's `pack_blocks_device` (its
XLA program on the CPU backend, fed the slack it needs) and both
packages' host pack `prepare_padded_blocks(prefix_len=64)`: the cases of
tests/unit/test_raggedpack.py, the SHA block boundaries (55/56, 119/120
bytes) at 1 to 8 blocks, and bucket pad rows, which the port leaves
zero with a block count of 0.  The port needs no slack past the last
row, and a row longer than its blocks raises before any launch.  The
fused program with the device pack forced gives the JAX program's hex
digests.  Exact: the outputs are bytes.
"""

import numpy as np
import pytest
import torch

from transferia_tpu.columnar.batch import bucket_rows
from transferia_tpu.ops import fused as ref_fused
from transferia_tpu.ops import raggedpack as ref_pack
from transferia_tpu.ops import sha256 as ref_sha
from transferia_tpu.predicate import parse as ref_parse
from transferia_tpu_torch.ops import fused as port_fused
from transferia_tpu_torch.ops import raggedpack as port_pack
from transferia_tpu_torch.ops import sha256 as port_sha
from transferia_tpu_torch.predicate import parse

BOUNDARY_LENS = [0, 1, 54, 55, 56, 63, 64, 119, 120, 500]


def make_ragged(msgs):
    data = np.frombuffer(b"".join(msgs), dtype=np.uint8).copy()
    offsets = np.cumsum([0] + [len(m) for m in msgs]).astype(np.int32)
    return data, offsets


def random_msgs(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]


def reference_pack(data, offsets, bucket, mb):
    """The JAX package's device pack, given its slack pad."""
    flat = np.pad(data, (0, mb * 64))
    blocks, nb = ref_pack.pack_blocks_device(flat, offsets, bucket, mb)
    return np.asarray(blocks), np.asarray(nb)


def port_pack_cpu(data, offsets, bucket, mb):
    blocks, nb = port_pack.pack_blocks_device(data, offsets, bucket, mb,
                                              device="cpu")
    return blocks.numpy(), nb.numpy()


def check_against_both(msgs, mb, bucket):
    data, offsets = make_ragged(msgs)
    n = len(msgs)
    blocks, nb = port_pack_cpu(data, offsets, bucket, mb)
    assert blocks.shape == (bucket, mb * 64) and nb.shape == (bucket,)
    ref_blocks, ref_nb = reference_pack(data, offsets, bucket, mb)
    np.testing.assert_array_equal(blocks[:n], ref_blocks[:n])
    np.testing.assert_array_equal(nb[:n], ref_nb[:n])
    for pkg in (port_sha, ref_sha):
        want, want_nb, _ = pkg.prepare_padded_blocks(
            data, offsets, prefix_len=64, max_blocks=mb)
        np.testing.assert_array_equal(blocks[:n], want)
        np.testing.assert_array_equal(nb[:n], want_nb)
    # bucket pad rows: zero bytes, no blocks (K-A keeps their state)
    assert not blocks[n:].any()
    assert not nb[n:].any()


REF_CASES = [  # tests/unit/test_raggedpack.py::test_parity_with_host_pack
    [b"", b"a", b"hello world", b"x" * 54, b"y" * 55, b"z" * 100],
    [b"u" * 3 for _ in range(40)],
    [bytes([i % 251]) * (i % 120) for i in range(70)],
]


@pytest.mark.parametrize("case", range(len(REF_CASES)))
def test_reference_cases(case):
    msgs = REF_CASES[case]
    mb = port_fused.pow2_blocks(max(len(m) for m in msgs))
    check_against_both(msgs, mb, bucket_rows(len(msgs)))


@pytest.mark.parametrize("mb", range(1, 9))
def test_block_boundaries(mb):
    """Every boundary length that fits mb blocks, the longest row that
    fits, and random lengths; bucket pad rows after them."""
    fit = mb * 64 - 9
    lens = [n for n in BOUNDARY_LENS if n <= fit] + [fit]
    lens += list(np.random.default_rng(mb).integers(0, fit + 1, 37))
    check_against_both(random_msgs(lens, seed=100 + mb), mb,
                       len(lens) + 11)


def test_no_slack_and_a_buffer_ending_at_the_last_row():
    """The flat buffer ends exactly at off[n] (the reference needs width
    bytes past it); nonzero bytes right after a row do not leak in."""
    msgs = random_msgs([7, 120, 0, 56], seed=5)
    data, offsets = make_ragged(msgs)
    assert len(data) == offsets[-1]
    check_against_both(msgs, 4, 4)
    # a row whose bytes are followed by others in the buffer
    blocks, _ = port_pack_cpu(data, offsets[:2], 1, 4)
    assert blocks[0, 7] == 0x80 and not blocks[0, 8:56].any()


def test_empty_rows_and_empty_buffer():
    data = np.zeros(0, dtype=np.uint8)
    offsets = np.zeros(4, dtype=np.int32)
    check_against_both([b"", b"", b""], 1, 256)
    blocks, nb = port_pack_cpu(data, offsets, 256, 1)
    assert nb[:3].tolist() == [1, 1, 1] and blocks[0, 0] == 0x80


@pytest.mark.parametrize("mb", [1, 2, 4])
def test_row_longer_than_its_blocks_raises(mb):
    msgs = random_msgs([3, mb * 64 - 8], seed=mb)
    data, offsets = make_ragged(msgs)
    with pytest.raises(ValueError, match="SHA blocks"):
        port_pack.pack_blocks_device(data, offsets, 256, mb, device="cpu")
    with pytest.raises(ValueError, match="SHA blocks"):
        ref_pack.pack_blocks_device(np.pad(data, (0, mb * 64)), offsets,
                                    256, mb)


def test_wrapper_rejects_bad_arguments():
    data = torch.zeros(10, dtype=torch.uint8)
    offsets = torch.tensor([0, 4, 10], dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        port_pack.ragged_pack(data.to(torch.int32), offsets, 256, 1)
    with pytest.raises(ValueError, match="int32"):
        port_pack.ragged_pack(data, offsets.to(torch.int64), 256, 1)
    with pytest.raises(ValueError, match="bucket"):
        port_pack.ragged_pack(data, offsets, 1, 1)
    with pytest.raises(ValueError, match="bucket"):
        port_pack.ragged_pack(data, offsets, 256, 0)


def test_fused_program_with_the_device_pack(monkeypatch):
    """FusedMaskFilterProgram(device="cpu") with the device-pack route
    forced: one unchunked launch of K12's plain version then K-A's, hex
    digests and keep mask equal to the JAX program's."""
    monkeypatch.setattr(port_fused, "_pallas_pack_enabled",
                        lambda device: True)
    port_fused.set_chunk_rows(256)  # would chunk, the device pack does not
    ref_fused.set_chunk_rows(0)
    try:
        rng = np.random.default_rng(9)
        n = 1000
        msgs = random_msgs(list(rng.integers(0, 180, n)), seed=9)
        data, offsets = make_ragged(msgs)
        # a second column: the last n rows of 2n, offsets starting past 0
        more = random_msgs(list(rng.integers(0, 120, 2 * n)), seed=10)
        tail_data, tail_off = make_ragged(more)
        tail_off = tail_off[n:]
        region = rng.integers(0, 500, n).astype(np.int32)
        valid = rng.random(n) > 0.1
        pred = {"region": (region, valid)}
        keys = [b"pack-key", b"second"]
        mask_cols = [(data, offsets), (tail_data, tail_off)]
        text = "region < 400"
        calls = []
        real = port_fused.ragged_pack
        monkeypatch.setattr(port_fused, "ragged_pack",
                            lambda *a: calls.append(1) or real(*a))
        program = port_fused.FusedMaskFilterProgram(keys, parse(text),
                                                    device="cpu")
        hexes, keep = program.run(mask_cols, pred, n)
        ref = ref_fused.FusedMaskFilterProgram(keys, ref_parse(text))
        ref_hexes, ref_keep = ref.run(mask_cols, pred, n)
    finally:
        port_fused.set_chunk_rows(None)
        ref_fused.set_chunk_rows(None)
    assert len(calls) == 2  # one pack per masked column, one launch
    for got, want in zip(hexes, ref_hexes):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(keep, ref_keep)


def test_device_pack_only_on_a_card(monkeypatch):
    monkeypatch.setenv("TRANSFERIA_TPU_PALLAS_PACK", "1")
    assert not port_fused._pallas_pack_enabled(torch.device("cpu"))
    assert port_fused._pallas_pack_enabled(torch.device("cuda", 0))
    monkeypatch.setenv("TRANSFERIA_TPU_PALLAS_PACK", "0")
    assert not port_fused._pallas_pack_enabled(torch.device("cuda", 0))
