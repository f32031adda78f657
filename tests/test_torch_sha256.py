"""K-A (HMAC-SHA256 / SHA-256) of the PyTorch port against the JAX package.

The port's plain PyTorch version of kernel K-A (what a CPU tensor runs)
must give the same digest words as the JAX package's device program and
as hashlib, on the same padded blocks and the same key states.  Exact:
the outputs are integers.
"""

import hashlib
import hmac

import jax
import numpy as np
import pytest
import torch

from transferia_tpu.ops import sha256 as ref_sha
from transferia_tpu_torch.ops import sha256 as port_sha
from transferia_tpu_torch.weights import states_from_jax

CPU = torch.device("cpu")
_ref_hmac = jax.jit(ref_sha.hmac_device_core, static_argnums=(4,))


def flat(messages):
    data = np.frombuffer(b"".join(messages), dtype=np.uint8).copy()
    offsets = np.zeros(len(messages) + 1, dtype=np.int32)
    offsets[1:] = np.cumsum([len(m) for m in messages])
    return data, offsets


def messages_up_to(max_len, n, seed):
    rng = np.random.default_rng(seed)
    lens = [0, max_len] + list(rng.integers(0, max_len + 1, n - 2))
    return [rng.integers(0, 256, k, dtype=np.uint8).tobytes() for k in lens]


# longest message (with the 64-byte HMAC prefix counted in the padding
# only) that fits mb blocks: mb*64 - 9
@pytest.mark.parametrize("mb", [1, 2, 4])
@pytest.mark.parametrize("key", [b"k", bytes(range(64)), b"long" * 30])
def test_hmac_plain_matches_jax_and_hashlib(mb, key):
    msgs = messages_up_to(mb * 64 - 9, 40, seed=mb)
    data, offsets = flat(msgs)
    blocks, nb, got_mb = port_sha.prepare_padded_blocks(
        data, offsets, prefix_len=64, max_blocks=mb)
    assert got_mb == mb
    # 8 pad rows with n_blocks = 0, as a bucket-padded batch has
    blocks = np.pad(blocks, ((0, 8), (0, 0)))
    nb = np.pad(nb, (0, 8))
    inner_np, outer_np = ref_sha._hmac_key_states(key)
    want = np.asarray(_ref_hmac(blocks, nb, inner_np[0], outer_np[0], mb))
    inner, outer = states_from_jax(inner_np, outer_np, CPU)
    got = port_sha.hmac_device_core(torch.from_numpy(blocks),
                                    torch.from_numpy(nb), inner, outer, mb)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    hexes = [bytes(r).hex() for r in port_sha._words_to_bytes(
        got.numpy().view(np.uint32))[:len(msgs)]]
    assert hexes == [hmac.new(key, m, hashlib.sha256).hexdigest()
                     for m in msgs]


@pytest.mark.parametrize("key", [b"", b"secret", b"x" * 64, b"y" * 100])
def test_key_states_match_jax(key):
    # the port computes the states with K-A in SHA mode (one block each)
    inner, outer = port_sha._hmac_key_states(key, CPU)
    ref_inner, ref_outer = ref_sha._hmac_key_states(key)
    np.testing.assert_array_equal(inner.numpy().view(np.uint32),
                                  ref_inner.reshape(8))
    np.testing.assert_array_equal(outer.numpy().view(np.uint32),
                                  ref_outer.reshape(8))


def test_sha256_mode_matches_jax_and_hashlib():
    msgs = [b"", b"abc", b"a" * 55, b"b" * 56, b"c" * 64, b"d" * 119,
            b"e" * 120, b"f" * 200, "unicode-é→".encode()]
    data, offsets = flat(msgs)
    blocks, nb, mb = port_sha.prepare_padded_blocks(data, offsets)
    words = port_sha.sha256_padded(torch.from_numpy(blocks),
                                   torch.from_numpy(nb), mb)
    got = port_sha._words_to_bytes(words.numpy().view(np.uint32))
    np.testing.assert_array_equal(got, ref_sha.sha256_batch(data, offsets))
    assert [bytes(r) for r in got] == [hashlib.sha256(m).digest()
                                       for m in msgs]


def test_prepare_padded_blocks_matches_jax():
    data, offsets = flat(messages_up_to(300, 30, seed=9))
    for prefix in (0, 64):
        got = port_sha.prepare_padded_blocks(data, offsets, prefix)
        want = ref_sha.prepare_padded_blocks(data, offsets, prefix)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_pad_rows_keep_initial_state():
    blocks = torch.zeros((4, 64), dtype=torch.uint8)
    nb = torch.zeros(4, dtype=torch.int32)
    h0 = port_sha._h0(CPU)
    got = port_sha.sha256_hmac(blocks, nb, h0, None, 1)
    assert bool((got == h0).all())


@pytest.mark.parametrize("bad", ["dtype", "width", "nblocks", "state"])
def test_wrapper_rejects_bad_arguments(bad):
    blocks = torch.zeros((4, 128), dtype=torch.uint8)
    nb = torch.ones(4, dtype=torch.int32)
    init = port_sha._h0(CPU)
    if bad == "dtype":
        blocks = blocks.to(torch.int32)
    elif bad == "width":
        blocks = blocks[:, :100]
    elif bad == "nblocks":
        nb = nb.to(torch.int64)
    else:
        init = init[:4]
    with pytest.raises(ValueError):
        port_sha.sha256_hmac(blocks, nb, init, None, 2)
