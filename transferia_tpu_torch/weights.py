"""The port's "weights": HMAC key states and pool accumulators.

The fused transform's only learned-free parameters are the per-key HMAC
inner/outer states (one SHA-256 compression of key^ipad and key^opad).
The JAX package keeps them as numpy uint32 arrays
(``transferia_tpu.ops.sha256._hmac_key_states``); the port keeps them as
(8,) int32 tensors on its device with the same bits.  `states_from_jax`
converts the former into the latter, so tests can feed both packages
identical key material, and `FusedMaskFilterProgram.run(states=...)`
and `ShardedFusedProgram.run(states=...)` (parallel/fusedmesh.py) take
either kind.  The mesh keeps no other state: its shards share the key
states and the dictionary pools.

The table fingerprint's per-pool-entry accumulators are the other state
worth carrying across packages: the JAX package's `pool_accumulators`
gives two numpy uint32 arrays; `accs_from_jax` turns them into the port's
(k,) int32 tensors, which `DictPool.memo_set(ops.rowhash._ACC_MEMO_KEY,
...)` seeds into a pool's memo.

A dictionary's value pool is data rather than state, but tests feed one
pool's content to both packages: `pool_from_jax` turns a JAX-package
`DictPool`'s arrays into the port's `DictPool` (empty memo).

The rename and lambda transformers carry no state: a rename is its
name mapping, and a registered lambda is code (the port's SR fan-in
function, `ops.lambdas.bench_lambda`, is its own copy of bench.py's),
so nothing of theirs crosses between the packages.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from transferia_tpu_torch.columnar.batch import DictPool
from transferia_tpu_torch.ops.sha256 import words_to_tensor
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device

KeyState = tuple[torch.Tensor, torch.Tensor]


def states_from_jax(inner: np.ndarray, outer: np.ndarray,
                    device: DeviceLike = None) -> KeyState:
    """JAX-package key states (numpy uint32, (8,) or (1, 8)) -> the
    port's (inner, outer) int32 tensors on `device`."""
    dev = resolve_device(device)
    return (words_to_tensor(np.asarray(inner).reshape(8), dev),
            words_to_tensor(np.asarray(outer).reshape(8), dev))


def as_key_state(state: Union[KeyState, tuple[np.ndarray, np.ndarray]],
                 device: torch.device) -> KeyState:
    """Either kind of key state as the port's tensors on `device`."""
    inner, outer = state
    if isinstance(inner, torch.Tensor):
        return inner.to(device), outer.to(device)
    return states_from_jax(inner, outer, device)


def accs_from_jax(acc1: np.ndarray, acc2: np.ndarray,
                  device: DeviceLike = None) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """JAX-package pool accumulators (numpy uint32, (k,)) -> the port's
    (k,) int32 tensors with the same bits on `device`."""
    dev = resolve_device(device)
    return (words_to_tensor(np.asarray(acc1), dev),
            words_to_tensor(np.asarray(acc2), dev))


def pool_from_jax(values_data: np.ndarray, values_offsets: np.ndarray,
                  null_code: Optional[int]) -> DictPool:
    """A JAX-package DictPool's arrays (flat uint8 values, (k+1,) int32
    offsets, the null sentinel's index or None) -> the port's DictPool
    over copies of them, with an empty memo."""
    return DictPool(np.array(values_data, dtype=np.uint8),
                    np.array(values_offsets, dtype=np.int32),
                    null_code=None if null_code is None else int(null_code))
