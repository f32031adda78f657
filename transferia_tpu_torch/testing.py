"""Test helpers: a virtual mesh over one device.

The twin of transferia_tpu/testing.py `force_virtual_cpu_mesh`, which
makes JAX show n virtual CPU devices.  `force_virtual_mesh(n)` makes the
port's default mesh (runtime/device.py `mesh_devices`) n virtual shards
over the one device an entry point asked for: on the CPU the tests hold
an 8-shard mesh against JAX's 8-device mesh, and on one card a
multi-shard mesh runs for real.  `force_virtual_mesh(None)` restores the
default (every card on CUDA, one device on the CPU).
"""

from __future__ import annotations

from typing import Optional

from transferia_tpu_torch.runtime import device as _device


def force_virtual_mesh(n_shards: Optional[int]) -> None:
    """Make the default mesh n_shards virtual shards (None = the real
    devices again)."""
    if n_shards is not None and n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n_shards}")
    _device._virtual_mesh = n_shards
