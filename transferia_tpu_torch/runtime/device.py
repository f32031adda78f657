"""Device resolution for the port: the counterpart of ``jax.devices()``.

Entry points take ``device=None`` and run on CUDA unless the caller asks
for the CPU.  There is no silent CPU path: asking for CUDA (explicitly or
by default) on a host without a usable card raises.  On the CPU every
kernel wrapper runs its plain PyTorch version, which is what the tests
use.

The kernels are built for ``sm_90a`` only (ops/_build.py), so a CUDA
device must report compute capability (9, 0).

`mesh_devices` is the counterpart of ``len(jax.devices())`` for the mesh
(parallel/): every visible card on CUDA, one device on the CPU, or the
count `testing.force_virtual_mesh` forces.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]

REQUIRED_CAPABILITY = (9, 0)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch device an entry point runs on (CUDA by default).

    Raises RuntimeError when CUDA is asked for but unavailable, or when
    the card is not a Hopper (the kernels' only target)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap}; the kernels are built for sm_90a "
            f"({REQUIRED_CAPABILITY})")
    return dev


# forced by testing.force_virtual_mesh: the default mesh is this many
# virtual shards over the one device an entry point asked for
_virtual_mesh: Optional[int] = None


def mesh_devices(device: DeviceLike = None) -> int:
    """How many devices the default mesh spans: the counterpart of
    ``len(jax.devices())``.  On CUDA every visible card, on the CPU 1,
    and under `testing.force_virtual_mesh(n)` n virtual shards."""
    dev = resolve_device(device)
    if _virtual_mesh is not None:
        return _virtual_mesh
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def default_mesh_devices(device: DeviceLike = None) -> list[torch.device]:
    """The devices of the default mesh, one per shard: every card, or
    under a virtual mesh the caller's device repeated."""
    dev = resolve_device(device)
    n = mesh_devices(dev)
    if _virtual_mesh is not None or dev.type == "cpu":
        return [dev] * n
    return [torch.device("cuda", i) for i in range(n)]
