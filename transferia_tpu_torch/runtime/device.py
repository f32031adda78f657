"""Device resolution for the port: the counterpart of ``jax.devices()``.

Entry points take ``device=None`` and run on CUDA unless the caller asks
for the CPU.  There is no silent CPU path: asking for CUDA (explicitly or
by default) on a host without a usable card raises.  On the CPU every
kernel wrapper runs its plain PyTorch version, which is what the tests
use.

The kernels are built for ``sm_90a`` only (ops/_build.py), so a CUDA
device must report compute capability (9, 0).
"""

from __future__ import annotations

from typing import Union

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
