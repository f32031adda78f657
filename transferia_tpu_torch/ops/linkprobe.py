"""Host-to-device link profiling for placement and chunk sizing.

The port's counterpart of transferia_tpu/ops/linkprobe.py.  `probe_link`
measures, once per process and device:
  - launch_overhead_s: host wall time of an empty kernel launch of the
    port's own library (csrc/probe.cu) plus a synchronize (median of 3);
  - h2d_bytes_per_s / d2h_bytes_per_s: a 4 MiB copy between a pinned host
    buffer and the card, timed with CUDA events.

The result feeds transform/fused.py's placement model and ops/fused.py's
chunk sizing.  TRANSFERIA_TPU_LINK="rtt_ms,h2d_mbs,d2h_mbs" pins the
profile instead; on the CPU a constant in-process profile is returned
without measuring.  A failed measurement raises: a card whose empty
kernel cannot launch cannot run the transform either.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

import torch

from transferia_tpu_torch.runtime import knobs


@dataclass(frozen=True)
class LinkProfile:
    backend: str
    launch_overhead_s: float
    h2d_bytes_per_s: float
    d2h_bytes_per_s: float
    measured: bool  # False for env-pinned / in-process constants

    def describe(self) -> str:
        suffix = "" if self.measured else " (pinned)"
        return (
            f"backend={self.backend} launch={self.launch_overhead_s * 1e3:.3f}ms "
            f"h2d={self.h2d_bytes_per_s / 1e6:.0f}MB/s "
            f"d2h={self.d2h_bytes_per_s / 1e6:.0f}MB/s"
            f"{suffix}"
        )


_lock = threading.Lock()
_cached: dict[str, LinkProfile] = {}

# the CPU "link" is in-process: memcpy speed, launches in microseconds
_INPROCESS = dict(launch_overhead_s=100e-6,
                  h2d_bytes_per_s=8e9, d2h_bytes_per_s=8e9)

_PROBE_BYTES = 4 << 20


def _parse_env(backend: str) -> Optional[LinkProfile]:
    env = knobs.env_raw("TRANSFERIA_TPU_LINK")
    if not env:
        return None
    try:
        rtt_ms, h2d_mbs, d2h_mbs = (float(x) for x in env.split(","))
    except ValueError:
        return None
    # clamp: zero/negative bandwidths would divide-by-zero in the cost
    # model; a pinned "dead link" still has to be a number
    return LinkProfile(backend=backend,
                       launch_overhead_s=max(rtt_ms, 0.0) / 1e3,
                       h2d_bytes_per_s=max(h2d_mbs, 1e-3) * 1e6,
                       d2h_bytes_per_s=max(d2h_mbs, 1e-3) * 1e6,
                       measured=False)


def _empty_launch(device: torch.device) -> None:
    from transferia_tpu_torch.ops import _build

    lib = _build.library("probe")
    rc = lib.trt_empty_launch(torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, rc, "empty probe launch")


def _copy_seconds(dst: torch.Tensor, src: torch.Tensor) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    dst.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    return max(start.elapsed_time(end) / 1e3, 1e-9)


def _measure(device: torch.device) -> LinkProfile:
    with torch.cuda.device(device):
        _empty_launch(device)  # loads the library outside the window
        torch.cuda.synchronize(device)
        rtts = []
        for _ in range(3):
            t0 = time.perf_counter()
            _empty_launch(device)
            torch.cuda.synchronize(device)
            rtts.append(time.perf_counter() - t0)
        host = torch.empty(_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
        dev = torch.empty(_PROBE_BYTES, dtype=torch.uint8, device=device)
        _copy_seconds(dev, host)  # first touch outside the window
        h2d_s = _copy_seconds(dev, host)
        d2h_s = _copy_seconds(host, dev)
    return LinkProfile(
        backend="cuda",
        launch_overhead_s=sorted(rtts)[1],
        h2d_bytes_per_s=_PROBE_BYTES / h2d_s,
        d2h_bytes_per_s=_PROBE_BYTES / d2h_s,
        measured=True,
    )


def probe_link(device: torch.device) -> LinkProfile:
    """The process-wide link profile of one device (measured once)."""
    key = str(device)
    profile = _cached.get(key)
    if profile is not None:
        return profile
    with _lock:
        profile = _cached.get(key)
        if profile is None:
            profile = _parse_env(device.type)
            if profile is None:
                profile = (_measure(device) if device.type == "cuda" else
                           LinkProfile(backend=device.type, measured=False,
                                       **_INPROCESS))
            _cached[key] = profile
        return profile
