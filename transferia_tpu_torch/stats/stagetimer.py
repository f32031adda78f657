"""Pipeline stage timing (the port's copy of the sampling part of
``transferia_tpu/stats/stagetimer.py``).

`stage(name)` times a block with near-zero overhead when disabled (one
module-level bool check); for the stages named in `collect_samples` it
keeps each call's duration, which is where the replication path's
transform p50/p99 are read.  The reference also sums stage totals for
its breakdown line and feeds every stage into its mergeable log-bucket
histograms (`stats/hdr.py`); both come with the telemetry slice
(ROADMAP.md A5).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

_enabled = False
_lock = threading.Lock()
_sample_stages: set[str] = set()
_samples: dict[str, list[float]] = {}


def collect_samples(*names: str) -> None:
    """Keep per-call durations for these stages (for percentiles)."""
    _sample_stages.update(names)


def samples(name: str) -> list[float]:
    with _lock:
        return list(_samples.get(name, ()))


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def reset() -> None:
    with _lock:
        _samples.clear()


@contextmanager
def stage(name: str):
    if not _enabled or name not in _sample_stages:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _samples.setdefault(name, []).append(dt)
