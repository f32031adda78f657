"""Pipeline stage timing (the port's copy of
``transferia_tpu/stats/stagetimer.py``, less its histograms).

`stage(name)` times a block with near-zero overhead when disabled (one
module-level bool check); when enabled it sums every stage's seconds
and calls (`snapshot`), and for the stages named in `collect_samples`
it keeps each call's duration, which is where the replication path's
transform p50/p99 are read.  `add` books a duration measured elsewhere.
The reference also feeds every stage into its mergeable log-bucket
histograms (`stats/hdr.py`); they come with the telemetry slice
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
_totals: dict[str, float] = {}
_counts: dict[str, int] = {}


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
        _totals.clear()
        _counts.clear()


@contextmanager
def stage(name: str):
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add(name, time.perf_counter() - t0)


def add(name: str, seconds: float) -> None:
    if not _enabled:
        return
    with _lock:
        _totals[name] = _totals.get(name, 0.0) + seconds
        _counts[name] = _counts.get(name, 0) + 1
        if name in _sample_stages:
            _samples.setdefault(name, []).append(seconds)


def snapshot() -> dict[str, dict]:
    """Every stage's summed seconds and call count since the last reset."""
    with _lock:
        return {k: {"seconds": v, "calls": _counts.get(k, 0)}
                for k, v in sorted(_totals.items())}
