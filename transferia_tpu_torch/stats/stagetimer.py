"""Pipeline stage timing (the port's copy of
``transferia_tpu/stats/stagetimer.py``).

`stage(name)` times a block with near-zero overhead when disabled (one
module-level bool check).  When enabled it sums every stage's seconds
and calls (`snapshot`, `format_breakdown`), feeds every duration into
the process-global mergeable histograms (`stats/hdr.py` STAGES), and
for the stages named in `collect_samples` keeps each call's duration,
which is where the replication path's transform p50/p99 are read.
`add` books a duration measured elsewhere.

Totals are summed across threads, so with N part-upload threads a stage
total can exceed wall time; the point is the *ratio* between stages and
the overlap factor (sum(stages)/wall).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from transferia_tpu_torch.stats import hdr

_enabled = False
_lock = threading.Lock()
_totals: dict[str, float] = {}
_counts: dict[str, int] = {}
_sample_stages: set[str] = set()
_samples: dict[str, list[float]] = {}


def collect_samples(*names: str) -> None:
    """Also keep per-call durations for these stages (for percentiles)."""
    _sample_stages.update(names)


def samples(name: str) -> list[float]:
    with _lock:
        return list(_samples.get(name, ()))


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()
        _samples.clear()


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
    hdr.observe(name, seconds)


def snapshot() -> dict[str, dict]:
    """Every stage's summed seconds and call count since the last reset."""
    with _lock:
        return {
            k: {"seconds": round(v, 4), "calls": _counts.get(k, 0)}
            for k, v in sorted(_totals.items())
        }


def format_breakdown(wall_seconds: float) -> str:
    snap = snapshot()
    if not snap:
        return ""
    parts = []
    for name, d in sorted(snap.items(), key=lambda kv: -kv[1]["seconds"]):
        pct = 100.0 * d["seconds"] / wall_seconds if wall_seconds else 0.0
        parts.append(f"{name}={d['seconds']:.2f}s({pct:.0f}%)")
    total = sum(d["seconds"] for d in snap.values())
    overlap = total / wall_seconds if wall_seconds else 0.0
    parts.append(f"overlap_factor={overlap:.2f}")
    return " ".join(parts)
