"""Host resource limits (the port's copy of `effective_cpus` from
``transferia_tpu/runtime/limits.py``; the memory watchdog waits)."""

from __future__ import annotations

import os


def effective_cpus() -> float:
    """Cores this process can actually use (affinity ∩ cgroup quota).

    The sizing input for host-parallel work: the fs provider's
    column-parallel decode and readahead auto-knobs derive from it, so a
    1-core box degrades to serial behavior instead of thrashing."""
    try:
        n = float(len(os.sched_getaffinity(0)))
    except (AttributeError, OSError):
        n = float(os.cpu_count() or 1)
    try:  # cgroup v2: "max 100000" or "<quota> <period>"
        with open("/sys/fs/cgroup/cpu.max") as fh:
            quota_s, period_s = fh.read().split()
        if quota_s != "max":
            n = min(n, int(quota_s) / int(period_s))
    except (OSError, ValueError):
        pass
    return round(n, 2)
