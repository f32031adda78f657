"""Host resource limits (the port's copy of
``transferia_tpu/runtime/limits.py``).

`effective_cpus` sizes host-parallel work.  `apply_resource_limits()` is
called by the CLI's setup: it reads the cgroup memory limit (v2
memory.max / v1 limit_in_bytes) and, once a process, starts a watchdog
thread that samples RSS every `INTERVAL_S`; above `SOFT_FRACTION` of
the limit it forces a full gc.collect() and logs a warning, above
`HARD_FRACTION` it collects and logs an error.
"""

from __future__ import annotations

import gc
import logging
import os
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)


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


def cgroup_memory_limit() -> Optional[int]:
    """Container memory limit in bytes, None when unlimited/unknown."""
    for path in ("/sys/fs/cgroup/memory.max",
                 "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            with open(path) as fh:
                raw = fh.read().strip()
        except OSError:
            continue
        if raw in ("max", ""):
            return None
        try:
            limit = int(raw)
        except ValueError:
            continue
        # v1 reports a huge number when unlimited
        if limit >= 1 << 60:
            return None
        return limit
    return None


def process_rss() -> int:
    """Resident set size in bytes (/proc self)."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0


SOFT_FRACTION = 0.8
HARD_FRACTION = 0.95
INTERVAL_S = 5.0


class MemoryWatchdog:
    def __init__(self, limit_bytes: int):
        self.limit = limit_bytes
        self.soft = int(limit_bytes * SOFT_FRACTION)
        self.hard = int(limit_bytes * HARD_FRACTION)
        self.soft_hits = 0
        self.hard_hits = 0

    def check_once(self) -> str:
        """One sample; returns 'ok' | 'soft' | 'hard'."""
        rss = process_rss()
        if rss >= self.hard:
            self.hard_hits += 1
            logger.error(
                "memory watchdog: rss %dMiB >= %d%% of the %dMiB limit",
                rss >> 20, int(100 * self.hard / self.limit),
                self.limit >> 20)
            gc.collect()
            return "hard"
        if rss >= self.soft:
            self.soft_hits += 1
            logger.warning(
                "memory watchdog: rss %dMiB above soft threshold "
                "(%dMiB of %dMiB)", rss >> 20, self.soft >> 20,
                self.limit >> 20)
            gc.collect()
            return "soft"
        return "ok"

    def _loop(self) -> None:
        while True:
            time.sleep(INTERVAL_S)
            self.check_once()


_lock = threading.Lock()
_applied = False
_watchdog: Optional[MemoryWatchdog] = None


def apply_resource_limits() -> Optional[MemoryWatchdog]:
    """Start the watchdog from the cgroup's limit, at most once a
    process; later calls return the first call's watchdog.  Returns None
    (and does nothing) when no limit is discoverable: bare-metal runs
    stay unmanaged."""
    global _applied, _watchdog
    with _lock:
        if _applied:
            return _watchdog
        _applied = True
        limit = cgroup_memory_limit()
        if not limit:
            logger.info("no memory limit discovered; watchdog disabled")
            return None
        # tame the allocator a bit under a limit
        gc.set_threshold(400, 10, 10)
        _watchdog = MemoryWatchdog(limit)
        threading.Thread(target=_watchdog._loop, daemon=True,
                         name="memory-watchdog").start()
        logger.info("memory watchdog armed at %dMiB (cgroup)", limit >> 20)
        return _watchdog
