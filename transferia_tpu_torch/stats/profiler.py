"""Sampling CPU profiler (pure Python, zero deps; the port's copy of
``transferia_tpu/stats/profiler.py``).

The upstream Go system runs always-on pprof and its documented perf
loop is "profile -> speedscope -> fix the top frame".
This module is the engine's equivalent: a wall-clock sampler over
`sys._current_frames()` that attributes self-time to the innermost
frame and renders a top-N table.  Exposed two ways: the
`/debug/profile?seconds=N` endpoint on the health port (cli/main.py)
and `profile()` as a context manager for bench harnesses.

Sampling keeps overhead proportional to the rate (~100 Hz default ≈
<1% on one core) and needs no instrumentation of the profiled code —
the same reason the reference chose pprof's sampling profile over
tracing.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional


# innermost frames that mean "this thread is parked, not computing" —
# wall samplers count blocked threads (server accept loops, pool idlers);
# CPU attribution excludes them by default, like pprof's CPU profile
_IDLE_FRAMES = {
    ("select", "selectors.py"),
    ("poll", "selectors.py"),
    ("wait", "threading.py"),
    ("_wait_for_tstate_lock", "threading.py"),
    ("accept", "socket.py"),
    ("readinto", "socket.py"),
    ("recv_into", "socket.py"),
    ("sleep", "time"),
}


def _is_idle(qualname: str, filename: str) -> bool:
    leaf = qualname.rsplit(".", 1)[-1]
    return (leaf, filename) in _IDLE_FRAMES


def _qualname(code) -> str:
    # co_qualname is 3.11+; co_name keeps 3.10 samplers alive (the
    # attribute error killed the sampler thread on its first tick,
    # silently producing empty profiles)
    return getattr(code, "co_qualname", None) or code.co_name


# -- native-frame attribution -------------------------------------------------
#
# A ctypes call into the C++ hostops kernels creates no Python frame:
# a sample landing mid-kernel shows the CALLER's line, so profiles
# silently inflated Python lines that were really C++ time (the host
# mask's line, for one, was almost entirely inside hmac_sha256_hex).  The native bindings
# (native/__init__.py) publish "thread T is inside native symbol S"
# around every exported call; the sampler reads the marker and tags
# the sample explicitly instead of blaming the Python line.
#
# ident-keyed dict, not a threading.local: the SAMPLER thread must read
# other threads' markers.  CPython dict get/set are atomic under the
# GIL, so no lock is needed on this per-native-call hot path.
_NATIVE_ACTIVE: dict[int, str] = {}

NATIVE_TAG = "[native hostops]"


class native_call:
    """Marks the calling thread as executing the named C++ symbol for
    the duration (re-entrant: nested native calls restore the outer
    marker on exit)."""

    __slots__ = ("_name", "_ident", "_prev")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._ident = threading.get_ident()
        self._prev = _NATIVE_ACTIVE.get(self._ident)
        _NATIVE_ACTIVE[self._ident] = self._name
        return self

    def __exit__(self, *exc):
        if self._prev is None:
            _NATIVE_ACTIVE.pop(self._ident, None)
        else:
            _NATIVE_ACTIVE[self._ident] = self._prev
        return False


def active_native(ident: int) -> Optional[str]:
    """The native symbol thread `ident` is currently inside, if any."""
    return _NATIVE_ACTIVE.get(ident)


@dataclass
class ProfileReport:
    seconds: float = 0.0
    samples: int = 0          # busy samples
    idle_samples: int = 0     # parked threads (waits, accept loops)
    rate_hz: float = 0.0
    # (func, file:line) -> sample count
    self_counts: Counter = field(default_factory=Counter)
    cum_counts: Counter = field(default_factory=Counter)

    def top(self, n: int = 10) -> list[tuple[str, float, float]]:
        """[(location, self_cpu_seconds, self_pct)] — hottest first.

        Weights are CPU seconds (per-thread POSIX CPU-clock deltas) on
        POSIX, or one sampling tick per busy sample in the wall
        fallback."""
        total = sum(self.self_counts.values())
        if not total:
            return []
        return [
            (loc, secs, 100.0 * secs / total)
            for loc, secs in self.self_counts.most_common(n)
        ]

    @property
    def cpu_seconds(self) -> float:
        return sum(self.self_counts.values())

    def format(self, n: int = 10) -> str:
        lines = [
            f"wall={self.seconds:.2f}s cpu={self.cpu_seconds:.2f}s "
            f"busy_samples={self.samples} "
            f"idle_samples={self.idle_samples} "
            f"rate={self.rate_hz:.0f}Hz",
            f"{'self':>8}  {'%':>6}  location",
        ]
        for loc, secs, pct in self.top(n):
            lines.append(f"{secs:>7.3f}s  {pct:>5.1f}%  {loc}")
        return "\n".join(lines)


class Sampler:
    """Background sampling thread; use via profile() or start/stop.

    Each tick attributes every thread's current Python frame weighted by
    that thread's CPU-time delta since the previous tick (POSIX
    per-thread CPU clocks); ticks where a thread burned no CPU count as
    idle.  Without pthread_getcpuclockid it degrades to plain wall
    sampling with a frame-based idle heuristic.
    """

    def __init__(self, hz: float = 97.0,
                 threads: Optional[set[int]] = None):
        # 97 Hz (prime) avoids phase-locking with periodic work
        self.hz = hz
        self._threads = threads
        self._stop = threading.Event()
        self._report = ProfileReport(rate_hz=hz)
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0

    def _loop(self) -> None:
        # CPU-time source: per-thread POSIX CPU clocks read via
        # time.clock_gettime — these do NOT release the GIL, unlike the
        # /proc/self/task stat reads the first version used.  Under a
        # busy interpreter every GIL release costs up to the 5ms switch
        # interval to win back, so a /proc-based tick (6+ syscalls)
        # degraded the sampler to ~20Hz and starved the profile; the
        # clock reads keep the loop at its configured rate and resolve
        # in nanoseconds instead of the 10ms /proc quantum.
        interval = 1.0 / self.hz
        my_ident = threading.get_ident()
        rep = self._report
        cpu_mode = hasattr(time, "pthread_getcpuclockid")
        clk: dict[int, int] = {}
        prev: dict[int, float] = {}
        while not self._stop.wait(interval):
            frames = sys._current_frames()
            for ident, frame in frames.items():
                if ident == my_ident:
                    continue
                if self._threads is not None and ident not in self._threads:
                    continue
                code = frame.f_code
                fname = code.co_filename.rsplit("/", 1)[-1]
                weight = 1.0 / self.hz  # wall fallback: one tick
                if cpu_mode:
                    delta = self._cpu_delta(ident, clk, prev)
                    if delta is None or delta <= 0.0:
                        rep.idle_samples += 1
                        continue
                    weight = delta
                elif _is_idle(_qualname(code), fname):
                    rep.idle_samples += 1
                    continue
                loc = (f"{_qualname(code)} ({fname}:{frame.f_lineno})")
                native = _NATIVE_ACTIVE.get(ident)
                if native is not None:
                    # the thread is inside a C++ kernel: blame the
                    # native symbol (tagged), not the Python call line
                    loc = f"{native} {NATIVE_TAG} <- {loc}"
                rep.self_counts[loc] += weight
                rep.samples += 1
                seen = set()
                f = frame
                while f is not None:
                    c = f.f_code
                    cum = (f"{_qualname(c)} "
                           f"({c.co_filename.rsplit('/', 1)[-1]})")
                    if cum not in seen:  # recursion counts once
                        rep.cum_counts[cum] += weight
                        seen.add(cum)
                    f = f.f_back

    @staticmethod
    def _cpu_delta(ident: int, clk: dict, prev: dict) -> Optional[float]:
        """CPU seconds this thread burned since its previous tick; None
        on the first sighting (no baseline yet) or for exited threads
        (clock ids die with their pthread — stale cache entries surface
        as OSError and are dropped; an ident reuse recomputes)."""
        c = clk.get(ident)
        if c is None:
            try:
                c = time.pthread_getcpuclockid(ident)
                clk[ident] = c
                prev[ident] = time.clock_gettime(c)
            except (OSError, AttributeError):
                pass
            return None
        try:
            now = time.clock_gettime(c)
        except OSError:
            clk.pop(ident, None)
            prev.pop(ident, None)
            return None
        delta = now - prev.get(ident, now)
        prev[ident] = now
        return delta

    def start(self) -> "Sampler":
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._loop,
                                        name="profile-sampler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> ProfileReport:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        self._report.seconds = time.perf_counter() - self._t0
        return self._report


class profile:
    """Context manager: `with profile() as p: ...; print(p.report.format())`

    `threads={ident, ...}` restricts sampling to those threads — e.g.
    `{threading.get_ident()}` to profile just the calling thread in a
    process where unrelated daemon threads also burn CPU."""

    def __init__(self, hz: float = 97.0,
                 threads: Optional[set[int]] = None):
        self._sampler = Sampler(hz=hz, threads=threads)
        self.report: Optional[ProfileReport] = None

    def __enter__(self) -> "profile":
        self._sampler.start()
        return self

    def __exit__(self, *exc) -> None:
        self.report = self._sampler.stop()


def sample_seconds(seconds: float, hz: float = 97.0) -> ProfileReport:
    """Block for `seconds`, sampling every live thread (the HTTP
    endpoint's implementation — it runs in a server worker thread, so
    blocking here never stalls the profiled program)."""
    s = Sampler(hz=hz).start()
    time.sleep(max(0.05, min(seconds, 60.0)))
    return s.stop()
