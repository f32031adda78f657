"""Runtime lock-order sentinel (the port's copy of
``transferia_tpu/runtime/lockwatch.py``).

`TRANSFERIA_TPU_LOCKWATCH=1` (or an explicit `arm()`) turns the named
production locks created through :func:`named_lock` into instrumented
wrappers that record, per thread, the stack of locks currently held.
Every first acquisition of lock B while lock A is held contributes the
edge ``A -> B`` to an observed global order DAG; acquiring A while B is
held after that is a **lock-order inversion** — the runtime witness of
a potential deadlock — and produces a structured finding carrying both
acquisition sites (the site that established ``A -> B`` and the site
that just observed ``B -> A``).

Also watched:

- **long holds** — a lock held beyond ``TRANSFERIA_TPU_LOCKWATCH_HOLD_MS``
  (default 250 ms) at release time;
- **blocking calls under a lock** — `time.sleep` is patched while armed
  (call sites that already route blocking work through helpers can call
  :func:`note_blocking` directly).

Cost model: locks created while the watch is DISARMED are plain
`threading` primitives — zero overhead.  A `WatchedLock` under an armed
watch pays one frame probe plus two dict updates per acquire/release
pair (single-digit microseconds); full stacks are captured only when a
finding fires.  Counters fold into `DeviceStats`
(`lockwatch_*` metrics) and ride obs segments so the chaos
``lock_order`` gauntlet and the fleet pane can assert "zero inversions"
across processes.

Leaf module: stdlib + `runtime.knobs` only.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Optional

from transferia_tpu_torch.runtime import knobs

ENV_LOCKWATCH = "TRANSFERIA_TPU_LOCKWATCH"
ENV_HOLD_MS = "TRANSFERIA_TPU_LOCKWATCH_HOLD_MS"
DEFAULT_HOLD_MS = 250.0

# findings kept per watch (dedup usually keeps this tiny; the bound is
# a safety valve so a pathological schedule can't grow memory)
MAX_FINDINGS = 256
_OBS_FINDINGS = 32          # findings shipped per obs segment

COUNTER_NAMES = ("acquisitions", "inversions", "long_holds",
                 "blocking_in_lock")


def _site() -> str:
    """`file:line` of the production caller, skipping lockwatch frames."""
    try:
        f = sys._getframe(1)
        while f is not None and f.f_code.co_filename == __file__:
            f = f.f_back
        if f is None:
            return "?:0"
        return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"
    except Exception:
        return "?:0"


def _stack(limit: int = 12) -> list:
    return [ln.strip() for ln in
            traceback.format_stack(limit=limit)[:-2]]


class _Held:
    """One entry of a thread's held-lock stack."""

    __slots__ = ("name", "t0", "site", "count")

    def __init__(self, name: str, t0: float, site: str):
        self.name = name
        self.t0 = t0
        self.site = site
        self.count = 1


class LockWatch:
    """The sentinel: observed order DAG + per-thread held stacks."""

    def __init__(self, hold_ms: Optional[float] = None):
        if hold_ms is None:
            hold_ms = knobs.env_float(ENV_HOLD_MS, DEFAULT_HOLD_MS)
        self.hold_ms = float(hold_ms)
        self._lock = threading.Lock()      # guards DAG/findings/counters
        self._tls = threading.local()
        # edge (a, b): first site pair that observed "b acquired while
        # a held" — the witness replayed when the inverse edge appears
        self._edges: dict = {}
        self._findings: list = []
        self._finding_keys: set = set()
        self._counters = dict.fromkeys(COUNTER_NAMES, 0)
        self._folded = dict.fromkeys(COUNTER_NAMES, 0)

    # -- per-thread stack ---------------------------------------------------
    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def held_names(self) -> list:
        return [h.name for h in self._held()]

    def _add_finding(self, key, finding: dict) -> None:
        # caller holds self._lock
        if key in self._finding_keys or \
                len(self._findings) >= MAX_FINDINGS:
            return
        self._finding_keys.add(key)
        self._findings.append(finding)

    # -- events ---------------------------------------------------------
    def note_acquire(self, name: str) -> None:
        held = self._held()
        for h in held:
            if h.name == name:           # reentrant (RLock) acquire
                h.count += 1
                return
        site = _site()
        entry = _Held(name, time.monotonic(), site)
        inversion = None
        with self._lock:
            self._counters["acquisitions"] += 1
            for h in held:
                fwd = (h.name, name)
                rev = (name, h.name)
                if rev in self._edges and fwd not in self._edges:
                    first = self._edges[rev]
                    key = ("inv",) + tuple(sorted((h.name, name)))
                    if key not in self._finding_keys:
                        inversion = (h, first, key, site)
                if fwd not in self._edges:
                    self._edges[fwd] = {"held_site": h.site,
                                        "acquire_site": site}
            if inversion is not None:
                h, first, key, site2 = inversion
                self._counters["inversions"] += 1
                self._add_finding(key, {
                    "kind": "lock_order_inversion",
                    "locks": sorted((h.name, name)),
                    "first": {"order": [name, h.name],
                              "held_site": first["held_site"],
                              "acquire_site": first["acquire_site"]},
                    "second": {"order": [h.name, name],
                               "held_site": h.site,
                               "acquire_site": site2},
                    "thread": threading.current_thread().name,
                    "stack": _stack(),
                })
        held.append(entry)

    def note_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            h = held[i]
            if h.name != name:
                continue
            h.count -= 1
            if h.count > 0:
                return
            held.pop(i)
            dt_ms = (time.monotonic() - h.t0) * 1000.0
            if dt_ms > self.hold_ms:
                with self._lock:
                    self._counters["long_holds"] += 1
                    self._add_finding(("hold", name, h.site), {
                        "kind": "long_hold",
                        "lock": name,
                        "held_ms": round(dt_ms, 3),
                        "threshold_ms": self.hold_ms,
                        "acquire_site": h.site,
                        "thread": threading.current_thread().name,
                    })
            return

    def note_blocking(self, label: str) -> None:
        """A blocking call ran on this thread; a finding if a watched
        lock is held (patched `time.sleep` lands here while armed)."""
        held = self._held()
        if not held:
            return
        top = held[-1]
        site = _site()
        with self._lock:
            self._counters["blocking_in_lock"] += 1
            self._add_finding(("blk", label, top.name, site), {
                "kind": "blocking_in_lock",
                "call": label,
                "lock": top.name,
                "locks_held": [h.name for h in held],
                "call_site": site,
                "acquire_site": top.site,
                "thread": threading.current_thread().name,
                "stack": _stack(),
            })

    # -- reporting ------------------------------------------------------
    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def findings(self, kind: str = "") -> list:
        with self._lock:
            out = list(self._findings)
        if kind:
            out = [f for f in out if f.get("kind") == kind]
        return out

    def inversions(self) -> list:
        return self.findings("lock_order_inversion")

    def edge_count(self) -> int:
        with self._lock:
            return len(self._edges)

    def snapshot(self) -> dict:
        """Cumulative counters + a bounded findings list (obs segment
        payload: mergeable latest-per-process, like the ledger)."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "order_edges": len(self._edges),
                "findings": [dict(f, stack=None)
                             for f in self._findings[:_OBS_FINDINGS]],
            }

    def fold_into(self, metrics) -> dict:
        """Publish counter DELTAS since the last fold into a Metrics
        registry as `lockwatch_*` counters (idempotent when no new
        events arrived — fold twice, publish once)."""
        with self._lock:
            deltas = {name: self._counters[name] - self._folded[name]
                      for name in COUNTER_NAMES}
            self._folded = dict(self._counters)
        for name, d in deltas.items():
            if d:
                metrics.counter(f"lockwatch_{name}").inc(d)
        return deltas


class WatchedLock:
    """Instrumented wrapper over a `threading` lock.

    Implements the private Condition protocol (`_release_save` /
    `_acquire_restore` / `_is_owned`) so `threading.Condition(watched)`
    keeps working — a `cond.wait()` really releases the lock, and the
    held-stack bookkeeping must agree."""

    __slots__ = ("name", "_inner", "_reentrant")

    def __init__(self, name: str, inner, reentrant: bool):
        self.name = name
        self._inner = inner
        self._reentrant = reentrant

    def _watch(self) -> Optional["LockWatch"]:
        return _STATE

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            w = _STATE
            if w is not None:
                w.note_acquire(self.name)
        return got

    def release(self) -> None:
        w = _STATE
        if w is not None:
            w.note_release(self.name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return bool(locked()) if locked is not None else False

    # -- threading.Condition protocol ------------------------------------
    def _release_save(self):
        w = _STATE
        if w is not None:
            w.note_release(self.name)
        inner = self._inner
        if hasattr(inner, "_release_save"):
            return inner._release_save()
        inner.release()
        return None

    def _acquire_restore(self, state) -> None:
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()
        w = _STATE
        if w is not None:
            w.note_acquire(self.name)

    def _is_owned(self) -> bool:
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        w = _STATE
        if w is not None:
            return self.name in w.held_names()
        # disarmed fallback mirrors Condition's own probe
        if inner.acquire(False):
            inner.release()
            return False
        return True


# -- module state ------------------------------------------------------------

_STATE: Optional[LockWatch] = None
_ARM_LOCK = threading.Lock()
_real_sleep = time.sleep


def _watched_sleep(seconds):
    w = _STATE
    if w is not None:
        w.note_blocking("time.sleep")
    return _real_sleep(seconds)


def is_armed() -> bool:
    return _STATE is not None


def active() -> Optional[LockWatch]:
    return _STATE


def arm(hold_ms: Optional[float] = None) -> LockWatch:
    """Install (or return) the process-wide watch and patch
    `time.sleep` for blocking-call detection."""
    global _STATE
    with _ARM_LOCK:
        if _STATE is None:
            _STATE = LockWatch(hold_ms=hold_ms)
            time.sleep = _watched_sleep
        return _STATE


def disarm() -> Optional[LockWatch]:
    """Remove the watch (returns it for post-mortem reads); locks
    created while armed fall back to plain delegation."""
    global _STATE
    with _ARM_LOCK:
        w = _STATE
        _STATE = None
        if time.sleep is _watched_sleep:
            time.sleep = _real_sleep
        return w


def named_lock(name: str, kind: str = "lock"):
    """A named lock that joins the watch when one is armed at creation
    time.  `kind`: "lock" | "rlock".  Disarmed processes get the plain
    primitive back — the hot path stays untouched."""
    reentrant = kind == "rlock"
    inner = threading.RLock() if reentrant else threading.Lock()
    if _STATE is None and not knobs.env_bool(ENV_LOCKWATCH, False):
        return inner
    if _STATE is None:
        arm()
    return WatchedLock(name, inner, reentrant)


def note_blocking(label: str) -> None:
    """Explicit hook for blocking helpers (socket reads, HTTP
    roundtrips) that want coverage beyond the `time.sleep` patch."""
    w = _STATE
    if w is not None:
        w.note_blocking(label)


def fold_into(metrics) -> dict:
    """Fold the active watch's counter deltas into `metrics`
    (`DeviceStats` exposes them as `lockwatch_*`); no-op disarmed."""
    w = _STATE
    if w is None:
        return {}
    return w.fold_into(metrics)
