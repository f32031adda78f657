"""Deterministic fault injection: named failpoints on the data plane
(the port's copy of ``transferia_tpu/chaos/failpoints.py``: the same
`random.Random(f"{seed}:{site}")` draws in the same order, so a spec
and a seed fire on the same hits in both packages).

Modeled on Go's gofail / Rust's `fail` crate: production code carries
named injection sites —

    from transferia_tpu_torch.chaos.failpoints import failpoint
    ...
    failpoint("sink.push")

— and each call is a single module-flag check when chaos is off (the
first statement of `failpoint` returns on `not _ENABLED`; no registry
lookup, no allocation), so the sites stay compiled into the hot path at
zero cost.  Sites are declared centrally in `chaos/sites.py`.

Activation is a spec string, via env or API:

    TRANSFERIA_TPU_FAILPOINTS='sink.push=after:3,times:2,raise:ConnectionError;
                               storage.part.read=prob:0.1'
    TRANSFERIA_TPU_FAILPOINTS_SEED=7

Grammar (`;`-separated site clauses, `,`-separated terms):

    spec    := clause (';' clause)*
    clause  := site '=' term (',' term)*  |  site        (always fire)
    term    := 'prob:' float   — fire with probability p (seeded PRNG)
             | 'every:' N      — fire on every Nth eligible hit
             | 'after:' K      — skip the first K hits
             | 'times:' M      — stop after M fires
             | 'raise:' Error  — action: raise this error class
             | 'delay:' ms     — action: sleep, then continue
             | 'truncate:' f   — action: torn write, keep ceil(f*n) rows

Triggers compose: `after` gates first, then `every` and `prob` must
both pass, and `times` caps total fires.  A clause with no trigger
terms fires on every hit.  The default action is `raise` with
`ChaosInjectedError` (retriable — not fatal).

Determinism: every site draws from its own `random.Random` seeded from
(seed, site name), and count-based triggers depend only on the site's
hit index — so for a fixed seed+spec the decision sequence per site is
identical across runs regardless of thread interleaving across sites.
`fire_log()` exposes the fired hit indices per site for replay checks.
"""

from __future__ import annotations

import math
import os
import random
import threading
import time
from contextlib import contextmanager
from typing import Optional

from transferia_tpu_torch.abstract.errors import (
    AbortTransferError,
    CodedError,
    FatalError,
    TransferError,
    WorkerKilledError,
)
from transferia_tpu_torch.chaos.sites import site_names

from transferia_tpu_torch.runtime import knobs
ENV_SPEC = "TRANSFERIA_TPU_FAILPOINTS"
ENV_SEED = "TRANSFERIA_TPU_FAILPOINTS_SEED"


class ChaosInjectedError(TransferError):
    """Default injected failure — retriable by design (not FatalError),
    so the framework's own recovery machinery gets exercised."""


class TornWriteError(ChaosInjectedError):
    """Raised by a sink site after deliberately landing only a prefix of
    the batch — the canonical at-least-once duplicate generator."""

    def __init__(self, site: str, kept: int, total: int):
        super().__init__(
            f"[chaos:{site}] torn write: {kept}/{total} rows landed")
        self.kept = kept
        self.total = total


class FailpointSpecError(ValueError):
    """Malformed spec string or unknown site name."""


# error classes resolvable from `raise:<name>` terms
_ERROR_CLASSES = {
    "ChaosInjectedError": ChaosInjectedError,
    "ConnectionError": ConnectionError,
    "ConnectionResetError": ConnectionResetError,
    "TimeoutError": TimeoutError,
    "OSError": OSError,
    "IOError": OSError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "FatalError": FatalError,
    "AbortTransferError": AbortTransferError,
    # kill-worker-thread action: not retriable, the snapshot worker dies
    # mid-part and its lease strands for reclamation (chaos worker_crash)
    "WorkerKilledError": WorkerKilledError,
}


class Failpoint:
    """One armed site: trigger state + action.  Hit accounting is under
    a per-site lock so the decision sequence is a pure function of the
    hit index (thread arrival order never changes what fires)."""

    __slots__ = ("name", "prob", "every", "after", "times", "action",
                 "arg", "rng", "hits", "fires", "fired_at", "_lock")

    def __init__(self, name: str, *, prob: Optional[float] = None,
                 every: Optional[int] = None, after: int = 0,
                 times: Optional[int] = None, action: str = "raise",
                 arg=ChaosInjectedError, seed: int = 0):
        self.name = name
        self.prob = prob
        self.every = every
        self.after = after
        self.times = times
        self.action = action
        self.arg = arg
        self.rng = random.Random(f"{seed}:{name}")
        self.hits = 0
        self.fires = 0
        self.fired_at: list[int] = []  # hit indices (1-based) that fired
        self._lock = threading.Lock()

    def should_fire(self) -> bool:
        with self._lock:
            self.hits += 1
            if self.times is not None and self.fires >= self.times:
                return False
            eligible = self.hits - self.after
            if eligible <= 0:
                return False
            if self.every is not None and eligible % self.every != 0:
                return False
            if self.prob is not None and \
                    self.rng.random() >= self.prob:
                return False
            self.fires += 1
            self.fired_at.append(self.hits)
            return True


_ENABLED = False  # the hot-path flag: failpoint() returns on False
_lock = threading.Lock()
_sites: dict[str, Failpoint] = {}


def _parse_clause(clause: str, seed: int) -> Failpoint:
    name, sep, terms_s = clause.partition("=")
    name = name.strip()
    if not name:
        raise FailpointSpecError(f"empty site name in clause {clause!r}")
    if name not in site_names():
        raise FailpointSpecError(
            f"unknown failpoint site {name!r} (see chaos/sites.py)")
    kw: dict = {}
    action_seen = False
    for term in (terms_s.split(",") if sep else []):
        term = term.strip()
        if not term:
            continue
        key, sep2, val = term.partition(":")
        if not sep2:
            raise FailpointSpecError(
                f"malformed term {term!r} in clause for {name!r}")
        try:
            if key == "prob":
                kw["prob"] = float(val)
                if not 0.0 <= kw["prob"] <= 1.0:
                    raise ValueError
            elif key == "every":
                kw["every"] = int(val)
                if kw["every"] < 1:
                    raise ValueError
            elif key == "after":
                kw["after"] = int(val)
                if kw["after"] < 0:
                    raise ValueError
            elif key == "times":
                kw["times"] = int(val)
                if kw["times"] < 1:
                    raise ValueError
            elif key == "raise":
                if val not in _ERROR_CLASSES:
                    raise FailpointSpecError(
                        f"unknown error class {val!r} for {name!r} "
                        f"(known: {', '.join(sorted(_ERROR_CLASSES))})")
                kw["action"], kw["arg"] = "raise", _ERROR_CLASSES[val]
                action_seen = True
            elif key == "delay":
                kw["action"], kw["arg"] = "delay", float(val) / 1000.0
                if kw["arg"] < 0:
                    raise ValueError
                action_seen = True
            elif key == "truncate":
                kw["action"], kw["arg"] = "truncate", float(val)
                if not 0.0 < kw["arg"] <= 1.0:
                    raise ValueError
                action_seen = True
            else:
                raise FailpointSpecError(
                    f"unknown term key {key!r} in clause for {name!r}")
        except FailpointSpecError:
            raise
        except ValueError:
            raise FailpointSpecError(
                f"bad value {val!r} for {key!r} in clause for {name!r}"
            ) from None
    if action_seen and sum(
            1 for t in terms_s.split(",")
            if t.strip().split(":")[0] in ("raise", "delay", "truncate")
    ) > 1:
        raise FailpointSpecError(
            f"multiple actions in clause for {name!r}")
    return Failpoint(name, seed=seed, **kw)


def parse_spec(spec: str, seed: int = 0) -> dict[str, Failpoint]:
    """Parse a full spec string into armed failpoints (pure — does not
    activate anything)."""
    out: dict[str, Failpoint] = {}
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        fp = _parse_clause(clause, seed)
        if fp.name in out:
            raise FailpointSpecError(
                f"site {fp.name!r} armed twice in one spec")
        out[fp.name] = fp
    return out


def configure(spec: str, seed: int = 0) -> None:
    """Arm the registry from a spec string and enable injection."""
    global _ENABLED
    sites = parse_spec(spec, seed)
    with _lock:
        _sites.clear()
        _sites.update(sites)
        _ENABLED = bool(_sites)


def reset() -> None:
    """Disarm everything; the hot path goes back to the flag check."""
    global _ENABLED
    with _lock:
        _ENABLED = False
        _sites.clear()


def is_enabled() -> bool:
    return _ENABLED


@contextmanager
def active(spec: str, seed: int = 0):
    """Scoped activation (tests, chaos runner trials)."""
    configure(spec, seed)
    try:
        yield
    finally:
        reset()


def activate_from_env(environ=os.environ) -> bool:
    """Arm from TRANSFERIA_TPU_FAILPOINTS; returns True when armed."""
    spec = knobs.env_str(ENV_SPEC, "", environ=environ)
    if not spec:
        return False
    configure(spec, knobs.env_int(ENV_SEED, 0, environ=environ))
    return True


# -- the call-site API -------------------------------------------------------

def _record_fire(name: str, fp: Failpoint) -> None:
    """A site fired: land a trace instant ON the active span (the
    chaos plane stays visible in causal timelines — a kill trial's
    injected fault shows up inside the exact span it perturbed) and
    bill the ambient ledger scope's chaos_fires."""
    from transferia_tpu_torch.stats import trace
    from transferia_tpu_torch.stats.ledger import LEDGER

    trace.instant("chaos_fire", site=name, action=fp.action,
                  fire=fp.fires, hit=fp.hits)
    LEDGER.add(chaos_fires=1)


def failpoint(name: str) -> None:
    """The injection site.  Disabled: one module-flag check, return.
    Enabled: evaluate the site's trigger; on fire, raise the armed error
    or sleep the armed delay.  Truncate-armed sites never fire here —
    torn writes need call-site cooperation (`torn_rows`)."""
    if not _ENABLED:
        return
    fp = _sites.get(name)
    if fp is None or fp.action == "truncate":
        return
    if not fp.should_fire():
        return
    _record_fire(name, fp)
    if fp.action == "delay":
        time.sleep(fp.arg)
        return
    raise fp.arg(f"[chaos:{name}] injected failure "
                 f"(fire {fp.fires}, hit {fp.hits})")


def torn_rows(name: str, n_rows: int) -> Optional[int]:
    """Torn-write sites: returns how many leading rows the caller should
    land before raising `TornWriteError`, or None (no fire).  Only
    `truncate`-armed sites fire here; a torn write needs at least one
    surviving row and at least one lost row to mean anything."""
    if not _ENABLED:
        return None
    fp = _sites.get(name)
    if fp is None or fp.action != "truncate" or n_rows < 2:
        return None
    if not fp.should_fire():
        return None
    _record_fire(name, fp)
    return min(n_rows - 1, max(1, math.ceil(fp.arg * n_rows)))


# -- reporting ---------------------------------------------------------------

def fire_counts() -> dict[str, int]:
    with _lock:
        return {name: fp.fires for name, fp in _sites.items()}


def hit_counts() -> dict[str, int]:
    with _lock:
        return {name: fp.hits for name, fp in _sites.items()}


def fire_log() -> dict[str, list[int]]:
    """Per-site fired hit indices — the replayable fire sequence."""
    with _lock:
        return {name: list(fp.fired_at) for name, fp in _sites.items()}


def fold_into(metrics) -> None:
    """Fold fire counts into a stats registry as chaos_* counters —
    the periodic-fold surface for env-armed soaks (idempotent: reads
    the registry back and incs only the delta, so callers can fold on
    every heartbeat).  One-shot reporters (the trial runner) use
    ChaosStats.record_site directly."""
    from transferia_tpu_torch.stats.registry import ChaosStats

    total = 0
    for name, fires in sorted(fire_counts().items()):
        cname = ChaosStats.site_counter_name(name)
        cur = metrics.value(cname)
        if fires > cur:
            metrics.counter(cname, f"chaos fires at {name}").inc(
                fires - cur)
        total += fires
    cur = metrics.value("chaos_fires")
    if total > cur:
        metrics.counter("chaos_fires", "total chaos fires").inc(
            total - cur)


# arm from the environment at import: `TRANSFERIA_TPU_FAILPOINTS=... trtpu
# replicate ...` injects faults into any entry point with zero code changes
activate_from_env()
