"""SLO objectives + multi-window burn-rate evaluation (the judge; the
port's copy of ``transferia_tpu/stats/slo.py``).

The observability plane records (traces, ledgers, mergeable HDR
histograms, freshness watermarks) — this module *interprets*: a small
declarative objective set is evaluated over the durable obs-segment
stream into per-objective verdicts any process can compute.

Objectives
----------
Two kinds:

- ``latency`` — "fraction of <stage> observations at or under
  <threshold_ms> must be >= <target>".  Backed by the mergeable HDR
  stage histograms exported in every obs segment (``replication_lag``
  from the watermark plane, ``part_upload`` from the snapshot engine).
- ``availability`` — "fraction of part commit decisions that are
  granted (not fenced) must be >= <target>".  Backed by the ledger
  ``commits`` / ``commit_fences`` counters in the same segments.

Defaults live in `DEFAULT_OBJECTIVES`; ``TRANSFERIA_TPU_SLO_SPEC`` (a
JSON list of objective dicts) replaces them, and the per-knob envs
``TRANSFERIA_TPU_SLO_LAG_MS`` / ``TRANSFERIA_TPU_SLO_UPLOAD_MS`` tune
the default thresholds without writing JSON.

Burn rate
---------
Classic multi-window error-budget burn: for window W ending at the
evaluation epoch, ``bad_fraction(W) / (1 - target)`` — burn 1.0 spends
the budget exactly at the objective's allowance, burn N spends it N×
faster.  Two windows (fast 5m, slow 1h) must BOTH burn >= 1 to page:
the fast window catches a fresh regression quickly, the slow window
keeps a transient blip from paging.  Windows are carved from the
CUMULATIVE segment stream: per process, the newest segment is the
window end and the newest segment older than (epoch - W) is the
baseline; ``end.diff(baseline)`` is exact bucket subtraction
(stats/hdr.py), and the per-process windows merge bucket-wise.

Determinism
-----------
`evaluate` is PURE over the segment list: the evaluation epoch is the
max segment timestamp (never the caller's clock), merges fold in
sorted process order, and every float is rounded before it lands in a
verdict — so the scheduler leader, any worker, and an offline `trtpu
slo --fleet` compute byte-identical verdicts from the same segments.
The ``slo.evaluate`` failpoint pins that a fault during evaluation
surfaces as an error payload to the caller, never a half-verdict.

Alert hook
----------
`SloAlertHook` latches the fleet QoS plane on burn: every burning
objective latches an external backpressure signal (admission sheds new
work while the budget is burning), and an objective pinned to a tenant
escalates that tenant's WDRR weight (an INTERACTIVE tenant burning
budget drains faster), restoring the baseline weight on recovery.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Optional

from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.runtime import knobs
from transferia_tpu_torch.stats import hdr, trace, watermark

FAST_WINDOW_SECONDS = 300.0     # 5m: catches a fresh regression
SLOW_WINDOW_SECONDS = 3600.0    # 1h: keeps a blip from paging

ENV_SPEC = "TRANSFERIA_TPU_SLO_SPEC"
ENV_LAG_MS = "TRANSFERIA_TPU_SLO_LAG_MS"
ENV_UPLOAD_MS = "TRANSFERIA_TPU_SLO_UPLOAD_MS"


@dataclass(frozen=True)
class SloObjective:
    """One declarative objective.  `tenant` / `transfer` scope the
    alert hook's escalation (evaluation itself is fleet-wide: stage
    histograms merge across the fleet, commit counters likewise)."""

    name: str
    kind: str = "latency"            # "latency" | "availability"
    stage: str = watermark.STAGE_LAG  # hdr stage (latency kind)
    threshold_ms: float = 5000.0
    target: float = 0.99             # good-event fraction objective
    tenant: str = ""
    transfer: str = ""

    def to_json(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "stage": self.stage, "threshold_ms": self.threshold_ms,
                "target": self.target, "tenant": self.tenant,
                "transfer": self.transfer}


def default_objectives(environ=os.environ) -> tuple:
    return (
        SloObjective(
            "replication_lag_p99", stage=watermark.STAGE_LAG,
            threshold_ms=knobs.env_float(ENV_LAG_MS, 5000.0,
                                          environ=environ),
            target=0.99),
        SloObjective(
            "part_upload_p99", stage="part_upload",
            threshold_ms=knobs.env_float(ENV_UPLOAD_MS, 30_000.0,
                                          environ=environ),
            target=0.99),
        SloObjective(
            "part_commit_availability", kind="availability",
            target=0.999),
    )


DEFAULT_OBJECTIVES = default_objectives()


def objectives_from_env(environ=os.environ) -> tuple:
    """The active objective set: ``TRANSFERIA_TPU_SLO_SPEC`` (JSON list
    of objective dicts) replaces the defaults wholesale; a torn spec
    falls back to the defaults rather than silently disabling SLOs."""
    raw = knobs.env_str(ENV_SPEC, "", environ=environ)
    if not raw:
        return default_objectives(environ)
    try:
        spec = json.loads(raw)
        if not isinstance(spec, list):
            raise ValueError("spec must be a JSON list")
        out = []
        for d in spec:
            out.append(SloObjective(
                name=str(d["name"]),
                kind=str(d.get("kind", "latency")),
                stage=str(d.get("stage", watermark.STAGE_LAG)),
                threshold_ms=float(d.get("threshold_ms", 5000.0)),
                target=min(0.999999, max(0.0,
                                         float(d.get("target", 0.99)))),
                tenant=str(d.get("tenant", "")),
                transfer=str(d.get("transfer", "")),
            ))
        return tuple(out)
    except (KeyError, TypeError, ValueError):
        return default_objectives(environ)


# -- pure evaluation over obs segments ----------------------------------------

def _window_state(segments: list[dict], epoch: float,
                  window: float) -> tuple[dict, dict, int]:
    """Carve one burn window out of the cumulative segment stream.
    Returns (merged stage hists, summed ledger-totals delta, process
    count).  Per process: end = newest segment, baseline = newest
    segment with ts <= epoch - window (none -> zero baseline, i.e. the
    process's whole history lies inside the window)."""
    from transferia_tpu_torch.stats.fleetobs import _proc_key

    by_proc: dict = {}
    for seg in segments:
        by_proc.setdefault(_proc_key(seg), []).append(seg)
    hists: dict[str, hdr.LogHistogram] = {}
    totals: dict[str, float] = {}
    cutoff = epoch - window
    for proc in sorted(by_proc):
        run = sorted(by_proc[proc],
                     key=lambda s: (s.get("ts", 0.0) or 0.0,
                                    s.get("seq", 0) or 0))
        end = run[-1]
        base = None
        for seg in run:
            if (seg.get("ts", 0.0) or 0.0) <= cutoff:
                base = seg
            else:
                break
        end_hists = end.get("hists", {}) or {}
        base_hists = (base.get("hists", {}) or {}) if base else {}
        for stage in sorted(end_hists):
            h = hdr.LogHistogram.from_json(end_hists.get(stage))
            if base_hists.get(stage) is not None:
                h = h.diff(hdr.LogHistogram.from_json(
                    base_hists[stage]))
            agg = hists.get(stage)
            if agg is None:
                hists[stage] = h
            else:
                agg.merge(h)
        end_tot = (end.get("ledger", {}) or {}).get("totals", {}) or {}
        base_tot = ((base.get("ledger", {}) or {}).get("totals", {})
                    or {}) if base else {}
        for name, v in end_tot.items():
            if not isinstance(v, (int, float)):
                continue
            prior = base_tot.get(name, 0)
            prior = prior if isinstance(prior, (int, float)) else 0
            totals[name] = totals.get(name, 0) + max(0, v - prior)
    return hists, totals, len(by_proc)


def _burn(objective: SloObjective, hists: dict,
          totals: dict) -> tuple[float, int]:
    """(burn rate, event count) for one objective over one window."""
    budget = max(1e-6, 1.0 - objective.target)
    if objective.kind == "availability":
        commits = int(totals.get("commits", 0))
        fences = int(totals.get("commit_fences", 0))
        events = commits + fences
        bad = (fences / events) if events else 0.0
        return round(bad / budget, 6), events
    h = hists.get(objective.stage)
    if h is None or h.count <= 0:
        return 0.0, 0
    bad = 1.0 - h.fraction_at_most(objective.threshold_ms / 1000.0)
    return round(bad / budget, 6), h.count


def evaluate(raw_segments: list,
             objectives: Optional[tuple] = None,
             fast_window: float = FAST_WINDOW_SECONDS,
             slow_window: float = SLOW_WINDOW_SECONDS) -> dict:
    """Pure multi-window burn-rate verdicts over an obs-segment list
    (the `/debug/slo` payload).  Identical input segments produce an
    identical verdict dict in ANY process and ANY segment order."""
    from transferia_tpu_torch.stats.fleetobs import _parse_segments

    objectives = objectives_from_env() if objectives is None \
        else objectives
    with trace.span("slo_evaluate", segments=len(raw_segments or [])):
        failpoint("slo.evaluate")
        segments, corrupt = _parse_segments(raw_segments)
        epoch = max(((s.get("ts", 0.0) or 0.0) for s in segments),
                    default=0.0)
        fast = _window_state(segments, epoch, fast_window)
        slow = _window_state(segments, epoch, slow_window)
        merged_wm = watermark.merge_maps(
            [seg.get("watermarks") for seg in segments])
        verdicts: dict[str, dict] = {}
        ok = True
        for obj in objectives:
            burn_fast, n_fast = _burn(obj, fast[0], fast[1])
            burn_slow, n_slow = _burn(obj, slow[0], slow[1])
            burning = burn_fast >= 1.0 and burn_slow >= 1.0
            ok = ok and not burning
            v = {
                "objective": obj.to_json(),
                "burn_fast": burn_fast,
                "burn_slow": burn_slow,
                "events_fast": n_fast,
                "events_slow": n_slow,
                "burning": burning,
                "ok": not burning,
            }
            if obj.kind == "latency":
                h = slow[0].get(obj.stage)
                v["window_p99_ms"] = h.summary()["p99_ms"] if h else 0.0
            verdicts[obj.name] = v
        return {
            "epoch": round(epoch, 6),
            "windows": {"fast_seconds": fast_window,
                        "slow_seconds": slow_window},
            "segments": len(segments),
            "corrupt_segments": corrupt,
            "processes": slow[2],
            "objectives": verdicts,
            "burning": sorted(n for n, v in verdicts.items()
                              if v["burning"]),
            "ok": ok,
            "watermarks": watermark.summarize(merged_wm, now=epoch),
        }


def local_segments() -> list[dict]:
    """One synthetic cumulative segment from THIS process's registries
    — lets `/debug/slo` and `trtpu slo --demo` evaluate without a
    coordinator.  Single segment means the burn windows both see the
    whole process history (no baseline yet), which is the honest
    reading for a young process."""
    import socket

    from transferia_tpu_torch.stats.ledger import LEDGER

    snap = LEDGER.snapshot()
    return [{
        "v": 1,
        "worker": "local",
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "seq": 1,
        "ts": time.time(),
        "kind": "local",
        "spans": [],
        "ledger": {
            "totals": snap["totals"],
            "transfers": snap["transfers"],
            "tenants": snap["tenants"],
            "conservation_ok": bool(snap["conservation"].get("ok")),
        },
        "telemetry": {},
        "hists": hdr.STAGES.snapshot(),
        "watermarks": watermark.WATERMARKS.snapshot(),
    }]


def debug_slo() -> dict:
    """The `GET /debug/slo` payload: fleet verdicts through the
    registered obs runtime when there is one, local-process verdicts
    otherwise.  Errors surface as an ``error`` payload (the CLI's
    wrong-shape contract treats those as exit 2), never a raise into
    the health server."""
    from transferia_tpu_torch.stats import fleetobs

    rt = fleetobs._runtime()
    try:
        if rt is not None:
            segments = rt["cp"].list_obs_segments(rt["scope"])
            view = evaluate(segments)
            view["scope"] = rt["scope"]
        else:
            view = evaluate(local_segments())
            view["scope"] = "local"
        return view
    except Exception as e:
        return {"error": f"slo evaluation failed: {e}"}


def format_verdicts(view: dict) -> str:
    """Render one `trtpu slo` frame."""
    lines = []
    lines.append(
        f"slo: {'OK' if view.get('ok') else 'BURNING'}  "
        f"scope={view.get('scope', '-')}  "
        f"segments={view.get('segments', 0)} "
        f"({view.get('processes', 0)} process(es))"
        + (f"  torn={view['corrupt_segments']}"
           if view.get("corrupt_segments") else ""))
    header = (f"{'objective':<28} {'kind':<13} {'burn5m':>8} "
              f"{'burn1h':>8} {'events':>8} {'p99_ms':>10} {'state':>8}")
    lines.append(header)
    for name, v in sorted(view.get("objectives", {}).items()):
        obj = v.get("objective", {})
        lines.append(
            f"{name:<28} {obj.get('kind', '?'):<13} "
            f"{v.get('burn_fast', 0):>8.2f} "
            f"{v.get('burn_slow', 0):>8.2f} "
            f"{v.get('events_slow', 0):>8} "
            f"{v.get('window_p99_ms', '-'):>10} "
            f"{'BURN' if v.get('burning') else 'ok':>8}")
    wm = view.get("watermarks", {})
    if wm:
        lines.append("freshness (max-lag watermark per transfer):")
        for tid, row in sorted(wm.items()):
            lag = row.get("lag_ms")
            lines.append(
                f"  {tid:<30} tables={row.get('tables', 0):<5} "
                f"lag={'-' if lag is None else f'{lag:.0f}ms'}")
    return "\n".join(lines)


def fold_verdicts(metrics, view: dict) -> None:
    """Fold one evaluation into `SloStats` gauges (heartbeat cadence
    exposure for prometheus scrapers)."""
    from transferia_tpu_torch.stats.registry import SloStats

    stats = SloStats(metrics)
    objectives = view.get("objectives", {}) or {}
    stats.objectives.set(len(objectives))
    stats.burning.set(len(view.get("burning", []) or []))
    stats.evaluations.inc()
    worst_fast = max((v.get("burn_fast", 0.0)
                      for v in objectives.values()), default=0.0)
    worst_slow = max((v.get("burn_slow", 0.0)
                      for v in objectives.values()), default=0.0)
    stats.worst_burn_fast.set(worst_fast)
    stats.worst_burn_slow.set(worst_slow)
    lags = [row.get("lag_ms") for row in
            (view.get("watermarks", {}) or {}).values()
            if isinstance(row.get("lag_ms"), (int, float))]
    stats.worst_lag_ms.set(max(lags) if lags else 0.0)


class SloAlertHook:
    """Latches the fleet QoS plane while objectives burn.

    - every burning objective latches an external backpressure signal
      (``slo:<name>``) so admission sheds new work;
    - a burning objective pinned to a tenant escalates that tenant's
      WDRR weight by `escalate_factor` (the INTERACTIVE-tenant story:
      its queue drains faster while its budget burns), restoring the
      remembered baseline on recovery.

    Idempotent per tick: apply() diffs against the currently-latched
    set, so repeated evaluations don't stack escalations."""

    def __init__(self, scheduler=None, backpressure=None,
                 escalate_factor: float = 2.0):
        self.scheduler = scheduler
        self.backpressure = backpressure
        self.escalate_factor = max(1.0, float(escalate_factor))
        self._latched: set[str] = set()
        self._baseline_weights: dict[str, float] = {}

    def apply(self, view: dict) -> dict:
        """Apply one evaluation's verdicts; returns the actions taken
        (for logs/tests)."""
        burning = {}
        for name, v in (view.get("objectives", {}) or {}).items():
            if v.get("burning"):
                burning[name] = v
        actions = {"latched": [], "cleared": [], "escalated": [],
                   "restored": []}
        newly = set(burning) - self._latched
        cleared = self._latched - set(burning)
        if self.backpressure is not None:
            for name in sorted(newly):
                self.backpressure.latch_external(
                    f"slo:{name}",
                    reason=f"burn {burning[name].get('burn_fast', 0)}x")
                actions["latched"].append(f"slo:{name}")
            for name in sorted(cleared):
                self.backpressure.clear_external(f"slo:{name}")
                actions["cleared"].append(f"slo:{name}")
        if self.scheduler is not None:
            for name in sorted(newly):
                tenant = (burning[name].get("objective", {})
                          or {}).get("tenant", "")
                if not tenant or tenant in self._baseline_weights:
                    continue
                prev = self.scheduler.set_tenant_weight(
                    tenant,
                    self.scheduler.tenant_weight(tenant)
                    * self.escalate_factor)
                self._baseline_weights[tenant] = prev
                actions["escalated"].append(tenant)
            still_burning_tenants = {
                (v.get("objective", {}) or {}).get("tenant", "")
                for v in burning.values()}
            for tenant in sorted(set(self._baseline_weights)
                                 - still_burning_tenants):
                self.scheduler.set_tenant_weight(
                    tenant, self._baseline_weights.pop(tenant))
                actions["restored"].append(tenant)
        self._latched = set(burning)
        return actions
