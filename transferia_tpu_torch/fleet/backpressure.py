"""Backpressure: load signals for the fleet scheduler's admission gate
(the port's copy of ``transferia_tpu/fleet/backpressure.py``).

The data plane already exports the gauges that say when a worker is
hot (stats/registry.py): `decode_readahead_inflight_bytes` piles up
when host decode outruns the downstream, `sinker_inflight_rows` when
the sink write path lags, `dispatch_compression_ratio` collapses
toward 1.0 when the device wire is shipping flat buffers (the link is
then the bottleneck, not compute), and the scheduler's own
`fleet_queue_depth` grows when admission outruns dispatch.  This
module folds those into one shed/resume decision with hysteresis, so
a hot worker sheds NEW admissions instead of thrashing the work it
already holds — and resumes only after the signal has genuinely
drained, not on the first dip below the high watermark.

Each signal carries its own (high, low) watermark pair and latches
independently: pressure starts at `value >= high` and clears only at
`value <= low`.  The controller is overloaded while any signal is
latched.  `inverted` signals (compression ratio) latch when the value
FALLS to the high-pressure mark and clear when it recovers.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from transferia_tpu_torch.runtime import lockwatch
from transferia_tpu_torch.stats.registry import Metrics

logger = logging.getLogger(__name__)


@dataclass
class SignalSpec:
    """One load signal: a metric name plus its hysteresis band.

    `inverted=True` means LOW values signal pressure (the compression
    ratio: a healthy encoded wire sits well above 1.0); the band is
    then (high=enter-pressure-at-or-below, low=leave-at-or-above).
    `min_activity` gates inverted signals on a companion counter — a
    ratio gauge that never moved (no dispatches yet) is idle, not hot.
    """

    name: str
    metric: str
    high: float
    low: float
    inverted: bool = False
    activity_metric: str = ""
    min_activity: float = 0.0


# The default signal table (DeviceStats/readahead/interchange gauges ->
# admission decisions).  Watermarks are deliberately lax —
# operators tune them via FleetTuning/env; the defaults only catch
# order-of-magnitude blowups.
DEFAULT_SIGNALS = (
    SignalSpec("readahead_inflight", "decode_readahead_inflight_bytes",
               high=1 << 30, low=1 << 28),
    SignalSpec("readahead_depth", "decode_readahead_depth",
               high=64, low=16),
    SignalSpec("sink_inflight_rows", "sinker_inflight_rows",
               high=2_000_000, low=500_000),
    SignalSpec("fleet_queue_depth", "fleet_queue_depth",
               high=4096, low=1024),
    # link honesty: a compressed wire showing ~1.0 is shipping flat
    # buffers — the link is saturating for nothing.  Gated on actual
    # dispatch traffic so an idle pipeline never reads as hot.
    SignalSpec("dispatch_ratio", "dispatch_compression_ratio",
               high=1.05, low=1.5, inverted=True,
               activity_metric="h2d_encoded_bytes",
               min_activity=float(64 << 20)),
)


@dataclass
class SignalState:
    spec: SignalSpec
    value: float = 0.0
    latched: bool = False
    transitions: int = 0


class BackpressureController:
    """Hysteresis gate over load gauges in a Metrics registry.

    `overloaded()` re-reads every signal and returns whether any is
    latched.  A `probe` callable (tests, remote workers) overrides the
    metrics read: it receives the metric name and returns the value.
    """

    def __init__(self, metrics: Optional[Metrics] = None,
                 signals: tuple[SignalSpec, ...] = DEFAULT_SIGNALS,
                 probe: Optional[Callable[[str], float]] = None):
        self.metrics = metrics or Metrics()
        self._probe = probe
        self._lock = lockwatch.named_lock("fleet.backpressure")
        self._states = [SignalState(s) for s in signals]
        # tick listeners: called (outside the signal lock) on every
        # overloaded() evaluation — the scheduler hangs its gauge
        # refresh here so fleet_queue_depth/desired_workers are fresh
        # at the exact moment this controller reads them, not stale
        # from the last dispatch
        self._tick_listeners: list[Callable[[], None]] = []
        # external latches (the SLO alert hook): named pressure sources
        # outside the gauge table, held until explicitly cleared
        self._external: dict[str, str] = {}

    def add_tick_listener(self, cb: Callable[[], None]) -> None:
        with self._lock:
            if cb not in self._tick_listeners:
                self._tick_listeners.append(cb)

    def remove_tick_listener(self, cb: Callable[[], None]) -> None:
        """Unhook on scheduler shutdown: a long-lived shared controller
        must not keep dead schedulers alive (and writing stale gauges)
        through their listener references."""
        with self._lock:
            if cb in self._tick_listeners:
                self._tick_listeners.remove(cb)

    def _read(self, metric: str) -> float:
        if self._probe is not None:
            return float(self._probe(metric))
        return float(self.metrics.value(metric))

    def overloaded(self) -> bool:
        """Re-evaluate every signal; True while any is latched."""
        with self._lock:
            listeners = list(self._tick_listeners)
        for cb in listeners:
            try:
                cb()
            except Exception as e:
                # a broken listener must not block admission decisions
                logger.debug("backpressure tick listener failed: %s", e)
        with self._lock:
            hot = False
            for st in self._states:
                s = st.spec
                st.value = self._read(s.metric)
                if s.inverted:
                    if s.activity_metric and \
                            self._read(s.activity_metric) < s.min_activity:
                        # no traffic yet: an untouched ratio gauge
                        # (0.0) must not read as a collapsed wire
                        if st.latched:
                            st.latched = False
                            st.transitions += 1
                        continue
                    enter = st.value <= s.high
                    leave = st.value >= s.low
                else:
                    enter = st.value >= s.high
                    leave = st.value <= s.low
                if not st.latched and enter:
                    st.latched = True
                    st.transitions += 1
                elif st.latched and leave:
                    st.latched = False
                    st.transitions += 1
                hot = hot or st.latched
            return hot or bool(self._external)

    def latch_external(self, name: str, reason: str = "") -> None:
        """Latch a named external pressure source (an SLO objective
        burning budget sheds new admissions until it recovers)."""
        with self._lock:
            if name not in self._external:
                logger.info("backpressure: external latch %s (%s)",
                            name, reason or "-")
            self._external[name] = reason

    def clear_external(self, name: str) -> None:
        with self._lock:
            if self._external.pop(name, None) is not None:
                logger.info("backpressure: external latch %s cleared",
                            name)

    def snapshot(self) -> dict:
        """Per-signal values/latch states for /debug/fleet."""
        with self._lock:
            out = {
                st.spec.name: {
                    "value": st.value,
                    "latched": st.latched,
                    "high": st.spec.high,
                    "low": st.spec.low,
                    "inverted": st.spec.inverted,
                    "transitions": st.transitions,
                }
                for st in self._states
            }
            for name, reason in sorted(self._external.items()):
                out[f"external:{name}"] = {
                    "value": 1.0, "latched": True, "high": 1.0,
                    "low": 0.0, "inverted": False, "transitions": 0,
                    "reason": reason,
                }
            return out

    def latched_signals(self) -> list[str]:
        with self._lock:
            return [st.spec.name for st in self._states if st.latched] \
                + [f"external:{n}" for n in sorted(self._external)]
