"""Mergeable log-bucketed latency histograms (HDR-style; the port's
copy of ``transferia_tpu/stats/hdr.py``, bucket for bucket).

The scalar stage timers (stats/stagetimer.py totals, trace.py
stage_summary percentiles over raw duration lists) are per-process and
un-mergeable: N workers each holding a sorted list of durations cannot
produce a fleet p99 without shipping every sample.  This module is the
mergeable replacement the fleet observability plane exports inside obs
segments (stats/fleetobs.py): values land in fixed log2 buckets with
SUB sub-buckets per octave, so

    merge(h(A), h(B)) == h(A ++ B)     (exact, bucket-wise add)

holds by construction — the property the fleet panes and `bench.py
--fleet` tail rely on to report cross-process p50/p99/p999.

Bucketing: for v seconds, frexp(v) = (m, e) with m in [0.5, 1);
the bucket index is (e + BIAS) * SUB + floor((m - 0.5) * 2 * SUB) —
SUB=16 sub-buckets per octave bounds the relative quantile error at
~1/(2*16) ≈ 3%, plenty for tail-latency SLO work, while a year-long
duration still fits in a couple thousand sparse buckets.

Exemplars: the histogram remembers the largest observed value and the
trace id active when it was recorded (`max_trace`) — the fleet pane's
"jump to the worst dispatch in Perfetto" hook.  Merging keeps the
exemplar of whichever side holds the larger max.

`STAGES` is the process-global registry the export plane snapshots;
recording is one dict lookup + a few int adds under a lock, cheap
enough for per-part / per-dispatch call sites (never per-row).
"""

from __future__ import annotations

import math
import threading
from typing import Optional

SUB = 16          # sub-buckets per octave (power of two)
BIAS = 64         # supports values down to 2^-64 s
_MIN_VALUE = 2.0 ** -BIAS


def bucket_index(value: float) -> int:
    """Sparse bucket index for a duration in seconds (<=0 clamps to
    the smallest bucket — negative latencies are clock skew, not
    data)."""
    if value < _MIN_VALUE:
        return 0
    m, e = math.frexp(value)          # value = m * 2**e, m in [0.5, 1)
    idx = (e + BIAS) * SUB + int((m - 0.5) * 2 * SUB)
    return max(0, idx)


def bucket_mid(idx: int) -> float:
    """Representative value (bucket midpoint) for quantile read-back."""
    e = idx // SUB - BIAS
    sub = idx % SUB
    lo = math.ldexp(1.0 + sub / SUB, e - 1)
    hi = math.ldexp(1.0 + (sub + 1) / SUB, e - 1)
    return (lo + hi) / 2.0


class LogHistogram:
    """One mergeable latency distribution (sparse log2 buckets).

    Not thread-safe on its own — callers (the STAGES registry, the
    merge plane) hold their own locks; a histogram inside an obs
    segment is immutable data."""

    __slots__ = ("counts", "count", "total", "max_value", "max_trace",
                 "min_value")

    def __init__(self):
        self.counts: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.max_value = 0.0
        self.min_value = 0.0
        self.max_trace = 0        # trace id active at the max (0 = none)

    def observe(self, value: float, trace_id: int = 0) -> None:
        value = float(value)
        idx = bucket_index(value)
        self.counts[idx] = self.counts.get(idx, 0) + 1
        self.count += 1
        self.total += value
        if value > self.max_value or self.count == 1:
            self.max_value = value
            self.max_trace = int(trace_id or 0)
        if value < self.min_value or self.count == 1:
            self.min_value = value

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Bucket-wise add of `other` into self (exact: merge of two
        histograms equals the histogram of the concatenated samples)."""
        for idx, n in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + n
        self.count += other.count
        self.total += other.total
        if other.count:
            if not self.count - other.count or \
                    other.max_value > self.max_value:
                self.max_value = other.max_value
                self.max_trace = other.max_trace
            if not self.count - other.count or \
                    other.min_value < self.min_value:
                self.min_value = other.min_value
        return self

    def quantile(self, q: float) -> float:
        """Value at quantile q in [0, 1] (0.0 for an empty histogram).
        The top occupied bucket reads back the exact max — tails never
        round up past an observation."""
        if self.count <= 0:
            return 0.0
        rank = max(1, math.ceil(min(max(q, 0.0), 1.0) * self.count))
        indices = sorted(self.counts)
        cum = 0
        for idx in indices:
            cum += self.counts[idx]
            if cum >= rank:
                if idx == indices[-1]:
                    return self.max_value
                return bucket_mid(idx)
        return self.max_value

    def fraction_at_most(self, value: float) -> float:
        """Fraction of observations <= value (the SLO good-event
        ratio).  1.0 for an empty histogram — no observations means no
        bad events, not a breach.  The bucket containing `value` counts
        as good, so the answer inherits the ~3% bucket granularity —
        plenty for burn-rate work, and exactly reproducible from any
        merge order."""
        if self.count <= 0:
            return 1.0
        limit = bucket_index(value)
        good = sum(n for idx, n in self.counts.items() if idx <= limit)
        return min(1.0, good / self.count)

    def diff(self, baseline: "LogHistogram") -> "LogHistogram":
        """Self minus a prior snapshot of the SAME histogram (bucket-
        wise, clamped at 0) — how a bench carves its own window out of
        the process-global registry.  The max/exemplar are taken from
        self when any new observation landed (approximate: the true
        window max is unrecoverable from cumulative buckets, but a
        bench window's max is almost always the lifetime max)."""
        out = LogHistogram()
        for idx, n in self.counts.items():
            d = n - baseline.counts.get(idx, 0)
            if d > 0:
                out.counts[idx] = d
        out.count = max(0, self.count - baseline.count)
        out.total = max(0.0, self.total - baseline.total)
        if out.count:
            out.max_value = self.max_value
            out.max_trace = self.max_trace
            out.min_value = self.min_value
        return out

    # -- wire form (obs segments) --------------------------------------------
    def to_json(self) -> dict:
        return {
            "counts": {str(i): n for i, n in sorted(self.counts.items())},
            "count": self.count,
            "total": round(self.total, 9),
            "max": self.max_value,
            "min": self.min_value,
            "max_trace": self.max_trace,
        }

    @classmethod
    def from_json(cls, d: dict) -> "LogHistogram":
        """Tolerant of junk: a torn segment must degrade to an empty
        histogram, never raise into the merge loop."""
        h = cls()
        if not isinstance(d, dict):
            return h
        raw = d.get("counts")
        if isinstance(raw, dict):
            for k, n in raw.items():
                try:
                    idx, cnt = int(k), int(n)
                except (TypeError, ValueError):
                    continue
                if cnt > 0:
                    h.counts[idx] = h.counts.get(idx, 0) + cnt
        try:
            h.count = max(0, int(d.get("count", 0)))
            h.total = float(d.get("total", 0.0))
            h.max_value = float(d.get("max", 0.0))
            h.min_value = float(d.get("min", 0.0))
            h.max_trace = int(d.get("max_trace", 0) or 0)
        except (TypeError, ValueError):
            pass
        if h.count != sum(h.counts.values()):
            # torn counts vs header: trust the buckets (quantiles stay
            # internally consistent; totals are advisory)
            h.count = sum(h.counts.values())
        return h

    def summary(self) -> dict:
        """The pane row: p50/p99/p999 in ms + count + max exemplar."""
        return {
            "count": self.count,
            "p50_ms": round(self.quantile(0.50) * 1000.0, 3),
            "p99_ms": round(self.quantile(0.99) * 1000.0, 3),
            "p999_ms": round(self.quantile(0.999) * 1000.0, 3),
            "max_ms": round(self.max_value * 1000.0, 3),
            "mean_ms": round(
                (self.total / self.count) * 1000.0, 3) if self.count
            else 0.0,
            "max_trace": self.max_trace,
        }


class StageHistograms:
    """Process-global per-stage registry (module singleton STAGES).

    `observe` defaults the exemplar to the active trace context, so the
    max bucket of every exported histogram points at a real span id in
    the merged fleet timeline."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: dict[str, LogHistogram] = {}

    def observe(self, stage: str, seconds: float,
                trace_id: Optional[int] = None) -> None:
        if trace_id is None:
            from transferia_tpu_torch.stats import trace

            ctx = trace.current_context()
            trace_id = ctx.trace_id if ctx else 0
        with self._lock:
            h = self._hists.get(stage)
            if h is None:
                h = self._hists[stage] = LogHistogram()
            h.observe(seconds, trace_id)

    def get(self, stage: str) -> LogHistogram:
        """A copy of one stage's histogram (empty when unseen) — safe
        to use as a diff baseline."""
        with self._lock:
            h = self._hists.get(stage)
            return LogHistogram.from_json(h.to_json()) if h \
                else LogHistogram()

    def snapshot(self) -> dict[str, dict]:
        """{stage: histogram json} — the obs-segment payload."""
        with self._lock:
            return {name: h.to_json()
                    for name, h in sorted(self._hists.items())}

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()


STAGES = StageHistograms()


def observe(stage: str, seconds: float,
            trace_id: Optional[int] = None) -> None:
    """Module-level convenience: record one latency into the global
    per-stage registry."""
    STAGES.observe(stage, seconds, trace_id)


def merge_stage_maps(maps: list[dict]) -> dict[str, LogHistogram]:
    """Merge N segments' `hists` payloads into live histograms —
    bucket-wise exact, junk-tolerant (a torn map contributes what it
    can)."""
    out: dict[str, LogHistogram] = {}
    for m in maps:
        if not isinstance(m, dict):
            continue
        for name, d in m.items():
            h = out.get(name)
            if h is None:
                h = out[name] = LogHistogram()
            h.merge(LogHistogram.from_json(d))
    return out
