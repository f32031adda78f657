"""Minimal 5-field cron matcher for the regular snapshot's own schedule
(the port's copy of ``transferia_tpu/utils/cron.py``)."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class CronSpec:
    minutes: frozenset
    hours: frozenset
    days: frozenset
    months: frozenset
    weekdays: frozenset
    dom_restricted: bool = True
    dow_restricted: bool = True

    def matches(self, t: Optional[time.struct_time] = None) -> bool:
        t = t or time.localtime()
        dom_ok = t.tm_mday in self.days
        dow_ok = (t.tm_wday + 1) % 7 in self.weekdays  # cron: 0=Sunday
        # standard cron: when BOTH day fields are restricted they OR
        if self.dom_restricted and self.dow_restricted:
            day_ok = dom_ok or dow_ok
        else:
            day_ok = dom_ok and dow_ok
        return (
            t.tm_min in self.minutes
            and t.tm_hour in self.hours
            and t.tm_mon in self.months
            and day_ok
        )

    def next_after(self, start: Optional[float] = None) -> float:
        """Epoch seconds of the next matching minute (linear scan, bounded
        to one year)."""
        t = int(start if start is not None else time.time())
        t = t - (t % 60) + 60
        for _ in range(366 * 24 * 60):
            if self.matches(time.localtime(t)):
                return float(t)
            t += 60
        raise ValueError("cron spec never matches")


def _parse_field(field: str, lo: int, hi: int) -> frozenset:
    out: set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = int(a), int(b)
        else:
            start = end = int(part)
        out.update(range(start, end + 1, step))
    bad = [v for v in out if not lo <= v <= hi]
    if bad:
        raise ValueError(f"cron field value out of range: {bad}")
    return frozenset(out)


def parse_cron(expr: str) -> CronSpec:
    parts = expr.split()
    if len(parts) != 5:
        raise ValueError(
            f"cron expression must have 5 fields, got {len(parts)}: {expr!r}"
        )
    # weekday 7 is a standard alias for Sunday (0)
    weekdays = frozenset(
        0 if v == 7 else v for v in _parse_field(parts[4], 0, 7)
    )
    return CronSpec(
        minutes=_parse_field(parts[0], 0, 59),
        hours=_parse_field(parts[1], 0, 23),
        days=_parse_field(parts[2], 1, 31),
        months=_parse_field(parts[3], 1, 12),
        weekdays=weekdays,
        dom_restricted=parts[2] != "*",
        dow_restricted=parts[4] != "*",
    )
