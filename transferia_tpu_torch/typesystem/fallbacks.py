"""Versioned type fallbacks (the port's copy of
``transferia_tpu/typesystem/fallbacks.py``).

A transfer records the typesystem version current at its creation
(`Transfer.type_system_version`); when LATEST_VERSION moves ahead, every
registered fallback with `since > transfer_version` is applied as a sink
middleware so old transfers keep seeing old type behavior.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from transferia_tpu_torch.columnar.batch import ColumnBatch

LATEST_VERSION = 1


@dataclass(frozen=True)
class Fallback:
    """One versioned transform: transfers with type_system_version <
    since get it applied.  provider "" = every provider; side "source"
    or "target"."""

    name: str
    since: int
    provider: str
    side: str
    apply: Callable[[ColumnBatch], ColumnBatch]


_FALLBACKS: list[Fallback] = []


def register_fallback(fb: Fallback) -> None:
    _FALLBACKS.append(fb)


def fallbacks_for(provider: str, side: str,
                  transfer_version: int) -> list[Fallback]:
    """All fallbacks to apply for a transfer pinned at transfer_version,
    newest change first."""
    out = [
        fb for fb in _FALLBACKS
        if fb.side == side
        and fb.provider in ("", provider)
        and fb.since > transfer_version
    ]
    return sorted(out, key=lambda fb: -fb.since)
