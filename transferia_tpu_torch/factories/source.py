"""Source factory (the port's copy of ``transferia_tpu/factories/source.py``)."""

from __future__ import annotations

from typing import Optional

from transferia_tpu_torch.abstract.interfaces import Source
from transferia_tpu_torch.providers.registry import get_provider
from transferia_tpu_torch.stats.registry import Metrics


def new_source(transfer, metrics: Optional[Metrics] = None,
               coordinator=None) -> Source:
    provider = get_provider(transfer.src_provider(), transfer, metrics,
                            coordinator)
    source = provider.source()
    if source is None:
        raise ValueError(
            f"provider {transfer.src_provider()!r} has no replication "
            f"capability"
        )
    return source
