"""Storage factory (the port's copy of
``transferia_tpu/factories/storage.py``)."""

from __future__ import annotations

from typing import Optional

from transferia_tpu_torch.abstract.interfaces import Storage
from transferia_tpu_torch.providers.registry import get_provider
from transferia_tpu_torch.stats.registry import Metrics


def new_storage(transfer, metrics: Optional[Metrics] = None,
                coordinator=None) -> Storage:
    """The source's snapshot storage.  A snapshot hands its coordinator
    on, so that a storage that keeps state between runs (the Airbyte
    source's STATE) finds it; the reference passes none (ROADMAP.md C)."""
    provider = get_provider(transfer.src_provider(), transfer, metrics,
                            coordinator=coordinator)
    storage = provider.storage()
    if storage is None:
        raise ValueError(
            f"provider {transfer.src_provider()!r} has no snapshot capability"
        )
    return storage
