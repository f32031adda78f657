"""Storage factory (the port's copy of
``transferia_tpu/factories/storage.py``)."""

from __future__ import annotations

from typing import Optional

from transferia_tpu_torch.abstract.interfaces import Storage
from transferia_tpu_torch.providers.registry import get_provider
from transferia_tpu_torch.stats.registry import Metrics


def new_storage(transfer, metrics: Optional[Metrics] = None) -> Storage:
    provider = get_provider(transfer.src_provider(), transfer, metrics)
    storage = provider.storage()
    if storage is None:
        raise ValueError(
            f"provider {transfer.src_provider()!r} has no snapshot capability"
        )
    return storage
