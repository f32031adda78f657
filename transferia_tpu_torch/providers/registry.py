"""Provider base + registry (the port's copy of the parts of
``transferia_tpu/providers/registry.py`` a snapshot transfer and
replication use).

A provider gets the transfer and the device the transfer's pipeline
runs on (the memory sink keys its staged rows there); capabilities it
lacks return None.
"""

from __future__ import annotations

import abc
from typing import Optional, Type

from transferia_tpu_torch.abstract.interfaces import (
    AsyncSink,
    Sinker,
    Source,
    Storage,
)
from transferia_tpu_torch.runtime.device import DeviceLike
from transferia_tpu_torch.stats.registry import Metrics


class Provider(abc.ABC):
    """One connector.  Subclasses override the capabilities they
    support."""

    NAME = ""

    def __init__(self, transfer, metrics: Optional[Metrics] = None,
                 coordinator=None, device: DeviceLike = None):
        self.transfer = transfer
        self.metrics = metrics or Metrics()
        self.coordinator = coordinator
        self.device = device

    def source(self) -> Optional[Source]:
        """Replication capability."""
        return None

    def storage(self) -> Optional[Storage]:
        """Snapshot capability."""
        return None

    def sinker(self) -> Optional[Sinker]:
        """Sync sink capability."""
        return None

    def snapshot_sinker(self) -> Optional[Sinker]:
        """Dedicated snapshot-stage sink, else sinker()."""
        return None

    def async_sink(self) -> Optional[AsyncSink]:
        """Native AsyncSink."""
        return None


_PROVIDERS: dict[str, Type[Provider]] = {}


def register_provider(cls: Type[Provider]) -> Type[Provider]:
    if not cls.NAME:
        raise ValueError("provider class must set NAME")
    _PROVIDERS[cls.NAME] = cls
    return cls


def get_provider(name: str, transfer, metrics: Optional[Metrics] = None,
                 coordinator=None, device: DeviceLike = None) -> Provider:
    cls = _PROVIDERS.get(name)
    if cls is None:
        from transferia_tpu_torch.providers import load_builtin_providers

        load_builtin_providers()
        cls = _PROVIDERS.get(name)
    if cls is None:
        raise KeyError(
            f"provider {name!r} is unknown or not yet ported to "
            f"transferia_tpu_torch; ported: {sorted(_PROVIDERS)}"
        )
    return cls(transfer, metrics, coordinator, device)
