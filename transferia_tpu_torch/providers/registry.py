"""Provider base + registry (the port's copy of the parts of
``transferia_tpu/providers/registry.py`` a snapshot transfer and
replication use).

A provider gets the transfer and the device the transfer's pipeline
runs on (the memory sink keys its staged rows there); capabilities it
lacks return None.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Callable, Optional, Type

from transferia_tpu_torch.abstract.interfaces import (
    AsyncSink,
    Sinker,
    Source,
    Storage,
)
from transferia_tpu_torch.runtime.device import DeviceLike
from transferia_tpu_torch.stats.registry import Metrics


@dataclass
class TestResult:
    """Endpoint connectivity check result."""

    __test__ = False  # not a pytest class

    ok: bool
    checks: dict[str, str] = field(default_factory=dict)  # name -> "ok"/err

    def add(self, name: str, err: Optional[BaseException] = None) -> None:
        self.checks[name] = "ok" if err is None else str(err)
        if err is not None:
            self.ok = False


class _SniffDone(Exception):
    """Ends a sniff's table load once it has its rows."""


class ActivateCallbacks:
    """Hooks handed to Provider.activate: the activation's cleanup and
    upload, and the `rollbacks` (utils.rollbacks.Rollbacks) a hook that
    acquires source resources registers its undos on."""

    def __init__(self, cleanup: Callable[[list], None],
                 upload: Callable[[list], None],
                 rollbacks=None):
        self.cleanup = cleanup
        self.upload = upload
        self.rollbacks = rollbacks


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

    def snapshot_provider(self):
        """Event-model-v2 snapshot capability (events.SnapshotProvider);
        None = the v1 Storage path only."""
        return None

    def event_target(self):
        """Native event-model-v2 target (events.EventTarget); None = the
        v1 sink behind events.EventTargetOverAsyncSink."""
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

    def activate(self, callbacks: ActivateCallbacks) -> None:
        """Custom activation flow; the default (cleanup + upload of every
        table) is the activate task's own."""
        raise NotImplementedError

    def supports_activate(self) -> bool:
        return type(self).activate is not Provider.activate

    def cleanup(self, tables: list) -> None:
        """Drop/truncate target tables per cleanup_policy."""

    def test(self) -> TestResult:
        """Connectivity checks."""
        return TestResult(ok=True)

    def deactivate(self) -> None:
        """Release source resources."""

    SNIFF_TABLE_CAP = 20

    def sniff(self, max_rows: int = 10) -> dict:
        """Preview a sample of rows from up to SNIFF_TABLE_CAP tables (a
        "_truncated" entry reports how many tables were skipped), through
        the storage capability."""
        storage = self.storage()
        if storage is None:
            raise NotImplementedError(
                f"provider {self.NAME!r} has no snapshot capability to "
                f"sniff"
            )
        from transferia_tpu_torch.abstract.table import TableDescription

        out: dict[str, list] = {}
        try:
            all_tables = list(storage.table_list())
            if len(all_tables) > self.SNIFF_TABLE_CAP:
                out["_truncated"] = [
                    f"{len(all_tables) - self.SNIFF_TABLE_CAP} more "
                    f"tables not sampled"
                ]
            for tid in all_tables[:self.SNIFF_TABLE_CAP]:
                rows: list = []

                def pusher(batch, _rows=rows):
                    items = batch.to_rows() \
                        if hasattr(batch, "to_rows") else batch
                    for it in items:
                        if it.is_row_event():
                            _rows.append(it.as_dict())
                            if len(_rows) >= max_rows:
                                raise _SniffDone()

                try:
                    storage.load_table(TableDescription(id=tid), pusher)
                except _SniffDone:
                    pass
                out[str(tid)] = rows
        finally:
            storage.close()
        return out


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
