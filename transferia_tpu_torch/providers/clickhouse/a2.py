"""Native ClickHouse event-model-v2 target (the port's copy of
``transferia_tpu/providers/clickhouse/a2.py``).

InsertBatchEvent columnar blocks go to the RowBinary sink directly (no
detour through v1 row items), and an Init TableLoadEvent creates the
table from the schema it carries before the first block arrives, so
inserts never race the DDL.  The port's sink has one shard
(`CHSinker`).
"""

from __future__ import annotations

import concurrent.futures
from typing import Sequence

from transferia_tpu_torch.events.model import (
    Event,
    InsertBatchEvent,
    RawItems,
    RowEvents,
    TableLoadEvent,
)
from transferia_tpu_torch.events.pipeline import EventTarget
from transferia_tpu_torch.providers.clickhouse.provider import (
    CHSinker,
    CHTargetParams,
)
from transferia_tpu_torch.runtime.device import DeviceLike


class CHEventTarget(EventTarget):
    def __init__(self, params: CHTargetParams, device: DeviceLike = None):
        self.sinker = CHSinker(params, device)

    def _precreate(self, ev: TableLoadEvent) -> None:
        if ev.schema is not None:
            self.sinker.ensure_table(ev.table_id, ev.schema)

    def async_push(self, events: Sequence[Event]
                   ) -> "concurrent.futures.Future[None]":
        fut: concurrent.futures.Future = concurrent.futures.Future()
        try:
            for ev in events:
                if isinstance(ev, TableLoadEvent):
                    if not ev.is_done:
                        self._precreate(ev)
                elif isinstance(ev, InsertBatchEvent):
                    self.sinker.push(ev.batch)
                elif isinstance(ev, (RowEvents, RawItems)):
                    self.sinker.push(ev.items)
                else:
                    raise TypeError(
                        f"CH a2 target: unknown event "
                        f"{type(ev).__name__}")
            fut.set_result(None)
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            fut.set_exception(e)
        return fut

    def close(self) -> None:
        self.sinker.close()
