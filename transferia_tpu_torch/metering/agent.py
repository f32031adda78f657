"""Metering agent + middleware (the port's copy of
``transferia_tpu/metering/agent.py``): counts rows and bytes entering and
leaving a transfer's sink pipeline and flushes periodic usage records
to a writer (none by default)."""

from __future__ import annotations

import threading
import time
from typing import Optional, Protocol

from transferia_tpu_torch.abstract.interfaces import Batch, Sinker
from transferia_tpu_torch.middlewares.helpers import batch_bytes, batch_len


class MeteringWriter(Protocol):
    def write(self, record: dict) -> None: ...


class NullWriter:
    def write(self, record: dict) -> None:
        pass


class MeteringAgent:
    """Aggregates rows/bytes and flushes periodic usage records."""

    def __init__(self, transfer_id: str,
                 writer: Optional[MeteringWriter] = None,
                 flush_interval: float = 60.0):
        self.transfer_id = transfer_id
        self.writer = writer or NullWriter()
        self.flush_interval = flush_interval
        self._lock = threading.Lock()
        self._counters = {"input_rows": 0, "input_bytes": 0,
                          "output_rows": 0, "output_bytes": 0}
        self._last_flush = time.time()

    def record(self, direction: str, rows: int, nbytes: int) -> None:
        with self._lock:
            self._counters[f"{direction}_rows"] += rows
            self._counters[f"{direction}_bytes"] += nbytes
            if time.time() - self._last_flush >= self.flush_interval:
                self._flush_locked()

    def _flush_locked(self) -> None:
        self.writer.write({"transfer_id": self.transfer_id,
                           "ts": time.time(), **self._counters})
        self._last_flush = time.time()


_AGENTS: dict[str, MeteringAgent] = {}
_AGENTS_LOCK = threading.Lock()


def metering_agent(transfer_id: str) -> MeteringAgent:
    with _AGENTS_LOCK:
        agent = _AGENTS.get(transfer_id)
        if agent is None:
            agent = _AGENTS[transfer_id] = MeteringAgent(transfer_id)
        return agent


class OutputMetering(Sinker):
    """Counts delivered rows/bytes."""

    def __init__(self, inner: Sinker, agent: MeteringAgent):
        self.inner = inner
        self.agent = agent

    def push(self, batch: Batch) -> None:
        self.inner.push(batch)
        self.agent.record("output", batch_len(batch), batch_bytes(batch))

    def close(self) -> None:
        self.inner.close()


class InputMetering(Sinker):
    """Counts rows entering the pipeline."""

    def __init__(self, inner: Sinker, agent: MeteringAgent):
        self.inner = inner
        self.agent = agent

    def push(self, batch: Batch) -> None:
        self.agent.record("input", batch_len(batch), batch_bytes(batch))
        self.inner.push(batch)

    def close(self) -> None:
        self.inner.close()
