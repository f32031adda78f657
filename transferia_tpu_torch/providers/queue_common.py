"""Shared queue-source machinery (the port's copy of
``transferia_tpu/providers/queue_common.py``).

A broker provider composes:
  reader (broker client) -> Sequencer -> ParseQueue(parser) -> AsyncSink
                               ^ offsets commit only after a confirmed push
`pump_checkpoint` carries the reference's `replication.pump`
failpoint, trace instant and poll watermark.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

from transferia_tpu_torch.abstract.interfaces import AsyncSink, Source
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.parsequeue import ParseQueue
from transferia_tpu_torch.parsers import Message, Parser, make_parser
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.stats.registry import Metrics, SourceStats
from transferia_tpu_torch.stats.watermark import POLL_PREFIX, WATERMARKS

logger = logging.getLogger(__name__)

STOP_POLL_SECONDS = 0.2  # idle wait after an empty fetch


class Sequencer:
    """Tracks in-flight (partition, offset) ranges and yields the highest
    offset safe to commit once pushes confirm: out-of-order acks must not
    commit past an unacked message."""

    def __init__(self):
        self._lock = threading.Lock()
        # (topic, partition) -> list of [offset, acked] in fetch order
        self._inflight: dict[tuple[str, int], list[list]] = {}

    def start_processing(self, topic: str, partition: int,
                         offsets: Sequence[int]) -> None:
        with self._lock:
            lst = self._inflight.setdefault((topic, partition), [])
            for o in offsets:
                lst.append([o, False])

    def ack(self, topic: str, partition: int,
            offsets: Sequence[int]) -> Optional[int]:
        """Mark offsets done; return the new committable high-water mark
        (the largest offset with no unacked predecessors), or None."""
        with self._lock:
            lst = self._inflight.get((topic, partition), [])
            offset_set = set(offsets)
            for entry in lst:
                if entry[0] in offset_set:
                    entry[1] = True
            commit = None
            while lst and lst[0][1]:
                commit = lst.pop(0)[0]
            return commit


@dataclass
class FetchedBatch:
    topic: str
    partition: int
    messages: list[Message]

    def offsets(self) -> list[int]:
        return [m.offset for m in self.messages]


def pump_checkpoint(fb: FetchedBatch,
                    stats: Optional[SourceStats] = None,
                    transfer_id: str = "") -> None:
    """Per-fetched-batch pump bookkeeping: the `replication.pump`
    failpoint (a kill between fetch and enqueue, which the resuming pump
    must absorb by restarting from its last committed offset), the trace
    instant, the source counters and the poll watermark."""
    failpoint("replication.pump")
    trace.instant("replication_pump", topic=fb.topic,
                  partition=fb.partition,
                  messages=len(fb.messages))
    if stats is not None:
        stats.changeitems.inc(len(fb.messages))
        stats.read_bytes.inc(sum(len(m.value) for m in fb.messages))
    if transfer_id:
        # poll watermark: the newest broker write time seen for this
        # partition — the stand-in event time for batches whose
        # parser drops it
        wm = max((m.write_time_ns for m in fb.messages), default=0)
        if wm:
            WATERMARKS.advance(
                transfer_id, f"{POLL_PREFIX}{fb.topic}:{fb.partition}",
                event_ns=wm, origin="poll")


class QueueSource(Source):
    """Generic replication source over a fetch/commit client.

    client contract:
      fetch(max_messages) -> list[FetchedBatch] (blocking up to poll timeout)
      commit(topic, partition, offset) -> None
      close() -> None
    """

    def __init__(self, client, parser_config, parallelism: int = 4,
                 metrics: Optional[Metrics] = None, transfer_id: str = ""):
        self.client = client
        self.parser: Parser = make_parser(parser_config) \
            if parser_config else make_parser({"blank": {}})
        self.parallelism = parallelism
        self.stats = SourceStats(metrics or Metrics())
        self.sequencer = Sequencer()
        self._stop = threading.Event()
        self.transfer_id = transfer_id

    def run(self, sink: AsyncSink) -> None:
        def parse(fb: FetchedBatch):
            t0 = time.monotonic()
            result = self.parser.do_batch(fb.messages)
            self.stats.decode_time.observe(time.monotonic() - t0)
            self.stats.parsed_rows.inc(result.row_count())
            if result.unparsed is not None:
                self.stats.unparsed_rows.inc(result.unparsed.n_rows)
            batches = list(result.batches)
            if result.unparsed is not None:
                batches.append(result.unparsed)
            return batches

        def ack(fb: FetchedBatch, err: Optional[BaseException]):
            if err is not None:
                return  # the failure latches in the parsequeue; no commit
            commit = self.sequencer.ack(fb.topic, fb.partition,
                                        fb.offsets())
            if commit is not None:
                self.client.commit(fb.topic, fb.partition, commit)

        pq = ParseQueue(self.parallelism, sink, parse, ack)
        try:
            while not self._stop.is_set():
                if pq.failure is not None:
                    raise pq.failure
                fetched = self.client.fetch(max_messages=1024)
                if not fetched:
                    self._stop.wait(STOP_POLL_SECONDS)
                    continue
                for fb in fetched:
                    pump_checkpoint(fb, self.stats, self.transfer_id)
                    self.sequencer.start_processing(
                        fb.topic, fb.partition, fb.offsets()
                    )
                    pq.add(fb)
            pq.wait()
            if pq.failure is not None:
                raise pq.failure
        finally:
            pq.close()
            self.client.close()

    def stop(self) -> None:
        self._stop.set()
