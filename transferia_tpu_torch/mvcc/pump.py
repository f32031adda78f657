"""Live replication pump: CDC flows into the MVCC store DURING the
snapshot (the port's copy of ``transferia_tpu/mvcc/pump.py``).

A pump over the fetch/commit client contract `QueueSource` uses
(providers/queue_common.py), appending LSN-ordered delta layers into the
store WHILE the snapshot loads:

  client.fetch -> pump_checkpoint (failpoint + trace + counters)
      -> parser.do_batch -> pump-assigned monotone LSNs
      -> per-table buffers -> store.append_delta(layer, offsets)

**Offsets ride the layers.**  Each sealed layer's admission record
carries the per-source-partition high offsets its rows covered
("topic:partition" -> offset), so the control doc is the pump's own
checkpoint: a restarted pump seeks a client that can seek to
`doc_offsets(manifest) + 1`.  A flush that seals several tables' layers
puts the offsets on the LAST layer only: die between them and the
offsets do not advance, so the resumed pump re-fetches the window and
the PK latest-wins merge absorbs the overlap.

**The offset fence.**  The source's offsets commit in two fenced steps
and nowhere else: the cutover seals `store.local_offsets()` inside the
same coordinator decision as the watermark and epoch, and only the
sealed values ever reach `client.commit` (`commit_sealed_offsets`, the
`mvcc.offset_commit` failpoint).  A pump that appends after the seal is
FENCED by layer admission and stops itself.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import numpy as np

from transferia_tpu_torch.abstract import mvccfence
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.mvcc.store import MvccStore
from transferia_tpu_torch.parsers import make_parser
from transferia_tpu_torch.providers.queue_common import pump_checkpoint
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.stats.registry import Metrics, SourceStats

logger = logging.getLogger(__name__)

# rows buffered per table before a delta layer seals: a kill loses at most
# one unflushed window, and the layer count stays O(feed / 256)
DEFAULT_LAYER_ROWS = 256


def partition_key(topic: str, partition: int) -> str:
    return f"{topic}:{partition}"


def split_partition_key(key: str) -> tuple[str, int]:
    topic, _, part = key.rpartition(":")
    return topic, int(part)


class MvccPump:
    """One worker's replication pump into an MvccStore.

    client contract (as QueueSource's):
      fetch(max_messages) -> list[FetchedBatch]
      commit(topic, partition, offset) -> None
      seek(topic, partition, offset) -> None   (optional; resume)
      close() -> None

    Drive it synchronously (`step()` in a loop) or as a thread
    (`start()` / `drain()`: the activation runner starts it before the
    snapshot read and drains it at the cutover).
    """

    def __init__(self, store: MvccStore, client, parser=None,
                 parser_config=None, worker: str = "pump",
                 layer_rows: int = DEFAULT_LAYER_ROWS,
                 metrics: Optional[Metrics] = None,
                 transfer_id: str = "", poll: float = 0.05):
        self.store = store
        self.client = client
        self.parser = parser if parser is not None else make_parser(
            parser_config if parser_config else {"blank": {}})
        self.worker = worker
        self.layer_rows = max(1, int(layer_rows))
        self.source_stats = SourceStats(metrics or Metrics())
        self.transfer_id = transfer_id
        self.poll = poll
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.failure: Optional[BaseException] = None
        self.fenced = False
        # per-table un-sealed row buffers and the offsets they cover
        self._pending: dict[str, list] = {}
        self._pending_rows = 0
        self._offsets: dict[str, int] = {}
        self._resume(store.control_state())

    def _resume(self, state: dict) -> None:
        """Arm the LSN and seq counters and the client cursor from the
        control doc: the manifest IS the checkpoint."""
        self._next_lsn = int(state.get(
            "watermark", mvccfence.doc_watermark(state))) + 1
        self._next_seq = 1 + max(
            (int(d.get("seq", 0))
             for d in (state.get("layers") or [])
             if d.get("worker") == self.worker), default=-1)
        covered = mvccfence.doc_offsets(state)
        self._offsets.update(covered)
        seek = getattr(self.client, "seek", None)
        if seek is None:
            return
        for key, off in sorted(covered.items()):
            topic, part = split_partition_key(key)
            seek(topic, part, int(off) + 1)
        if covered:
            logger.info("mvcc pump %s: resumed %d partition(s) past "
                        "admitted offsets %s", self.worker,
                        len(covered), covered)

    # -- synchronous drive --------------------------------------------------
    def step(self, max_messages: int = 1024) -> int:
        """One fetch/parse/buffer pass; seals layers when the buffers
        reach `layer_rows`.  Returns messages consumed (0 = the feed is
        idle).  Raises what the parse or append raised; thread mode
        latches it into `self.failure` instead."""
        if self.fenced:
            return 0
        fetched = self.client.fetch(max_messages=max_messages)
        consumed = 0
        for fb in fetched:
            pump_checkpoint(fb, self.source_stats, self.transfer_id)
            consumed += len(fb.messages)
            result = self.parser.do_batch(fb.messages)
            self.source_stats.parsed_rows.inc(result.row_count())
            batches = list(result.batches)
            if result.unparsed is not None:
                self.source_stats.unparsed_rows.inc(
                    result.unparsed.n_rows)
                batches.append(result.unparsed)
            for b in batches:
                if b.n_rows == 0:
                    continue
                # pump-local monotone LSNs in fetch order: the delta
                # ordering the merge and the sealed watermark rank by
                b.lsns = np.arange(self._next_lsn,
                                   self._next_lsn + b.n_rows,
                                   dtype=np.int64)
                self._next_lsn += b.n_rows
                self._pending.setdefault(str(b.table_id), []).append(b)
                self._pending_rows += b.n_rows
            key = partition_key(fb.topic, fb.partition)
            high = max(fb.offsets())
            if high > self._offsets.get(key, -1):
                self._offsets[key] = high
            if self._pending_rows >= self.layer_rows:
                self.flush()
                if self.fenced:
                    break
        return consumed

    def flush(self) -> int:
        """Seal every pending table buffer as one delta layer each.  The
        covered-offsets snapshot rides ONLY the last layer."""
        if not self._pending:
            return 0
        tables = sorted(self._pending)
        sealed = 0
        for i, table in enumerate(tables):
            batches = self._pending.pop(table)
            offs = dict(self._offsets) if i == len(tables) - 1 else None
            seq = self._next_seq
            self._next_seq += 1
            decision = self.store.append_delta(
                table, self.worker, seq, batches, offsets=offs)
            if decision.get("status") == mvccfence.FENCED:
                # the cutover sealed under us: this pump is a zombie now;
                # drop everything un-admitted and stop
                logger.warning(
                    "mvcc pump %s: layer (%s, %d) fenced by sealed "
                    "cutover, stopping", self.worker, table, seq)
                self.fenced = True
                self._pending.clear()
                self._pending_rows = 0
                return sealed
            rows = sum(b.n_rows for b in batches)
            self._pending_rows -= rows
            sealed += 1
            self.store.stats.pump_layers.inc()
            self.store.stats.pump_rows.inc(rows)
        return sealed

    def offsets(self) -> dict:
        """Per-partition high offsets over every ADMITTED layer (this
        pump's and the manifest's, never the unflushed buffer): the value
        the cutover seals."""
        out = mvccfence.doc_offsets(self.store.control_state())
        for key, off in self.store.local_offsets().items():
            if int(off) > out.get(key, -1):
                out[key] = int(off)
        return out

    def commit_sealed_offsets(self) -> dict:
        """Commit the SEALED source offsets to the client: the only path
        by which replication offsets reach the source, strictly after
        the cutover decision that froze them.  Idempotent; returns what
        committed."""
        offs = self.store.sealed_offsets()
        if offs is None:
            raise RuntimeError(
                f"mvcc pump {self.worker}: no sealed cutover; offsets "
                f"only commit inside the fence")
        failpoint("mvcc.offset_commit")
        sp = trace.span("mvcc_offset_commit", scope=self.store.scope,
                        partitions=len(offs))
        with sp:
            for key, off in sorted(offs.items()):
                topic, part = split_partition_key(key)
                self.client.commit(topic, part, int(off))
            self.store.stats.offset_commits.inc(max(1, len(offs)))
        return offs

    # -- thread drive -------------------------------------------------------
    def start(self) -> "MvccPump":
        """Run the pump concurrently with the snapshot load."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"mvcc-pump-{self.worker}",
            daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            while not self._stop.is_set() and not self.fenced:
                if self.step() == 0:
                    self._stop.wait(self.poll)
        except BaseException as e:  # latched, re-raised by drain()
            self.failure = e

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def drain(self) -> int:
        """Quiesce for the cutover: stop the thread, absorb what the feed
        still holds, seal the partial buffers.  Raises the thread's
        latched failure if it died."""
        self.stop()
        if self.failure is not None:
            raise self.failure
        total = 0
        while not self.fenced:
            n = self.step()
            total += n
            if n == 0:
                break
        self.flush()
        return total

    def close(self) -> None:
        self.stop()
        close = getattr(self.client, "close", None)
        if close:
            close()

    # -- construction -------------------------------------------------------
    @classmethod
    def from_transfer(cls, transfer, store: MvccStore,
                      metrics: Optional[Metrics] = None,
                      worker: str = "pump",
                      layer_rows: int = DEFAULT_LAYER_ROWS
                      ) -> Optional["MvccPump"]:
        """Build a pump from the transfer's replication source when it is
        queue-shaped (exposes the fetch/commit client and parser that
        QueueSource composes).  None when the source provider has no
        replication capability or is not queue-shaped: the activation
        then runs snapshot-only.  As in the reference, the source is
        built without a coordinator, so a Kafka client's commits (which
        land in the coordinator's transfer state) go nowhere here."""
        from transferia_tpu_torch.factories import new_source

        try:
            src = new_source(transfer, metrics or Metrics())
        except ValueError:
            return None
        client = getattr(src, "client", None)
        parser = getattr(src, "parser", None)
        if client is None or not hasattr(client, "fetch"):
            close = getattr(src, "stop", None)
            if close:
                close()
            return None
        return cls(store, client, parser=parser, metrics=metrics,
                   worker=worker, layer_rows=layer_rows,
                   transfer_id=transfer.id)
