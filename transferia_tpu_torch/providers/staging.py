"""Staging machinery for staged-commit sinks (the port's copy of the
parts of ``transferia_tpu/providers/staging.py`` the memory sink uses).

- `PartStage` is one part's staging state: the `(key, epoch)` identity,
  the in-memory batch buffer and the torn-write dedup window;
- the dedup window drops a replayed torn-write prefix before publish.
  A replay needs both signals: the retry layer armed the window
  (`StagedSinker.note_push_retry`, called by the sink Retrier before it
  re-pushes a failed batch), and the incoming batch's row-key sequence
  (`ops/rowhash.batch_row_keys`, kernel K10 in keys mode on a card)
  starts with the previous staged push's keys in order.  Only that
  prefix drops; equal rows in different batches are source
  multiplicity and pass;
- `EpochFence` is the sink-side publish fence: an epoch older than the
  last accepted publish of a key raises `StaleEpochPublishError`.

The reference's `sink.stage`/`sink.publish` failpoints and spans are
telemetry and are not ported (ROADMAP.md A5).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from transferia_tpu_torch.abstract.errors import StaleEpochPublishError
from transferia_tpu_torch.abstract.interfaces import Batch, is_columnar
from transferia_tpu_torch.runtime.device import DeviceLike

# cap on the row keys remembered from the last staged push (past it the
# window stops matching: duplicates land and the at-least-once bound
# covers them)
DEDUP_WINDOW_ROWS = 1 << 20


class DedupWindow:
    """Torn-write replay detector over one part's staged pushes.

    A torn write lands a prefix of a batch, then the push errors and the
    Retrier re-pushes the whole batch.  A push is a replay when the
    window was armed since the last row push and its key sequence starts
    with the previous staged push's; exactly that prefix is dropped."""

    def __init__(self, max_rows: int = DEDUP_WINDOW_ROWS,
                 device: DeviceLike = None):
        self.max_rows = max_rows
        self.device = device
        self._prev = None  # np.uint64 keys of the last staged row push
        self._armed = False

    def arm_replay(self) -> None:
        """The next row push is a retry of a failed one (Retrier)."""
        self._armed = True

    def filter(self, batch: Batch) -> tuple[Batch, int]:
        """Drop the replayed prefix of a recognized replay, else pass
        through.  Returns (batch, rows dropped); control items pass and
        do not consume the armed flag."""
        keys = _row_keys(batch, self.device)
        if keys is None or len(keys) == 0:
            return batch, 0
        armed, self._armed = self._armed, False
        prev = self._prev
        dropped = 0
        if armed and prev is not None and 0 < len(prev) <= len(keys) \
                and np.array_equal(keys[:len(prev)], prev):
            dropped = int(len(prev))
            batch = _drop_prefix(batch, dropped)
        # remember this push whole (a later tear replays it whole)
        self._prev = keys if len(keys) <= self.max_rows else None
        return batch, dropped


def _row_keys(batch: Batch, device: DeviceLike):
    """Content keys (np.uint64, row order) of a pushed batch; None = no
    row content."""
    from transferia_tpu_torch.columnar.batch import ColumnBatch
    from transferia_tpu_torch.ops.rowhash import batch_row_keys

    if is_columnar(batch):
        if batch.n_rows == 0:
            return None
        return batch_row_keys(batch, device=device)
    rows = [it for it in batch if it.is_row_event()]
    if not rows or len(rows) != len(batch):
        # mixed/control batch: pass through rather than misattribute
        return None
    return batch_row_keys(ColumnBatch.from_rows(rows), device=device)


def _drop_prefix(batch: Batch, k: int) -> Batch:
    if is_columnar(batch):
        return batch.slice(k, batch.n_rows)
    return batch[k:]


class PartStage:
    """One part's staging state inside a sink: the staged batches (held
    in memory until publish), their row count and the dedup window."""

    def __init__(self, key: str, epoch: int,
                 dedup_rows: int = DEDUP_WINDOW_ROWS,
                 device: DeviceLike = None):
        self.key = key
        self.epoch = epoch
        self.batches: list[Batch] = []
        self.rows = 0
        self.dedup_dropped = 0
        self._window = DedupWindow(dedup_rows, device)

    def note_push_retry(self) -> None:
        """The Retrier is about to re-push a failed batch: arm the dedup
        window."""
        self._window.arm_replay()

    def stage(self, batch: Batch) -> Batch:
        """Dedup one pushed batch against the window, count and hold
        it."""
        batch, dropped = self._window.filter(batch)
        self.dedup_dropped += dropped
        self.rows += batch.n_rows if is_columnar(batch) else sum(
            1 for it in batch if it.is_row_event())
        self.batches.append(batch)
        return batch


class EpochFence:
    """Sink-side publish fence: the last accepted publish epoch per key.
    Older epochs raise (a zombie); equal or newer pass and are
    recorded."""

    def __init__(self):
        self._lock = threading.Lock()
        self._published: dict[str, int] = {}

    def check_and_advance(self, key: str, epoch: int) -> Optional[int]:
        """The previously published epoch (None = first publish), or
        StaleEpochPublishError."""
        with self._lock:
            prev = self._published.get(key)
            if prev is not None and epoch < prev:
                raise StaleEpochPublishError(key, epoch, prev)
            self._published[key] = epoch
            return prev
