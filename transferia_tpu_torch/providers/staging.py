"""Staging machinery for staged-commit sinks (the port's copy of the
parts of ``transferia_tpu/providers/staging.py`` the memory, ClickHouse,
Postgres, Kafka and `fs` sinks use).

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
  last accepted publish of a key raises `StaleEpochPublishError`;
- `WireStage` and the `__trtpu_` naming (`part_slug`, `stage_ident`,
  `META_COLUMN`, `COMMITS_TABLE`) serve the wire sinks (ClickHouse):
  a part stages into its own table and publish swaps it in;
- `DirectoryPartStage` is the directory sinks' (`fs`) staging: an inner
  sink writes the part into `<root>/.staging/<slug>.e<epoch>/` and the
  publish renames the files in behind a marker-file epoch fence.

`PartStage.stage` owns the `sink.stage` failpoint and the `sink_stage`
span; `publish_guard` wraps every publish with the `sink.publish`
failpoint and the `sink_publish` span, as in the reference.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np

from transferia_tpu_torch.abstract.errors import StaleEpochPublishError
from transferia_tpu_torch.abstract.interfaces import Batch, is_columnar
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.runtime.device import DeviceLike
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.stats.ledger import LEDGER

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
    """One part's staging state inside a sink: the dedup window, the row
    count and, with `hold=True`, the staged batches held in memory until
    publish (`hold=False`: the sink persists the filtered batch into its
    own staging area)."""

    def __init__(self, key: str, epoch: int, hold: bool = True,
                 dedup_rows: int = DEDUP_WINDOW_ROWS,
                 device: DeviceLike = None):
        self.key = key
        self.epoch = epoch
        self.hold = hold
        self.batches: list[Batch] = []
        self.rows = 0
        self.dedup_dropped = 0
        self.poisoned = False
        self._window = DedupWindow(dedup_rows, device)

    def mark_failed(self) -> None:
        """Poison the stage after a failure downstream of the dedup
        window: the window already holds the batch's keys, so a push
        retry could drop the unwritten suffix.  Every further stage()
        fails until the part retries and `begin_part` replaces the
        stage."""
        self.poisoned = True

    def note_push_retry(self) -> None:
        """The Retrier is about to re-push a failed batch: arm the dedup
        window."""
        self._window.arm_replay()

    def stage(self, batch: Batch) -> Batch:
        """Fire the `sink.stage` failpoint (a fault here must fail the
        push with nothing newly visible), dedup one pushed batch against
        the window, count it and (when holding) keep it."""
        if self.poisoned:
            raise ConnectionError(
                f"stage for {self.key!r} poisoned by an earlier staging "
                f"failure; the part must restage from scratch")
        failpoint("sink.stage")
        sp = trace.span("sink_stage", part=self.key, epoch=self.epoch)
        with sp:
            batch, dropped = self._window.filter(batch)
            if dropped:
                self.dedup_dropped += dropped
                LEDGER.add(dedup_rows_dropped=dropped)
            n = batch.n_rows if is_columnar(batch) else sum(
                1 for it in batch if it.is_row_event())
            self.rows += n
            if sp:
                sp.add(rows=n, dedup_dropped=dropped)
            if self.hold:
                self.batches.append(batch)
        return batch


class publish_guard:
    """Context manager every `publish_part` implementation enters:
    fires the `sink.publish` failpoint (a fault here must leave the
    target either fully unpublished or fully replaced — never torn) and
    records the publish as a trace span."""

    def __init__(self, key: str, epoch: int):
        self._sp = trace.span("sink_publish", part=key, epoch=epoch)
        failpoint("sink.publish")

    def __enter__(self):
        self._sp.__enter__()
        return self._sp

    def __exit__(self, *exc):
        return self._sp.__exit__(*exc)


def part_slug(key: str) -> str:
    """Wire-safe stable identity for a part key (a ClickHouse partition
    id), the same for every epoch of the part."""
    return re.sub(r"[^A-Za-z0-9._-]", "_", key)


# -- wire-target staging conventions -----------------------------------------
#
# `__trtpu_` prefixes every object the staged commit creates in a target
# (staging tables, the fence table, the hidden part column);
# `__trtpu_commits` holds one row per publish with its epoch, the
# persisted twin of EpochFence; `__trtpu_part` is the hidden part column
# a REPLACE/DROP PARTITION addresses.

META_PREFIX = "__trtpu"
META_COLUMN = "__trtpu_part"
COMMITS_TABLE = "__trtpu_commits"


def is_meta_name(name: str) -> bool:
    """True for identifiers owned by the staging plane."""
    return name.startswith(META_PREFIX)


def stage_ident_prefix(key: str, prefix: str = "__trtpu_stg_") -> str:
    """Identifier prefix shared by every epoch's staging table of one
    part key: `begin_part` sweeps the tables under it."""
    h = hashlib.sha1(key.encode()).hexdigest()[:12]
    return f"{prefix}{h}_e"


def stage_ident(key: str, epoch: int, prefix: str = "__trtpu_stg_") -> str:
    """Short, identifier-safe staging-table name for (part key, epoch):
    a zombie and the owner that stole its part stage side by side."""
    return f"{stage_ident_prefix(key, prefix)}{epoch}"


class WireStage:
    """One part's staging state inside a wire sink: the (key, epoch)
    identity, its slug and staging-table name, the dedup-window
    PartStage (not holding), and the first staged batch's table and
    schema (a wire sink learns the shape from the data)."""

    def __init__(self, key: str, epoch: int, device: DeviceLike = None):
        self.key = key
        self.epoch = epoch
        self.slug = part_slug(key)
        self.table = stage_ident(key, epoch)
        self.state = PartStage(key, epoch, hold=False, device=device)
        self.tid = None
        self.schema = None


class DirectoryPartStage:
    """File-backed staging for directory sinks (`fs`).

    An inner sink instance writes the part's batches into
    `<root>/.staging/<slug>.e<epoch>/` (a dot directory: invisible to the
    storage readers' globs); `publish` renames the staged files into
    `<root>` under part-keyed names (`<staged name>.part-<slug>.<ext>`),
    replacing the files an earlier publish of the same part landed,
    behind a marker-file epoch fence
    (`<root>/.staging/.published.<slug>.json`).  The dedup window keys
    each push on `device` (K10 on a card)."""

    def __init__(self, root: str, key: str, epoch: int, make_inner,
                 dedup_rows: int = DEDUP_WINDOW_ROWS,
                 device: DeviceLike = None):
        self.root = root
        self.key = key
        self.epoch = epoch
        self.slug = part_slug(key)
        # the directory carries the epoch: a zombie and the survivor that
        # reclaimed its part stage side by side, and only the fenced
        # publish decides whose files land
        self.dir = os.path.join(root, ".staging", f"{self.slug}.e{epoch}")
        # begin replaces, for every epoch of this key: a crashed earlier
        # owner's directory would otherwise stay forever.  The epoch
        # suffix matches exactly, so a dotted sibling slug is never swept
        staging_root = os.path.join(root, ".staging")
        pat = re.compile(rf"^{re.escape(self.slug)}\.e\d+$")
        try:
            leftovers = os.listdir(staging_root)
        except OSError:
            leftovers = []
        for name in leftovers:
            if pat.match(name):
                shutil.rmtree(os.path.join(staging_root, name),
                              ignore_errors=True)
        os.makedirs(self.dir, exist_ok=True)
        self.inner = make_inner(self.dir)
        self.state = PartStage(key, epoch, hold=False,
                               dedup_rows=dedup_rows, device=device)
        self._closed = False

    def push(self, batch: Batch) -> None:
        staged = self.state.stage(batch)
        try:
            self.inner.push(staged)
        except BaseException:
            # the staging write died after the dedup window recorded this
            # batch: the staged files hold an unknown prefix, so only a
            # full part restage (begin replaces) is safe
            self.state.mark_failed()
            raise

    def note_push_retry(self) -> None:
        self.state.note_push_retry()

    def _marker(self) -> str:
        return os.path.join(self.root, ".staging",
                            f".published.{self.slug}.json")

    def publish(self) -> int:
        with publish_guard(self.key, self.epoch):
            if not self._closed:
                self.inner.close()
                self._closed = True
            # the sink-side epoch fence, persisted beside the staging area
            marker = self._marker()
            try:
                with open(marker) as fh:
                    prev = int(json.load(fh).get("epoch", -1))
            except (FileNotFoundError, ValueError, OSError):
                prev = None
            if prev is not None and self.epoch < prev:
                raise StaleEpochPublishError(self.key, self.epoch, prev)
            # replace: drop what an older publish of this part landed
            infix = f".part-{self.slug}."
            for fname in os.listdir(self.root):
                if infix in fname:
                    os.remove(os.path.join(self.root, fname))
            # then move the staged files in (same-filesystem renames; a
            # crash mid-loop is recovered by the retried part's
            # republish, which replaces everything again)
            for fname in sorted(os.listdir(self.dir)):
                stem, dot, ext = fname.rpartition(".")
                out = f"{stem}{infix}{ext}" if dot else \
                    f"{fname}{infix}dat"
                os.replace(os.path.join(self.dir, fname),
                           os.path.join(self.root, out))
            tmp = f"{marker}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump({"epoch": self.epoch, "key": self.key}, fh)
            os.replace(tmp, marker)
            os.rmdir(self.dir)
            return self.state.rows

    def abort(self) -> None:
        if not self._closed:
            try:
                self.inner.close()
            except Exception:  # trtpu: ignore[EXC001] — best-effort abort
                pass
            self._closed = True
        shutil.rmtree(self.dir, ignore_errors=True)


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
