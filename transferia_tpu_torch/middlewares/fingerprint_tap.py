"""Inline snapshot validation: fingerprint post-transform batches (the
port's copy of ``transferia_tpu/middlewares/fingerprint_tap.py``).

A pass-through sink middleware that streams every row batch it forwards
through the order-independent table fingerprint (ops/rowhash.py).  The
snapshot loader inserts it after the transformer chain, stamps each
part's digest onto its coordinator part record when the part completes,
and merges the per-part digests into per-table fingerprints at the end.
The port's `TableFingerprinter` runs on the tap's device: with the
default backend on a card that is kernel K10 (and, for dictionary
columns, `trt_var_accumulators` once per pool).
"""

from __future__ import annotations

import threading

from transferia_tpu_torch.abstract.interfaces import Batch, Sinker, is_columnar
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.ops.rowhash import (
    FingerprintAggregate,
    TableFingerprinter,
)
from transferia_tpu_torch.runtime.device import DeviceLike


class FingerprintTap(Sinker):
    def __init__(self, inner: Sinker, backend: str = "auto",
                 device: DeviceLike = None):
        self.inner = inner
        self._backend = backend
        self._device = device
        self._lock = threading.Lock()
        self._tables: dict[TableID, TableFingerprinter] = {}

    def _tap(self, batch: Batch) -> None:
        if is_columnar(batch):
            blocks = [batch]
        else:
            rows = [it for it in batch if it.is_row_event()]
            if not rows:
                return
            blocks = [ColumnBatch.from_rows(run)
                      for run in _homogeneous_runs(rows)]
        for b in blocks:
            if b.n_rows == 0:
                continue
            with self._lock:
                fp = self._tables.get(b.table_id)
                if fp is None:
                    fp = TableFingerprinter(backend=self._backend,
                                            device=self._device)
                    self._tables[b.table_id] = fp
                fp.push(b)

    def push(self, batch: Batch) -> None:
        self._tap(batch)
        self.inner.push(batch)

    def aggregates(self) -> dict[TableID, FingerprintAggregate]:
        with self._lock:
            return {tid: fp.result() for tid, fp in self._tables.items()}

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name):
        # transparent passthrough for optional sink surface
        return getattr(self.inner, name)


def _homogeneous_runs(items):
    runs, key = [], None
    for it in items:
        k = (it.table_id, id(it.table_schema))
        if not runs or k != key:
            runs.append([])
            key = k
        runs[-1].append(it)
    return runs
