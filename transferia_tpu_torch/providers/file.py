"""Local-filesystem object provider: Parquet files as a table (the port's
copy of the Parquet route of ``transferia_tpu/providers/file.py``).

Parquet is the columnar fast path: row groups decode straight to
ColumnBatch in the host library (providers/parquet_native.py), runs of
row groups are shardable parts, zone maps prune whole groups before
decode (predicate/stats.py) and the chain's pushed-down filter drops
rows right after it (`_batch_filter`).

Not ported (they raise NotImplementedError naming ROADMAP.md A10): the
CSV and JSONL formats, the JAX package's arrow routes (its arrow-side
scan filter, the arrow decode of columns outside the native decoder's
envelope, and the `iter_batches` stream of row groups too large to
decode whole) and the `fs` sink, whose Parquet writer is pyarrow's.
"""

from __future__ import annotations

import glob as globmod
import os
import threading
from dataclasses import dataclass
from typing import Optional

from transferia_tpu_torch.abstract.interfaces import (
    Pusher,
    ScanPredicateStorage,
    ShardingStorage,
    Storage,
    TableInfo,
)
from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.models.endpoint import (
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.predicate.compile import compile_mask
from transferia_tpu_torch.predicate.stats import (
    ColumnRange,
    range_disproves,
)
from transferia_tpu_torch.providers.parquet_meta import (
    FileMetaData,
    parquet_metadata,
)
from transferia_tpu_torch.providers.parquet_native import (
    NativeParquetReader,
    slice_columns,
)
from transferia_tpu_torch.providers.readahead import RowGroupReadahead
from transferia_tpu_torch.providers.registry import (
    Provider,
    register_provider,
)
from transferia_tpu_torch.runtime.limits import effective_cpus
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.stats import stagetimer, trace
from transferia_tpu_torch.stats.registry import DeviceStats

NOT_PORTED = "not ported to transferia_tpu_torch yet (ROADMAP.md A10)"


@register_endpoint
@dataclass
class FileSourceParams(EndpointParams):
    PROVIDER = "fs"
    IS_SOURCE = True

    path: str = ""            # file, dir, or glob
    format: str = "parquet"   # parquet (csv | jsonl: not ported)
    table: str = "data"       # logical table name
    namespace: str = "fs"
    batch_rows: int = 65_536
    # decode-pipeline knobs:
    # decode_threads: column-parallel native decode width; 0 = auto
    # (effective CPUs / (2 x upload workers): parts already decode in
    # parallel across workers, so K only widens when cores are spare).
    # readahead_groups: decoded row groups in flight per part (the one
    # the consumer holds + queued + decoding); -1 = auto (2 with >1
    # effective CPU, else 0), 0 = serial decode.  readahead_bytes adds
    # an optional in-flight decoded-payload cap on top (0 = none).
    # rowgroups_per_part: consecutive row groups per shard part; 0 =
    # auto (1 with readahead off, else up to 4, keeping ~4 parts queued
    # per upload worker).  Parts spanning several groups are what give
    # the per-part readahead a g+1 to prefetch.
    decode_threads: int = 0
    readahead_groups: int = -1
    readahead_bytes: int = 0
    rowgroups_per_part: int = 0


@register_endpoint
@dataclass
class FileTargetParams(EndpointParams):
    PROVIDER = "fs"
    IS_TARGET = True

    path: str = ""            # output directory
    format: str = "parquet"   # parquet | jsonl


def _expand(path: str) -> list[str]:
    if os.path.isdir(path):
        return sorted(
            p for p in globmod.glob(os.path.join(path, "**", "*"),
                                    recursive=True)
            if os.path.isfile(p)
        )
    return sorted(globmod.glob(path))


class FileStorage(Storage, ShardingStorage, ScanPredicateStorage):
    def __init__(self, params: FileSourceParams, metrics=None,
                 upload_workers: int = 1):
        if params.format != "parquet":
            raise NotImplementedError(
                f"fs source format {params.format!r}: {NOT_PORTED}")
        self.params = params
        self.table = TableID(params.namespace, params.table)
        self._schema: Optional[TableSchema] = None
        self._scan_predicates: dict[TableID, object] = {}
        self._pred_fns: dict[TableID, object] = {}
        self._pruned_lock = threading.Lock()
        self.scan_rows_pruned = 0
        self._upload_workers = max(1, upload_workers)
        self._readahead_gauges = None
        if metrics is not None:
            ds = DeviceStats(metrics)
            self._readahead_gauges = (ds.readahead_depth,
                                      ds.readahead_bytes)

    # -- decode-pipeline knob resolution ------------------------------------
    def _decode_threads(self) -> int:
        k = self.params.decode_threads
        if k <= 0:
            # auto: each upload worker already runs a consumer thread
            # and a readahead decoder, so claim only half the per-worker
            # core share
            k = int(effective_cpus()) // (2 * self._upload_workers)
        return max(1, min(8, k))

    def _readahead_groups(self) -> int:
        n = self.params.readahead_groups
        if n < 0:  # auto: overlap decode unless there's a single core
            n = 2 if effective_cpus() >= 2 else 0
        return n

    def _count_pruned(self, n: int) -> None:
        # upload workers share this storage across threads
        with self._pruned_lock:
            self.scan_rows_pruned += n

    def _files(self) -> list[str]:
        files = _expand(self.params.path)
        if not files:
            raise FileNotFoundError(
                f"fs source: no files match {self.params.path!r}"
            )
        return files

    # -- schema inference ---------------------------------------------------
    def table_schema(self, table: TableID) -> TableSchema:
        if self._schema is None:
            self._schema = parquet_metadata(self._files()[0]).table_schema()
        return self._schema

    def table_list(self, include=None):
        if include and not any(
                self.table.include_matches(p) for p in include):
            return {}
        eta = sum(parquet_metadata(f).num_rows for f in self._files())
        return {self.table: TableInfo(
            eta_rows=eta, schema=self.table_schema(self.table)
        )}

    def estimate_table_rows_count(self, table: TableID) -> int:
        info = self.table_list().get(self.table)
        return info.eta_rows if info else 0

    # -- sharding: runs of row groups ---------------------------------------
    def _groups_per_part(self, n_groups: int) -> int:
        """Row groups per shard part.  One group per part maximizes
        worker-level parallelism but starves the per-part readahead —
        there is no g+1 inside a single-group part.  Auto keeps ~4 parts
        queued per upload worker and caps the run at 4 groups so one
        straggler part never serializes the tail."""
        p = self.params.rowgroups_per_part
        if p <= 0:
            if self._readahead_groups() <= 0:
                return 1  # serial decode: per-group parts
            p = min(4, max(1, n_groups // (4 * self._upload_workers)))
        return max(1, p)

    def shard_table(self, table: TableDescription) -> list[TableDescription]:
        out = []
        for f in self._files():
            meta = parquet_metadata(f)
            n_groups = meta.num_row_groups
            step = self._groups_per_part(n_groups)
            for lo in range(0, n_groups, step):
                hi = min(lo + step, n_groups)
                out.append(TableDescription(
                    id=table.id, filter=f"rg:{lo}:{hi}:{f}",
                    eta_rows=sum(meta.row_groups[g].num_rows
                                 for g in range(lo, hi)),
                ))
        return out

    # -- load ---------------------------------------------------------------
    def load_table(self, table: TableDescription, pusher: Pusher) -> None:
        schema = self.table_schema(table.id)
        if table.filter.startswith("rg:"):
            _, lo, hi, path = table.filter.split(":", 3)
            self._load_row_groups(path, int(lo), int(hi), table.id, schema,
                                  pusher)
            return
        for f in self._files():
            n_groups = parquet_metadata(f).num_row_groups
            self._load_row_groups(f, 0, n_groups, table.id, schema, pusher)

    def set_scan_predicate(self, table: TableID, node) -> bool:
        """ScanPredicateStorage: zone maps skip whole row groups, and a
        numpy filter drops rows of each decoded batch.  Advisory: the
        chain re-applies the predicate."""
        self._scan_predicates[table] = node
        return True

    def _prune_row_groups(self, meta: FileMetaData, groups: list[int],
                          tid: TableID) -> list[int]:
        """Zone-map pruning: drop whole row groups whose min/max stats
        disprove the scan predicate (predicate/stats.py) — the only form
        of pushdown that skips decode, not just pivot/transform."""
        node = self._scan_predicates.get(tid)
        if node is None:
            return groups
        pred_cols = node.columns()
        kept = []
        for g in groups:
            rg = meta.row_groups[g]
            ranges = {}
            for col in rg.columns:
                if col.path_in_schema not in pred_cols:
                    continue  # wide tables: only the predicate's columns
                st = col.statistics
                if st is None or not st.has_min_max:
                    continue
                ranges[col.path_in_schema] = ColumnRange(
                    min=st.min, max=st.max, null_count=st.null_count)
            try:
                if ranges and range_disproves(node, ranges):
                    self._count_pruned(rg.num_rows)
                    continue
            except (TypeError, ValueError, ArithmeticError):
                pass  # odd stats types: scan the group normally
            kept.append(g)
        return kept

    def _batch_filter(self, tid: TableID, batch: ColumnBatch
                      ) -> ColumnBatch:
        """Scan-predicate filter over a decoded batch — numpy compiler,
        the same 3VL as the chain's filter."""
        node = self._scan_predicates.get(tid)
        if node is None or batch.n_rows == 0:
            return batch
        fn = self._pred_fns.get(tid)
        if fn is None:
            fn = compile_mask(node)
            self._pred_fns[tid] = fn
        keep = fn(batch)
        if keep.all():
            return batch
        out = batch.filter(keep)
        self._count_pruned(batch.n_rows - out.n_rows)
        return out

    def _has_huge_row_groups(self, meta: FileMetaData,
                             groups: list[int]) -> bool:
        """Row groups too large to materialize whole per part thread
        (externally-written files can carry ~1M-row groups)."""
        max_rg_rows = max(meta.row_groups[g].num_rows for g in groups)
        return max_rg_rows > max(8 * self.params.batch_rows, 1 << 20)

    def _load_groups_native(self, meta: FileMetaData, path: str,
                            groups: list[int], tid: TableID,
                            schema: TableSchema, pusher: Pusher) -> None:
        """Decode row groups in the host library, readahead overlapping
        decode with the pushes, and push them batch_rows at a time."""
        reader = NativeParquetReader(path, meta, schema,
                                     decode_threads=self._decode_threads())

        def decode(g):
            # the reference books this decode in the stage timer only;
            # the span names the same stage so a trace shows it too
            with stagetimer.stage("source_decode"), \
                    trace.span("source_decode", group=g):
                return reader.read_row_group(g)

        def cols_nbytes(cols):
            return sum(c.nbytes() for c in cols.values())

        with RowGroupReadahead(
                groups, decode, max_groups=self._readahead_groups(),
                max_bytes=self.params.readahead_bytes or None,
                nbytes=cols_nbytes, gauges=self._readahead_gauges) as ra:
            for g, cols in ra:
                n = meta.row_groups[g].num_rows
                for b_lo in range(0, n, self.params.batch_rows):
                    b_hi = min(b_lo + self.params.batch_rows, n)
                    with stagetimer.stage("pivot"):
                        batch = ColumnBatch(
                            tid, schema, slice_columns(cols, b_lo, b_hi))
                        batch.read_bytes = batch.nbytes()
                    with stagetimer.stage("source_decode"):
                        batch = self._batch_filter(tid, batch)
                    if batch.n_rows:
                        pusher(batch)

    def _load_row_groups(self, path: str, lo: int, hi: int, tid: TableID,
                         schema: TableSchema, pusher: Pusher) -> None:
        failpoint("storage.file.open")
        meta = parquet_metadata(path)
        groups = self._prune_row_groups(meta, list(range(lo, hi)), tid)
        trace.instant("file_part_open", path=path, lo=lo, hi=hi,
                      groups=len(groups))
        if not groups:
            return
        if self._has_huge_row_groups(meta, groups):
            raise NotImplementedError(
                f"fs source: {path} has row groups over "
                f"{max(8 * self.params.batch_rows, 1 << 20)} rows, which "
                f"the JAX package streams through arrow: {NOT_PORTED}")
        self._load_groups_native(meta, path, groups, tid, schema, pusher)


@register_provider
class FileProvider(Provider):
    NAME = "fs"

    def storage(self):
        return FileStorage(
            self.transfer.src, metrics=self.metrics,
            upload_workers=self.transfer.runtime.sharding.process_count)

    def sinker(self):
        raise NotImplementedError(f"fs sink: {NOT_PORTED}")
