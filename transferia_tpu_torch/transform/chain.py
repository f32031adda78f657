"""Transformation chain with per-table plan cache.

Reference parity: pkg/transformer/transformation.go:22-70 — the chain plans
which transformers are Suitable per (TableID, schema hash), caches the plan,
and re-plans when the schema fingerprint changes.  The port's chain takes
columnar blocks and `ChangeItem` row batches (pivoted per homogeneous
run), emits, drops or fails on transformer error blocks, counts
`TransformStats`, plans its fused steps onto the chain's device and hands
that device to every planned step (`Transformer.bind_device`; the lambda
transformer's device strategy runs there).  A step that fans one block
out into several (`MultiBatch`, batch_splitter's) has each part run
through the steps after it.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional, Sequence

from transferia_tpu_torch.abstract.change_item import ChangeItem
from transferia_tpu_torch.abstract.interfaces import Batch, is_columnar
from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.runtime.device import DeviceLike
from transferia_tpu_torch.stats.registry import TransformStats
from transferia_tpu_torch.transform.base import Transformer
from transferia_tpu_torch.transform.registry import parse_transformers_config

logger = logging.getLogger(__name__)

_ERROR_BEHAVIORS = ("emit", "drop", "fail")


class MultiBatch:
    """Marker wrapper: a transformer produced several batches.  The
    chain unwraps it; sinks never see this type."""

    def __init__(self, parts: list[ColumnBatch]):
        self.parts = parts
        self.n_rows = sum(p.n_rows for p in parts)


class _Plan:
    __slots__ = ("steps", "out_schema", "out_table")

    def __init__(self, steps: list[Transformer], in_table: TableID,
                 in_schema: TableSchema, device: DeviceLike):
        from transferia_tpu_torch.transform.fused import maybe_fuse_steps

        self.steps = maybe_fuse_steps(steps, in_table, in_schema, device)
        table, schema = in_table, in_schema
        for t in self.steps:
            t.bind_device(device)
            table = t.result_table(table)
            schema = t.result_schema(schema)
        self.out_schema = schema
        self.out_table = table


class Transformation:
    """Applies a transformer chain to batches with plan caching.

    device: where fused steps run (None = CUDA, which must be present;
    "cpu" runs the kernels' plain PyTorch versions).
    error_behavior:
      emit  — failed rows are pushed with the __transform_error column
      drop  — failed rows are discarded (counted in stats)
      fail  — the first failed row raises
    """

    def __init__(self, transformers: Sequence[Transformer],
                 error_behavior: str = "emit", device: DeviceLike = None,
                 stats: Optional[TransformStats] = None):
        if error_behavior not in _ERROR_BEHAVIORS:
            raise ValueError(f"error_behavior must be one of "
                             f"{_ERROR_BEHAVIORS}, got {error_behavior!r}")
        self.transformers = list(transformers)
        self.error_behavior = error_behavior
        self.device = device
        self.stats = stats or TransformStats()
        self._plans: dict[tuple[TableID, str], _Plan] = {}
        self._lock = threading.Lock()

    def plan_for(self, table: TableID, schema: TableSchema) -> _Plan:
        key = (table, schema.fingerprint())
        plan = self._plans.get(key)
        if plan is None:
            with self._lock:
                plan = self._plans.get(key)
                if plan is None:
                    steps = [
                        t for t in self.transformers
                        if t.suitable(table, schema)
                    ]
                    plan = _Plan(steps, table, schema, self.device)
                    self._plans[key] = plan
                    self.stats.compiles.inc()
                    logger.info(
                        "transform plan for %s/%s: %s",
                        table, schema.fingerprint(),
                        [t.describe() for t in plan.steps]
                        or "(passthrough)",
                    )
        return plan

    def output_schema(self, table: TableID,
                      schema: TableSchema) -> tuple[TableID, TableSchema]:
        """The (table, schema) the plan for an input table emits."""
        plan = self.plan_for(table, schema)
        return plan.out_table, plan.out_schema

    def pushable_predicate(self, table: TableID, schema: TableSchema):
        """The first row-filter predicate that may legally run inside the
        source scan (ScanPredicateStorage), or None.

        Legal when every step before the filter only alters known
        columns (mask_field) and the predicate reads none of them; a
        fused mask+filter run qualifies by construction (its predicate
        evaluates on the run's input).  Any other step stops the walk.
        The chain re-applies the predicate regardless, so pushdown only
        saves work.
        """
        from transferia_tpu_torch.transform.fused import DeviceFusedStep
        from transferia_tpu_torch.transform.plugins.filter import FilterRows
        from transferia_tpu_torch.transform.plugins.mask import MaskField

        plan = self.plan_for(table, schema)
        modified: set[str] = set()
        for step in plan.steps:
            if isinstance(step, DeviceFusedStep):
                if step.pred_node is not None:
                    if step.pred_node.columns() & modified:
                        return None
                    return step.pred_node
                modified.update(n for n, _ in step.mask_entries)
                continue
            if isinstance(step, FilterRows):
                if step.node.columns() & modified:
                    return None
                return step.node
            if isinstance(step, MaskField):
                modified.update(step.columns)
                continue
            return None
        return None

    def apply(self, batch: Batch) -> Batch:
        """Transform a batch; row-item batches are pivoted to columnar
        first (batches holding control or system items pass through
        untouched).  Mixed-table or mixed-schema row batches are split
        into homogeneous runs before the pivot."""
        if not self.transformers:
            return batch
        if is_columnar(batch):
            return self._apply_columnar(batch)
        items = list(batch)
        if not items or any(not it.is_row_event() for it in items):
            return batch
        groups = self._split_homogeneous(items)
        if len(groups) == 1:
            return self._apply_columnar(ColumnBatch.from_rows(items))
        out_items: list[ChangeItem] = []
        for run in groups:
            res = self._apply_columnar(ColumnBatch.from_rows(run))
            if is_columnar(res):
                out_items.extend(res.to_rows())
            else:
                out_items.extend(res)
        return out_items

    @staticmethod
    def _split_homogeneous(items: list[ChangeItem]
                           ) -> list[list[ChangeItem]]:
        """Split into consecutive runs sharing (table_id, schema)."""
        groups: list[list[ChangeItem]] = []
        cur_key = None
        for it in items:
            key = (it.table_id, id(it.table_schema)
                   if it.table_schema is not None else None)
            if not groups or key != cur_key:
                # id() over-splits: equal schemas of different identity
                # still pivot fine run by run
                groups.append([])
                cur_key = key
            groups[-1].append(it)
        return groups

    def _run_steps(self, batch: ColumnBatch, steps: Sequence[Transformer],
                   outputs: list[ColumnBatch]) -> Optional[ColumnBatch]:
        """Apply steps in turn; error blocks and a fan-out's parts are
        appended to outputs; returns the surviving block."""
        current: Optional[ColumnBatch] = batch
        for i, step in enumerate(steps):
            if current is None or current.n_rows == 0:
                break
            res = step.apply(current)
            if res.errors is not None and res.errors.n_rows:
                n_err = res.errors.n_rows
                self.stats.errors.inc(n_err)
                if self.error_behavior == "fail":
                    raise ValueError(
                        f"transformer {step.describe()} failed {n_err} rows "
                        f"in {current.table_id}"
                    )
                if self.error_behavior == "emit":
                    outputs.append(res.errors)
            if isinstance(res.transformed, MultiBatch):
                rest = steps[i + 1:]
                for part in res.transformed.parts:
                    done = self._run_steps(part, rest, outputs)
                    if done is not None and done.n_rows:
                        outputs.append(done)
                return None
            current = res.transformed
        return current

    def _apply_columnar(self, batch: ColumnBatch) -> Batch:
        plan = self.plan_for(batch.table_id, batch.schema)
        if not plan.steps:
            return batch
        self.stats.rows_in.inc(batch.n_rows)
        t0 = time.monotonic()
        outputs: list[ColumnBatch] = []
        current = self._run_steps(batch, plan.steps, outputs)
        self.stats.time.observe(time.monotonic() - t0)
        result: list[ColumnBatch] = []
        if current is not None and current.n_rows:
            self.stats.rows_out.inc(current.n_rows)
            result.append(current)
        result.extend(outputs)
        if not result:
            # fully filtered: an empty block of the plan's output shape,
            # so sinks still see the schema
            return current if current is not None else batch.slice(0, 0)
        if len(result) == 1:
            return result[0]
        # transformed block + error blocks: one ordered push unit of row
        # items across the two schemas
        out_items: list[ChangeItem] = []
        for b in result:
            out_items.extend(b.to_rows())
        return out_items


def build_chain(config: Optional[dict], device: DeviceLike = None,
                stats: Optional[TransformStats] = None
                ) -> Optional[Transformation]:
    """Build a Transformation from a transfer.transformation config dict."""
    if not config:
        return None
    transformers = parse_transformers_config(config.get("transformers"))
    if not transformers:
        return None
    return Transformation(
        transformers,
        error_behavior=config.get("error_behavior", "emit"),
        device=device,
        stats=stats,
    )
