"""Transformation chain with per-table plan cache.

Reference parity: pkg/transformer/transformation.go:22-70 — the chain plans
which transformers are Suitable per (TableID, schema hash), caches the plan,
and re-plans when the schema fingerprint changes.  The port's chain takes
columnar batches only (ChangeItem rows are not ported yet), plans its
fused steps onto the chain's device and hands that device to every
planned step (`Transformer.bind_device`; the lambda transformer's device
strategy runs there).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Sequence

from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.runtime.device import DeviceLike
from transferia_tpu_torch.transform.base import Transformer
from transferia_tpu_torch.transform.registry import parse_transformers_config

logger = logging.getLogger(__name__)

_ERROR_BEHAVIORS = ("emit", "drop", "fail")


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
    """Applies a transformer chain to columnar batches with plan caching.

    device: where fused steps run (None = CUDA, which must be present;
    "cpu" runs the kernels' plain PyTorch versions).  error_behavior is
    accepted for config compatibility; no ported transformer emits
    per-row errors.
    """

    def __init__(self, transformers: Sequence[Transformer],
                 error_behavior: str = "emit", device: DeviceLike = None):
        if error_behavior not in _ERROR_BEHAVIORS:
            raise ValueError(f"error_behavior must be one of "
                             f"{_ERROR_BEHAVIORS}, got {error_behavior!r}")
        self.transformers = list(transformers)
        self.error_behavior = error_behavior
        self.device = device
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

    def apply(self, batch: ColumnBatch) -> ColumnBatch:
        """Transform one columnar batch through the planned steps."""
        plan = self.plan_for(batch.table_id, batch.schema)
        current = batch
        for step in plan.steps:
            if current.n_rows == 0:
                break
            current = step.apply(current).transformed
        return current


def build_chain(config: Optional[dict],
                device: DeviceLike = None) -> Optional[Transformation]:
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
    )
