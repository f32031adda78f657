"""Transformer contract (pkg/abstract/transformer.go:32-38)."""

from __future__ import annotations

import abc
from dataclasses import dataclass

from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.runtime.device import DeviceLike


@dataclass
class TransformResult:
    """Output of one transformer application: the transformed block
    (possibly empty).  The per-row error blocks of the reference are not
    ported: no ported transformer emits them."""

    transformed: ColumnBatch


class Transformer(abc.ABC):
    """One transformation step.

    suitable()/result_schema() are called at plan time (cached per schema
    fingerprint); apply() runs per batch on the hot path.
    """

    TYPE = ""  # registry key, e.g. "mask_field"

    @abc.abstractmethod
    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        ...

    def result_schema(self, schema: TableSchema) -> TableSchema:
        """Output schema for an input schema (identity by default)."""
        return schema

    def result_table(self, table: TableID) -> TableID:
        """Output table id (identity by default; rename overrides)."""
        return table

    def bind_device(self, device: DeviceLike) -> None:
        """Called at plan time with the chain's device (nothing by
        default; a step that places work on the device keeps it)."""

    @abc.abstractmethod
    def apply(self, batch: ColumnBatch) -> TransformResult:
        ...

    def describe(self) -> str:
        return self.TYPE
