"""Transformer contract (pkg/abstract/transformer.go:32-38)."""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Optional

import numpy as np

from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import Column, ColumnBatch
from transferia_tpu_torch.runtime.device import DeviceLike

# Error column tagged onto rows that failed a transformer.
TRANSFORM_ERROR_COL = "__transform_error"


@dataclass
class TransformResult:
    """Output of one transformer application.

    transformed: the successfully transformed block (possibly empty).
    errors: rows that failed, in their pre-transform shape with an added
            __transform_error utf8 column (the chain emits, drops or
            fails on them per its error_behavior).
    """

    transformed: Optional[ColumnBatch]
    errors: Optional[ColumnBatch] = None


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


def error_batch(source: ColumnBatch, mask: np.ndarray,
                message: str) -> Optional[ColumnBatch]:
    """Build the __transform_error block for rows selected by mask."""
    if not mask.any():
        return None
    failed = source.filter(mask)
    n = failed.n_rows
    err_col = Column.from_pylist(
        TRANSFORM_ERROR_COL, CanonicalType.UTF8, [message] * n
    )
    cols = dict(failed.columns)
    cols[TRANSFORM_ERROR_COL] = err_col
    schema = failed.schema.append(
        ColSchema(TRANSFORM_ERROR_COL, CanonicalType.UTF8)
    )
    return failed.with_columns(cols, schema)
