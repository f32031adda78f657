"""Transformer framework of the port (reference: pkg/transformer/).

Transformers operate on ColumnBatch blocks.  The chain (`Transformation`)
plans per (table, schema fingerprint) — mirroring the reference's plan
cache (transformation.go:22-70) — and fuses mask_field + filter_rows runs
into one device step (transform/fused.py).
"""

from transferia_tpu_torch.transform.base import TransformResult, Transformer
from transferia_tpu_torch.transform.registry import (
    make_transformer,
    register_transformer,
)
from transferia_tpu_torch.transform.chain import Transformation, build_chain

# Load built-in plugins (self-registering, like the reference's init() blank
# imports in pkg/transformer/registry/).
import transferia_tpu_torch.transform.plugins  # noqa: E402,F401

__all__ = [
    "TransformResult",
    "Transformer",
    "make_transformer",
    "register_transformer",
    "Transformation",
    "build_chain",
]
