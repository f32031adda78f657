"""Predicate engine: WHERE-like filters over columnar batches.

Reference parity: pkg/predicate/ (ast.go, parser.go).  The AST compiles
to a vectorized numpy mask on the host (compile.py) and to a postfix
program for the device kernel (device.py).
"""

from transferia_tpu_torch.predicate.parser import parse, ParseError
from transferia_tpu_torch.predicate.ast import (
    And, Or, Not, Cmp, InList, IsNull, Between, Node,
)
from transferia_tpu_torch.predicate.compile import compile_mask

__all__ = [
    "parse", "ParseError", "compile_mask",
    "And", "Or", "Not", "Cmp", "InList", "IsNull", "Between", "Node",
]
