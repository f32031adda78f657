"""Device row predicate: eligibility, lowering, kernel K-C and its plain twin.

The host twin is predicate/compile.py (numpy, authoritative semantics —
SQL Kleene three-valued logic, NULL comparisons never match).  This
module lowers a predicate AST to the flat postfix program that kernel
K-C (csrc/pred3vl_mask.cu) evaluates per row, and keeps `eval3_torch`,
the plain PyTorch version that follows transferia_tpu/predicate/device.py
`_eval3_jnp` (line 131) node for node.

Device eligibility (`device_compatible`, `_literal_device_safe`) is
copied from the reference so the same predicates fuse in both packages:
only fixed-width columns whose dtype compares bit-exactly in 32 bits
(bool, int8/16/32, uint8/16, float32, date32), with literals that fit.

Comparisons follow the promotion the reference's jnp trace applied: an
integer column against an integer (or bool) literal compares in
integer; a float32 column, or any float literal, compares in float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from transferia_tpu_torch.abstract.schema import CanonicalType, TableSchema
from transferia_tpu_torch.ops import _build
from transferia_tpu_torch.predicate.ast import (
    And, Between, Cmp, InList, IsNull, Node, Not, Or, TrueNode,
)

# dtypes that compare bit-exactly in the 32-bit device program
_DEVICE_SAFE = {
    CanonicalType.BOOLEAN,
    CanonicalType.INT8,
    CanonicalType.INT16,
    CanonicalType.INT32,
    CanonicalType.UINT8,
    CanonicalType.UINT16,
    CanonicalType.FLOAT,   # float32
    CanonicalType.DATE,    # int32 days
}


def device_compatible(node: Node, schema: TableSchema) -> bool:
    """True when every referenced column evaluates bit-exactly on device."""
    ok, _ = _walk(node, schema)
    return ok


def _walk(node: Node, schema: TableSchema) -> tuple[bool, bool]:
    if isinstance(node, TrueNode):
        return True, False
    if isinstance(node, (And, Or)):
        return all(_walk(p, schema)[0] for p in node.parts), False
    if isinstance(node, Not):
        return _walk(node.inner, schema)
    if isinstance(node, (IsNull, Between, InList, Cmp)):
        cs = schema.find(node.column)
        if cs is None or cs.data_type not in _DEVICE_SAFE:
            return False, False
        if isinstance(node, IsNull):
            return True, False
        values = (node.values if isinstance(node, InList)
                  else [node.low, node.high] if isinstance(node, Between)
                  else [node.value])
        if isinstance(node, Cmp) and node.op == "~":
            return False, False
        return all(v is None or _literal_device_safe(v, cs.data_type)
                   for v in values), False
    return False, False


def _literal_device_safe(v, ctype: CanonicalType) -> bool:
    """True when comparing `v` against a ctype column on device gives the
    same answer as the host path (numpy, which promotes to int64/float64).

    The device evaluates in 32 bits, so a literal that doesn't fit the
    column's dtype bit-exactly can silently change comparisons
    (e.g. float32(16777217) == 16777216.0) — such predicates must stay on
    the host path.
    """
    if isinstance(v, bool):
        return ctype == CanonicalType.BOOLEAN
    if ctype == CanonicalType.BOOLEAN:
        return False
    if isinstance(v, int):
        if ctype == CanonicalType.FLOAT:
            # int literal vs float32 column: exact iff it fits 2^24
            return abs(v) <= 2**24
        # integer columns: the literal must fit the column dtype
        info = np.iinfo(ctype.np_dtype)
        return info.min <= v <= info.max
    if isinstance(v, float):
        if ctype == CanonicalType.FLOAT:
            # must survive the float64 -> float32 round-trip bit-exactly
            return float(np.float32(v)) == v or np.isnan(v)
        # float literal vs integer column: the device comparison happens
        # in float32, so EVERY possible column value must be f32-exact —
        # true only for the sub-24-bit integer dtypes.  int32/date columns
        # hold values like 2^24+1 that collapse onto the literal in f32
        # (host float64 keeps them distinct), so those stay on the host.
        if ctype in (CanonicalType.INT32, CanonicalType.DATE):
            return False
        return float(np.float32(v)) == v
    return False


# -- lowering to the kernel's postfix program ---------------------------------

# limits of the kernel's by-value parameter block (csrc/pred3vl_mask.cu)
MAX_INSTR = 128
MAX_LITS = 64
MAX_COLS = 16
MAX_DEPTH = 64

OP_TRUE, OP_CMP, OP_CMP_NULL, OP_ISNULL, OP_IN, OP_AND, OP_OR, OP_NOT = \
    range(8)
_CMP_CODES = {"=": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
IN_NEGATE, IN_HAS_NULL = 1, 2

# column dtype codes of the kernel
_DTYPE_CODES = {
    torch.bool: 0, torch.int8: 1, torch.uint8: 2, torch.int16: 3,
    torch.uint16: 4, torch.int32: 5, torch.float32: 6,
}


class PredProgram:
    """A predicate lowered for K-C: postfix instructions {op, slot, a, b}
    over column slots (`columns`, sorted names) and a literal table."""

    def __init__(self, node: Node):
        self.node = node
        self.columns: tuple[str, ...] = tuple(sorted(node.columns()))
        self._slot = {c: i for i, c in enumerate(self.columns)}
        self._instrs: list[tuple[int, int, int, int]] = []
        self._ilits: list[int] = []
        self._flits: list[float] = []
        self._lit_is_float: list[int] = []
        self._depth = 0
        self.max_depth = 0
        self._emit(node)
        if (len(self._instrs) > MAX_INSTR or len(self._ilits) > MAX_LITS
                or len(self.columns) > MAX_COLS
                or self.max_depth > MAX_DEPTH):
            raise ValueError(
                f"predicate too large for the device kernel "
                f"({len(self._instrs)} instructions > {MAX_INSTR}, "
                f"{len(self._ilits)} literals > {MAX_LITS}, "
                f"{len(self.columns)} columns > {MAX_COLS} or depth "
                f"{self.max_depth} > {MAX_DEPTH}): {node!r}")
        self.instrs = np.array(self._instrs, dtype=np.int32).reshape(-1, 4)
        self.ilits = np.array(self._ilits, dtype=np.int64)
        self.flits = np.array(self._flits, dtype=np.float32)
        self.lit_is_float = np.array(self._lit_is_float, dtype=np.int32)

    def _push(self, op: int, slot: int = 0, a: int = 0, b: int = 0,
              pops: int = 0) -> None:
        self._instrs.append((op, slot, a, b))
        self._depth += 1 - pops
        self.max_depth = max(self.max_depth, self._depth)

    def _literal(self, v) -> int:
        is_float = isinstance(v, float)
        self._ilits.append(0 if is_float else int(v))
        self._flits.append(float(np.float32(v)))
        self._lit_is_float.append(int(is_float))
        return len(self._ilits) - 1

    def _emit(self, node: Node) -> None:
        if isinstance(node, TrueNode):
            self._push(OP_TRUE)
        elif isinstance(node, (And, Or)):
            op = OP_AND if isinstance(node, And) else OP_OR
            self._emit(node.parts[0])
            for p in node.parts[1:]:
                # Kleene AND/OR are associative: fold pairwise
                self._emit(p)
                self._push(op, pops=2)
        elif isinstance(node, Not):
            self._emit(node.inner)
            self._push(OP_NOT, pops=1)
        elif isinstance(node, IsNull):
            self._push(OP_ISNULL, self._slot[node.column], int(node.negate))
        elif isinstance(node, Between):
            self._emit(And((Cmp(node.column, ">=", node.low),
                            Cmp(node.column, "<=", node.high))))
        elif isinstance(node, InList):
            lits = [v for v in node.values if v is not None]
            first = len(self._ilits)
            for v in lits:
                self._literal(v)
            flags = ((IN_NEGATE if node.negate else 0)
                     | (IN_HAS_NULL if len(lits) < len(node.values) else 0))
            self._push(OP_IN, self._slot[node.column], first,
                       len(lits) | flags << 16)
        elif isinstance(node, Cmp):
            if node.value is None:
                # col <op> NULL is always UNKNOWN
                self._push(OP_CMP_NULL, self._slot[node.column])
            elif node.op not in _CMP_CODES:
                raise ValueError(f"unsupported device op {node.op!r}")
            else:
                self._push(OP_CMP, self._slot[node.column],
                           _CMP_CODES[node.op], self._literal(node.value))
        else:
            raise TypeError(f"unknown predicate node {node!r}")


def compile_mask_program(node: Node) -> PredProgram:
    """Lower a device-compatible predicate to K-C's program."""
    return PredProgram(node)


# -- kernel K-C and its plain version -----------------------------------------

DeviceCol = tuple[torch.Tensor, Optional[torch.Tensor]]


def pred3vl_mask(program: PredProgram, cols: list[DeviceCol], n: int,
                 pack_keep: bool,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """The TRUE mask of `program` over n rows.

    cols: (data, validity or None = all valid) per program column slot.
    Returns (n,) bool, or with pack_keep n/32 packed words as int32
    (bit j of word k = row 32k+j; n must be a multiple of 32).  CUDA
    tensors run kernel K-C; CPU tensors run `eval3_torch`.  `device`
    places a program that reads no column (TRUE), and must agree with
    the columns' device otherwise."""
    from transferia_tpu_torch.ops.decode import pack_mask_words

    _build.require(len(cols) == len(program.columns),
                   f"expected {len(program.columns)} columns, got "
                   f"{len(cols)}")
    _build.require(n > 0 and (not pack_keep or n % 32 == 0),
                   f"bad row count {n} (pack needs a multiple of 32)")
    devices = {t.device for data, valid in cols for t in (data, valid)
               if t is not None}
    if device is not None:
        devices.add(torch.device(device))
    _build.require(len(devices) == 1,
                   "columns on several devices, or no column and no device")
    for data, valid in cols:
        _build.require(data.dtype in _DTYPE_CODES and data.dim() == 1
                       and data.shape[0] >= n and data.is_contiguous(),
                       f"column data must be a contiguous 1-D tensor of "
                       f"{sorted(map(str, _DTYPE_CODES))} with >= n rows")
        _build.require(valid is None or (
            valid.dtype == torch.bool and valid.dim() == 1
            and valid.shape[0] >= n and valid.is_contiguous()),
            "validity must be None or a contiguous 1-D bool with >= n rows")
    dev = devices.pop()
    if dev.type == "cpu":
        keep = eval3_torch(program.node,
                           dict(zip(program.columns, cols)), n, dev)
        return pack_mask_words(keep, n) if pack_keep else keep
    _build.require(dev.type == "cuda", f"unsupported device {dev}")
    out = (torch.empty(n // 32, dtype=torch.int32, device=dev) if pack_keep
           else torch.empty(n, dtype=torch.bool, device=dev))
    n_cols = len(cols)
    data_ptrs = np.array([d.data_ptr() for d, _ in cols] or [0],
                         dtype=np.uint64)
    valid_ptrs = np.array([0 if v is None else v.data_ptr()
                           for _, v in cols] or [0], dtype=np.uint64)
    dtypes = np.array([_DTYPE_CODES[d.dtype] for d, _ in cols] or [0],
                      dtype=np.int32)
    lib = _build.library("pred3vl_mask")
    rc = lib.trt_pred3vl_mask(
        program.instrs.ctypes.data, len(program.instrs),
        program.ilits.ctypes.data, program.flits.ctypes.data,
        program.lit_is_float.ctypes.data, len(program.ilits),
        data_ptrs.ctypes.data, valid_ptrs.ctypes.data,
        dtypes.ctypes.data, n_cols, n, int(pack_keep), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "pred3vl_mask")
    _build.count_launch("pred3vl_mask")
    return out


def eval3_torch(node: Node, cols: dict[str, DeviceCol], n: int,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """Plain PyTorch version of K-C: the (n,) TRUE mask, UNKNOWN rows do
    not match.  cols maps name -> (data, validity or None)."""
    if device is None:
        device = next((d.device for d, _ in cols.values()),
                      torch.device("cpu"))
    t, _u = _eval3(node, cols, n, device)
    return t


def _column(cols: dict[str, DeviceCol], name: str, n: int, device
            ) -> tuple[torch.Tensor, torch.Tensor]:
    data, valid = cols[name]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=device)
    return data[:n], valid[:n]


def _eval3(node: Node, cols: dict[str, DeviceCol], n: int, device):
    if isinstance(node, TrueNode):
        ones = torch.ones(n, dtype=torch.bool, device=device)
        return ones, torch.zeros_like(ones)
    if isinstance(node, And):
        t, u = _eval3(node.parts[0], cols, n, device)
        f = ~t & ~u
        for p in node.parts[1:]:
            t2, u2 = _eval3(p, cols, n, device)
            f = f | (~t2 & ~u2)
            t = t & t2
        return t, ~t & ~f
    if isinstance(node, Or):
        t, u = _eval3(node.parts[0], cols, n, device)
        f = ~t & ~u
        for p in node.parts[1:]:
            t2, u2 = _eval3(p, cols, n, device)
            f = f & (~t2 & ~u2)
            t = t | t2
        return t, ~t & ~f
    if isinstance(node, Not):
        t, u = _eval3(node.inner, cols, n, device)
        return ~t & ~u, u
    if isinstance(node, IsNull):
        _, valid = _column(cols, node.column, n, device)
        null = ~valid
        return (~null if node.negate else null), torch.zeros_like(null)
    if isinstance(node, Between):
        return _eval3(And((
            Cmp(node.column, ">=", node.low),
            Cmp(node.column, "<=", node.high),
        )), cols, n, device)
    if isinstance(node, InList):
        data, valid = _column(cols, node.column, n, device)
        mask = torch.zeros(n, dtype=torch.bool, device=device)
        has_null_literal = any(v is None for v in node.values)
        for v in node.values:
            if v is not None:
                mask = mask | _cmp_torch(data, "=", v)
        t = mask & valid
        f = ~mask & valid
        if has_null_literal:
            f = torch.zeros_like(f)
        if node.negate:
            t, f = f, t
        return t, ~t & ~f
    if isinstance(node, Cmp):
        data, valid = _column(cols, node.column, n, device)
        if node.value is None:
            # col <op> NULL is always UNKNOWN
            return (torch.zeros(n, dtype=torch.bool, device=device),
                    torch.ones(n, dtype=torch.bool, device=device))
        t = _cmp_torch(data, node.op, node.value) & valid
        return t, ~valid
    raise TypeError(f"unknown predicate node {node!r}")


def _cmp_torch(data: torch.Tensor, op: str, value) -> torch.Tensor:
    """Compare as the reference's jnp trace did: float32 when the column
    or the literal is float, integer otherwise."""
    if data.dtype == torch.float32 or isinstance(value, float):
        x = data.to(torch.float32)
        y = torch.tensor(float(np.float32(value)), dtype=torch.float32,
                         device=data.device)
    else:
        x = data.to(torch.int64)
        y = int(value)
    if op == "=":
        return x == y
    if op == "!=":
        return x != y
    if op == "<":
        return x < y
    if op == "<=":
        return x <= y
    if op == ">":
        return x > y
    if op == ">=":
        return x >= y
    raise ValueError(f"unsupported device op {op!r}")
