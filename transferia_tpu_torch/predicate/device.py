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

import ctypes
import threading
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

OP_TRUE, OP_CMP, OP_CMP_NULL, OP_ISNULL, OP_IN, OP_AND, OP_OR, OP_NOT = \
    range(8)
# a leaf's fold: push its pair, or combine it into the top entry
PUSH, FOLD_AND, FOLD_OR = range(3)
NEGATE, HAS_NULL, LIT_FLOAT = 1 << 5, 1 << 6, 1 << 7
# a comparison's outcome mask: bit 0 x < y, bit 1 x == y, bit 2 x > y,
# bit 3 unordered (a NaN, where only != holds)
CMP_MASKS = {"=": 0b0010, "!=": 0b1101, "<": 0b0001, "<=": 0b0011,
             ">": 0b0100, ">=": 0b0110}
MAX_SLOTS = 1 << 20   # the slot's 20 bits of an instruction word
M32 = 0xFFFFFFFF

# column dtype codes of the kernel
_DTYPE_CODES = {
    torch.bool: 0, torch.int8: 1, torch.uint8: 2, torch.int16: 3,
    torch.uint16: 4, torch.int32: 5, torch.float32: 6,
}

# K-C's launch arguments (csrc/pred3vl_mask.cu ColDesc, PredArgs; the
# source static_asserts the same sizes and offsets)
BY_VALUE_COLS = 16  # kByValueCols; more columns' descriptors go to the card


class ColDesc(ctypes.Structure):
    """One column of a K-C launch: data, validity (0: all valid), dtype."""

    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("dtype", ctypes.c_int32), ("pad", ctypes.c_int32)]


class PredArgs(ctypes.Structure):
    """K-C's `__grid_constant__` argument: up to BY_VALUE_COLS
    descriptors by value, or `dev_cols` pointing at them on the card."""

    _fields_ = [("cols", ColDesc * BY_VALUE_COLS),
                ("dev_cols", ctypes.c_void_p), ("prog", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("n_instr", ctypes.c_int32), ("n_lits", ctypes.c_int32),
                ("n_cols", ctypes.c_int32), ("pack", ctypes.c_int32),
                ("depth", ctypes.c_int32), ("pad", ctypes.c_int32)]


def _is_leaf(node: Node) -> bool:
    return isinstance(node, (TrueNode, IsNull, InList, Cmp))


def _list_values(node: Node, negate: bool) -> Optional[tuple]:
    """The literals of `node` as an IN list (NOT IN when `negate`), or
    None: `col = v` is `col IN (v)`, `col != v` is `col NOT IN (v)`."""
    if isinstance(node, InList) and node.negate == negate:
        return node.values
    if (isinstance(node, Cmp) and node.value is not None
            and node.op == ("!=" if negate else "=")):
        return (node.value,)
    return None


def _merge_lists(parts, is_and: bool) -> list[Node]:
    """The parts of an OR with every column's equalities and IN lists
    merged into one IN list, or of an AND with its inequalities and NOT
    IN lists merged into one NOT IN: the same Kleene value (a NULL
    literal in any of them keeps the list from being FALSE), one
    instruction and one pass over the literals."""
    lists: dict[str, list] = {}
    out: list[Node] = []
    for p in parts:
        values = _list_values(p, is_and)
        if values is None:
            out.append(p)
        else:
            lists.setdefault(p.column, []).append((p, values))
    for column, members in lists.items():
        out.append(members[0][0] if len(members) == 1 else InList(
            column, tuple(v for _, vs in members for v in vs), is_and))
    return out


def _need(node: Node) -> int:
    """Stack entries that evaluating `node` takes at most, children
    emitted in Sethi-Ullman order (PredProgram._emit)."""
    if isinstance(node, (And, Or)):
        needs = sorted((_need(p) for p in node.parts), reverse=True)
        return max(needs[0], 1 + needs[1]) if len(needs) > 1 else needs[0]
    if isinstance(node, Not):
        return _need(node.inner)
    return 2 if isinstance(node, Between) else 1


class PredProgram:
    """A predicate lowered for K-C: `code`, one (n_instr + n_lits, 4)
    int32 table of 16-byte records over column slots (`columns`, sorted
    names): `n_instr` postfix instructions {word, y, z, w}, then the
    `n_lits` literals of IN lists {int64 low word, high word, float32
    bits, is_float}.  word = op | fold << 3 | flags (NEGATE, HAS_NULL,
    LIT_FLOAT) | compare mask << 8 | slot << 12; a comparison carries its
    literal (y, z the int64 words, w the float32 bits), an IN its
    literals' first index (y) and count (z).  `max_depth` is the most
    stack entries the program holds.  The table goes to each card once
    (`on_device`)."""

    def __init__(self, node: Node):
        self.node = node
        self.columns: tuple[str, ...] = tuple(sorted(node.columns()))
        self._slot = {c: i for i, c in enumerate(self.columns)}
        self._instrs: list[tuple[int, int, int, int]] = []
        self._lits: list[tuple[int, int, int, int]] = []
        self._depth = 0
        self.max_depth = 0
        self._emit(node)
        self.n_instr, self.n_lits = len(self._instrs), len(self._lits)
        self.code = np.array(self._instrs + self._lits, dtype=np.uint32
                             ).view(np.int32).reshape(-1, 4)
        self._on_device: dict[torch.device, torch.Tensor] = {}
        self._upload_lock = threading.Lock()

    def on_device(self, device: torch.device) -> torch.Tensor:
        """The program table on a CUDA device, uploaded at first use."""
        with self._upload_lock:
            table = self._on_device.get(device)
            if table is None:
                table = torch.from_numpy(self.code).to(device)
                self._on_device[device] = table
            return table

    def _push(self, word: int, y: int = 0, z: int = 0, w: int = 0,
              depth: int = 1) -> None:
        """Emit one instruction that changes the depth by `depth`."""
        self._instrs.append((word & M32, y & M32, z & M32, w & M32))
        self._depth += depth
        self.max_depth = max(self.max_depth, self._depth)

    def _slot_word(self, op: int, column: str, fold: int, flags: int = 0,
                   mask: int = 0) -> int:
        slot = self._slot[column]
        if slot >= MAX_SLOTS:
            raise ValueError(f"predicate over more than {MAX_SLOTS} "
                             f"columns")
        return op | fold << 3 | flags | mask << 8 | slot << 12

    @staticmethod
    def _literal_words(v) -> tuple[int, int, int, bool]:
        """(int64 low word, high word, float32 bits, is_float)."""
        is_float = isinstance(v, float)
        lo, hi = np.array([0 if is_float else int(v)],
                          dtype=np.int64).view(np.int32).tolist()
        bits = int(np.array(v, dtype=np.float32).view(np.int32))
        return lo, hi, bits, is_float

    def _emit(self, node: Node) -> None:
        """Emit `node`, pushing one entry."""
        if isinstance(node, (And, Or)):
            # Kleene AND/OR are associative and commutative and evaluate
            # every part: fold pairwise, the part with the largest stack
            # need first (Sethi-Ullman), so the depth grows at most by one
            # per doubling of the leaves; a leaf part folds in directly
            is_and = isinstance(node, And)
            parts = sorted(_merge_lists(node.parts, is_and), key=_need,
                           reverse=True)
            self._emit(parts[0])
            for p in parts[1:]:
                if _is_leaf(p):
                    self._leaf(p, FOLD_AND if is_and else FOLD_OR)
                else:
                    self._emit(p)
                    self._push(OP_AND if is_and else OP_OR, depth=-1)
        elif isinstance(node, Not):
            self._emit(node.inner)
            self._push(OP_NOT, depth=0)
        elif isinstance(node, Between):
            self._emit(And((Cmp(node.column, ">=", node.low),
                            Cmp(node.column, "<=", node.high))))
        else:
            self._leaf(node, PUSH)

    def _leaf(self, node: Node, fold: int) -> None:
        """Emit a leaf that pushes its pair or folds into the top."""
        depth = 1 if fold == PUSH else 0
        if isinstance(node, TrueNode):
            self._push(OP_TRUE | fold << 3, depth=depth)
        elif isinstance(node, IsNull):
            self._push(self._slot_word(OP_ISNULL, node.column, fold,
                                       NEGATE if node.negate else 0),
                       depth=depth)
        elif isinstance(node, InList):
            lits = [v for v in node.values if v is not None]
            has_null = len(lits) < len(node.values)
            first = len(self._lits)
            for v in lits:
                lo, hi, bits, is_float = self._literal_words(v)
                self._lits.append((lo & M32, hi & M32, bits & M32,
                                   int(is_float)))
            flags = ((NEGATE if node.negate else 0)
                     | (HAS_NULL if has_null else 0))
            self._push(self._slot_word(OP_IN, node.column, fold, flags),
                       first, len(lits), depth=depth)
        elif isinstance(node, Cmp):
            if node.value is None:
                # col <op> NULL is always UNKNOWN
                self._push(self._slot_word(OP_CMP_NULL, node.column, fold),
                           depth=depth)
            elif node.op not in CMP_MASKS:
                raise ValueError(f"unsupported device op {node.op!r}")
            else:
                lo, hi, bits, is_float = self._literal_words(node.value)
                self._push(self._slot_word(
                    OP_CMP, node.column, fold,
                    LIT_FLOAT if is_float else 0, CMP_MASKS[node.op]),
                    lo, hi, bits, depth=depth)
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
    _launch(program, cols, n, pack_keep, out)
    _build.count_launch("pred3vl_mask")
    return out


def _launch(program: PredProgram, cols: list[DeviceCol], n: int,
            pack_keep: bool, out: torch.Tensor) -> None:
    """One K-C launch on the current stream of `out`'s device (checked
    arguments)."""
    dev = out.device
    stream = torch.cuda.current_stream(dev)
    table = program.on_device(dev)
    # launches on other streams than the upload's keep the table alive
    table.record_stream(stream)
    args = PredArgs(prog=table.data_ptr(), out=out.data_ptr(), n=n,
                    n_instr=program.n_instr, n_lits=program.n_lits,
                    n_cols=len(cols), pack=int(pack_keep),
                    depth=program.max_depth)
    descs = [ColDesc(d.data_ptr(), _build.ptr(v), _DTYPE_CODES[d.dtype])
             for d, v in cols]
    if len(descs) <= BY_VALUE_COLS:
        args.cols[:len(descs)] = descs
    else:
        # the pinned copy is held by PyTorch's host allocator until the
        # copy recorded on this stream has run
        dev_cols = torch.frombuffer(
            bytearray((ColDesc * len(descs))(*descs)), dtype=torch.uint8
        ).pin_memory().to(dev, non_blocking=True)
        args.dev_cols = dev_cols.data_ptr()
    lib = _build.library("pred3vl_mask")
    rc = lib.trt_pred3vl_mask(ctypes.addressof(args), stream.cuda_stream)
    _build.check(lib, rc, "pred3vl_mask")


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
