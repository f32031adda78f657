"""K-C (three-valued predicate) of the PyTorch port against the JAX package.

`eval3_torch` (what a CPU tensor runs) must equal the JAX package's
`compile_mask_jnp` and the host evaluator `compile_mask` on every
device-eligible predicate.  The cases are those of
tests/unit/test_predicate_3vl.py (NOT over NULL, NULL through AND/OR,
IN with NULL literals, IS NULL) written over device-eligible column
types, plus every comparison, BETWEEN and float NaN.  The lowered
postfix program that the CUDA kernel runs is checked here too, through
a small numpy interpreter of its instruction set.  Exact: outputs are
bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.predicate import compile_mask as ref_compile_mask
from transferia_tpu.predicate import parse as ref_parse
from transferia_tpu.predicate.device import compile_mask_jnp
from transferia_tpu.predicate.device import (
    device_compatible as ref_device_compatible,
)
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.ops.decode import pack_mask_words
from transferia_tpu_torch.predicate import compile_mask, parse
from transferia_tpu_torch.predicate import device as port_device

COLS = [("id", "int32"), ("x", "float"), ("b", "boolean"), ("i8", "int8"),
        ("u8", "uint8"), ("i16", "int16"), ("u16", "uint16"),
        ("d", "date")]

# tests/unit/test_predicate_3vl.py, over device-eligible types
CASES_3VL = [
    "NOT x = 1", "x != 1", "x > 0 OR id = 1", "x > 99 OR id = 2",
    "x > 0 AND id >= 1", "NOT (x > 0 AND id >= 1)", "x IS NULL",
    "NOT x IS NULL", "id IN (2, NULL)", "id NOT IN (2, NULL)",
    "id IN (NULL)", "id NOT IN (NULL)", "id NOT IN (2)", "NOT id IN (2)",
]
CASES_MORE = [
    "b = true", "b != false", "b < true", "i8 < -3", "u8 >= 200",
    "i16 BETWEEN -50 AND 50", "u16 > 30000", "d <= 19000", "id = NULL",
    "x = 1.5", "x != 1.5", "x < 0", "x IN (1.5, 2.5, NULL)",
    "x NOT IN (1.5)", "x >= 2.5 OR x IS NULL", "i16 > 2.5", "u8 <= 100.5",
    "NOT i8 > 0", "NOT (i8 > 0 OR x < 0.5)", "id IS NOT NULL",
    "(b = true OR i16 > 0) AND NOT (u16 < 100 OR id >= 0)",
    "NOT (NOT (id > 0 AND (x < 1 OR b = true)) OR i8 IN (1, 2, 3))",
    "id BETWEEN NULL AND 5", "",
]


def make_batches(n, seed):
    rng = np.random.default_rng(seed)
    data = {
        "id": rng.integers(-3, 4, n).astype(np.int32),
        "x": rng.choice(np.array([0.0, 0.5, 1.0, 1.5, 2.5, -1.0, np.nan],
                                 dtype=np.float32), n),
        "b": rng.integers(0, 2, n).astype(np.bool_),
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "u8": rng.integers(0, 256, n).astype(np.uint8),
        "i16": rng.integers(-100, 100, n).astype(np.int16),
        "u16": rng.integers(0, 65536, n).astype(np.uint16),
        "d": rng.integers(18000, 20000, n).astype(np.int32),
    }
    valid = {k: rng.random(n) > 0.25 for k in data}
    pylists = {k: [None if not valid[k][i] else v[i].item()
                   for i in range(n)] for k, v in data.items()}
    port = ColumnBatch.from_pydict(TableID("", "t"), new_table_schema(COLS),
                                   pylists)
    ref = RefBatch.from_pydict(port.table_id, ref_schema(COLS), pylists)
    return data, valid, port, ref


def interpret(program, cols, n):
    """numpy interpreter of K-C's instruction set (the kernel's spec)."""
    stack = []
    for op, slot, a, b in program.instrs.tolist():
        if op == port_device.OP_TRUE:
            stack.append((np.ones(n, bool), np.zeros(n, bool)))
            continue
        if op in (port_device.OP_AND, port_device.OP_OR):
            t2, u2 = stack.pop()
            t1, u1 = stack.pop()
            f1, f2 = ~t1 & ~u1, ~t2 & ~u2
            if op == port_device.OP_AND:
                t, f = t1 & t2, f1 | f2
            else:
                t, f = t1 | t2, f1 & f2
            stack.append((t, ~t & ~f))
            continue
        if op == port_device.OP_NOT:
            t, u = stack.pop()
            stack.append((~t & ~u, u))
            continue
        data, valid = cols[slot]
        valid = np.ones(n, bool) if valid is None else valid

        def cmp(code, lit):
            if data.dtype == np.float32 or program.lit_is_float[lit]:
                x, y = data.astype(np.float32), program.flits[lit]
            else:
                x, y = data.astype(np.int64), program.ilits[lit]
            return [x == y, x != y, x < y, x <= y, x > y, x >= y][code]

        if op == port_device.OP_CMP:
            stack.append((valid & cmp(a, b), ~valid))
        elif op == port_device.OP_CMP_NULL:
            stack.append((np.zeros(n, bool), np.ones(n, bool)))
        elif op == port_device.OP_ISNULL:
            stack.append((valid == bool(a), np.zeros(n, bool)))
        elif op == port_device.OP_IN:
            count, flags = b & 0xFFFF, b >> 16
            m = np.zeros(n, bool)
            for k in range(count):
                m |= cmp(0, a + k)
            t, f = m & valid, ~m & valid
            if flags & port_device.IN_HAS_NULL:
                f = np.zeros(n, bool)
            if flags & port_device.IN_NEGATE:
                t, f = f, t
            stack.append((t, ~t & ~f))
        else:
            raise AssertionError(f"unknown op {op}")
    assert len(stack) == 1
    return stack[0][0]


@pytest.mark.parametrize("text", CASES_3VL + CASES_MORE)
def test_eval3_matches_jax_and_host(text):
    n = 515
    data, valid, port_batch, ref_batch = make_batches(n, seed=len(text))
    node = parse(text)
    schema = new_table_schema(COLS)
    assert port_device.device_compatible(node, schema)
    assert ref_device_compatible(ref_parse(text), ref_schema(COLS))
    cols = {k: (torch.from_numpy(data[k]), torch.from_numpy(valid[k]))
            for k in node.columns()}
    got = port_device.eval3_torch(node, cols, n).numpy()
    jnp_cols = {k: (jnp.asarray(data[k]), jnp.asarray(valid[k]))
                for k in node.columns()}
    want = np.asarray(compile_mask_jnp(ref_parse(text))(jnp_cols, n))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, compile_mask(node)(port_batch))
    np.testing.assert_array_equal(
        got, ref_compile_mask(ref_parse(text))(ref_batch))
    # the lowered program the kernel runs gives the same mask, and the
    # wrapper's CPU path (plain version) packs it as the kernel would
    program = port_device.compile_mask_program(node)
    slots = [(data[c], valid[c]) for c in program.columns]
    np.testing.assert_array_equal(interpret(program, slots, n), got)
    tslots = [(torch.from_numpy(d), torch.from_numpy(v)) for d, v in slots]
    np.testing.assert_array_equal(
        port_device.pred3vl_mask(program, tslots, n, False,
                                 torch.device("cpu")).numpy(), got)
    packed = port_device.pred3vl_mask(program, tslots, 512, True,
                                      torch.device("cpu"))
    np.testing.assert_array_equal(
        packed.numpy(),
        pack_mask_words(torch.from_numpy(got[:512]), 512).numpy())


@pytest.mark.parametrize("text,ctype", [
    ("c > 16777217", "float"), ("c = 0.1", "float"), ("c < 2.5", "int32"),
    ("c < 2.5", "date"), ("c = 300", "int8"), ("c = -1", "uint16"),
    ("c = 1", "boolean"), ("c = true", "int32"), ("c ~ 'a%'", "int32"),
    ("c > 5", "int64"), ("c > 5", "double"), ("c = 'x'", "utf8"),
    ("c IS NULL", "int64"), ("c = 1.5", "float"), ("c < 16777216", "float"),
])
def test_device_compatible_matches_jax(text, ctype):
    schema = [("c", ctype)]
    assert port_device.device_compatible(parse(text),
                                         new_table_schema(schema)) == \
        ref_device_compatible(ref_parse(text), ref_schema(schema))


def test_no_column_program_needs_a_device():
    program = port_device.compile_mask_program(parse(""))
    with pytest.raises(ValueError):
        port_device.pred3vl_mask(program, [], 64, False)
    got = port_device.pred3vl_mask(program, [], 64, True,
                                   torch.device("cpu"))
    assert got.numpy().view(np.uint32).tolist() == [0xFFFFFFFF] * 2


def test_oversized_predicate_is_refused():
    text = " OR ".join(f"id = {i}" for i in range(70))
    with pytest.raises(ValueError, match="too large"):
        port_device.compile_mask_program(parse(text))
