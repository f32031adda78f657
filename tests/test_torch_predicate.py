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


def kleene(fold, a, b):
    """(t, u) of a AND b (fold FOLD_AND) or a OR b, Kleene."""
    (t1, u1), (t2, u2) = a, b
    f1, f2 = ~t1 & ~u1, ~t2 & ~u2
    if fold == port_device.FOLD_AND:
        t, f = t1 & t2, f1 | f2
    else:
        t, f = t1 | t2, f1 & f2
    return t, ~t & ~f


def interpret(program, cols, n):
    """numpy interpreter of K-C's program table (the kernel's spec):
    `program.code` holds n_instr records {word, y, z, w} with word = op |
    fold << 3 | flags | compare mask << 8 | slot << 12 (a comparison's
    literal in y, z (int64) and w (float32 bits); an IN's first literal
    and count in y, z), then n_lits IN literals {int64 low word, high
    word, float32 bits, is_float}.  Checks that the stack never holds more
    than `program.max_depth` <= 64 entries (the kernel keeps the top in
    registers and 63 below it in 64-bit registers)."""
    assert program.code.shape == (program.n_instr + program.n_lits, 4)
    instrs = program.code[:program.n_instr].view(np.uint32)
    lits = program.code[program.n_instr:]
    lit_i = np.ascontiguousarray(lits[:, :2]).view(np.int64)[:, 0]
    lit_f = np.ascontiguousarray(lits[:, 2]).view(np.float32)
    lit_is_float = lits[:, 3] != 0
    assert program.max_depth <= 64
    stack = []
    for word, y, z, w in instrs.tolist():
        op, fold = word & 7, (word >> 3) & 3
        if op == port_device.OP_NOT:
            t, u = stack.pop()
            stack.append((~t & ~u, u))
            continue
        if op in (port_device.OP_AND, port_device.OP_OR):
            b, a = stack.pop(), stack.pop()
            stack.append(kleene(port_device.FOLD_AND if op ==
                                port_device.OP_AND else port_device.FOLD_OR,
                                a, b))
            continue
        data, valid = cols[word >> 12] if op != port_device.OP_TRUE \
            else (None, None)
        valid = np.ones(n, bool) if valid is None else valid

        def cmp(mask, is_float, ilit, flit):
            # the outcome's bit of the mask: <, ==, >, unordered
            if data.dtype == np.float32 or is_float:
                x = data.astype(np.float32)
                outcome = np.select([x < flit, x == flit, x > flit],
                                    [0, 1, 2], 3)
            else:
                x = data.astype(np.int64)
                outcome = np.select([x < ilit, x == ilit], [0, 1], 2)
            return (mask >> outcome) & 1 == 1

        if op == port_device.OP_TRUE:
            leaf = (np.ones(n, bool), np.zeros(n, bool))
        elif op == port_device.OP_CMP:
            ilit = np.array([y, z], np.uint32).view(np.int64)[0]
            flit = np.array([w], np.uint32).view(np.float32)[0]
            leaf = (valid & cmp((word >> 8) & 15,
                                word & port_device.LIT_FLOAT, ilit, flit),
                    ~valid)
        elif op == port_device.OP_CMP_NULL:
            leaf = (np.zeros(n, bool), np.ones(n, bool))
        elif op == port_device.OP_ISNULL:
            leaf = (valid == bool(word & port_device.NEGATE),
                    np.zeros(n, bool))
        elif op == port_device.OP_IN:
            m = np.zeros(n, bool)
            for k in range(y, y + z):
                m |= cmp(port_device.CMP_MASKS["="], lit_is_float[k],
                         lit_i[k], lit_f[k])
            t, f = m & valid, ~m & valid
            if word & port_device.HAS_NULL:
                f = np.zeros(n, bool)
            if word & port_device.NEGATE:
                t, f = f, t
            leaf = (t, ~t & ~f)
        else:
            raise AssertionError(f"unknown op {op}")
        if fold == port_device.PUSH:
            stack.append(leaf)
        else:
            stack.append(kleene(fold, stack.pop(), leaf))
        assert len(stack) <= program.max_depth
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
