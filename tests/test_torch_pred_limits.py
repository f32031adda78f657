"""Predicates of any size through the port, against the JAX package.

The JAX package fuses every predicate that `device_compatible` accepts,
whatever its numbers of instructions, literals, columns and nesting
depth; so does the port, whose kernel K-C reads its program from the
card.  The cases: a 70-literal OR of equalities (which lowers to one IN
list), IN of 70 values, NOT IN with and without NULL, an AND over 20
columns of mixed device-safe dtypes (more than K-C takes by value), a
70-deep parenthesised right-nested AND/OR and an OR of 70 comparisons
over three columns (70 instructions).

- Each lowers; its program, run by `interpret` (the kernel's spec,
  tests/test_torch_predicate.py), equals JAX's `compile_mask_jnp` bit
  for bit, nulls included, as do `eval3_torch` and the host evaluators;
  the Sethi-Ullman order, with each leaf folded into the entry below
  it, keeps the stack depth within the kernel's 64 (1 for the deep
  nesting, which the children's own order takes to 71).
- The chain (`mask_field` on a string column, then `filter_rows`) over
  2,065 rows gives the JAX chain's bytes with chunked dispatch on (256)
  and off, in both dispatch encodings, with the same plan.
- The mesh program (`ShardedFusedProgram`, 8 virtual shards) with the
  70-literal OR gives the JAX mesh program's hexes, keep mask and sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_chain import ROWS, check_chain
from test_torch_chain import knobs  # noqa: F401  (fixture)
from test_torch_predicate import interpret
from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.ops import dispatch as ref_dispatch
from transferia_tpu.parallel import fusedmesh as ref_fm
from transferia_tpu.predicate import compile_mask as ref_compile_mask
from transferia_tpu.predicate import parse as ref_parse
from transferia_tpu.predicate.device import compile_mask_jnp
from transferia_tpu.predicate.device import (
    device_compatible as ref_device_compatible,
)
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.ops import dispatch as port_dispatch
from transferia_tpu_torch.parallel import fusedmesh as port_fm
from transferia_tpu_torch.predicate import compile_mask, parse
from transferia_tpu_torch.predicate import device as port_device
from transferia_tpu_torch.testing import force_virtual_mesh

TYPES = ["boolean", "int8", "uint8", "int16", "uint16", "int32", "float",
         "date"]
N_COLS = 20
COLS = ([("id", "int32"), ("s", "utf8")]
        + [(f"c{k}", TYPES[k % len(TYPES)]) for k in range(N_COLS)])
# a condition true on most valid rows of each type
COND = {"boolean": "{} IN (true, false)", "int8": "{} > -120",
        "uint8": "{} != 7", "int16": "{} BETWEEN -990 AND 990",
        "uint16": "{} >= 100", "int32": "{} < 999000", "float": "{} != 2.5",
        "date": "{} >= 18010"}


def nested(depth: int) -> str:
    """`col > i OP (...)` nested `depth` deep, AND and OR alternating,
    over integer columns."""
    ints = ["id", "c1", "c3", "c5", "c7"]
    text = "id = 1"
    for i in range(depth):
        text = (f"{ints[i % len(ints)]} > {i} "
                f"{'AND' if i % 2 else 'OR'} ({text})")
    return text


WIDE_OR = " OR ".join(f"id = {i}" for i in range(70))
WIDE_IN = f"id IN ({', '.join(str(i) for i in range(70))})"
EVENS = ", ".join(str(i) for i in range(0, 140, 2))
NOT_IN_NULL = f"id NOT IN ({EVENS}, NULL)"
NOT_IN = f"id NOT IN ({EVENS})"
AND_20 = " AND ".join(COND[t].format(c) for c, t in COLS[2:])
DEEP = nested(70)


def rare_cmps(cols, lows, highs, steps, k: int = 70) -> str:
    """An OR of k comparisons, each true on a few rows: column i % 3
    below its low end or above its high end by a margin that grows with
    i; no IN list can stand for them (k instructions)."""
    parts = []
    for i in range(k):
        j = i % len(cols)
        m = steps[j] * (i // 6 + 1)
        parts.append(f"{cols[j]} < {lows[j] + m}" if i % 2
                     else f"{cols[j]} > {highs[j] - m}")
    return " OR ".join(parts)


CMP_70 = rare_cmps(("c1", "c3", "c5"), (-128, -1000, -10**6),
                   (127, 999, 10**6 - 1), (1, 8, 8000))
CASES = {"or70": WIDE_OR, "in70": WIDE_IN, "not_in_null": NOT_IN_NULL,
         "not_in": NOT_IN, "and20": AND_20, "deep70": DEEP,
         "cmp70": CMP_70}


def columns(n: int, seed: int) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """name -> (data, validity) for every fixed column of COLS."""
    rng = np.random.default_rng(seed)
    make = {
        "boolean": lambda: rng.integers(0, 2, n).astype(np.bool_),
        "int8": lambda: rng.integers(-128, 128, n).astype(np.int8),
        "uint8": lambda: rng.integers(0, 256, n).astype(np.uint8),
        "int16": lambda: rng.integers(-1000, 1000, n).astype(np.int16),
        "uint16": lambda: rng.integers(0, 65536, n).astype(np.uint16),
        "int32": lambda: rng.integers(-10**6, 10**6, n).astype(np.int32),
        "float": lambda: rng.choice(np.array(
            [0.5, 1.5, 2.5, -1.0, np.nan], dtype=np.float32), n),
        "date": lambda: rng.integers(18000, 20000, n).astype(np.int32),
    }
    out = {"id": (rng.integers(0, 206, n).astype(np.int32),
                  rng.random(n) > 0.05)}
    for name, ctype in COLS[2:]:
        out[name] = (make[ctype](), rng.random(n) > 0.03)
    return out


def pydict(cols: dict, n: int) -> dict[str, list]:
    data = {k: [v[i].item() if ok[i] else None for i in range(n)]
            for k, (v, ok) in cols.items()}
    data["s"] = [None if i % 11 == 0 else f"user-{i}@example.com/{i % 7}"
                 for i in range(n)]
    return data


@pytest.mark.parametrize("case", sorted(CASES))
def test_large_predicate_lowers_and_matches_jax(case):
    text = CASES[case]
    n = 515
    cols = columns(n, seed=len(text))
    node = parse(text)
    assert port_device.device_compatible(node, new_table_schema(COLS))
    assert ref_device_compatible(ref_parse(text), ref_schema(COLS))
    program = port_device.compile_mask_program(node)
    assert program.max_depth <= 64
    if case == "deep70":
        assert program.max_depth == 1
    used = {k: cols[k] for k in node.columns()}
    if case == "and20":
        assert len(program.columns) == N_COLS > port_device.BY_VALUE_COLS
    if case in ("or70", "in70"):
        # the equalities merge into one IN list
        assert (program.n_instr, program.n_lits) == (1, 70)
    if case == "cmp70":
        assert (program.n_instr, program.n_lits) == (70, 0)
    want = np.asarray(compile_mask_jnp(ref_parse(text))(
        {k: (jnp.asarray(d), jnp.asarray(v)) for k, (d, v) in used.items()},
        n))
    assert 0 < want.sum() < n or case == "not_in_null"
    got = interpret(program, [cols[c] for c in program.columns], n)
    np.testing.assert_array_equal(got, want)
    tcols = {k: (torch.from_numpy(d), torch.from_numpy(v))
             for k, (d, v) in used.items()}
    np.testing.assert_array_equal(
        port_device.eval3_torch(node, tcols, n).numpy(), want)
    data = pydict(cols, n)
    port_batch = ColumnBatch.from_pydict(TableID("", "t"),
                                         new_table_schema(COLS), data)
    ref_batch = RefBatch.from_pydict(port_batch.table_id, ref_schema(COLS),
                                     data)
    np.testing.assert_array_equal(compile_mask(node)(port_batch), want)
    np.testing.assert_array_equal(
        ref_compile_mask(ref_parse(text))(ref_batch), want)


def test_nesting_order_bounds_the_depth():
    """Emitting each AND/OR's children in their own order would need a
    stack entry per level; the lowering's order needs one at any depth
    of this nesting, and log2(leaves) for a balanced tree."""
    assert port_device.compile_mask_program(parse(nested(100))).max_depth \
        == 1
    leaves = [f"id = {i}" for i in range(64)]
    while len(leaves) > 1:
        leaves = [f"({a} {'AND' if i % 4 else 'OR'} {b})"
                  for i, (a, b) in enumerate(zip(leaves[::2], leaves[1::2]))]
    assert port_device.compile_mask_program(parse(leaves[0])).max_depth == 6


CHAIN_CASES = {"or70": WIDE_OR, "in70": WIDE_IN, "and20": AND_20,
               "deep70": DEEP}


@pytest.mark.parametrize("chunk", [256, 0])
@pytest.mark.parametrize("encoding", ["raw", "auto"])
@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_with_large_predicate_byte_identical_to_jax(
        case, encoding, chunk, knobs):  # noqa: F811
    config = {"transformers": [
        {"mask_field": {"columns": ["s"], "salt": "wide"}},
        {"filter_rows": {"filter": CHAIN_CASES[case]}},
    ]}
    check_chain(config, COLS, pydict(columns(ROWS, seed=3), ROWS), knobs,
                encoding, chunk)


@pytest.fixture
def mesh8():
    force_virtual_mesh(8)
    yield
    force_virtual_mesh(None)


_MESH_REFERENCE: dict = {}


@pytest.mark.parametrize("mode", ["auto", "raw"])
def test_mesh_program_with_large_predicate_matches_jax(mode, mesh8):
    n = 8 * 256 + 37
    rng = np.random.default_rng(5)
    values = [f"v{i}-{'x' * (i % 40)}".encode() for i in range(n)]
    data = np.frombuffer(b"".join(values), dtype=np.uint8).copy()
    offsets = np.concatenate([[0], np.cumsum([len(v) for v in values])]
                             ).astype(np.int32)
    pred_cols = {"id": (rng.integers(0, 206, n).astype(np.int32),
                        rng.random(n) > 0.1)}
    if not _MESH_REFERENCE:
        ref = ref_fm.ShardedFusedProgram([b"wide"], ref_parse(WIDE_OR))
        ref_dispatch.set_dispatch_encoding("auto")
        try:
            hexes, keep = ref.run([(data, offsets)], pred_cols, n)
        finally:
            ref_dispatch.set_dispatch_encoding(None)
        _MESH_REFERENCE.update(hexes=hexes, keep=keep, kept=ref.last_kept,
                               hist=ref.last_shard_hist)
    port_dispatch.set_dispatch_encoding(mode)
    try:
        prog = port_fm.ShardedFusedProgram([b"wide"], parse(WIDE_OR),
                                           device="cpu")
        hexes, keep = prog.run([(data, offsets)], pred_cols, n)
    finally:
        port_dispatch.set_dispatch_encoding(None)
    np.testing.assert_array_equal(hexes[0], _MESH_REFERENCE["hexes"][0])
    np.testing.assert_array_equal(keep, _MESH_REFERENCE["keep"])
    assert 0 < keep.sum() < n
    assert prog.last_kept == _MESH_REFERENCE["kept"]
    np.testing.assert_array_equal(prog.last_shard_hist,
                                  _MESH_REFERENCE["hist"])
