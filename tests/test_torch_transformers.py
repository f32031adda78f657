"""The port's host transformers `convert`, `pk`, `logger_tf` and `misc`
(`transferia_tpu_torch/transform/plugins/`) against the JAX package's,
on the CPU.  Every comparison is exact: schemas, every column's bytes,
and the error blocks each plugin emits.

- Every registered name of the four plugins on seeded batches, through
  each package's chain (`build_chain`; the port's with `device="cpu"`),
  with their options and error routes (`emit`, `drop`, `fail`).
- Chains that put these steps around bench.py's mask and filter: the
  same planned steps (the mask and filter fused between the host steps)
  and the same output.
"""

import logging

import numpy as np
import pytest

from tests.test_torch_lambda import (
    PORT_FN,
    REF_FN,
    SR_COLS,
    assert_same,
    column_state,
    schema_rows,
    sr_data,
)
from transferia_tpu.abstract import change_item as ref_ci
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu.transform.chain import build_chain as ref_build_chain
from transferia_tpu.transform.registry import \
    registered_transformers as ref_registered
from transferia_tpu_torch.abstract import change_item as port_ci
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.transform import fused as port_tfused
from transferia_tpu_torch.transform.chain import build_chain
from transferia_tpu_torch.transform.registry import _REGISTRY

PLUGIN_NAMES = ("to_string", "number_to_float", "to_datetime",
                "replace_primary_key", "logger", "batch_splitter",
                "regex_replace", "jsonparser", "problem_item_detector",
                "raw_doc_grouper", "raw_cdc_doc_grouper",
                "mongo_pk_extender", "custom", "yt_dict")

MIXED = [("id", "int64", True), ("name", "utf8"), ("score", "double"),
         ("flag", "boolean"), ("n8", "int8"), ("u32", "uint32"),
         ("ts", "int64"), ("ratio", "float")]


def mixed_data(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def nulls(vals, every):
        return [None if i % every == every - 1 else v
                for i, v in enumerate(vals)]

    return {
        "id": [int(v) for v in rng.integers(-2**40, 2**40, n)],
        "name": nulls([f"user {int(v)} é" for v in rng.integers(0, 99, n)],
                      7),
        "score": nulls([float(v) / 3 for v in rng.integers(-900, 900, n)],
                       5),
        "flag": nulls([bool(v) for v in rng.integers(0, 2, n)], 4),
        "n8": [int(v) for v in rng.integers(-128, 128, n)],
        "u32": [int(v) for v in rng.integers(0, 2**32, n)],
        "ts": nulls([int(v) for v in rng.integers(0, 2_000_000_000, n)], 6),
        "ratio": [float(np.float32(v)) for v in rng.random(n)],
    }


def both(cols, data, table=("ns", "t")):
    port = ColumnBatch.from_pydict(TableID(*table), new_table_schema(cols),
                                   data)
    ref = RefBatch.from_pydict(RefTableID(*table), ref_schema(cols), data)
    return port, ref


def item_rows(items) -> list:
    return [(it.kind.value, it.schema, it.table, it.column_names,
             tuple(v.hex() if isinstance(v, bytes) else v
                   for v in it.column_values),
             None if it.table_schema is None
             else schema_rows(it.table_schema)) for it in items]


def assert_outputs_equal(out, ref_out):
    """A chain's output: one block, or row items (a block with its error
    blocks, a fan-out's parts)."""
    if isinstance(ref_out, list):
        assert isinstance(out, list)
        assert item_rows(out) == item_rows(ref_out)
    else:
        assert not isinstance(out, list)
        assert_same(out, ref_out)


def run_chain(transformers, cols, data, error_behavior="emit",
              table=("ns", "t")):
    cfg = {"transformers": transformers, "error_behavior": error_behavior}
    port_batch, ref_batch = both(cols, data, table)
    port_chain = build_chain(cfg, device="cpu")
    ref_chain = ref_build_chain(cfg)
    out = port_chain.apply(port_batch)
    ref_out = ref_chain.apply(ref_batch)
    return out, ref_out, port_chain, ref_chain


def test_every_plugin_name_is_registered_as_in_jax():
    import transferia_tpu_torch.transform.plugins  # noqa: F401

    assert set(PLUGIN_NAMES) <= set(_REGISTRY)
    assert set(PLUGIN_NAMES) <= set(ref_registered())


# -- convert --------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    {}, {"columns": ["score", "flag", "n8"]}, {"columns": ["nope"]},
    {"columns": ["id", "name"]}, {"tables": ["ns.t"]}, {"tables": ["x.*"]},
])
@pytest.mark.parametrize("seed", [1, 2])
def test_to_string_equals_jax(cfg, seed):
    out, ref_out, _, _ = run_chain([{"to_string": cfg}], MIXED,
                                   mixed_data(61, seed))
    assert_outputs_equal(out, ref_out)


@pytest.mark.parametrize("cfg", [{}, {"tables": ["ns.t"]},
                                 {"tables": ["other.t"]}])
def test_number_to_float_equals_jax(cfg):
    out, ref_out, _, _ = run_chain([{"number_to_float": cfg}], MIXED,
                                   mixed_data(50, 3))
    assert_outputs_equal(out, ref_out)


@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns"])
def test_to_datetime_equals_jax(unit):
    out, ref_out, _, _ = run_chain(
        [{"to_datetime": {"columns": ["ts", "n8", "name"], "unit": unit}}],
        MIXED, mixed_data(40, 4))
    assert_outputs_equal(out, ref_out)


def test_to_datetime_refuses_a_bad_unit_as_jax():
    msgs = []
    for build in (lambda c: build_chain(c, device="cpu"), ref_build_chain):
        with pytest.raises(ValueError, match="bad unit") as e:
            build({"transformers": [{"to_datetime": {"columns": ["ts"],
                                                     "unit": "h"}}]})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- pk, logger -----------------------------------------------------------------

@pytest.mark.parametrize("keys", [["name"], ["u32", "id"], ["missing"]])
def test_replace_primary_key_equals_jax(keys):
    out, ref_out, _, _ = run_chain([{"replace_primary_key": {"keys": keys}}],
                                   MIXED, mixed_data(30, 5))
    assert_outputs_equal(out, ref_out)


@pytest.mark.parametrize("cfg", [{}, {"sample_rows": 2},
                                 {"sample_rows": 3, "level": "debug"}])
def test_logger_equals_jax(cfg, caplog):
    caplog.set_level(logging.DEBUG)
    out, ref_out, _, _ = run_chain([{"logger": cfg}], MIXED,
                                   mixed_data(12, 6))
    assert_outputs_equal(out, ref_out)
    port_logs = [(r.levelno, r.getMessage()) for r in caplog.records
                 if r.name == "transferia_tpu_torch.transform.logger"]
    ref_logs = [(r.levelno, r.getMessage()) for r in caplog.records
                if r.name == "transferia_tpu.transform.logger"]
    assert port_logs == ref_logs and len(port_logs) == \
        1 + cfg.get("sample_rows", 0)


# -- misc -----------------------------------------------------------------------

@pytest.mark.parametrize("max_rows", [7, 25, 100])
def test_batch_splitter_equals_jax(max_rows):
    """The fan-out's parts each run the steps after the splitter."""
    out, ref_out, _, _ = run_chain(
        [{"batch_splitter": {"max_rows": max_rows}},
         {"to_string": {"columns": ["score"]}}], MIXED, mixed_data(25, 7))
    assert_outputs_equal(out, ref_out)


@pytest.mark.parametrize("pattern,repl", [(r"user (\d+)", r"u-\1"),
                                          ("é", "e"), ("^$", "empty")])
def test_regex_replace_equals_jax(pattern, repl):
    out, ref_out, _, _ = run_chain(
        [{"regex_replace": {"columns": ["name", "score"],
                            "pattern": pattern, "replacement": repl}}],
        MIXED, mixed_data(33, 8))
    assert_outputs_equal(out, ref_out)


JSON_COLS = [("id", "int64", True), ("doc", "utf8")]


def json_data(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(24):
        r = int(rng.integers(0, 6))
        docs.append([
            '{"a": 1, "b": {"c": "x"}}', "not json", "[1, 2]", None,
            f'{{"a": {i}, "b": {{"c": "v{i}"}}, "d": true}}', '"str"'][r])
    return {"id": list(range(24)), "doc": docs}


@pytest.mark.parametrize("keep_source", [False, True])
@pytest.mark.parametrize("behavior", ["emit", "drop"])
@pytest.mark.parametrize("seed", [1, 2])
def test_jsonparser_and_its_error_batches_equal_jax(keep_source, behavior,
                                                    seed):
    cfg = {"column": "doc", "keep_source": keep_source, "fields": [
        {"name": "a", "type": "int64"},
        {"name": "c", "type": "utf8", "path": "b.c"},
        {"name": "d", "type": "boolean", "key": True}]}
    out, ref_out, _, _ = run_chain([{"jsonparser": cfg}], JSON_COLS,
                                   json_data(seed), behavior)
    assert_outputs_equal(out, ref_out)


def test_jsonparser_fail_behavior_raises_as_jax():
    cfg = {"column": "doc", "fields": [{"name": "a", "type": "int64"}]}
    msgs = []
    for pkg in ("port", "jax"):
        port_batch, ref_batch = both(JSON_COLS, json_data(3))
        chain_cfg = {"transformers": [{"jsonparser": cfg}],
                     "error_behavior": "fail"}
        chain = build_chain(chain_cfg, device="cpu") if pkg == "port" \
            else ref_build_chain(chain_cfg)
        with pytest.raises(ValueError, match="failed") as e:
            chain.apply(port_batch if pkg == "port" else ref_batch)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


PID_COLS = [("id", "int64", True), ("name", "utf8"), ("age", "int32"),
            ("email", "utf8")]


def pid_data(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n = 40
    return {"id": [None if v == 0 else int(v)
                   for v in rng.integers(0, 8, n)],
            "name": [f"n{int(v)}" for v in rng.integers(0, 9, n)],
            "age": [None if v < 2 else int(v)
                    for v in rng.integers(0, 60, n)],
            "email": [None if v == 0 else f"e{int(v)}@x"
                      for v in rng.integers(0, 4, n)]}


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_problem_item_detector_equals_jax(drop, seed):
    out, ref_out, _, _ = run_chain(
        [{"problem_item_detector": {"drop": drop}}], PID_COLS,
        pid_data(seed))
    assert_outputs_equal(out, ref_out)


def cdc_batches(seed: int):
    """A CDC block with kinds and LSNs, from row items in both
    packages."""
    from transferia_tpu.abstract.kinds import Kind as RefKind
    from transferia_tpu_torch.abstract.kinds import Kind

    out = []
    for ci, kinds, schema_of, cb in (
            (port_ci, Kind, new_table_schema, ColumnBatch),
            (ref_ci, RefKind, ref_schema, RefBatch)):
        schema = schema_of(PID_COLS[:3])
        r = np.random.default_rng(seed)
        rows = [ci.ChangeItem(
            kind=kinds(("insert", "update", "delete")[int(r.integers(0, 3))]),
            schema="db", table="people",
            column_names=("id", "name", "age"),
            column_values=(i, f"n{int(r.integers(0, 9))}",
                           int(r.integers(0, 90))),
            table_schema=schema, lsn=1000 + i) for i in range(18)]
        out.append(cb.from_rows(rows))
    return tuple(out)


@pytest.mark.parametrize("name", ["raw_doc_grouper", "raw_cdc_doc_grouper"])
@pytest.mark.parametrize("doc", ["doc", "payload"])
def test_raw_doc_groupers_equal_jax(name, doc):
    cfg = {"transformers": [{name: {"keys": ["id"], "doc_column": doc}}]}
    for port_batch, ref_batch in (both(PID_COLS, pid_data(3)),
                                  cdc_batches(4)):
        out = build_chain(cfg, device="cpu").apply(port_batch)
        ref_out = ref_build_chain(cfg).apply(ref_batch)
        assert schema_rows(out.schema) == schema_rows(ref_out.schema)
        assert [r.as_dict() for r in out.to_rows()] == \
            [r.as_dict() for r in ref_out.to_rows()]
        for c in ref_out.columns:
            if ref_out.schema.find(c).data_type.value != "any":
                assert column_state(out.column(c)) == \
                    column_state(ref_out.column(c)), c


def mongo_batches(seed: int):
    rng = np.random.default_rng(seed)
    ids = [None if i % 5 == 4 else
           {"oid": f"o{int(rng.integers(0, 99))}",
            "shard": int(rng.integers(0, 4))} if i % 3 else f"plain{i}"
           for i in range(20)]
    cols = [("_id", "any", True), ("v", "int32")]
    return both(cols, {"_id": ids, "v": list(range(20))})


@pytest.mark.parametrize("fields", [["oid"], ["oid", "shard"], []])
def test_mongo_pk_extender_equals_jax(fields):
    cfg = {"transformers": [{"mongo_pk_extender": {"fields": fields}}]}
    port_batch, ref_batch = mongo_batches(5)
    out = build_chain(cfg, device="cpu").apply(port_batch)
    ref_out = ref_build_chain(cfg).apply(ref_batch)
    assert schema_rows(out.schema) == schema_rows(ref_out.schema)
    assert [r.as_dict() for r in out.to_rows()] == \
        [r.as_dict() for r in ref_out.to_rows()]


def test_yt_dict_equals_jax():
    cols = [("k", "int64", True), ("meta", "any"), ("tags", "any")]
    data = {"k": list(range(6)),
            "meta": [{"b": 2, "a": [1, "x"]}, None, "s", 3, {"z": None}, []],
            "tags": [["a"], ["b", "c"], None, [], ["é"], [1]]}
    cfg = {"transformers": [{"yt_dict": {}}]}
    port_batch, ref_batch = both(cols, data)
    out = build_chain(cfg, device="cpu").apply(port_batch)
    ref_out = ref_build_chain(cfg).apply(ref_batch)
    assert_same(out, ref_out)


@pytest.mark.parametrize("mode", ["host", "device"])
def test_custom_is_the_lambda_as_jax(mode):
    ref_tfused.set_placement("host")
    port_tfused.set_placement(mode)
    try:
        port_batch, ref_batch = both(SR_COLS, sr_data(300, seed=9),
                                     ("", "hits"))
        out = build_chain({"transformers": [{"custom": {
            "function": PORT_FN}}]}, device="cpu").apply(port_batch)
        ref_out = ref_build_chain({"transformers": [{"custom": {
            "function": REF_FN}}]}).apply(ref_batch)
    finally:
        ref_tfused.set_placement(None)
        port_tfused.set_placement(None)
    assert_same(out, ref_out)


# -- the host steps around the fused run ------------------------------------------

CB_COLS = [("WatchID", "int64"), ("URL", "utf8"), ("RegionID", "int32"),
           ("ResolutionWidth", "int32"), ("Title", "utf8")]
MASK = {"mask_field": {"columns": ["URL"], "salt": "bench-salt"}}
FILTER = {"filter_rows": {"filter": "RegionID < 400 AND ResolutionWidth >= 390"}}


def cb_data(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"WatchID": [int(v) for v in rng.integers(0, 2**62, n)],
            "URL": [f"https://site{int(v)}.test/p?{int(v) * 7}"
                    for v in rng.integers(0, 500, n)],
            "RegionID": [int(v) for v in rng.integers(0, 800, n)],
            "ResolutionWidth": [int(v) for v in rng.integers(200, 2600, n)],
            "Title": [f"title {int(v)}" for v in rng.integers(0, 50, n)]}


def step_names(chain, batch) -> list:
    return [type(s).__name__ for s in
            chain.plan_for(batch.table_id, batch.schema).steps]


@pytest.mark.parametrize("chain", [
    [{"replace_primary_key": {"keys": ["WatchID"]}}, MASK, FILTER,
     {"to_string": {}}],
    [{"replace_primary_key": {"keys": ["WatchID"]}}, MASK, FILTER,
     {"number_to_float": {}}],
    [{"logger": {}}, MASK, FILTER, {"regex_replace": {
        "columns": ["Title"], "pattern": "title", "replacement": "T"}}],
    [{"batch_splitter": {"max_rows": 300}}, MASK, FILTER,
     {"to_string": {"columns": ["RegionID"]}}],
])
@pytest.mark.parametrize("mode", ["host", "device"])
def test_chains_around_the_fused_run_equal_jax(chain, mode):
    port_tfused.set_placement(mode)
    try:
        out, ref_out, port_chain, ref_chain = run_chain(
            chain, CB_COLS, cb_data(1000, 11), table=("", "hits"))
        port_batch, ref_batch = both(CB_COLS, cb_data(1000, 11),
                                     ("", "hits"))
        names = step_names(port_chain, port_batch)
        assert names == step_names(ref_chain, ref_batch)
    finally:
        port_tfused.set_placement(None)
    assert "DeviceFusedStep" in names
    assert_outputs_equal(out, ref_out)
