"""The port's container runner (`transferia_tpu_torch/container/`), its
Airbyte source (`providers/airbyte.py`) and its dbt step
(`transform/plugins/dbt.py`) against the JAX package's, on the CPU.

The cases of `tests/e2e/test_container_e2e.py`, each run through both
packages with the same fake connector and fake `dbt` (the port's
`recipes/airbyte_connector.py` and `recipes/fake_dbt.py`, stdlib scripts
the `exec` runtime runs): the docker and podman argv, discover and the
schema, check, a snapshot into memory, the incremental state's resume,
"needs a runtime", dbt after the snapshot (its argv and profiles.yml),
and dbt never joining the row plans.  Also: two typed streams through
the mask and a filter, and the runner's errors and timeouts.  Equal
results in each; the rows are exact.
"""

import json
import os
import sys
from pathlib import Path

import pytest

from tests.recipes.fake_postgres import FakePG as RefFakePG
from transferia_tpu import container as ref_container
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.table import TableDescription as RefTD
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.providers import airbyte as ref_airbyte
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers.postgres import PGTargetParams as RefPGTarget
from transferia_tpu.providers.sample import (
    SampleSourceParams as RefSampleParams,
)
from transferia_tpu.tasks import activate_delivery as ref_activate
from transferia_tpu.transform import build_chain as ref_build_chain
from transferia_tpu.transform.plugins import dbt as ref_dbt
from transferia_tpu_torch import container
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.providers import airbyte
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers.postgres import PGTargetParams
from transferia_tpu_torch.providers.sample import SampleSourceParams
from transferia_tpu_torch.recipes import airbyte_connector, fake_dbt
from transferia_tpu_torch.recipes.fake_postgres import FakePG
from transferia_tpu_torch.tasks import activate_delivery
from transferia_tpu_torch.transform.chain import build_chain
from transferia_tpu_torch.transform.plugins import dbt

PKGS = {
    "port": dict(container=container, airbyte=airbyte, memory=port_memory,
                 transfer=Transfer, coordinator=MemoryCoordinator,
                 activate=activate_delivery, tid=TableID,
                 td=TableDescription, pg=FakePG, pg_target=PGTargetParams,
                 sample=SampleSourceParams, dbt=dbt, build_chain=build_chain,
                 kw={"device": "cpu"}),
    "jax": dict(container=ref_container, airbyte=ref_airbyte,
                memory=ref_memory, transfer=RefTransfer,
                coordinator=RefCoordinator, activate=ref_activate,
                tid=RefTableID, td=RefTD, pg=RefFakePG,
                pg_target=RefPGTarget, sample=RefSampleParams, dbt=ref_dbt,
                build_chain=ref_build_chain, kw={}),
}
CONNECTOR = [sys.executable, airbyte_connector.__file__]
DBT = [sys.executable, fake_dbt.__file__]
TYPED = [{"name": "orders", "shape": "typed", "total": 3000},
         {"name": "events", "shape": "typed", "total": 1700}]


def make_params(pkg, config=None, **kw):
    return PKGS[pkg]["airbyte"].AirbyteSourceParams(
        config=config or {"api_key": "k"}, runtime="exec",
        exec_argv=CONNECTOR, sync_mode=kw.pop("sync_mode", "full_refresh"),
        **kw)


def both(fn):
    got, want = fn("port"), fn("jax")
    assert got == want
    return got


def schema_view(schema) -> list:
    return [(c.name, c.data_type.value, c.primary_key, c.original_type)
            for c in schema]


def batch_rows(batches) -> list:
    return [tuple(sorted(r.as_dict().items()))
            for b in batches for r in b.to_rows()]


def test_docker_argv_mapping_equals_jax():
    def run(pkg):
        c = PKGS[pkg]["container"]
        spec = c.ContainerSpec(
            image="airbyte/source-x:1.0",
            args=["read", "--config", "/data/config.json"],
            env={"A": "1", "B": "two words"}, mounts=[("/tmp/x", "/data")],
            network="host", workdir="/w", entrypoint="/bin/sh")
        return [c.ContainerRunner(rt).argv(spec)
                for rt in ("docker", "podman", "exec")]

    got = both(run)
    assert got[0][:9] == ["docker", "run", "--rm", "-i", "-e", "A=1", "-e",
                          "B=two words", "-v"]
    assert got[2] == ["read", "--config", "/data/config.json"]


@pytest.mark.parametrize("config", [None, {"api_key": "k",
                                           "streams": TYPED}])
def test_airbyte_discover_and_schema_equal_jax(config):
    def run(pkg):
        st = PKGS[pkg]["airbyte"].AirbyteStorage(make_params(pkg, config))
        tables = st.table_list()
        return {str(tid): (info.eta_rows, schema_view(info.schema))
                for tid, info in tables.items()}

    got = both(run)
    if config is None:
        schema = dict((n, (t, pk)) for n, t, pk, _ in
                      got["airbyte.users"][1])
        assert schema == {"id": ("int64", True), "email": ("utf8", False),
                          "meta": ("any", False)}
    else:
        assert [t for _, t, _, _ in got["airbyte.orders"][1]] == [
            "int64", "double", "utf8", "boolean", "int64", "utf8"]


def test_airbyte_check_equals_jax():
    def run(pkg):
        a = PKGS[pkg]["airbyte"]
        a.AirbyteStorage(make_params(pkg)).ping()
        bad = a.AirbyteStorage(make_params(pkg, {"api_key": "wrong"}))
        with pytest.raises(a.AirbyteError, match="bad api_key") as e:
            bad.ping()
        return str(e.value)

    assert "bad api_key" in both(run)


def test_airbyte_snapshot_to_memory_equals_jax():
    def run(pkg):
        p = PKGS[pkg]
        sink = f"ab-snap-{pkg}"
        store = p["memory"].get_store(sink)
        store.clear()
        t = p["transfer"](id=sink, src=make_params(pkg),
                          dst=p["memory"].MemoryTargetParams(sink_id=sink))
        p["activate"](t, p["coordinator"](), **p["kw"])
        return [r.as_dict() for r in store.rows(p["tid"]("airbyte",
                                                         "users"))]

    rows = both(run)
    assert [r["id"] for r in rows] == [0, 1, 2, 3]
    assert rows[1]["email"] == "u1@x.io" and rows[1]["meta"] == {"n": 1}


def test_airbyte_typed_streams_through_the_chain_equal_jax():
    """Two typed streams through the mask and a boolean filter (the
    JSON integer is int64, which the device predicate does not take, so
    the boolean keeps the filter fused with the mask)."""
    chain = {"transformers": [
        {"mask_field": {"columns": ["email"], "salt": "ab"}},
        {"filter_rows": {"filter": "active = true"}}]}

    def run(pkg):
        p = PKGS[pkg]
        sink = f"ab-typed-{pkg}"
        store = p["memory"].get_store(sink)
        store.clear()
        t = p["transfer"](
            id=sink, src=make_params(pkg, {"api_key": "k", "streams": TYPED},
                                     batch_rows=1000),
            dst=p["memory"].MemoryTargetParams(sink_id=sink),
            transformation=chain)
        p["activate"](t, p["coordinator"](), **p["kw"])
        return {s["name"]: [tuple(sorted(r.as_dict().items())) for r in
                            store.rows(p["tid"]("airbyte", s["name"]))]
                for s in TYPED}

    got = both(run)
    for s in TYPED:
        want = [i for i in range(s["total"]) if i % 3 != 0]
        assert [dict(r)["id"] for r in got[s["name"]]] == want
    first = dict(got["orders"][0])
    assert first["created_at"] == "2024-02-02T01:01:07Z"
    assert len(first["email"]) == 64 and first["active"] is True


def test_airbyte_incremental_state_resume_equals_jax():
    def run(pkg):
        p = PKGS[pkg]
        cp = p["coordinator"]()
        params = make_params(pkg, sync_mode="incremental")
        tid = p["td"](id=p["tid"]("airbyte", "users"))
        got = []
        p["airbyte"].AirbyteStorage(params, "t-inc", cp).load_table(
            tid, got.append)
        first = (batch_rows(got), json.loads(json.dumps(
            cp.get_transfer_state("t-inc")["airbyte_state"])))
        got2 = []
        p["airbyte"].AirbyteStorage(params, "t-inc", cp).load_table(
            tid, got2.append)
        return first, batch_rows(got2), \
            cp.get_transfer_state("t-inc")["airbyte_state"]

    first, second, state = both(run)
    assert first[1] == {"users": {"cursor": 4}}
    assert [dict(r)["id"] for r in second] == [4, 5, 6, 7]
    assert state == {"users": {"cursor": 8}}


def test_airbyte_needs_runtime_equals_jax(monkeypatch):
    monkeypatch.delenv("TRANSFERIA_CONTAINER_RUNTIME", raising=False)

    def run(pkg):
        p = PKGS[pkg]
        monkeypatch.setattr(p["container"].ContainerRunner, "_detect",
                            staticmethod(lambda: ""))
        st = p["airbyte"].AirbyteStorage(
            p["airbyte"].AirbyteSourceParams(image="airbyte/source-x"))
        with pytest.raises(p["container"].ContainerError,
                           match="no container runtime") as e:
            st.table_list()
        return str(e.value)

    both(run)


def dbt_after_snapshot(pkg: str, tmp: Path) -> dict:
    p = PKGS[pkg]
    record = tmp / f"dbt-{pkg}.jsonl"
    project = tmp / "proj"
    project.mkdir(exist_ok=True)
    os.environ["FAKE_DBT_RECORD"] = str(record)
    pg = p["pg"]().start()
    try:
        t = p["transfer"](
            id="dbt1", src=p["sample"](preset="users", table="users",
                                       rows=10, batch_rows=5),
            dst=p["pg_target"](host="127.0.0.1", port=pg.port,
                               database="dw", user="u", password='p"w\\x'),
            transformation={"transformers": [{"dbt": {
                "project_path": str(project), "operation": "build",
                "runtime": "exec", "exec_argv": DBT}}]})
        p["activate"](t, p["coordinator"](), **p["kw"])
        runs = [json.loads(ln) for ln in record.read_text().splitlines()]
        landed = sum(len(tb.rows) for (_ns, n), tb in pg.tables.items()
                     if not n.startswith("__trtpu"))
        argv = runs[0]["argv"]
        profiles_dir = argv[argv.index("--profiles-dir") + 1]
        return {"runs": len(runs), "landed": landed,
                "argv": [a if a != profiles_dir else "<profiles-dir>"
                         for a in argv],
                "profiles": runs[0]["profiles"].replace(str(pg.port),
                                                        "<port>"),
                "profiles_dir_removed": not os.path.exists(profiles_dir)}
    finally:
        pg.stop()
        os.environ.pop("FAKE_DBT_RECORD", None)


def test_dbt_runs_after_snapshot_equals_jax(tmp_path):
    got = both(lambda pkg: dbt_after_snapshot(pkg, tmp_path))
    assert got["runs"] == 1 and got["landed"] == 10
    assert got["argv"] == ["build", "--profiles-dir", "<profiles-dir>",
                           "--project-dir", str(tmp_path / "proj"),
                           "--profile", "transferia"]
    assert 'type: "postgres"' in got["profiles"]
    assert "port: <port>" in got["profiles"]
    assert 'password: "p\\"w\\\\x"' in got["profiles"]
    assert got["profiles_dir_removed"]


@pytest.mark.parametrize("provider", ["ch", "pg", "memory"])
def test_dbt_profiles_yaml_equals_jax(provider):
    from transferia_tpu.providers.clickhouse import CHTargetParams as RefCH
    from transferia_tpu_torch.providers.clickhouse import CHTargetParams

    def run(pkg):
        p = PKGS[pkg]
        dst = {"ch": CHTargetParams if pkg == "port" else RefCH,
               "pg": p["pg_target"],
               "memory": p["memory"].MemoryTargetParams}[provider]()
        step = p["dbt"].DbtTransformer(profile_name="prof")
        try:
            return step._profiles_yaml(dst)
        except p["dbt"].DbtError as e:
            return ("raised", str(e))

    got = both(run)
    if provider == "memory":
        assert got[0] == "raised"
    else:
        assert got.startswith("prof:\n  target: t\n  outputs:\n    t:\n")


def test_dbt_never_joins_row_plans_equals_jax():
    def run(pkg):
        p = PKGS[pkg]
        chain = p["build_chain"]({"transformers": [
            {"dbt": {"project_path": "/x", "runtime": "exec"}},
            {"rename_tables": {"tables": [{"from": "a.b", "to": "c.d"}]}},
        ]})
        from transferia_tpu.abstract.schema import new_table_schema as ref_s
        from transferia_tpu_torch.abstract.schema import new_table_schema

        mk = new_table_schema if pkg == "port" else ref_s
        plan = chain.plan_for(p["tid"]("a", "b"),
                              mk([("id", "int64", True)]))
        return [s.TYPE for s in plan.steps], \
            p["dbt"].DbtTransformer().describe()

    assert both(run) == (["rename_tables"], "dbt(run)")


def test_dbt_never_runs_for_a_replication_only_or_secondary_job():
    for pkg in ("port", "jax"):
        p = PKGS[pkg]
        t = p["transfer"](id="d", src=p["sample"](),
                          dst=p["memory"].MemoryTargetParams(),
                          transformation={"transformers": [{"dbt": {
                              "runtime": "exec",
                              "exec_argv": ["/nonexistent/dbt"]}}]})
        t.runtime.current_job = 1
        assert p["dbt"].run_dbt_transformations(t) == 0
        t.runtime.current_job = 0
        t.transformation = None
        assert p["dbt"].run_dbt_transformations(t) == 0


def test_runner_errors_and_timeouts():
    """A nonzero exit names its stderr tail as the JAX runner's does; a
    child that writes nothing past the runner's idle limit, or outlasts
    the run's timeout, is killed and raises."""
    script = ("import sys, time; sys.stderr.write('boom'); "
              "print('a'); sys.stdout.flush(); time.sleep({}); "
              "sys.exit({})")

    def run(pkg):
        c = PKGS[pkg]["container"]
        spec = c.ContainerSpec(args=[sys.executable, "-c",
                                     script.format(0, 3)])
        with pytest.raises(c.ContainerError) as e:
            list(c.ContainerRunner("exec").stream(spec))
        return str(e.value)

    assert both(run) == "(internal) container exited rc=3: boom"
    slow = container.ContainerSpec(args=[sys.executable, "-c",
                                         script.format(30, 0)])
    runner = container.ContainerRunner("exec")
    runner.IDLE_TIMEOUT = 0.5
    lines = []
    with pytest.raises(container.ContainerError, match="no output line"):
        for ln in runner.stream(slow):
            lines.append(ln)
    assert lines == ["a"]
    with pytest.raises(container.ContainerError, match="no output line"):
        list(container.ContainerRunner("exec").stream(slow, timeout=0.5))
    out = container.ContainerRunner("exec").run(container.ContainerSpec(
        args=[sys.executable, "-c", "print('x\\r\\ny', end='')"],
        env={"K": "v"}))
    assert out == "x\ny"
