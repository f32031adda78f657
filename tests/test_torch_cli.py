"""The port's CLI (`transferia_tpu_torch/cli/`) against the JAX package's,
on the CPU (`--device cpu`: the kernels' plain versions).

- `parse_transfer_yaml`: `Transfer.to_dict()` equal across the packages
  on every `examples/*.yaml` and on the cases of
  `tests/e2e/test_cli.py` (environment substitution and defaults, a
  missing variable, unknown keys, an unknown provider).
- The round trips of `Transfer`, `EndpointParams`, `ChangeItem` and
  `TableSchema`, each equal to the JAX package's.
- Commands: `validate` (exit code and output) on the examples,
  `describe` on every provider both packages register, `typesystem-docs`,
  `activate`/`upload`/`sniff` on a sample -> memory transfer (equal
  target rows), `replicate` PG -> PG through each package's own fakes
  (stopped by SIGTERM; equal target rows, DDL objects and fences), the
  memory coordinator's refusal of `--job-count 2`, the filestore
  coordinator (`activate` and `checksum --against-operation`; the
  sharded runs are in tests/test_torch_sharded.py), the s3 coordinator
  (`activate` over each package's fake S3), the left-out `flight`
  exiting 2 naming its item, `chaos` (a seeded snapshot trial with the
  JAX report, a bad `--spec` exiting 2) and `check` (the JAX exit codes
  on a fixture tree), `trace` on the demo transfer, the
  health port's panes, the log sanitizer, and the device rule: without a
  card the CLI raises unless `--device cpu`.
- The fleet commands: `worker --max-tickets` and `--idle-exit` on a
  filestore queue (equal ticket states and sink rows), `fleet bench
  --json` (every field but the timings and the lag histogram's count), `top --fleet`, `slo --fleet`,
  `trace --fleet` and `explain <transfer-id>` over the segments those
  workers exported, `slo --demo` and `explain demo`, and the health
  port's `/debug/fleet`, `/debug/fleet/obs` and `/debug/slo`.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

from tests.recipes.fake_postgres import FakePG as RefFakePG
from tests.recipes.fake_postgres import FakeTable as RefFakeTable
from tests.torch_quiescent import ledger_quiescent  # noqa: F401
from transferia_tpu.abstract import change_item as ref_ci
from transferia_tpu.abstract import schema as ref_schema
from transferia_tpu.cli import config as ref_config
from transferia_tpu.cli import main as ref_main
from transferia_tpu.models import endpoint as ref_endpoint
from transferia_tpu.models import transfer as ref_transfer
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.utils import logsanitize as ref_san
from transferia_tpu_torch.abstract import change_item as port_ci
from transferia_tpu_torch.abstract import schema as port_schema
from transferia_tpu_torch.cli import config as port_config
from transferia_tpu_torch.cli import main as port_main
from transferia_tpu_torch.models import endpoint as port_endpoint
from transferia_tpu_torch.models import transfer as port_transfer
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.recipes.fake_postgres import FakePG, FakeTable
from transferia_tpu_torch.utils import logsanitize as port_san

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted(ROOT.glob("examples/*.yaml"))
EXAMPLE_ENV = {"PG_PASSWORD": "pw", "MASK_SALT": "salt",
               "ORACLE_PASSWORD": "pw",
               "MYSQL_PASSWORD": "pw", "PII_SALT": "pii"}

YAML = """
id: yaml-test
type: SNAPSHOT_ONLY
src:
  type: sample
  params:
    preset: users
    table: people
    rows: 50
    batch_rows: 25
dst:
  type: memory
  params:
    sink_id: {sink}
transformation:
  transformers:
    - mask_field: {{columns: [email], salt: "${{TEST_MASK_SALT:fallback}}"}}
runtime:
  process_count: 2
"""


def run(pkg: str, argv: list) -> tuple:
    """(exit code, stdout, stderr) of a package's CLI main in this
    process; the port's on the CPU."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        if pkg == "port":
            rc = port_main.main(["--device", "cpu", "--log-level", "error"]
                                + argv)
        else:
            rc = ref_main.main(["--log-level", "error"] + argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture
def example_env(monkeypatch):
    for k, v in EXAMPLE_ENV.items():
        monkeypatch.setenv(k, v)


# -- parse_transfer_yaml -------------------------------------------------------

@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_examples_parse_equal_to_jax(path, example_env):
    want = ref_config.load_transfer(str(path)).to_dict()
    got = port_config.load_transfer(str(path))
    assert got.to_dict() == want
    assert got.validation == ref_config.load_transfer(str(path)).validation


@pytest.mark.parametrize("salt", [None, "from-env"])
def test_env_substitution_and_default_equal_jax(salt, monkeypatch):
    if salt is None:
        monkeypatch.delenv("TEST_MASK_SALT", raising=False)
    else:
        monkeypatch.setenv("TEST_MASK_SALT", salt)
    text = YAML.format(sink="cli_store")
    got = port_config.parse_transfer_yaml(text)
    assert got.to_dict() == ref_config.parse_transfer_yaml(text).to_dict()
    assert got.transformation["transformers"][0]["mask_field"]["salt"] == \
        (salt or "fallback")


@pytest.mark.parametrize("text,match", [
    ('id: x\nsrc: {type: sample, params: {table: "${NOPE_VAR}"}}\n'
     "dst: {type: stdout}\n", "NOPE_VAR"),
    ("id: x\nbogus_key: 1\nsrc: {type: sample}\ndst: {type: stdout}\n",
     "unknown config keys"),
    ("id: x\nsrc: {type: oracle9i}\ndst: {type: stdout}\n",
     "unknown endpoint"),
    ("id: x\nsrc: {type: sample}\n", "missing required key 'dst'"),
    ("id: x\ntype: SOMETIMES\nsrc: {type: sample}\ndst: {type: stdout}\n",
     "bad transfer type"),
    ("- a\n- b\n", "must be a YAML mapping"),
])
def test_config_errors_equal_jax(text, match):
    errs = []
    for mod in (port_config, ref_config):
        with pytest.raises(mod.ConfigError, match=match) as e:
            mod.parse_transfer_yaml(text)
        errs.append(str(e.value))
    if match != "unknown endpoint":   # the known endpoints differ
        assert errs[0] == errs[1]


def test_yaml_outside_the_subset_is_a_config_error():
    with pytest.raises(port_config.ConfigError, match="line 2"):
        port_config.parse_transfer_yaml(
            "id: x\nsrc: &a {type: sample}\ndst: {type: stdout}\n")


# -- round trips -----------------------------------------------------------------

def endpoint_classes():
    from transferia_tpu.providers import load_builtin_providers as ref_load
    from transferia_tpu_torch.providers import load_builtin_providers

    ref_load()
    load_builtin_providers()
    return sorted(port_endpoint._ENDPOINT_REGISTRY)


@pytest.mark.parametrize("key", endpoint_classes(),
                         ids=lambda k: "/".join(k))
def test_endpoint_round_trip_equals_jax(key):
    port_cls = port_endpoint._ENDPOINT_REGISTRY[key]
    ref_cls = ref_endpoint._ENDPOINT_REGISTRY[key]
    d = port_cls().to_dict()
    assert d == ref_cls().to_dict()
    back = port_endpoint.endpoint_from_dict(d)
    assert type(back) is port_cls and back.to_dict() == d
    d2 = dict(d, cleanup_policy="truncate", not_a_field=1)
    assert port_cls.from_dict(d2).to_dict() == ref_cls.from_dict(d2).to_dict()


def test_endpoint_from_dict_unknown_raises_keyerror():
    with pytest.raises(KeyError, match="unknown endpoint"):
        port_endpoint.endpoint_from_dict({"__provider__": "nope"})


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_transfer_round_trip_equals_jax(path, example_env):
    t = port_config.load_transfer(str(path))
    t.regular_snapshot.incremental.append(
        port_transfer.IncrementalTableCfg("public", "t", "id", "7"))
    t.data_objects.include_object_ids.append("public.t")
    t.labels["team"] = "a"
    d = t.to_dict()
    back = port_transfer.Transfer.from_dict(json.loads(json.dumps(d)))
    assert back.to_dict() == d
    assert ref_transfer.Transfer.from_dict(d).to_dict() == d


def change_items(pkg):
    ci, sch = (port_ci, port_schema) if pkg == "port" else (ref_ci,
                                                           ref_schema)
    schema = sch.TableSchema([
        sch.ColSchema("id", sch.CanonicalType.INT64, primary_key=True,
                      required=True, original_type="pg:bigint"),
        sch.ColSchema("url", sch.CanonicalType.UTF8, path="a.b"),
        sch.ColSchema("score", sch.CanonicalType.DOUBLE,
                      expression="x + 1")])
    return [
        ci.ChangeItem(kind=ci.Kind.INSERT, schema="public", table="t",
                      column_names=("id", "url", "score"),
                      column_values=(1, "u", 1.5), table_schema=schema,
                      lsn=7, commit_time_ns=9, txn_id="tx", counter=3),
        ci.ChangeItem(kind=ci.Kind.UPDATE, schema="public", table="t",
                      column_names=("id", "url", "score"),
                      column_values=(2, None, 2.0), table_schema=schema,
                      old_keys=ci.OldKeys(("id",), (1,))),
        ci.ChangeItem(kind=ci.Kind.DELETE, schema="", table="t",
                      old_keys=ci.OldKeys(("id",), (5,))),
    ]


def test_change_item_and_schema_round_trips_equal_jax():
    ports, refs = change_items("port"), change_items("jax")
    for p, r in zip(ports, refs):
        j = json.loads(json.dumps(p.to_json()))
        assert j == r.to_json()
        assert port_ci.ChangeItem.from_json(j) == p
        assert port_ci.ChangeItem.from_json(j).to_json() == \
            ref_ci.ChangeItem.from_json(j).to_json()
        if p.table_schema is not None:
            sj = p.table_schema.to_json()
            assert port_schema.TableSchema.from_json(sj) == p.table_schema
            assert sj == ref_schema.TableSchema.from_json(sj).to_json()


# -- commands ----------------------------------------------------------------------

@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_validate_equals_jax(path, example_env):
    got = run("port", ["validate", "--transfer", str(path)])
    want = run("jax", ["validate", "--transfer", str(path)])
    assert got[:2] == want[:2]
    assert got[0] == 0 and got[1].startswith("OK: ")


def test_validate_missing_variable_and_bad_chain_equal_jax(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("id: x\nsrc: {type: nope}\ndst: {type: stdout}\n")
    chain = tmp_path / "chain.yaml"
    chain.write_text("id: x\nsrc: {type: sample}\ndst: {type: stdout}\n"
                     "transformation: {transformers: [{no_such_tf: {}}]}\n")
    for path in (bad, chain):
        got = run("port", ["validate", "--transfer", str(path)])
        want = run("jax", ["validate", "--transfer", str(path)])
        assert got[0] == want[0] == 1
        assert got[2].split(":")[0] == want[2].split(":")[0]


def common_providers():
    from transferia_tpu_torch.providers import load_builtin_providers

    load_builtin_providers()
    return sorted({p for p, _ in port_endpoint._ENDPOINT_REGISTRY})


@pytest.mark.parametrize("provider", common_providers())
def test_describe_equals_jax(provider):
    got = run("port", ["describe", "--provider", provider])
    want = run("jax", ["describe", "--provider", provider])
    assert got[0] == want[0] == 0
    assert json.loads(got[1]) == json.loads(want[1])


def test_typesystem_docs_equal_jax(tmp_path):
    assert run("port", ["typesystem-docs", "--out",
                        str(tmp_path / "port")])[0] == 0
    assert run("jax", ["typesystem-docs", "--out",
                       str(tmp_path / "jax")])[0] == 0
    port_docs = {p.name: p.read_text() for p in (tmp_path / "port").iterdir()}
    ref_docs = {p.name: p.read_text() for p in (tmp_path / "jax").iterdir()}
    assert port_docs
    for name, text in port_docs.items():
        assert text == ref_docs[name], name


def memory_rows(store) -> list:
    return sorted(tuple(sorted(it.as_dict().items())) for it in store.rows())


@pytest.mark.parametrize("command", ["activate", "upload", "reupload"])
def test_snapshot_commands_equal_jax(command, tmp_path, monkeypatch):
    monkeypatch.delenv("TEST_MASK_SALT", raising=False)
    rows = {}
    for pkg, mem in (("port", port_memory), ("jax", ref_memory)):
        sink = f"cli_{command}_{pkg}"
        path = tmp_path / f"{pkg}.yaml"
        path.write_text(YAML.format(sink=sink))
        store = mem.get_store(sink)
        store.clear()
        argv = [command, "--transfer", str(path)]
        if command == "upload":
            argv += ["--table", "sample.people"]
        rc, out, _ = run(pkg, argv)
        assert rc == 0 and "transfer yaml-test: " in out
        rows[pkg] = memory_rows(store)
        assert len(rows[pkg]) == 50
    assert rows["port"] == rows["jax"]


def test_sniff_equals_jax(tmp_path):
    path = tmp_path / "t.yaml"
    path.write_text(YAML.format(sink="cli_sniff"))
    got = run("port", ["sniff", "--transfer", str(path), "--rows", "3"])
    want = run("jax", ["sniff", "--transfer", str(path), "--rows", "3"])
    assert got[0] == want[0] == 0
    assert json.loads(got[1]) == json.loads(want[1])


def test_add_and_remove_tables_commands(tmp_path):
    path = tmp_path / "t.yaml"
    path.write_text(YAML.format(sink="cli_ops") +
                    'data_objects: ["sample.people"]\n')
    for pkg in ("port", "jax"):
        rc, out, _ = run(pkg, ["add-tables", "--transfer", str(path),
                               "--table", "sample.people"])
        assert rc == 0 and "added 1 table(s)" in out
        with pytest.raises(ValueError, match="empty"):
            run(pkg, ["remove-tables", "--transfer", str(path), "--table",
                      "sample.people"])


def test_memory_coordinator_refuses_sharding_as_jax(tmp_path):
    path = tmp_path / "t.yaml"
    path.write_text(YAML.format(sink="cli_refuse"))
    msgs = []
    for pkg in ("port", "jax"):
        with pytest.raises(SystemExit, match="job-count") as e:
            run(pkg, ["--job-count", "2", "activate", "--transfer",
                      str(path)])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("argv,item", [
    (["flight"], "A7"), (["flight", "serve", "--port", "0"], "A7"),
    (["flight", "bench"], "A7"),
    (["flight", "bench", "--rows", "100"], "A7"),
])
def test_left_out_commands_exit_2_naming_their_item(argv, item):
    rc, out, err = run("port", argv)
    assert rc == 2 and not out
    assert f"ROADMAP.md {item}" in err and "not ported" in err
    # what stays out, and nothing else: flight alone
    assert sorted(port_main.LEFT_OUT) == ["flight"]


def test_chaos_runs_on_the_cpu_as_jax():
    """`chaos --device cpu` runs its trials and exits 0 with the JAX
    package's report for the same seed (the port's skips aside)."""
    argv = ["chaos", "--mode", "snapshot", "--trials", "1", "--seed", "7",
            "--rows", "512", "--json"]
    got, want = run("port", argv), run("jax", argv)
    assert got[0] == want[0] == 0
    port, ref = json.loads(got[1]), json.loads(want[1])
    for d in (port, ref):
        for r in d["results"]:
            r.pop("seconds")
    assert port.pop("skipped") == []
    for r in port["results"]:
        assert r.pop("skipped") == []
    assert port == ref and port["passed"]


@pytest.mark.parametrize("spec", ["bogus.site=times:1",
                                  "sink.push=after:x",
                                  "sink.push=raise:NoSuchError"])
def test_chaos_bad_spec_exits_2_as_jax(spec):
    got = run("port", ["chaos", "--spec", spec])
    want = run("jax", ["chaos", "--spec", spec])
    assert got[0] == want[0] == 2
    assert got[1] == want[1] == ""
    assert got[2] == want[2] and got[2].startswith("bad --spec:")


def test_check_strict_exits_as_jax_on_a_fixture_tree(tmp_path,
                                                     monkeypatch):
    """`check` through each package's CLI on the same tree: a silent
    swallow reports and exits 0, fails --strict with 1, and a bad rule
    id exits 2; a clean tree passes --strict."""
    from transferia_tpu.analysis import cli as ref_check
    from transferia_tpu_torch.analysis import cli as port_check

    bad = "def f():\n    try:\n        g()\n    except Exception:\n" \
          "        pass\n"
    for pkg, mod, root in (("port", port_check, "transferia_tpu_torch"),
                           ("jax", ref_check, "transferia_tpu")):
        (tmp_path / pkg / root).mkdir(parents=True)
        (tmp_path / pkg / root / "bad.py").write_text(bad)
        monkeypatch.setattr(mod, "repo_root",
                            lambda p=pkg: str(tmp_path / p))
    results = {}
    for argv in (["check", "--baseline", "none"],
                 ["check", "--strict", "--baseline", "none"],
                 ["check", "--rules", "NOPE42"]):
        got, want = run("port", argv), run("jax", argv)
        assert got[0] == want[0]
        assert got[1].replace("transferia_tpu_torch", "transferia_tpu") \
            == want[1]
        results[argv[1]] = got[0]
    assert results == {"--baseline": 0, "--strict": 1, "--rules": 2}
    for pkg, root in (("port", "transferia_tpu_torch"),
                      ("jax", "transferia_tpu")):
        (tmp_path / pkg / root / "bad.py").write_text("x = 1\n")
    assert run("port", ["check", "--strict", "--baseline", "none"])[0] \
        == run("jax", ["check", "--strict", "--baseline", "none"])[0] == 0


def obs_segments(fake) -> list:
    """The fleet observability segments in a fake bucket that the run's
    timing does not decide: each final segment's key, its sequence
    number cut off, with its kind and worker.  The heartbeat's periodic
    segments fire on its 5-s timer, and a part's export is skipped while
    another export holds the exporter's lock, so those (and the
    sequence numbers they take) are left out; every segment present is
    one of the three kinds."""
    out = []
    for key in sorted(k for k in fake.objects if "/obs/" in k):
        seg = json.loads(fake.objects[key][0])
        assert seg["kind"] in ("part", "periodic", "final"), seg["kind"]
        if seg["kind"] == "final":
            out.append((key.rsplit("-", 1)[0], seg["kind"], seg["worker"]))
    return out


@pytest.mark.parametrize("kind,item", [("s3", "A7")])
def test_left_out_coordinators_name_their_item(kind, item, tmp_path,
                                               monkeypatch):
    """The s3 coordinator, once left out under ROADMAP.md A7, is ported:
    `activate` on it over each package's fake S3 equals the JAX CLI's
    (target rows, the operation's state and parts in the bucket), and
    without a bucket both exit naming the flag."""
    from tests.recipes.fake_s3 import FakeS3 as RefFakeS3
    from transferia_tpu.coordinator import S3Coordinator as RefS3
    from transferia_tpu_torch.coordinator import S3Coordinator
    from transferia_tpu_torch.recipes.fake_s3 import FakeS3

    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "test-ak")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "test-sk")
    # no export coalesced by the clock: each part's is made
    monkeypatch.setenv("TRANSFERIA_TPU_OBS_INTERVAL", "0")
    path = tmp_path / "t.yaml"
    path.write_text(YAML.format(sink="cli_coord"))
    got = {}
    for pkg, mem, fake_cls, cp_cls in (
            ("port", port_memory, FakeS3, S3Coordinator),
            ("jax", ref_memory, RefFakeS3, RefS3)):
        with pytest.raises(SystemExit, match="--coordinator-bucket"):
            run(pkg, ["--coordinator", kind, "activate", "--transfer",
                      str(path)])
        fake = fake_cls().start()
        try:
            mem.get_store("cli_coord").clear()
            rc, out, _ = run(pkg, [
                "--coordinator", kind, "--coordinator-bucket", "cp",
                "--coordinator-endpoint", fake.endpoint,
                "--coordinator-prefix", "pods", "activate", "--transfer",
                str(path)])
            cp = cp_cls(bucket="cp", endpoint=fake.endpoint, prefix="pods")
            got[pkg] = (rc, out, memory_rows(mem.get_store("cli_coord")),
                        cp.get_operation_state("op-yaml-test"),
                        sorted((p.key(), p.completed, p.completed_rows)
                               for p in cp.operation_parts("op-yaml-test")),
                        sorted(k.split("/")[1] for k in fake.objects),
                        obs_segments(fake))
        finally:
            fake.stop()
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0 and len(got["port"][2]) == 50
    assert len(got["port"][6]) == 1   # the one final export


def test_filestore_coordinator_needs_its_dir_as_jax(tmp_path):
    path = tmp_path / "t.yaml"
    path.write_text(YAML.format(sink="cli_fs_nodir"))
    msgs = []
    for pkg in ("port", "jax"):
        with pytest.raises(SystemExit, match="coordinator-dir") as e:
            run(pkg, ["--coordinator", "filestore", "activate",
                      "--transfer", str(path)])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_filestore_activation_equals_jax(tmp_path):
    """`activate` on the filestore coordinator: equal target rows, and
    the operation's parts and fingerprints on disk, where a later
    process (the checksum) reads them."""
    from transferia_tpu.coordinator import FileStoreCoordinator as RefFS
    from transferia_tpu_torch.coordinator import FileStoreCoordinator

    path = tmp_path / "t.yaml"
    path.write_text(YAML.format(sink="cli_fs") +
                    "validation: {fingerprint: true}\n")
    got = {}
    for pkg, mem, fs in (("port", port_memory, FileStoreCoordinator),
                         ("jax", ref_memory, RefFS)):
        mem.get_store("cli_fs").clear()
        root = str(tmp_path / pkg)
        rc, out, _ = run(pkg, ["--coordinator", "filestore",
                               "--coordinator-dir", root, "activate",
                               "--transfer", str(path)])
        assert rc == 0 and "activated" in out
        cp = fs(root=root)
        got[pkg] = (sorted(tuple(r.column_values)
                           for r in mem.get_store("cli_fs").rows()),
                    cp.get_operation_state("op-yaml-test"),
                    cp.operation_progress("op-yaml-test").done)
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 50 and got["port"][2]


def test_checksum_against_operation_without_fingerprints_as_jax(tmp_path):
    path = tmp_path / "t.yaml"
    path.write_text(YAML.format(sink="cli_against"))
    outs = []
    for pkg in ("port", "jax"):
        outs.append(run(pkg, ["--coordinator", "filestore",
                              "--coordinator-dir", str(tmp_path / pkg),
                              "checksum", "--transfer", str(path),
                              "--against-operation", "op-1"]))
    assert outs[0] == outs[1]
    assert outs[0][0] == 2 and "op-1: no recorded fingerprints" in \
        outs[0][2]


@pytest.mark.parametrize("argv", [
    ["describe", "--bogus"],
    # the s3 coordinator's options, known now that it is ported
    ["--coordinator-endpoint", "http://s3", "describe"],
    ["--coordinator-bucket", "b", "describe"],
])
def test_unknown_argument_is_refused(argv):
    if argv[0].startswith("--coordinator-"):
        # accepted as the JAX CLI accepts them (describe ignores them)
        got, want = run("port", argv), run("jax", argv)
        assert got[0] == want[0] == 0
        assert json.loads(got[1]).keys() <= json.loads(want[1]).keys()
        return
    with pytest.raises(SystemExit) as e:
        run("port", argv)
    assert e.value.code == 2


def test_cli_needs_a_card_unless_device_cpu(tmp_path):
    """Without a card every command raises unless --device cpu."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.main(["describe"])
    env = dict(os.environ, PG_PASSWORD="x")
    proc = subprocess.run(
        [sys.executable, "-m", "transferia_tpu_torch.cli.main", "validate",
         "--transfer", str(ROOT / "examples/pg2ch.yaml")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "transferia_tpu_torch.cli.main", "--device",
         "cpu", "validate", "--transfer", str(ROOT / "examples/pg2ch.yaml")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0
    assert proc.stdout.startswith("OK: pg2ch (SNAPSHOT_AND_INCREMENT)")


def test_trace_demo_writes_a_timeline(tmp_path):
    out = tmp_path / "trace.json"
    rc, text, _ = run("port", ["trace", "--rows", "2000", "--out", str(out)])
    assert rc == 0 and "events ->" in text and "device telemetry" in text
    doc = json.loads(out.read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"snapshot_op", "part"} <= names


# -- the health port ------------------------------------------------------------------

def test_health_port_panes():
    from transferia_tpu_torch.stats import fleetobs, trace

    fleetobs.unregister_runtime()
    srv = port_main._start_health_server(0)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        def get(path):
            try:
                with urllib.request.urlopen(base + path, timeout=60) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        assert get("/health") == (200, b'{"status":"ok"}')
        assert get("/nope")[0] == 404
        status, body = get("/debug/ledger")
        assert status == 200 and "totals" in json.loads(body)
        status, body = get("/debug/trace?seconds=0.1")
        assert status == 200 and "traceEvents" in json.loads(body)
        assert not trace.enabled()
        status, body = get("/debug/profile?seconds=0.2")
        assert status == 200 and body
        status, body = get("/debug/threads")
        assert status == 200 and b"Thread" in body
        # the fleet panes (their content against the JAX package's in
        # test_fleet_health_panes_equal_jax)
        status, body = get("/debug/slo")
        assert status == 200 and "objectives" in json.loads(body)
        status, body = get("/debug/fleet")
        assert status == 200 and "schedulers" in json.loads(body)
        status, body = get("/debug/fleet/obs")
        assert status == 503 and "no obs runtime" in json.loads(body)["error"]
    finally:
        srv.shutdown()


def test_chrome_trace_chunks_equal_jax():
    from transferia_tpu.stats import trace as ref_trace
    from transferia_tpu_torch.stats import trace as port_trace

    doc = {"traceEvents": [{"name": f"e{i}", "ph": "X", "ts": i, "dur": 1}
                           for i in range(500)],
           "displayTimeUnit": "ms", "otherData": {"a": 1}}
    for size in (64, 1024, 1 << 20):
        got = list(port_trace.iter_chrome_trace_chunks(doc, size))
        assert got == list(ref_trace.iter_chrome_trace_chunks(doc, size))
        assert json.loads("".join(got)) == doc


@pytest.mark.parametrize("limit", [1 << 30, 3_000_000_007])
def test_memory_watchdog_equals_jax(limit, monkeypatch):
    """The CLI's watchdog classifies each RSS sample as the JAX package's
    does at its default fractions, hit counts included."""
    from transferia_tpu.runtime import limits as ref_limits
    from transferia_tpu_torch.runtime import limits as port_limits

    samples = [0, int(limit * 0.5), int(limit * 0.8) - 1, int(limit * 0.8),
               int(limit * 0.9), int(limit * 0.95) - 1, int(limit * 0.95),
               limit, 2 * limit, 1]
    rss = {"v": 0}
    monkeypatch.setattr(port_limits, "process_rss", lambda: rss["v"])
    port = port_limits.MemoryWatchdog(limit)
    ref = ref_limits.MemoryWatchdog(limit, rss_fn=lambda: rss["v"])
    for rss["v"] in samples:
        assert port.check_once() == ref.check_once(), rss["v"]
    assert (port.soft, port.hard) == (ref.soft, ref.hard)
    assert (port.soft_hits, port.hard_hits) == (ref.soft_hits,
                                                ref.hard_hits) == (3, 3)


def test_resource_limits_start_one_watchdog_a_process(monkeypatch):
    import gc

    from transferia_tpu_torch.runtime import limits as port_limits

    monkeypatch.setattr(port_limits, "_applied", False)
    monkeypatch.setattr(port_limits, "_watchdog", None)
    monkeypatch.setattr(port_limits, "cgroup_memory_limit", lambda: 1 << 40)
    threshold = gc.get_threshold()
    try:
        first = port_limits.apply_resource_limits()
        assert first is not None and first.limit == 1 << 40
        for _ in range(3):
            assert port_limits.apply_resource_limits() is first
        assert gc.get_threshold() == (400, 10, 10)
    finally:
        gc.set_threshold(*threshold)
    names = [t.name for t in threading.enumerate()]
    assert names.count("memory-watchdog") == 1


@pytest.mark.parametrize("text", [
    "password=hunter2 user=x", 'connect "token": "abc.def" ok',
    "dsn postgres://u:secret@h:5432/db", "Authorization: Bearer abcdefghij",
    "api-key: k1, secret_access_key=zz; x", "plain message", "x" * 40_000,
])
def test_log_sanitizer_equals_jax(text):
    assert port_san.sanitize(text) == ref_san.sanitize(text)
    import logging

    recs = []
    for mod in (port_san, ref_san):
        rec = logging.LogRecord("t", logging.INFO, "f", 1, "%s", (text,),
                                None)
        mod.SanitizingFilter(max_len=1000).filter(rec)
        recs.append(rec.getMessage())
    assert recs[0] == recs[1]


# -- replicate, PG -> PG, each package over its own fakes --------------------------

HITS = [("id", "bigint", True, True), ("url", "text", False, False),
        ("region", "integer", False, False),
        ("score", "double precision", False, False)]
PG2PG = """
id: cli-pg2pg
type: SNAPSHOT_AND_INCREMENT
src:
  type: pg
  params: {{host: 127.0.0.1, port: {src}, schemas: [public], transfer_ddl: true}}
dst:
  type: pg
  params: {{host: 127.0.0.1, port: {dst}}}
transformation:
  transformers:
    - mask_field: {{columns: [url], salt: cli}}
    - filter_rows: {{filter: "region < 400 AND score >= 10"}}
"""


def hits(n):
    return [{"id": str(i), "url": f"https://e.test/{i % 97}",
             "region": str(i % 500), "score": f"{(i % 91) * 1.5}"}
            for i in range(n)]


def changes():
    out = []
    for k in range(1000, 1012):
        out.append(("I", k, (k, f"https://n/{k}", k % 450, (k % 30) * 1.5)))
    for k in (15, 16, 400, 401):
        out.append(("U", k, (k, f"https://u/{k}", 7, 33.0)))
    out.append(("U", 17, (17, "https://u/17", 450, 33.0)))  # filtered out
    for k in (20, 21, 450):
        out.append(("D", k, None))
    return out


def feed(pg, chg):
    pk = [{"name": "id", "type": "bigint"}]
    pg.feed_wal(json.dumps({"action": "B"}).encode())
    for kind, k, row in chg:
        msg = {"action": kind, "schema": "public", "table": "hits",
               "pk": pk}
        if row is not None:
            msg["columns"] = [{"name": c[0], "type": c[1], "value": v}
                              for c, v in zip(HITS, row)]
        if kind != "I":
            msg["identity"] = [{"name": "id", "type": "bigint", "value": k}]
        pg.feed_wal(json.dumps(msg).encode())
    pg.feed_wal(json.dumps({"action": "C"}).encode())
    return pg.wal[-1][0]


def replicate(pkg, tmp_path):
    fake, table = (FakePG, FakeTable) if pkg == "port" else (RefFakePG,
                                                             RefFakeTable)
    src, dst = fake().start(), fake().start()
    try:
        src.add_table(table("public", "hits", HITS, hits(600)))
        src.indexes.append(("public", "hits", "hits_r",
                            "CREATE INDEX hits_r ON public.hits (region)"))
        src.views.append(("public", "v", " SELECT id FROM public.hits;"))
        src.sequences.append(("public", "s", 1, 1, 600))
        path = tmp_path / f"{pkg}.yaml"
        path.write_text(PG2PG.format(src=src.port, dst=dst.port))
        done = threading.Event()

        def watch():
            deadline = time.monotonic() + 120
            while not src.slots and not done.is_set() and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
            if done.is_set() or not src.slots:
                return
            last = feed(src, changes())
            while src.flushed_lsn < last and not done.is_set() and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
            if not done.is_set():
                os.kill(os.getpid(), signal.SIGTERM)
            # the JAX package's source sees its stop only at its next
            # WAL message (ROADMAP.md C4): logical messages wake it
            while not done.wait(0.2):
                src.feed_wal(json.dumps({"action": "M"}).encode())

        previous = {s: signal.getsignal(s)
                    for s in (signal.SIGINT, signal.SIGTERM)}
        w = threading.Thread(target=watch, daemon=True)
        w.start()
        try:
            rc, out, err = run(pkg, ["replicate", "--transfer", str(path)])
        finally:
            done.set()
            for s, h in previous.items():
                signal.signal(s, h)
        w.join(10)
        assert rc == 0, err
        rows = sorted(tuple(r.get(c) for c in ("id", "url", "region",
                                               "score"))
                      for r in dst.tables[("public", "hits")].rows)
        fences = sorted(r["part_key"] for r in
                        dst.tables[("public", "__trtpu_commits")].rows)
        staging = sorted(n for _, n in dst.tables if "stg" in n)
        return rows, fences, staging, list(dst.executed_ddl)
    finally:
        src.stop()
        dst.stop()


def test_replicate_pg_to_pg_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("TRANSFERIA_TPU_MVCC_SPILL", "0")
    got = replicate("port", tmp_path)
    want = replicate("jax", tmp_path)
    assert got == want
    rows, fences, staging, ddl = got
    ids = {int(r[0]) for r in rows}
    assert {1000, 1011} <= ids and not {20, 21, 450} & ids
    assert fences == ["mvcc_public.hits"] and staging == []
    assert len(ddl) == 4


def test_regular_snapshot_command_equals_jax(tmp_path, monkeypatch):
    """`regular-snapshot --max-runs 1` on a clock 0.3 s before a minute's
    start (the cron's next match), each package into its memory sink;
    the sample source keeps no cursors, so both load every row."""
    real, offset = time.time, [0.0]
    monkeypatch.setattr(time, "time", lambda: real() + offset[0])
    rows = {}
    for pkg, mem in (("port", port_memory), ("jax", ref_memory)):
        sink = f"cli_regular_{pkg}"
        path = tmp_path / f"{pkg}.yaml"
        path.write_text(YAML.format(sink=sink) + (
            "regular_snapshot:\n  enabled: true\n  cron: \"* * * * *\"\n"
            "  incremental:\n    - {namespace: sample, name: people, "
            "cursor_field: user_id, initial_state: \"20\"}\n"))
        store = mem.get_store(sink)
        store.clear()
        now = real()
        offset[0] = (now // 60 + 1) * 60 - 0.3 - now
        rc, _, _ = run(pkg, ["regular-snapshot", "--transfer", str(path),
                             "--max-runs", "1"])
        assert rc == 0
        rows[pkg] = memory_rows(store)
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 50


def test_deactivate_drops_the_slot_as_jax(tmp_path):
    for pkg, fake in (("port", FakePG), ("jax", RefFakePG)):
        src = fake().start()
        try:
            src.slots["transferia_cli_pg2pg"] = "wal2json"
            path = tmp_path / f"{pkg}.yaml"
            path.write_text(PG2PG.format(src=src.port, dst=src.port))
            rc, out, _ = run(pkg, ["deactivate", "--transfer", str(path)])
            assert rc == 0 and "cli-pg2pg: deactivated" in out
            assert src.slots == {}
        finally:
            src.stop()


# -- the fleet commands -------------------------------------------------------

FLEET_CHAIN = {"transformers": [
    {"mask_field": {"columns": ["email"], "salt": "s"}},
    {"filter_rows": {"filter": "age >= 21"}},
]}
FLEET_MIX = [("a", "batch"), ("b", "scavenger"), ("a", "interactive"),
             ("c", "batch")]


def _pkg_modules(pkg):
    if pkg == "port":
        from transferia_tpu_torch.abstract.ticket import FleetTicket
        from transferia_tpu_torch.coordinator import FileStoreCoordinator
        from transferia_tpu_torch.stats import fleetobs, trace
        return FleetTicket, FileStoreCoordinator, port_memory, fleetobs, trace
    from transferia_tpu.abstract.ticket import FleetTicket
    from transferia_tpu.coordinator import FileStoreCoordinator
    from transferia_tpu.stats import fleetobs, trace
    return FleetTicket, FileStoreCoordinator, ref_memory, fleetobs, trace


def fleet_worker_run(pkg, root, monkeypatch):
    """Four `sample_snapshot` tickets on a filestore queue, drained by
    `worker --max-tickets 4` with tracing on; then the same worker
    command again with `--idle-exit` on the drained queue."""
    FleetTicket, FileStore, mem, fleetobs, trace = _pkg_modules(pkg)
    # the segments carry the process's cumulative ledger and histograms:
    # start them from nothing, as a fresh worker process would
    root_pkg = trace.__name__.split(".")[0]
    for mod, obj in (("stats.ledger", "LEDGER"), ("stats.hdr", "STAGES"),
                     ("stats.watermark", "WATERMARKS")):
        getattr(__import__(f"{root_pkg}.{mod}", fromlist=[obj]),
                obj).reset()
    trace.reset()
    cp = FileStore(root=str(root))
    for i, (tenant, qos) in enumerate(FLEET_MIX):
        mem.get_store(f"cli-fleet-{i}").clear()
        cp.enqueue_ticket("q", FleetTicket(
            ticket_id=f"t{i}", transfer_id=f"tr{i}", tenant=tenant,
            qos=qos, payload={
                "kind": "sample_snapshot", "rows": 400 + 100 * i,
                "preset": "users", "table": "users", "shard_parts": 2,
                "sink_id": f"cli-fleet-{i}", "operation_id": f"op-cf-{i}",
                "transformation": FLEET_CHAIN}))
    coord = ["--coordinator", "filestore", "--coordinator-dir", str(root)]
    monkeypatch.setenv("TRANSFERIA_TPU_TRACE", "1")
    try:
        first = run(pkg, coord + ["worker", "--queue", "q", "--worker-index",
                                  "0", "--heartbeat", "0.05",
                                  "--max-tickets", "4", "--idle-exit", "30"])
    finally:
        trace.enable(False)
        monkeypatch.delenv("TRANSFERIA_TPU_TRACE")
    idle = run(pkg, coord + ["worker", "--queue", "q", "--worker-index", "1",
                             "--idle-exit", "0.2"])
    fleetobs.unregister_runtime()
    tickets = []
    for t in cp.list_tickets("q"):
        d = t.to_json()
        for k in ("enqueued_at", "lease_expires_at", "completed_at"):
            d.pop(k)
        d["payload"] = {k: v for k, v in d["payload"].items()
                        if not k.startswith("_")}
        tickets.append(d)
    sinks = [memory_rows(mem.get_store(f"cli-fleet-{i}"))
             for i in range(len(FLEET_MIX))]
    for i in range(len(FLEET_MIX)):
        mem.get_store(f"cli-fleet-{i}").clear()
    return [first[0], first[1], idle, tickets, sinks]


@pytest.fixture(scope="module")
def fleet_dirs(tmp_path_factory):
    """Each package's filestore queue after `fleet_worker_run`."""
    mp = pytest.MonkeyPatch()
    dirs, got = {}, {}
    try:
        for pkg in ("port", "jax"):
            dirs[pkg] = tmp_path_factory.mktemp(f"fleet-{pkg}")
            got[pkg] = fleet_worker_run(pkg, dirs[pkg], mp)
    finally:
        mp.undo()
    return dirs, got


def test_worker_command_on_a_filestore_queue_equals_jax(fleet_dirs):
    _, got = fleet_dirs
    assert got["port"] == got["jax"]
    rc, out, idle, tickets, sinks = got["port"]
    assert rc == 0 and out == "worker w0: 4 ticket(s) run\n"
    assert idle == (0, "worker w1: 0 ticket(s) run\n", "")
    assert [t["state"] for t in tickets] == ["done"] * 4
    assert all(sinks)


def _fleet_cli(pkg, root, argv):
    return run(pkg, ["--coordinator", "filestore", "--coordinator-dir",
                     str(root)] + argv)


def test_top_fleet_equals_jax(fleet_dirs):
    """`top --fleet --json`: the same merged ledger per transfer and
    the same workers; `--once` renders the frame."""
    dirs, _ = fleet_dirs
    views = {}
    for pkg in ("port", "jax"):
        rc, out, _ = _fleet_cli(pkg, dirs[pkg], ["top", "--fleet", "--json"])
        assert rc == 0
        views[pkg] = json.loads(out)
        rc, out, _ = _fleet_cli(pkg, dirs[pkg], ["top", "--fleet", "--once"])
        assert rc == 0 and "fleet obs:" in out and "tr0" in out
    keys = ("rows_in", "rows_out", "tenant")
    for pkg, view in views.items():
        views[pkg] = (
            {tid: {k: e[k] for k in keys}
             for tid, e in sorted(view["transfers"].items())
             if tid.startswith("tr")},
            sorted(w.split(".")[1] for w in view["workers"]
                   if w.startswith("fleet.")),
            view["conservation"]["ok"])
    assert views["port"] == views["jax"]
    assert views["port"][0]["tr3"]["rows_out"] > 0


def test_slo_fleet_equals_jax(fleet_dirs):
    dirs, _ = fleet_dirs
    got = {}
    for pkg in ("port", "jax"):
        rc, out, _ = _fleet_cli(pkg, dirs[pkg], ["slo", "--fleet", "--json"])
        view = json.loads(out)
        got[pkg] = (rc, sorted(view["objectives"]), view["ok"],
                    view["scope"])
        rc2, text, _ = _fleet_cli(pkg, dirs[pkg], ["slo", "--fleet"])
        assert rc2 == rc and "slo:" in text
    assert got["port"] == got["jax"]


def test_trace_fleet_and_explain_transfer_equal_jax(fleet_dirs, tmp_path):
    """`trace --fleet tr1` and `explain tr1` over the exported spans: the
    same processes and span names in the timeline, the same stages on
    the critical path."""
    dirs, _ = fleet_dirs
    got = {}
    for pkg in ("port", "jax"):
        out_path = tmp_path / f"{pkg}.json"
        rc, text, _ = _fleet_cli(pkg, dirs[pkg], [
            "trace", "--fleet", "tr1", "--out", str(out_path)])
        doc = json.loads(out_path.read_text())
        names = sorted({e["name"] for e in doc["traceEvents"]
                        if e.get("ph") == "X"} - {"xla_compile"})
        rc_none, _, err = _fleet_cli(pkg, dirs[pkg], [
            "trace", "--fleet", "nope", "--out", str(out_path)])
        rc_x, ex_text, _ = _fleet_cli(pkg, dirs[pkg], [
            "explain", "tr1", "--json"])
        report = json.loads(ex_text)
        got[pkg] = (rc, "fleet conservation: OK" in text, names, rc_none,
                    "no spans matched" in err, rc_x,
                    report["attributed_pct"] >= 95.0,
                    sorted(report["stages"]), len(report["levers"]))
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0 and "part" in got["port"][2]


def _last_json(text: str) -> str:
    """The indented JSON document a command printed last."""
    return text[text.rindex("\n{\n") + 1:] if not text.startswith("{") \
        else text


def test_slo_demo_and_explain_demo_equal_jax():
    got = {}
    for pkg in ("port", "jax"):
        # the demo's stdout sink prints a few rows before the JSON
        rc, text, _ = run(pkg, ["slo", "--demo", "--rows", "3000", "--json"])
        view = json.loads(_last_json(text))
        rc2, ex, _ = run(pkg, ["explain", "demo", "--rows", "3000", "--json"])
        report = json.loads(_last_json(ex))
        got[pkg] = (rc, view["scope"], sorted(view["objectives"]), rc2,
                    report["attributed_pct"] >= 95.0,
                    report["transfer_id"] if "transfer_id" in report
                    else None)
    assert got["port"] == got["jax"]
    assert got["port"][3] == 0


def test_fleet_bench_json_equals_jax():
    timing = ("value", "wall_seconds", "dispatch_p50_ms", "dispatch_p99_ms",
              "dispatch_hdr_p50_ms", "dispatch_hdr_p99_ms",
              "dispatch_hdr_p999_ms", "dispatch_hdr_max_trace",
              "replication_lag_p99_ms", "pick_p50_us", "pick_p99_us",
              # a process-wide histogram's window: another test's thread
              # may publish into it
              "replication_lag_count")
    got = {}
    for pkg in ("port", "jax"):
        rc, out, _ = run(pkg, ["fleet", "bench", "--transfers", "24",
                               "--workers", "4", "--rows", "64", "--seed",
                               "5", "--json"])
        report = json.loads(out)
        got[pkg] = (rc, {k: v for k, v in report.items() if k not in timing})
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0 and got["port"][1]["completed"] == 24


def test_fleet_health_panes_equal_jax(fleet_dirs):
    """`/debug/fleet`, `/debug/fleet/obs` and `/debug/slo` with each
    package's runtime registered on its filestore queue."""
    dirs, _ = fleet_dirs
    got = {}
    for pkg, main in (("port", port_main), ("jax", ref_main)):
        FleetTicket, FileStore, _, fleetobs, _ = _pkg_modules(pkg)
        fleetobs.register_runtime(FileStore(root=str(dirs[pkg])),
                                  health_scope="fleet:q")
        srv = main._start_health_server(0)
        # the JAX package's returns the bound port, the port's the server
        bound = srv if isinstance(srv, int) else srv.server_address[1]
        base = f"http://127.0.0.1:{bound}"
        try:
            def get(path):
                with urllib.request.urlopen(base + path, timeout=60) as r:
                    return r.status, json.loads(r.read())

            st_f, fleet = get("/debug/fleet")
            st_o, obs = get("/debug/fleet/obs")
            st_s, slo = get("/debug/slo")
        finally:
            if not isinstance(srv, int):
                srv.shutdown()
            fleetobs.unregister_runtime()
        got[pkg] = (st_f, sorted(fleet), sorted(fleet["commits"]),
                    sorted(fleet.get("workers", {})), st_o,
                    {t: e["rows_out"] for t, e in obs["transfers"].items()
                     if t.startswith("tr")},
                    st_s, sorted(slo["objectives"]))
    assert got["port"] == got["jax"]
    assert got["port"][4] == 200 and got["port"][5]


# -- the Oracle and YTsaurus examples, each package over its own fakes --------

ORA_COLUMNS = [("ID", "NUMBER(10)", True, True),
               ("EMAIL", "VARCHAR2(64)", False, False),
               ("SCORE", "BINARY_FLOAT", False, False),
               ("BIG", "NUMBER(30)", False, False),
               ("CREATED", "DATE", False, False)]
YT_HITS = [{"name": "id", "type": "int64", "sort_order": "ascending"},
           {"name": "url", "type": "utf8"},
           {"name": "region", "type": "int32"},
           {"name": "payload", "type": "string"}]


def ora_rows(n: int, seed: int) -> list:
    import datetime as dt

    import numpy as np

    rng = np.random.default_rng(seed)
    score = rng.uniform(-1, 1, n).astype(np.float32)
    specials = (float("nan"), float("inf"), float("-inf"), -0.0, None)
    return [{"ID": i, "EMAIL": f"u{i}@example.test",
             "SCORE": specials[i % 5] if i % 9 == 0 else float(score[i]),
             "BIG": 10**25 + 2 * i + 1,
             "CREATED": dt.datetime(2020, 1, 1) + dt.timedelta(hours=i)}
            for i in range(n)]


def example_copy(name: str, tmp_path, subs: list) -> str:
    text = (ROOT / "examples" / name).read_text()
    for old, new in subs:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def fakes_of(pkg: str):
    if pkg == "port":
        from transferia_tpu_torch.recipes import fake_clickhouse as ch
        from transferia_tpu_torch.recipes import fake_oracle as ora
        from transferia_tpu_torch.recipes import fake_yt as yt
    else:
        from tests.recipes import fake_clickhouse as ch
        from tests.recipes import fake_oracle as ora
        from tests.recipes import fake_yt as yt
    return ora, yt, ch


def ch_table(ch, name: str) -> list:
    rows = ch.rows(name)
    return sorted((tuple(sorted((k, repr(v)) for k, v in r.items()))
                   for r in rows))


def test_oracle2ch_example_activates_equal_jax(tmp_path, monkeypatch):
    """examples/oracle2ch.yaml as it is but for the ports: 4 ROWID shards
    at one SCN, the mask and the SCORE filter into ClickHouse."""
    got = {}
    rows = ora_rows(1500, seed=31)
    for pkg in ("port", "jax"):
        ora, _, chmod = fakes_of(pkg)
        srv = ora.FakeOracle(service_name="XEPDB1", user="scott",
                             password="pw")
        srv.add_table(ora.FakeOraTable("SCOTT", "ACCOUNTS", ORA_COLUMNS,
                                       rows))
        srv.start()
        ch = chmod.FakeCH().start()
        try:
            (tmp_path / pkg).mkdir()
            path = example_copy("oracle2ch.yaml", tmp_path / pkg,
                                [("    port: 1521\n",
                                  f"    port: {srv.port}\n"),
                                 ("    port: 8123\n",
                                  f"    port: {ch.port}\n")])
            for k, v in {"ORACLE_HOST": "127.0.0.1", "ORACLE_PASSWORD": "pw",
                         "MASK_SALT": "ora-salt",
                         "CH_HOST": "127.0.0.1"}.items():
                monkeypatch.setenv(k, v)
            rc, out, err = run(pkg, ["activate", "--transfer", path])
            assert rc == 0, err
            scans = sorted(q for q in srv.queries if "ORA_HASH" in q)
            got[pkg] = (ch_table(ch, "SCOTT__ACCOUNTS"), scans)
        finally:
            srv.stop()
            ch.stop()
    assert got["port"] == got["jax"]
    table, scans = got["port"]
    import numpy as np

    want = [r["ID"] for r in rows if r["SCORE"] is not None and
            np.float32(r["SCORE"]) > np.float32(0.25)]
    assert len(table) == len(want) > 0
    assert len(scans) == 4 and all(" AS OF SCN 1000" in q for q in scans)


def test_yt2ch_example_activates_equal_jax(tmp_path, monkeypatch):
    """examples/yt2ch.yaml with its parts cut to 700 rows for 3,000: the
    mask on url and the int32 filter into ClickHouse."""
    got = {}
    hits = [{"id": i, "url": f"https://e.test/{i % 97}",
             "region": (i * 37) % 1000,
             "payload": bytes([i % 256, 255 - i % 256]).decode("latin-1")}
            for i in range(3000)]
    for pkg in ("port", "jax"):
        _, ytmod, chmod = fakes_of(pkg)
        yt, ch = ytmod.FakeYT().start(), chmod.FakeCH().start()
        yt.add_table("//home/db/hits", YT_HITS, hits)
        try:
            (tmp_path / pkg).mkdir()
            path = example_copy("yt2ch.yaml", tmp_path / pkg, [
                ("    port: 8123\n", f"    port: {ch.port}\n"),
                ("desired_part_rows: 125000", "desired_part_rows: 700")])
            for k, v in {"YT_PROXY": f"127.0.0.1:{yt.port}",
                         "MASK_SALT": "yt-salt",
                         "CH_HOST": "127.0.0.1"}.items():
                monkeypatch.setenv(k, v)
            rc, out, err = run(pkg, ["activate", "--transfer", path])
            assert rc == 0, err
            got[pkg] = (ch_table(ch, "hits"),
                        yt.requests.count("read_table"))
        finally:
            yt.stop()
            ch.stop()
    assert got["port"] == got["jax"]
    table, reads = got["port"]
    assert reads == 5
    assert len(table) == sum(1 for h in hits if h["region"] < 400)


def test_oracle2yt_dyn_example_replicates_equal_jax(tmp_path, monkeypatch):
    """examples/oracle2yt_dyn.yaml through `replicate`: the S&I activation
    into a sorted dynamic table of 4 tablets, then LogMiner redo fed once
    the tail mines (updates, a key-changing update, inserts, deletes, a
    CSF continuation), stopped by SIGTERM once the tail checkpointed the
    last SCN (polled on the fake's log, as each package's coordinator is
    its own process's memory)."""
    got = {}
    rows = ora_rows(800, seed=37)
    redo = [(3, 'update "SCOTT"."ACCOUNTS" set "EMAIL" = \'x@e.test\' '
                'where "ID" = 5 and "SCORE" IS NULL', 1),
            (3, 'update "SCOTT"."ACCOUNTS" set "ID" = 900 where "ID" = 7 '
                "and \"EMAIL\" = 'u7@example.test' and \"SCORE\" = "
                f"{rows[7]['SCORE']!r}", 1),
            (1, 'insert into "SCOTT"."ACCOUNTS"("ID","EMAIL","SCORE","BIG",'
                '"CREATED") values (1000, \'' + "n" * 300 + "@e.test', "
                "'Nan', 100000000000000000000000001, TO_DATE('2026-07-29 "
                "10:00:00', 'YYYY-MM-DD HH24:MI:SS'))", 4),
            (2, 'delete from "SCOTT"."ACCOUNTS" where "ID" = 11', 1),
            (2, 'delete from "SCOTT"."ACCOUNTS" where "ID" = 4242', 1)]
    for pkg in ("port", "jax"):
        ora, ytmod, _ = fakes_of(pkg)
        srv = ora.FakeOracle(service_name="XEPDB1", user="scott",
                             password="pw")
        srv.add_table(ora.FakeOraTable("SCOTT", "ACCOUNTS", ORA_COLUMNS,
                                       rows))
        srv.start()
        yt = ytmod.FakeYT().start()
        table = "//home/transfer/oracle/ACCOUNTS"
        if pkg == "port":
            yt.pivots_on_mount[table] = [[], [200], [400], [600]]
        try:
            (tmp_path / pkg).mkdir()
            path = example_copy("oracle2yt_dyn.yaml", tmp_path / pkg,
                                [("    port: 1521\n",
                                  f"    port: {srv.port}\n")])
            for k, v in {"ORACLE_HOST": "127.0.0.1",
                         "ORACLE_PASSWORD": "pw", "MASK_SALT": "ora-salt",
                         "YT_PROXY": f"127.0.0.1:{yt.port}"}.items():
                monkeypatch.setenv(k, v)
            done = threading.Event()
            last = []

            def mining():
                return any("v$logmnr_contents" in q.lower()
                           for q in list(srv.queries))

            def watch():
                deadline = time.monotonic() + 120
                while not mining() and not done.is_set() and \
                        time.monotonic() < deadline:
                    time.sleep(0.02)
                for op, sql, parts in redo:
                    last.append(srv.feed_redo("SCOTT", "ACCOUNTS", op, sql,
                                              csf_parts=parts))
                # the tail mines its checkpoint SCN again (SCN >=) after it
                # checkpointed the last row: the next START_LOGMNR at it
                marker = f"STARTSCN => {last[-1]},"
                while not any(marker in q for q in list(srv.queries)) and \
                        not done.is_set() and time.monotonic() < deadline:
                    time.sleep(0.02)
                if not done.is_set():
                    os.kill(os.getpid(), signal.SIGTERM)

            previous = {s: signal.getsignal(s)
                        for s in (signal.SIGINT, signal.SIGTERM)}
            w = threading.Thread(target=watch, daemon=True)
            w.start()
            try:
                rc, out, err = run(pkg, ["replicate", "--transfer", path])
            finally:
                done.set()
                for s, h in previous.items():
                    signal.signal(s, h)
            w.join(10)
            assert rc == 0, err
            if hasattr(yt, "sync_rows"):
                yt.sync_rows()
            node = yt.nodes[table]
            got[pkg] = ([tuple(sorted((k, repr(v)) for k, v in r.items()))
                         for r in node["rows"]],
                        node["attrs"].get("tablet_count"))
        finally:
            srv.stop()
            yt.stop()
    assert got["port"][1] == got["jax"][1] == 4
    port_rows, jax_rows = got["port"][0], got["jax"][0]
    assert port_rows == jax_rows
    ids = [dict(r)["ID"] for r in port_rows]
    assert "'900'" not in ids and "900" in ids and "7" not in ids
    assert "11" not in ids and "1000" in ids and len(ids) == 800


def test_oracle_and_yt_endpoints_are_no_longer_waiting():
    """`oracle`, `yt` and `yt_dyn` left the CLI's waiting providers: each
    parses into the port's endpoint, as in the JAX package; the
    providers still waiting raise naming their item."""
    assert not {"oracle", "yt", "yt_dyn"} & port_config.WAITING_PROVIDERS
    assert port_config.WAITING_PROVIDERS == {
        "arrow_ipc", "elastic", "eventhub", "flight", "greenplum",
        "kinesis", "logbroker", "opensearch", "ydb", "yds"}
    for src, dst in (("oracle", "ch"), ("yt", "yt"), ("sample", "yt_dyn")):
        text = f"id: x\nsrc: {{type: {src}}}\ndst: {{type: {dst}}}\n"
        got = port_config.parse_transfer_yaml(text)
        assert (got.src_provider(), got.dst_provider()) == (src, dst)
        assert got.to_dict() == ref_config.parse_transfer_yaml(text).to_dict()
    for kind in sorted(port_config.WAITING_PROVIDERS):
        with pytest.raises(port_config.ConfigError, match="ROADMAP.md A7"):
            port_config.parse_transfer_yaml(
                f"id: x\nsrc: {{type: {kind}}}\ndst: {{type: stdout}}\n")
