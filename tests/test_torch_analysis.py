"""The port's lint (`transferia_tpu_torch/analysis/`, `trtpu check`)
against the JAX package's, on the fixtures of
`tests/unit/test_analysis.py`.

- Every source fixture of the JAX test module (read from its text, not
  imported) through each per-file rule of both packages: LCK001,
  THD001, NET001 and EXC001's silent swallows give the JAX findings
  (rule, line, column, severity, message, snippet).
- The project rules on the JAX test cases: LCK002 (the lock-order
  graph), REG001's key pass, FPT001 with a synthetic catalog, TRC001
  and KNB001 (with the README's port section holding the doc rows).
- TPU001 and EXC001's dispatch markers are the torch ones, with
  fixtures of their own: one that fires and one that does not for each
  host sync and each marker.
- `check` gives the JAX exit codes (0; 1 under --strict; 2 on a bad path
  or rule id, and for --update-baseline on a narrowed run), and
  `check --strict` over `transferia_tpu_torch` exits 0.
"""

import ast
import json
import os
import textwrap

import pytest

from transferia_tpu.analysis import cli as ref_cli
from transferia_tpu.analysis import engine as ref_engine
from transferia_tpu.analysis import rules as ref_rules
from transferia_tpu_torch.analysis import baseline as port_baseline
from transferia_tpu_torch.analysis import cli as port_cli
from transferia_tpu_torch.analysis import engine as port_engine
from transferia_tpu_torch.analysis import rules as port_rules
from transferia_tpu_torch.cli import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TESTS = os.path.join(REPO, "tests", "unit", "test_analysis.py")
PKG = {"port": (port_rules, port_engine, "transferia_tpu_torch"),
       "jax": (ref_rules, ref_engine, "transferia_tpu")}


def jax_fixtures() -> dict:
    """Every multi-line string of the JAX test module that parses as a
    Python module, keyed by its first line number there."""
    with open(JAX_TESTS, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "\n" in node.value.strip():
            src = textwrap.dedent(node.value)
            try:
                ast.parse(src)
            except SyntaxError:
                continue
            out[f"line{node.lineno}"] = src
    return out


FIXTURES = jax_fixtures()
# dispatch markers only the JAX rule knows (the port's are torch's)
JAX_ONLY_MARKERS = ("jit", "device_put", "pallas_call",
                    "block_until_ready")


def check_src(pkg: str, rule_name: str, src: str,
              rel: str = "ops/fixture.py"):
    """Run one rule of a package over a source, honoring pragmas."""
    rules, engine, root = PKG[pkg]
    rule = getattr(rules, rule_name)()
    path = f"{root}/{rel}"
    if not rule.applies_to(path):
        return []
    supp = engine.Suppressions.scan(src)
    return [(f.rule, f.line, f.col, f.severity, f.message, f.snippet)
            for f in rule.check_file(path, ast.parse(src), src.splitlines())
            if not supp.suppressed(f)]


def test_fixtures_were_found():
    assert len(FIXTURES) > 40


@pytest.mark.parametrize("rule_name", ["LockDisciplineRule",
                                       "ThreadLifecycleRule",
                                       "ResourceSafetyRule",
                                       "ExceptionHygieneRule"])
def test_per_file_rules_equal_jax_on_every_fixture(rule_name):
    fired = 0
    for name, src in sorted(FIXTURES.items()):
        got = check_src("port", rule_name, src)
        want = check_src("jax", rule_name, src)
        if rule_name == "ExceptionHygieneRule" and any(
                m in src for m in JAX_ONLY_MARKERS):
            want = [f for f in want if "device dispatch" not in f[4]]
            got = [f for f in got if "device dispatch" not in f[4]]
        assert got == want, name
        fired += bool(got)
    assert fired >= 2


@pytest.mark.parametrize("rel", ["runtime/local.py", "chaos/x.py",
                                 "providers/kafka/client.py"])
def test_per_file_rules_scope_like_jax(rel):
    for rule_name in ("LockDisciplineRule", "ThreadLifecycleRule",
                      "ResourceSafetyRule"):
        for src in FIXTURES.values():
            assert check_src("port", rule_name, src, rel) == \
                check_src("jax", rule_name, src, rel)


def project(pkg: str, rule, sources: dict, root: str = "/tmp"):
    """A project rule over in-memory sources; paths name the package's
    root, and come back with it replaced by `PKG`."""
    files = {}
    for rel, src in sources.items():
        path = rel.replace("PKG", PKG[pkg][2])
        src = textwrap.dedent(src)
        files[path] = (ast.parse(src), src.splitlines())
    return [(f.rule, f.path.replace(PKG[pkg][2], "PKG"), f.line, f.col,
             f.severity, f.message.replace(PKG[pkg][2], "PKG"), f.snippet)
            for f in rule.check_project(root, files)]


@pytest.mark.parametrize("name", ["LCK2_ABBA", "LCK2_INTERPROC",
                                  "LCK2_CLEAN", "LCK2_COND_ALIAS",
                                  "LCK2_NAMED"])
def test_lock_order_equals_jax(name):
    with open(JAX_TESTS, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    src = next(n.value.value for n in tree.body
               if isinstance(n, ast.Assign)
               and n.targets[0].id == name)
    got = project("port", port_rules.LockOrderRule(),
                  {"PKG/pair.py": src})
    want = project("jax", ref_rules.LockOrderRule(), {"PKG/pair.py": src})
    assert got == want
    assert bool(got) == (name in ("LCK2_ABBA", "LCK2_INTERPROC",
                                  "LCK2_NAMED"))


REG_CASES = {
    "duplicate_transformer": {
        "PKG/a.py": '@register_transformer("mask_field")\nclass A: pass\n',
        "PKG/b.py": '@register_transformer("mask_field")\nclass B: pass\n'},
    "provider_without_name": {
        "PKG/p.py": "@register_provider\nclass P:\n    pass\n"},
    "same_key_two_registries": {
        "PKG/a.py": '@register_transformer("x")\nclass A: pass\n'
                    '@register_parser("x")\nclass B: pass\n'},
    "duplicate_provider_name": {
        "PKG/a.py": '@register_provider\nclass A:\n    NAME = "mq"\n',
        "PKG/b.py": '@register_provider\nclass B:\n    NAME = "mq"\n'},
}


@pytest.mark.parametrize("case", sorted(REG_CASES))
def test_registry_key_pass_equals_jax(case):
    got = {}
    for pkg, rules in (("port", port_rules), ("jax", ref_rules)):
        rule = rules.RegistryContractRule()
        rule.do_import_check = False
        got[pkg] = project(pkg, rule, REG_CASES[case])
    assert got["port"] == got["jax"]
    assert bool(got["port"]) == (case != "same_key_two_registries")


def test_registry_load_pass_holds_on_the_port():
    findings = port_rules.RegistryContractRule().import_check()
    assert findings == [], [f.message for f in findings]


FPT_CASES = {
    "clean": {"PKG/a.py": 'failpoint("sink.push")\n',
              "PKG/b.py": 'fp.torn_rows("storage.part.read", n)\n'},
    "non_literal": {"PKG/a.py": 'failpoint("sink.push")\nfailpoint(SITE)\n',
                    "PKG/b.py": 'torn_rows("storage.part.read", n)\n'},
    "unregistered": {"PKG/a.py": 'failpoint("sink.push")\n'
                                 'failpoint("made.up.site")\n',
                     "PKG/b.py": 'torn_rows("storage.part.read", n)\n'},
    "duplicate_owner": {"PKG/a.py": 'failpoint("sink.push")\n',
                        "PKG/b.py": 'failpoint("sink.push")\n'
                                    'failpoint("storage.part.read")\n'},
    "dead_entry": {"PKG/a.py": 'failpoint("sink.push")\n'},
    "exempt": {"PKG/chaos/failpoints.py": "failpoint(whatever)\n",
               "tests/unit/test_x.py": 'failpoint("bogus.site")\n',
               "PKG/a.py": 'failpoint("sink.push")\n',
               "PKG/b.py": 'torn_rows("storage.part.read", n)\n'},
}


@pytest.mark.parametrize("case", sorted(FPT_CASES))
def test_failpoint_contract_equals_jax(case):
    got = {}
    for pkg, rules in (("port", port_rules), ("jax", ref_rules)):
        rule = rules.FailpointContractRule()
        rule.known_sites = frozenset(("sink.push", "storage.part.read"))
        sources = dict(FPT_CASES[case])
        sources.setdefault("PKG/chaos/sites.py", "SITES = {}\n")
        got[pkg] = project(pkg, rule, sources)
    assert got["port"] == got["jax"]
    assert bool(got["port"]) == (case not in ("clean", "exempt"))


TRC_CASES = {
    "untraced": 'def naked():\n    failpoint("some.site")\n',
    "span": 'def f():\n    failpoint("some.site")\n'
            '    with trace.span("work"):\n        pass\n',
    "instant": 'def f(t):\n    failpoint("some.site")\n'
               '    trace.instant("fired", at=t)\n',
    "complete": 'def f(t0, d):\n    failpoint("some.site")\n'
                '    trace.complete("wait", t0=t0, dur=d)\n',
    "adopted_only": 'def f(ctx):\n    with trace.adopted(ctx):\n'
                    '        failpoint("some.site")\n',
    "torn_rows": 'def f(n):\n    return torn_rows("some.site", n)\n',
    "module_level": 'failpoint("some.site")\n',
    "non_literal": 'def f(site):\n    failpoint(site)\n',
}


@pytest.mark.parametrize("case", sorted(TRC_CASES))
def test_trace_contract_equals_jax(case):
    got = {}
    for pkg, rules in (("port", port_rules), ("jax", ref_rules)):
        got[pkg] = project(pkg, rules.TraceContractRule(),
                           {"PKG/a.py": TRC_CASES[case],
                            "PKG/chaos/runner.py": TRC_CASES["untraced"],
                            "tests/unit/t.py": TRC_CASES["untraced"]})
    assert got["port"] == got["jax"]
    assert bool(got["port"]) == (case in ("untraced", "adopted_only",
                                          "torn_rows", "module_level"))


KNB_CASES = {
    "direct_read": ({"a.py": 'import os\n'
                     'v = os.environ.get("TRANSFERIA_TPU_FOO", "1")\n'},
                    "| `TRANSFERIA_TPU_FOO` | 1 | a knob |\n"),
    "getenv_and_subscript": ({"a.py": 'import os\n'
                              'v = os.getenv("TRANSFERIA_TPU_FOO")\n'
                              'w = os.environ["TRANSFERIA_TPU_FOO"]\n'},
                             "TRANSFERIA_TPU_FOO\n"),
    "write_is_not_a_read": ({"a.py": 'import os\n'
                             'os.environ["TRANSFERIA_TPU_SET"] = "1"\n'
                             'del os.environ["TRANSFERIA_TPU_SET"]\n'}, ""),
    "documented_helper": ({"a.py": 'v = knobs.env_int('
                           '"TRANSFERIA_TPU_ROWS", 4)\n'},
                          "| `TRANSFERIA_TPU_ROWS` | 4 | rows |\n"),
    "undocumented_once": ({"a.py": 'v = knobs.env_int('
                           '"TRANSFERIA_TPU_HIDDEN", 4)\n'
                           'w = knobs.env_float('
                           '"TRANSFERIA_TPU_HIDDEN", 4.0)\n'}, ""),
    "dead_doc_row": ({"a.py": 'v = knobs.env_int("TRANSFERIA_TPU_LIVE", 4)\n'},
                     "| `TRANSFERIA_TPU_LIVE` | 4 | live |\n"
                     "| `TRANSFERIA_TPU_GONE` | 0 | removed |\n"),
    "constant_indirection": ({"a.py": 'ENV_ROWS = "TRANSFERIA_TPU_ROWS2"\n'
                              'v = knobs.env_int(ENV_ROWS, 4)\n'}, ""),
    "shim_slot": ({"a.py": 'def env_float(environ, key, default):\n'
                   '    return float(environ.get(key, default))\n'
                   'def read(environ):\n'
                   '    return env_float(environ, "TRANSFERIA_TPU_SHIM",'
                   ' 1.0)\n'}, "TRANSFERIA_TPU_SHIM\n"),
    "knobs_module_exempt": ({"runtime/knobs.py": 'import os\n'
                             'v = os.environ.get("TRANSFERIA_TPU_BASE")\n'},
                            "TRANSFERIA_TPU_BASE\n"),
    "suppressed": ({"a.py": 'import os\nv = os.environ.get('
                    '"TRANSFERIA_TPU_FOO")  # trtpu: ignore[KNB001]\n'},
                   "TRANSFERIA_TPU_FOO\n"),
}


def knob_findings(pkg: str, tmp_path, files: dict, readme: str):
    rules, engine, root = PKG[pkg]
    base = tmp_path / pkg
    # the README's port section holds the doc rows: the port scopes its
    # dead-row check to it, the reference reads the whole file
    (base / "README.md").parent.mkdir(parents=True, exist_ok=True)
    (base / "README.md").write_text(
        "## PyTorch / H100 port (`transferia_tpu_torch/`)\n" + readme)
    for rel, src in files.items():
        p = base / root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return [(f.rule, f.path.replace(root, "PKG"), f.line, f.col,
             f.message.replace(root, "PKG"))
            for f in engine.run_rules([root], [rules.KnobRegistryRule()],
                                      root=str(base)).findings]


@pytest.mark.parametrize("case", sorted(KNB_CASES))
def test_knob_registry_equals_jax(case, tmp_path):
    files, readme = KNB_CASES[case]
    got = knob_findings("port", tmp_path, files, readme)
    assert got == knob_findings("jax", tmp_path, files, readme)
    assert bool(got) == (case in ("direct_read", "getenv_and_subscript",
                                  "undocumented_once", "dead_doc_row",
                                  "constant_indirection"))


def test_knob_rows_outside_the_port_section_are_not_the_ports(tmp_path):
    """A knob only the JAX package reads may be documented outside the
    port's section: the port's lint does not call that row dead, while a
    dead row inside the section is still reported."""
    (tmp_path / "transferia_tpu_torch").mkdir()
    (tmp_path / "transferia_tpu_torch" / "a.py").write_text(
        'v = knobs.env_int("TRANSFERIA_TPU_LIVE", 4)\n')
    (tmp_path / "README.md").write_text(
        "## TPU\n| `TRANSFERIA_TPU_JAX_ONLY` | 1 | x |\n"
        "## PyTorch / H100 port\n| `TRANSFERIA_TPU_LIVE` | 4 | live |\n"
        "| `TRANSFERIA_TPU_GONE` | 0 | removed |\n"
        "## Chaos engineering\n| `TRANSFERIA_TPU_OTHER` | 0 | x |\n")
    found = port_engine.run_rules(["transferia_tpu_torch"],
                                  [port_rules.KnobRegistryRule()],
                                  root=str(tmp_path)).findings
    assert [(f.path, f.line, "dead doc row" in f.message)
            for f in found] == [("README.md", 5, True)]


# -- TPU001: host syncs in kernel-launch code ---------------------------------

LAUNCH = """
import torch
from transferia_tpu_torch.ops import _build


def launch(words: torch.Tensor, n: int, flag: bool):
    out = torch.empty(n, dtype=torch.int32, device=words.device)
    {body}
    lib = _build.library("pred_decode")
    rc = lib.trt_pred_decode(words.data_ptr(), out.data_ptr(), n)
    _build.check(lib, rc, "pred_decode")
    return out
"""

TPU_FIRES = {
    "item": "k = words[0].item()",
    "tolist": "k = out.tolist()",
    "cpu": "k = words.cpu()",
    "numpy": "k = out.numpy()",
    "synchronize": "torch.cuda.synchronize()",
    "branch_on_value": "if words.sum() > 0:\n        n = n + 1",
    "while_on_value": "while out.any():\n        break",
    "ifexp_on_value": "n = n + 1 if torch.any(words) else n",
    "derived_tensor": "m = words.to(torch.int64)\n"
                      "    if m.max() > 3:\n        n = 2",
}
TPU_QUIET = {
    "item": "k = n.bit_length()",
    "tolist": "k = list(range(n))",
    "cpu": "k = torch.device('cpu')",
    "numpy": "k = words.dtype",
    "synchronize": "stream = torch.cuda.current_stream(words.device)",
    "branch_on_value": "if words.numel() > 0 and words.dim() == 1:\n"
                       "        n = n + 1",
    "while_on_value": "while flag:\n        break",
    "ifexp_on_value": "n = n + 1 if words.is_cuda else n",
    "derived_tensor": "m = words.to(torch.int64)\n"
                      "    if m.shape[0] > 3 and m is not None:\n"
                      "        n = 2",
}


def tpu_findings(body: str, rel: str = "ops/fixture.py") -> list:
    return check_src("port", "DevicePurityRule",
                     LAUNCH.format(body=body), rel)


@pytest.mark.parametrize("case", sorted(TPU_FIRES))
def test_tpu001_flags_each_host_sync_in_launch_code(case):
    found = tpu_findings(TPU_FIRES[case])
    assert len(found) == 1 and found[0][0] == "TPU001", found
    assert found[0][1] in (8, 9)  # on the body's lines
    assert "kernel-launch code" in found[0][4]
    assert tpu_findings(TPU_QUIET[case]) == []


def test_tpu001_scope_pragmas_and_non_launch_code():
    bad = TPU_FIRES["item"]
    # host-side modules read results back legitimately
    assert tpu_findings(bad, "runtime/local.py") == []
    assert tpu_findings(bad, "ops/linkprobe.py") == []
    assert len(tpu_findings(bad, "predicate/device.py")) == 1
    assert len(tpu_findings(bad, "parallel/mesh.py")) == 1
    assert tpu_findings(bad + "  # trtpu: ignore[TPU001]") == []
    # a function that launches nothing may sync
    src = "def read(x):\n    if x.sum() > 0:\n        return x.item()\n"
    assert check_src("port", "DevicePurityRule", src) == []


def test_tpu001_sees_every_kernel_wrapper_of_the_port():
    """The rule recognizes the port's real launch wrappers (so a clean
    run over the tree means something): every `_build` library's."""
    from transferia_tpu_torch.analysis.rules.device_purity import _launches

    names = set()
    for rel in ("ops/decode.py", "ops/lambdas.py", "ops/raggedpack.py",
                "ops/rowhash.py", "ops/sha256.py", "parallel/fusedmesh.py",
                "parallel/mesh.py", "predicate/device.py"):
        path = os.path.join(REPO, "transferia_tpu_torch", rel)
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        names |= {n.name for n in ast.walk(tree)
                  if isinstance(n, ast.FunctionDef) and _launches(n)}
    assert {"pred_decode", "_dict_decode_launch", "region_sign_flip",
            "ragged_pack", "var_accumulators", "rowhash_lanes",
            "sha256_hmac", "digest_gather", "_launch_hist",
            "_launch"} <= names


# -- EXC001: the torch dispatch markers ---------------------------------------

EXC_WRAP = """
import logging


def f(batch, dev, lib):
    try:
        {body}
    except Exception:
        {handler}
    return batch
"""

EXC_MARKERS = {
    "to_device": "batch = batch.to(dev, non_blocking=True)",
    "to_device_kw": "batch = batch.to(device=dev)",
    "to_cuda_string": "batch = batch.to('cuda')",
    "cuda": "batch = batch.cuda()",
    "synchronize": "torch.cuda.synchronize()",
    "kernel_entry": "lib.trt_pred3vl_mask(batch, 0)",
    "library": "lib = _build.library('pred3vl_mask')",
}


@pytest.mark.parametrize("case", sorted(EXC_MARKERS))
def test_exc001_torch_dispatch_markers(case):
    def found(body, handler):
        return check_src("port", "ExceptionHygieneRule",
                         EXC_WRAP.format(body=body, handler=handler))

    wrap = found(EXC_MARKERS[case], "batch = None")
    assert len(wrap) == 1 and "wraps device dispatch" in wrap[0][4]
    # logging or re-raising handles it; a host-only body never fires
    assert found(EXC_MARKERS[case],
                 "logging.getLogger(__name__).warning('x')") == []
    assert found(EXC_MARKERS[case], "raise") == []
    assert found("batch = batch.to(torch.int64)", "batch = None") == []
    assert found("batch = batch.tolist()", "batch = None") == []


# -- the check command --------------------------------------------------------

EXC_BAD = "def f():\n    try:\n        g()\n    except Exception:\n" \
          "        pass\n"
NET_BAD = "import socket\n\ndef f():\n" \
          "    return socket.create_connection(('h', 1))\n"


def check_both(tmp_path, monkeypatch, capsys, argv, files) -> dict:
    """(exit code, stdout, stderr) of both packages' `check` on a tree
    under tmp_path (each under its own package directory)."""
    out = {}
    for pkg, cli, root in (("port", port_cli, "transferia_tpu_torch"),
                           ("jax", ref_cli, "transferia_tpu")):
        base = tmp_path / pkg
        for rel, src in files.items():
            p = base / root / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(src)
        monkeypatch.setattr(cli, "repo_root", lambda b=base: str(b))
        args = [a.replace("PKG", root).replace("BASE", str(base))
                for a in argv]
        rc = cli.main(args)
        o, e = capsys.readouterr()
        out[pkg] = (rc, o.replace(root, "PKG").replace(str(base), "BASE"),
                    e.replace(root, "PKG"))
    return out


CLI_CASES = {
    "report_only": (["--baseline", "none"], {"bad.py": EXC_BAD}, 0),
    "strict_new_finding": (["--strict", "--baseline", "none"],
                           {"bad.py": EXC_BAD}, 1),
    "strict_clean": (["--strict", "--baseline", "none"],
                     {"ok.py": "x = 1\n"}, 0),
    "json": (["--json", "--baseline", "none"], {"bad.py": NET_BAD}, 0),
    "bad_path": (["no/such/dir"], {"ok.py": "x = 1\n"}, 2),
    "bad_rule": (["--rules", "NOPE42"], {"ok.py": "x = 1\n"}, 2),
    "narrowed_update_path": (["PKG", "--update-baseline", "--baseline",
                              "BASE/b.json"], {"ok.py": "x = 1\n"}, 2),
    "narrowed_update_rules": (["--rules", "EXC001", "--update-baseline",
                               "--baseline", "BASE/b.json"],
                              {"ok.py": "x = 1\n"}, 2),
    "update_none": (["--update-baseline", "--baseline", "none"],
                    {"ok.py": "x = 1\n"}, 2),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_check_exit_codes_equal_jax(case, tmp_path, monkeypatch, capsys):
    argv, files, rc = CLI_CASES[case]
    got = check_both(tmp_path, monkeypatch, capsys, argv, files)
    assert got["port"][0] == got["jax"][0] == rc
    if case == "json":
        port, ref = (json.loads(got[p][1]) for p in ("port", "jax"))
        assert port == ref and {f["rule"] for f in port["new"]} == \
            {"NET001"}
    elif case != "bad_rule":  # the known-rule lists differ in wording
        assert got["port"] == got["jax"]


def test_baseline_round_trip_then_strict_equals_jax(tmp_path, monkeypatch,
                                                    capsys):
    files = {"bad.py": EXC_BAD}
    first = check_both(tmp_path, monkeypatch, capsys,
                       ["--update-baseline", "--baseline", "BASE/b.json"],
                       files)
    assert first["port"] == first["jax"] and first["port"][0] == 0
    then = check_both(tmp_path, monkeypatch, capsys,
                      ["--strict", "--baseline", "BASE/b.json"], files)
    assert then["port"] == then["jax"] and then["port"][0] == 0
    entries = [
        sorted((e["rule"], e["path"].split("/", 1)[1], e["message"],
                e["snippet"]) for e in json.loads(
                    (tmp_path / pkg / "b.json").read_text())[
                        "findings"].values())
        for pkg in ("port", "jax")]
    assert entries[0] == entries[1] and len(entries[0]) == 1


def test_default_baseline_is_the_ports_own():
    assert port_baseline.DEFAULT_BASELINE == ".trtpu-torch-baseline.json"
    assert port_cli.repo_root() == REPO
    assert port_cli.DEFAULT_PATH == "transferia_tpu_torch"


def test_list_rules_names_the_reference_rule_ids(capsys):
    assert port_main.main(["check", "--list-rules"]) == 0
    port_out = capsys.readouterr().out
    assert ref_cli.main(["--list-rules"]) == 0
    ref_out = capsys.readouterr().out
    ids = [line.split()[0] for line in port_out.splitlines()]
    assert ids == [line.split()[0] for line in ref_out.splitlines()]
    assert len(ids) == 10


def test_check_strict_over_the_port_tree_exits_0(capsys):
    """The port's tree passes its own lint, with no baseline entry."""
    assert not os.path.exists(os.path.join(
        REPO, port_baseline.DEFAULT_BASELINE))
    assert port_main.main(["--log-level", "error", "check",
                           "--strict"]) == 0
    assert "0 new finding(s)" in capsys.readouterr().out
