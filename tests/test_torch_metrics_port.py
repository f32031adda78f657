"""The port's `--metrics-port` (`transferia_tpu_torch/stats/
exposition.py`, wired in `cli/main.py`) against the JAX CLI's, which
serves prometheus_client's default registry; on the CPU.

- Both CLIs are run in this process with `--metrics-port` on a free
  port, and each port is scraped once its CLI returned (the server is
  bound by then): the same families, HELP texts, types and label sets,
  and `python_info` equal line for line.
- Neither serves a pipeline metric: a `Metrics` counter incremented in
  each package adds no family (the reference's pipeline registries are
  private; ROADMAP.md C's notes).
- The exposition's own formatting against prometheus_client's on fixed
  values, and the port's CLI never importing prometheus_client.
"""

import math
import os
import re
import socket
import subprocess
import sys
import urllib.request

import pytest

from transferia_tpu.cli import main as ref_main
from transferia_tpu.stats.registry import Metrics as RefMetrics
from transferia_tpu_torch.cli import main as port_main
from transferia_tpu_torch.stats import exposition
from transferia_tpu_torch.stats.registry import Metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {
    "process_cpu_seconds_total", "process_max_fds", "process_open_fds",
    "process_resident_memory_bytes", "process_start_time_seconds",
    "process_virtual_memory_bytes", "python_gc_collections_total",
    "python_gc_objects_collected_total",
    "python_gc_objects_uncollectable_total", "python_info",
}
SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def scrape(port: int) -> tuple[str, str]:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        return r.headers["Content-Type"], r.read().decode()


def parse(text: str) -> dict:
    """family -> {help, type, label sets, samples}; raises on a line the
    text format does not allow."""
    fams: dict = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, _, doc = line[7:].partition(" ")
            fams.setdefault(name, {"samples": []})["help"] = doc
        elif line.startswith("# TYPE "):
            name, _, typ = line[7:].partition(" ")
            fams.setdefault(name, {"samples": []})["type"] = typ
        else:
            m = SAMPLE.match(line)
            assert m, f"not a sample line: {line!r}"
            name, labels, value = m.group(1), m.group(3), m.group(4)
            float(value)
            keys = tuple(sorted(kv.split("=", 1)[0]
                                for kv in labels.split(",")) if labels
                         else ())
            fams[name]["samples"].append((keys, line))
    return fams


def shape(fams: dict) -> dict:
    return {name: (f["help"], f["type"],
                   sorted({k for k, _ in f["samples"]}))
            for name, f in fams.items()}


@pytest.fixture(scope="module")
def scraped():
    """Both CLIs' metrics ports, each scraped after a Metrics counter of
    its package was incremented."""
    out = {}
    RefMetrics().counter("pipeline_rows", "rows moved").inc(5)
    Metrics().counter("pipeline_rows", "rows moved").inc(5)
    for pkg, main, pre in (("jax", ref_main.main, []),
                           ("port", port_main.main, ["--device", "cpu"])):
        port = free_port()
        assert main(pre + ["--log-level", "error", "--metrics-port",
                           str(port), "typesystem-docs"]) == 0
        out[pkg] = scrape(port)
    return out


def test_families_equal_jax(scraped):
    (ref_ctype, ref_text), (ctype, text) = scraped["jax"], scraped["port"]
    assert ctype == ref_ctype == "text/plain; version=0.0.4; charset=utf-8"
    got, want = parse(text), parse(ref_text)
    assert shape(got) == shape(want)
    assert set(got) == FAMILIES
    assert [line for _, line in got["python_info"]["samples"]] == \
        [line for _, line in want["python_info"]["samples"]]


def test_values_are_this_process(scraped):
    fams = parse(scraped["port"][1])
    value = {name: float(f["samples"][0][1].rsplit(" ", 1)[1])
             for name, f in fams.items()}
    assert value["process_max_fds"] >= value["process_open_fds"] > 0
    assert value["process_resident_memory_bytes"] > 1 << 20
    assert value["process_cpu_seconds_total"] > 0
    gens = [k for k, _ in fams["python_gc_collections_total"]["samples"]]
    assert gens == [("generation",)] * 3


def test_no_pipeline_metric_is_served(scraped):
    """The reference's `Metrics` register in a private registry, so its
    `/metrics` serves none of them; neither does the port's."""
    import prometheus_client

    ref_m = RefMetrics()
    ref_m.counter("pipeline_rows", "rows moved").inc(3)
    assert ref_m.value("pipeline_rows") == 3
    for pkg in ("jax", "port"):
        served = set(parse(scraped[pkg][1]))
        assert served == FAMILIES and not any(
            n.startswith("pipeline_rows") for n in served)
    default = parse(prometheus_client.generate_latest().decode())
    assert set(default) == FAMILIES


@pytest.mark.parametrize("value", [0, 1, 4.0, 0.16, 1e-7, 2.49856e7,
                                   1792333589.84, 123456789.0, -3.5,
                                   math.inf, -math.inf, math.nan])
def test_value_format_equals_prometheus_client(value):
    from prometheus_client.utils import floatToGoString

    assert exposition._go_float(value) == floatToGoString(value)


def test_escaping_and_families_equal_prometheus_client():
    from prometheus_client import CollectorRegistry, generate_latest
    from prometheus_client.core import GaugeMetricFamily

    class One:
        def collect(self):
            g = GaugeMetricFamily("x_info", 'doc with \\ and\nnewline',
                                  labels=["b", "a"])
            g.add_metric(['q"u\\o\nte', "é"], 1)
            yield g

    reg = CollectorRegistry()
    reg.register(One())
    want = generate_latest(reg).decode()
    got = exposition._family("x_info", 'doc with \\ and\nnewline', "gauge",
                             [({"b": 'q"u\\o\nte', "a": "é"}, 1)])
    assert got == want


def test_the_cli_never_imports_prometheus_client():
    port = free_port()
    code = (
        "import sys, urllib.request\n"
        "from transferia_tpu_torch.cli.main import main\n"
        f"assert main(['--device', 'cpu', '--log-level', 'error', "
        f"'--metrics-port', '{port}', 'typesystem-docs']) == 0\n"
        f"body = urllib.request.urlopen('http://127.0.0.1:{port}/metrics',"
        " timeout=10).read()\n"
        "assert b'python_info' in body\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('prometheus_client', 'jax', 'pyarrow', 'transferia_tpu')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stdout + proc.stderr
