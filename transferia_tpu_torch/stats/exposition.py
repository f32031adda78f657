"""The CLI's `--metrics-port`: a Prometheus text-format (0.0.4) endpoint
on a stdlib `http.server` thread, without `prometheus_client`.

It serves what the JAX CLI's `prometheus_client.start_http_server`
serves, prometheus_client's default registry on Linux: the `python_gc_*`
families from `gc.get_stats()`, `python_info` from `platform`, and the
`process_*` families from `/proc/self`, under the same names, HELP
texts, types and labels, formatted as prometheus_client formats them.
The pipeline's `Metrics` live in registries of their own in both
packages, so neither serves them here (a gap between the reference's
`stats/__init__.py` docstring and its behaviour: ROADMAP.md, C's notes).
"""

from __future__ import annotations

import gc
import http.server
import math
import os
import platform
import threading

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

try:
    import resource

    _PAGESIZE = resource.getpagesize()
except ImportError:  # not Unix
    _PAGESIZE = 4096


def _go_float(d: float) -> str:
    """A sample value as prometheus_client writes it (Go's float
    format)."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to exponents sooner than Python
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _family(name: str, doc: str, mtype: str, samples: list) -> str:
    """One family: HELP, TYPE and its samples, each (labels, value)."""
    out = [f"# HELP {name} "
           + doc.replace("\\", r"\\").replace("\n", r"\n") + "\n",
           f"# TYPE {name} {mtype}\n"]
    for labels, value in samples:
        lbl = ",".join(f'{k}="{_escape_label(str(v))}"'
                       for k, v in sorted(labels.items()))
        out.append(f"{name}{{{lbl}}} {_go_float(value)}\n" if lbl
                   else f"{name} {_go_float(value)}\n")
    return "".join(out)


def _gc_families() -> list[str]:
    if not hasattr(gc, "get_stats") or \
            platform.python_implementation() != "CPython":
        return []
    stats = list(enumerate(gc.get_stats()))
    return [
        _family(name, doc, "counter",
                [({"generation": str(g)}, s[key]) for g, s in stats])
        for name, doc, key in (
            ("python_gc_objects_collected_total",
             "Objects collected during gc", "collected"),
            ("python_gc_objects_uncollectable_total",
             "Uncollectable objects found during GC", "uncollectable"),
            ("python_gc_collections_total",
             "Number of times this generation was collected",
             "collections"))]


def _platform_family() -> str:
    major, minor, patchlevel = platform.python_version_tuple()
    info = {"version": platform.python_version(),
            "implementation": platform.python_implementation(),
            "major": major, "minor": minor, "patchlevel": patchlevel}
    return _family("python_info", "Python platform information", "gauge",
                   [(info, 1)])


def _boot_time() -> float:
    with open("/proc/stat", "rb") as fh:
        for line in fh:
            if line.startswith(b"btime "):
                return float(line.split()[1])
    return 0.0


def _process_families() -> list[str]:
    """`/proc/self` as prometheus_client's ProcessCollector reads it; no
    family where `/proc` cannot be read."""
    try:
        btime = _boot_time()
    except OSError:
        return []
    if not btime:
        return []
    try:
        ticks = float(os.sysconf("SC_CLK_TCK"))
    except (ValueError, TypeError, AttributeError, OSError):
        ticks = 100.0
    out = []
    try:
        with open("/proc/self/stat", "rb") as fh:
            parts = fh.read().split(b")")[-1].split()
        out += [
            _family("process_virtual_memory_bytes",
                    "Virtual memory size in bytes.", "gauge",
                    [({}, float(parts[20]))]),
            _family("process_resident_memory_bytes",
                    "Resident memory size in bytes.", "gauge",
                    [({}, float(parts[21]) * _PAGESIZE)]),
            _family("process_start_time_seconds",
                    "Start time of the process since unix epoch in "
                    "seconds.", "gauge",
                    [({}, float(parts[19]) / ticks + btime)]),
            _family("process_cpu_seconds_total",
                    "Total user and system CPU time spent in seconds.",
                    "counter",
                    [({}, (float(parts[11]) + float(parts[12])) / ticks)]),
        ]
    except OSError:
        pass
    try:
        max_fds = None
        with open("/proc/self/limits", "rb") as fh:
            for line in fh:
                if line.startswith(b"Max open file"):
                    max_fds = float(line.split()[3])
                    break
        open_fds = len(os.listdir("/proc/self/fd"))
        out.append(_family("process_open_fds",
                           "Number of open file descriptors.", "gauge",
                           [({}, open_fds)]))
        if max_fds is not None:
            out.append(_family("process_max_fds",
                               "Maximum number of open file descriptors.",
                               "gauge", [({}, max_fds)]))
    except OSError:
        pass
    return out


def generate_latest() -> bytes:
    """The exposition text, families in prometheus_client's order."""
    return "".join(_gc_families() + [_platform_family()]
                   + _process_families()).encode("utf-8")


class _Handler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        body = b"" if self.path == "/favicon.ico" else generate_latest()
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def start_http_server(port: int, addr: str = "0.0.0.0"
                      ) -> http.server.ThreadingHTTPServer:
    """Serve the metrics on every path of (addr, port) from a daemon
    thread; returns the server (port 0 binds an ephemeral one:
    `server_address`; `shutdown()` stops it)."""
    srv = http.server.ThreadingHTTPServer((addr, port), _Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, name="metrics-http",
                     daemon=True).start()
    return srv
