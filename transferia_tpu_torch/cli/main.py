"""trtpu on PyTorch: the port's command-line interface (the port's copy of
``transferia_tpu/cli/main.py``).

    python -m transferia_tpu_torch.cli.main [--device cuda|cpu] \\
        activate --transfer transfer.yaml

Subcommands activate / upload / reupload / add-tables / remove-tables /
replicate / checksum / deactivate / sniff / regular-snapshot / validate /
describe / typesystem-docs / trace [--fleet] / fleet bench / worker /
top [--fleet] / slo / explain, global flags for the coordinator, the
worker's sharding indices, the log level and a health port (`/health`,
`/debug/trace`, `/debug/ledger`, `/debug/profile`, `/debug/threads`,
`/debug/fleet`, `/debug/fleet/obs`, `/debug/slo`) and a metrics port
(`--metrics-port`: the Prometheus text format of what the reference's
prometheus_client default registry serves, `stats/exposition.py`).
The memory coordinator refuses `--job-count > 1`, since parts cannot be
shared across processes in memory; a sharded snapshot runs one process a
job on `--coordinator filestore --coordinator-dir D --job-count N
--job-index i` (or, with no shared directory, `--coordinator s3
--coordinator-bucket B [--coordinator-endpoint URL]`), and `checksum --against-operation op-<id>` later proves
the target against the fingerprints that snapshot recorded.  `worker`
claims tickets from the fleet's durable queue (`fleet/worker.py`) on a
filestore or s3 coordinator shared by N worker processes; `top --fleet`,
`slo --fleet`, `trace --fleet` and `explain <transfer-id>` read the obs
segments those processes export through the same coordinator.
transfer.yaml is read without PyYAML (`cli/yamlread.py`).

`--device` (default `cuda`) is where every task the command runs does
its device work; without a card the CLI raises unless it is `cpu`, which
runs the kernels' plain versions.

Left out, each exiting 2 with a message naming its ROADMAP.md item
(`LEFT_OUT`): the commands check, chaos and flight.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading

from transferia_tpu_torch.coordinator import new_coordinator
from transferia_tpu_torch.coordinator.interface import TransferStatus
from transferia_tpu_torch.runtime.device import resolve_device

# what the port leaves out -> the ROADMAP.md item that owns its modules
LEFT_OUT = {
    "check": "A6, the port's lint (analysis/)",
    "chaos": "A6, the chaos runner (chaos/runner.py)",
    "flight": "A7, interchange/ (blocked: it needs pyarrow)",
}


def left_out_message(what: str) -> str:
    return (f"trtpu: {what} is not ported to transferia_tpu_torch yet "
            f"(ROADMAP.md {LEFT_OUT[what]})")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="trtpu",
        description="Data transfer on PyTorch and CUDA: snapshot + CDC "
                    "replication",
    )
    p.add_argument("--device", default="cuda",
                   help="where the tasks' device work runs: cuda (the "
                        "default; a card must be present) or cpu (the "
                        "kernels' plain versions)")
    p.add_argument("--log-level", default="info",
                   choices=["debug", "info", "warning", "error"])
    p.add_argument("--coordinator", default="memory",
                   choices=["memory", "filestore", "s3"],
                   help="control-plane backend: memory (one process), "
                        "filestore (a shared directory) or s3 (a bucket); "
                        "sharded workers need filestore or s3")
    p.add_argument("--coordinator-dir", default="",
                   help="filestore coordinator root directory")
    p.add_argument("--coordinator-bucket", default="",
                   help="bucket for --coordinator s3")
    p.add_argument("--coordinator-endpoint", default="",
                   help="S3-compatible endpoint URL (default: AWS)")
    p.add_argument("--coordinator-region", default="us-east-1",
                   help="region for --coordinator s3 signing")
    p.add_argument("--coordinator-prefix", default="",
                   help="key prefix inside the coordinator bucket")
    p.add_argument("--job-index", type=int, default=0,
                   help="this worker's index (0 = main)")
    p.add_argument("--job-count", type=int, default=0,
                   help="override runtime.job_count")
    p.add_argument("--process-count", type=int, default=0,
                   help="override runtime.process_count")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve Prometheus metrics on this port (0 = off)")
    p.add_argument("--health-port", type=int, default=0,
                   help="serve /health on this port (0 = off)")
    p.add_argument("--operation-id", default="",
                   help="shared operation id for sharded snapshot workers "
                        "(default: op-<transfer id>)")

    sub = p.add_subparsers(dest="command", required=True)

    def add_transfer_cmd(name, help_):
        c = sub.add_parser(name, help=help_)
        c.add_argument("--transfer", required=True,
                       help="path to transfer.yaml")
        return c

    add_transfer_cmd("activate", "snapshot + prepare replication")
    rep = add_transfer_cmd("replicate",
                           "activate if needed, then run replication")
    rep.add_argument("--max-attempts", type=int, default=0,
                     help="stop after N failed attempts (0 = retry forever)")
    up = add_transfer_cmd("upload", "ad-hoc copy of explicit tables")
    up.add_argument("--table", action="append", default=[],
                    help="table to upload (repeatable), e.g. ns.name")
    add_transfer_cmd("reupload",
                     "cleanup and re-snapshot every table")
    at = add_transfer_cmd("add-tables",
                          "snapshot new tables into a live transfer and "
                          "widen its include list")
    at.add_argument("--table", action="append", default=[], required=True,
                    help="table to add (repeatable), e.g. ns.name")
    rt = add_transfer_cmd("remove-tables",
                          "narrow the include list (target data stays)")
    rt.add_argument("--table", action="append", default=[], required=True,
                    help="table to remove (repeatable), e.g. ns.name")
    chk = add_transfer_cmd(
        "checksum", "full data-validation task (sampling, type-aware "
        "comparators)")
    chk.add_argument("--table", action="append", default=[],
                     help="restrict to a table (repeatable), e.g. ns.name")
    chk.add_argument("--size-threshold", type=int, default=None,
                     help="bytes above which tables are compared by "
                          "sampling instead of a full scan "
                          "(default 20 MiB; 0 = always sample)")
    chk.add_argument("--strict-types", action="store_true",
                     help="require exact canonical type equality instead "
                          "of family-level equivalence")
    chk.add_argument("--method", choices=["compare", "fingerprint"],
                     default="compare",
                     help="fingerprint: order-independent digest per "
                          "table (K10 on the card when profitable, O(1) "
                          "memory); row-level compare runs only on "
                          "digest mismatch")
    chk.add_argument("--fingerprint-backend",
                     choices=["auto", "host", "device"], default="auto",
                     help="where the fingerprint reduction runs "
                          "(auto measures, see ops/linkprobe.py)")
    chk.add_argument("--against-operation", default="",
                     help="compare the TARGET against the table "
                          "fingerprints a snapshot operation recorded "
                          "(validation: {fingerprint: true}) without "
                          "re-reading the source; needs the coordinator "
                          "that operation ran on")
    add_transfer_cmd("validate", "parse and validate the transfer config")
    add_transfer_cmd("deactivate",
                     "release source resources (replication slots etc.)")
    sniff = add_transfer_cmd("sniff",
                             "preview sample rows from the source")
    sniff.add_argument("--rows", type=int, default=5,
                       help="rows per table")
    reg = add_transfer_cmd("regular-snapshot",
                           "run the cron-driven re-snapshot loop")
    reg.add_argument("--max-runs", type=int, default=0,
                     help="stop after N runs (0 = forever)")
    desc = sub.add_parser("describe",
                          help="dump provider endpoint param schemas")
    desc.add_argument("--provider", default="",
                      help="limit to one provider")
    tsd = sub.add_parser("typesystem-docs",
                         help="generate per-provider typesystem.md files")
    tsd.add_argument("--out", default="docs/typesystem",
                     help="output directory")
    trc = sub.add_parser(
        "trace",
        help="run a transfer with pipeline tracing on; write a "
             "Perfetto-loadable timeline + per-stage summary")
    trc.add_argument("--transfer", default="",
                     help="path to transfer.yaml (default: built-in "
                          "sample->stdout demo with a fused mask+filter "
                          "chain)")
    trc.add_argument("--out", default="trace.json",
                     help="Chrome trace-event JSON output path "
                          "(open in Perfetto / chrome://tracing)")
    trc.add_argument("--seconds", type=float, default=10.0,
                     help="capture window for replication transfers "
                          "(snapshot transfers run to completion)")
    trc.add_argument("--rows", type=int, default=50_000,
                     help="demo source rows (only without --transfer)")
    trc.add_argument("--fleet", default="", metavar="TRANSFER_ID",
                     help="fleet mode: instead of running anything, "
                          "merge the obs segments of every worker "
                          "process from the coordinator "
                          "(stats/fleetobs.py) into one Perfetto "
                          "timeline for this transfer id ('all' = "
                          "every transfer)")
    flt = sub.add_parser(
        "fleet",
        help="fleet control plane (fleet/): `bench` drives 100+ "
             "concurrent sample->memory transfers through the "
             "admission/fair-share scheduler and reports p50/p99 "
             "dispatch latency, Jain fairness under a 10:1 tenant "
             "skew, and the delivery audit")
    flt.add_argument("action", choices=["bench"])
    flt.add_argument("--transfers", type=int, default=120,
                     help="bench: concurrent transfers to schedule")
    flt.add_argument("--workers", type=int, default=8,
                     help="bench: worker slots")
    flt.add_argument("--lanes", type=int, default=2,
                     help="bench: max in-flight transfers per worker")
    flt.add_argument("--rows", type=int, default=256,
                     help="bench: rows per transfer")
    flt.add_argument("--seed", type=int, default=7,
                     help="bench: tenant-mix shuffle seed")
    flt.add_argument("--json", action="store_true", dest="as_json",
                     help="machine-readable report")
    wk = sub.add_parser(
        "worker",
        help="run a supervised fleet worker process: claim tickets "
             "from the coordinator's durable admission queue (WDRR "
             "fair share), run them through the snapshot engine on "
             "--device, heartbeat the ticket lease, drain gracefully on "
             "SIGTERM (fleet/worker.py; pair with --coordinator "
             "filestore|s3 so N processes share one queue)")
    wk.add_argument("--queue", default="fleet",
                    help="durable admission queue name")
    wk.add_argument("--worker-index", type=int, default=-1,
                    help="this worker's index (-1 = random)")
    wk.add_argument("--heartbeat", type=float, default=1.0,
                    help="ticket lease renewal interval (seconds)")
    wk.add_argument("--idle-exit", type=float, default=0.0,
                    help="exit after this many seconds with nothing "
                         "claimable (0 = run until SIGTERM)")
    wk.add_argument("--max-tickets", type=int, default=0,
                    help="exit after running N tickets (0 = unbounded)")
    top = sub.add_parser(
        "top",
        help="live per-transfer / per-tenant resource console: polls "
             "GET /debug/ledger on a running worker's health port "
             "(stats/ledger.py), or with --fleet merges the "
             "coordinator's obs segments")
    top.add_argument("--url", default="http://127.0.0.1:8080",
                     help="health server base URL of the worker "
                          "(--health-port)")
    top.add_argument("--interval", type=float, default=2.0,
                     help="seconds between frames")
    top.add_argument("--frames", type=int, default=0,
                     help="stop after N frames (0 = until Ctrl-C)")
    top.add_argument("--limit", type=int, default=20,
                     help="transfer rows per frame")
    top.add_argument("--json", action="store_true", dest="as_json",
                     help="print one raw snapshot (ledger, or the "
                          "merged fleet view under --fleet) and exit")
    top.add_argument("--once", action="store_true",
                     help="render one formatted frame and exit")
    top.add_argument("--fleet", action="store_true",
                     help="cluster pane: merge the obs segments of every "
                          "worker process from the coordinator (global "
                          "--coordinator* flags): fleet ledger, "
                          "per-worker liveness ages, merged latency "
                          "histograms, cross-process conservation")
    sl = sub.add_parser(
        "slo",
        help="SLO verdicts: burn-rate objectives (fast 5m / slow 1h "
             "windows) over the merged obs-segment stream plus the "
             "per-transfer freshness watermarks (stats/slo.py); "
             "default polls GET /debug/slo on a worker's health "
             "port, --fleet evaluates the coordinator's segments, "
             "--demo runs a sample transfer and judges it")
    sl.add_argument("--url", default="http://127.0.0.1:8080",
                    help="health server base URL of the worker")
    sl.add_argument("--fleet", action="store_true",
                    help="evaluate the obs segments from the coordinator "
                         "(global --coordinator* flags)")
    sl.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable verdicts")
    sl.add_argument("--demo", action="store_true",
                    help="run the sample->stdout demo transfer on "
                         "--device, then evaluate this process's state")
    sl.add_argument("--rows", type=int, default=50_000,
                    help="demo rows")
    ex = sub.add_parser(
        "explain",
        help="critical-path attribution: walk the causal trace and "
             "attribute end-to-end wall time to pipeline stages with a "
             "top-3-levers summary (stats/critpath.py); `explain demo` "
             "runs the sample->stdout demo transfer traced on --device, "
             "`explain <transfer-id>` merges the fleet obs segments")
    ex.add_argument("target",
                    help="'demo' or a transfer id to explain from the "
                         "coordinator's obs segments")
    ex.add_argument("--rows", type=int, default=50_000,
                    help="demo rows")
    ex.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report")
    for name in ("check", "chaos", "flight"):
        # any arguments: main() refuses the command itself
        sub.add_parser(name, help=f"not ported: {LEFT_OUT[name]}")
    return p


def _setup(args) -> None:
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    from transferia_tpu_torch.runtime import knobs

    if knobs.env_str("TRANSFERIA_TPU_TRACE", "") not in (
            "", "0", "false", "no"):
        # headless span capture: the health port's /debug/trace and a
        # final write_chrome_trace see every span of the run
        from transferia_tpu_torch.stats import trace as _trace

        _trace.enable(True)
    # secret redaction + value truncation on every handler
    from transferia_tpu_torch.utils.logsanitize import install as _install

    _install()
    if args.metrics_port:
        from transferia_tpu_torch.stats.exposition import start_http_server

        start_http_server(args.metrics_port)
        logging.info("metrics on :%d", args.metrics_port)
    if args.health_port:
        _start_health_server(args.health_port)
    # cgroup-derived RAM budget
    from transferia_tpu_torch.runtime.limits import apply_resource_limits

    apply_resource_limits()


def _query_seconds(path: str, default: float = 5.0) -> float:
    """?seconds=N off a debug-endpoint path (callers cap at 60)."""
    from urllib.parse import parse_qs, urlparse

    q = parse_qs(urlparse(path).query)
    try:
        return float(q.get("seconds", [default])[0])
    except ValueError:
        return default


def _start_health_server(port: int):
    """Minimal /health endpoint plus the debug panes the port has.

    Returns the server (port=0 binds an ephemeral one: tests read
    `server_address`; `shutdown()` stops it)."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        # chunked transfer encoding (the streamed /debug/trace) needs 1.1
        protocol_version = "HTTP/1.1"

        def _send(self, status: int, ctype: str, body: bytes) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/debug/trace"):
                # span timeline capture (stats/trace.py): tracing on for
                # ?seconds=N (cap 60), Chrome trace-event JSON streamed
                # in chunks; 503 when the capture blows its deadline
                from transferia_tpu_torch.stats import trace

                try:
                    doc = trace.capture_seconds(_query_seconds(self.path))
                except TimeoutError as e:
                    self._send(503, "application/json",
                               json.dumps({"error": str(e)}).encode())
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for chunk in trace.iter_chrome_trace_chunks(doc):
                    data = chunk.encode()
                    self.wfile.write(
                        f"{len(data):X}\r\n".encode() + data + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
                return
            if self.path.startswith("/debug/fleet/obs"):
                # fleet-wide observability pane: obs segments of N
                # worker processes merged through the registered
                # coordinator (stats/fleetobs.py)
                from transferia_tpu_torch.stats import fleetobs

                view = fleetobs.debug_fleet_obs()
                if view is None:
                    self._send(503, "application/json", json.dumps({
                        "error": "no obs runtime registered (run under "
                                 "`trtpu worker` with an obs-capable "
                                 "coordinator)"}).encode())
                else:
                    self._send(200, "application/json",
                               fleetobs.dumps_view(view).encode())
            elif self.path.startswith("/debug/slo"):
                # burn-rate verdicts + freshness watermarks: fleet-wide
                # through the registered obs runtime, this process's
                # own state otherwise (stats/slo.py)
                from transferia_tpu_torch.stats import slo

                self._send(200, "application/json", json.dumps(
                    slo.debug_slo(), default=str).encode())
            elif self.path.startswith("/debug/fleet"):
                # fleet control plane state: admission queues, tenant
                # debt, dispatch percentiles, desired_workers
                from transferia_tpu_torch import fleet

                self._send(200, "application/json",
                           json.dumps(fleet.debug_snapshot()).encode())
            elif self.path.startswith("/debug/ledger"):
                # per-transfer/per-tenant resource attribution + the
                # conservation reconciliation (stats/ledger.py)
                from transferia_tpu_torch.stats.ledger import LEDGER

                self._send(200, "application/json",
                           json.dumps(LEDGER.snapshot()).encode())
            elif self.path.startswith("/debug/profile"):
                # sampling CPU profile; ?seconds=N caps at 60
                from transferia_tpu_torch.stats.profiler import (
                    sample_seconds,
                )

                secs = _query_seconds(self.path)
                self._send(200, "text/plain",
                           sample_seconds(secs).format(30).encode())
            elif self.path == "/debug/threads":
                # stack dump of every thread
                import traceback

                frames = sys._current_frames()
                names = {t.ident: t.name for t in threading.enumerate()}
                parts = [
                    f"Thread {names.get(ident, '?')} ({ident}):\n"
                    + "".join(traceback.format_stack(frame))
                    for ident, frame in frames.items()
                ]
                self._send(200, "text/plain", "\n".join(parts).encode())
            else:
                status = 200 if self.path in ("/", "/health") else 404
                self._send(status, "application/json", b'{"status":"ok"}')

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _coordinator(args):
    if args.coordinator == "filestore":
        if not args.coordinator_dir:
            raise SystemExit(
                "--coordinator filestore requires --coordinator-dir"
            )
        return new_coordinator("filestore", root=args.coordinator_dir)
    if args.coordinator == "s3":
        if not args.coordinator_bucket:
            raise SystemExit(
                "--coordinator s3 requires --coordinator-bucket "
                "(credentials via AWS_ACCESS_KEY_ID/AWS_SECRET_ACCESS_KEY)"
            )
        return new_coordinator(
            "s3",
            bucket=args.coordinator_bucket,
            endpoint=args.coordinator_endpoint,
            region=args.coordinator_region,
            prefix=args.coordinator_prefix,
        )
    # memory coordinator cannot share parts across processes
    if args.job_count > 1:
        raise SystemExit(
            "--coordinator memory does not support --job-count > 1; "
            "use --coordinator filestore or s3 (main.go:118-121 parity)"
        )
    return new_coordinator("memory")


def _load_transfer(args):
    from transferia_tpu_torch.cli.config import load_transfer

    transfer = load_transfer(args.transfer)
    transfer.runtime.current_job = args.job_index
    if args.job_count:
        transfer.runtime.sharding.job_count = args.job_count
    if args.process_count:
        transfer.runtime.sharding.process_count = args.process_count
    return transfer


def cli() -> int:
    """Console entry.  Process-wide signal tweaks live HERE, not in
    main(): tests call main() in-process and a leaked SIGPIPE=SIG_DFL
    would turn any broken-pipe write later in the run into silent
    process death."""
    try:
        # die quietly when piped into head & co.
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):
        pass  # non-POSIX
    return main()


def main(argv=None) -> int:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    left = args.command if args.command in LEFT_OUT else ""
    if extra and not left:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if left:
        print(left_out_message(left), file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    _setup(args)

    if args.command == "describe":
        return cmd_describe(args)
    if args.command == "validate":
        return cmd_validate(args, device)
    if args.command == "typesystem-docs":
        return cmd_typesystem_docs(args)
    if args.command == "trace":
        return cmd_trace(args, device)
    if args.command == "fleet":
        return cmd_fleet(args, device)
    if args.command == "worker":
        return cmd_worker(args, device)
    if args.command == "top":
        return cmd_top(args)
    if args.command == "slo":
        return cmd_slo(args, device)
    if args.command == "explain":
        return cmd_explain(args, device)

    transfer = _load_transfer(args)
    cp = _coordinator(args)
    # an include list widened/narrowed by add-/remove-tables overrides the
    # spec on restart (persisted through the coordinator)
    from transferia_tpu_torch.tasks import apply_persisted_include_list

    apply_persisted_include_list(transfer, cp)
    op_id = args.operation_id or None

    if args.command == "activate":
        from transferia_tpu_torch.tasks import activate_delivery

        activate_delivery(transfer, cp, operation_id=op_id, device=device)
        print(f"transfer {transfer.id}: activated")
        return 0

    if args.command == "upload":
        from transferia_tpu_torch.tasks import upload

        upload(transfer, cp, args.table, operation_id=op_id, device=device)
        print(f"transfer {transfer.id}: uploaded {len(args.table)} table(s)")
        return 0

    if args.command == "reupload":
        from transferia_tpu_torch.tasks import reupload

        reupload(transfer, cp, operation_id=op_id, device=device)
        print(f"transfer {transfer.id}: reuploaded")
        return 0

    if args.command == "add-tables":
        from transferia_tpu_torch.tasks import add_tables

        add_tables(transfer, cp, args.table, operation_id=op_id,
                   device=device)
        print(f"transfer {transfer.id}: added {len(args.table)} table(s)")
        return 0

    if args.command == "remove-tables":
        from transferia_tpu_torch.tasks import remove_tables

        remove_tables(transfer, cp, args.table)
        print(f"transfer {transfer.id}: removed {len(args.table)} table(s)")
        return 0

    if args.command == "replicate":
        return cmd_replicate(args, transfer, cp, device)

    if args.command == "checksum":
        return cmd_checksum(args, transfer, cp, device)

    if args.command == "deactivate":
        from transferia_tpu_torch.providers.registry import get_provider

        get_provider(transfer.src_provider(), transfer,
                     device=device).deactivate()
        cp.set_status(transfer.id, TransferStatus.DEACTIVATED)
        print(f"transfer {transfer.id}: deactivated")
        return 0

    if args.command == "sniff":
        from transferia_tpu_torch.providers.registry import get_provider

        sample = get_provider(transfer.src_provider(), transfer,
                              device=device).sniff(max_rows=args.rows)
        print(json.dumps(sample, indent=2, default=str))
        return 0

    if args.command == "regular-snapshot":
        from transferia_tpu_torch.runtime.local import run_regular_snapshot

        run_regular_snapshot(transfer, cp, max_runs=args.max_runs,
                             device=device)
        return 0

    raise SystemExit(f"unknown command {args.command}")


def cmd_replicate(args, transfer, cp, device) -> int:
    """Activate when there is no prior state, then loop the replication
    worker until SIGINT or SIGTERM."""
    from transferia_tpu_torch.runtime.local import run_replication
    from transferia_tpu_torch.tasks import activate_delivery

    state = cp.get_transfer_state(transfer.id)
    if state.get("status") != "activated":
        activate_delivery(transfer, cp, device=device)
    if not transfer.type.has_replication:
        print("transfer is snapshot-only; nothing to replicate")
        return 0
    stop = threading.Event()

    def handle_sig(signum, frame):
        logging.info("signal %d: stopping replication", signum)
        stop.set()

    # main() may run in-process (tests, chip_smoke.py): put the
    # previous handlers back once replication stops
    previous = {s: signal.signal(s, handle_sig)
                for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        run_replication(transfer, cp, stop_event=stop,
                        max_attempts=args.max_attempts, device=device)
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
    return 0


def _recorded_table(fqtn: str):
    """The table a recorded fingerprint's key names: the snapshot keys
    its digests by `TableID.fqtn()` (`"ns"."name"`).  The reference
    splits the key at its first dot and keeps the quotes, so its lookup
    fails on every table; the port reads the key back into its parts
    (ROADMAP.md C, a deliberate difference)."""
    import re

    from transferia_tpu_torch.abstract.schema import TableID

    m = re.fullmatch(r'"([^"]*)"\."([^"]*)"', fqtn) or \
        re.fullmatch(r'()"([^"]*)"', fqtn)
    return TableID(*m.groups()) if m else TableID.parse(fqtn)


def _checksum_against_operation(args, cp, dst_storage, device) -> int:
    """Target-only validation: fingerprint every table the snapshot
    recorded (the digests in the operation state) on `device` and
    compare; the source is never read again."""
    from transferia_tpu_torch.abstract.interfaces import is_columnar
    from transferia_tpu_torch.abstract.table import TableDescription
    from transferia_tpu_torch.columnar.batch import ColumnBatch
    from transferia_tpu_torch.ops.rowhash import TableFingerprinter

    state = cp.get_operation_state(args.against_operation)
    recorded = state.get("table_fingerprints") or {}
    if not recorded:
        print(f"operation {args.against_operation}: no recorded "
              f"fingerprints (was the snapshot run with validation: "
              f"{{fingerprint: true}}?)", file=sys.stderr)
        return 2
    rc = 0
    for fqtn, want in sorted(recorded.items()):
        tid = _recorded_table(fqtn)
        fp = TableFingerprinter(backend=args.fingerprint_backend,
                                device=device)

        def pusher(batch):
            if is_columnar(batch):
                fp.push(batch)
                return
            rows = [it for it in batch if it.is_row_event()]
            if rows:
                fp.push(ColumnBatch.from_rows(rows))

        try:
            dst_storage.load_table(TableDescription(id=tid), pusher)
        except Exception as e:
            print(f"{fqtn}: ERROR reading target: {e}")
            rc = 1
            continue
        got = fp.result().digest()
        if got == want:
            print(f"{fqtn}: OK [fingerprint] {got}")
        else:
            print(f"{fqtn}: MISMATCH [fingerprint] uploaded={want} "
                  f"target={got}")
            rc = 1
    return rc


def cmd_checksum(args, transfer, cp, device) -> int:
    """The full validation task: sampling storages, type-aware
    comparators, streaming compare; the fingerprint on `device`.  With
    `--against-operation`, the target against a snapshot's recorded
    fingerprints."""
    from transferia_tpu_torch.abstract.schema import TableID
    from transferia_tpu_torch.factories import new_storage
    from transferia_tpu_torch.providers.registry import get_provider
    from transferia_tpu_torch.tasks.checksum import (
        ChecksumParameters,
        compare_checksum,
        heterogeneous_data_types,
    )

    dst_provider = get_provider(transfer.dst_provider(), transfer,
                                device=device)
    # never fall back to .storage(): that reads transfer.src and would
    # vacuously compare the source against itself
    dst_storage = getattr(dst_provider, "destination_storage",
                          lambda: None)()
    if dst_storage is None:
        print("destination provider has no storage view of the target; "
              "cannot checksum", file=sys.stderr)
        return 2
    if args.against_operation:
        return _checksum_against_operation(args, cp, dst_storage, device)
    src_storage = new_storage(transfer)
    params = ChecksumParameters()
    if args.size_threshold is not None:
        params.table_size_threshold = args.size_threshold
    params.method = args.method
    params.fingerprint_backend = args.fingerprint_backend
    tables = None
    if args.table:
        tables = []
        for spec in args.table:
            ns, _, name = spec.rpartition(".")
            tables.append(TableID(ns, name))
    same = transfer.src_provider() == transfer.dst_provider()
    eq = ((lambda a, b: a == b) if (args.strict_types or same)
          else heterogeneous_data_types)
    report = compare_checksum(src_storage, dst_storage, tables,
                              params, equal_data_types=eq, device=device)
    print(report.summary())
    return 0 if report.ok else 1


def _demo_trace_transfer(rows: int):
    """sample->stdout snapshot with a fusable mask+filter chain: a
    self-contained timeline demo that exercises source decode, the
    fused device transform (mask+filter), the row pivot (verbose stdout
    sink unpivots a slice), and the sink — no external services."""
    from transferia_tpu_torch.models import Transfer, TransferType
    from transferia_tpu_torch.providers.sample import SampleSourceParams
    from transferia_tpu_torch.providers.stdout import StdoutTargetParams

    return Transfer(
        id="trace-demo",
        type=TransferType.SNAPSHOT_ONLY,
        src=SampleSourceParams(preset="iot", rows=rows),
        dst=StdoutTargetParams(verbose=True, max_rows_printed=2),
        transformation={"transformers": [
            {"mask_field": {"columns": ["device_id"], "salt": "trace"}},
            {"filter_rows": {"filter": "event_id >= 0"}},
        ]},
    )


def cmd_trace(args, device) -> int:
    """Run one transfer with tracing enabled; write trace.json (Chrome
    trace-event format, open in Perfetto) and print the stage summary
    (p50/p99 per stage, overlap factor, bytes moved) plus the device
    telemetry counters."""
    import time as _time

    from transferia_tpu_torch.stats import trace
    from transferia_tpu_torch.stats.ledger import LEDGER
    from transferia_tpu_torch.stats.registry import Metrics

    if args.fleet:
        return cmd_trace_fleet(args)
    if args.transfer:
        transfer = _load_transfer(args)
    else:
        transfer = _demo_trace_transfer(args.rows)
    cp = _coordinator(args)
    metrics = Metrics()
    trace.reset()
    trace.TELEMETRY.reset()  # fresh counters for this one-shot run
    trace.enable(True)
    t0 = _time.perf_counter()
    try:
        if transfer.type.has_replication:
            from transferia_tpu_torch.runtime.local import run_replication

            stop = threading.Event()
            timer = threading.Timer(max(0.5, args.seconds), stop.set)
            timer.daemon = True
            timer.start()
            try:
                run_replication(transfer, cp, metrics=metrics,
                                stop_event=stop, device=device)
            finally:
                timer.cancel()
        else:
            from transferia_tpu_torch.tasks import SnapshotLoader

            SnapshotLoader(transfer, cp, metrics=metrics,
                           device=device).upload_tables()
    finally:
        # export in the finally: a failed transfer is exactly when the
        # timeline matters most — the spans up to the failure survive
        wall = _time.perf_counter() - t0
        trace.enable(False)
        trace.TELEMETRY.fold_into(metrics)
        LEDGER.fold_into(metrics)
        n_events = trace.write_chrome_trace(args.out)
        print(f"trace: {n_events} events -> {args.out} "
              f"(open in https://ui.perfetto.dev or chrome://tracing)")
        print(trace.format_summary(wall))
        print("device telemetry: "
              + json.dumps(trace.TELEMETRY.snapshot()))
    return 0


def cmd_trace_fleet(args) -> int:
    """`trtpu trace --fleet <transfer>`: stitch the obs segments of every
    process that touched the transfer into one Perfetto timeline
    (stats/fleetobs.py): each worker process is a pid lane, and
    cross-process parent links render as flow arrows."""
    from transferia_tpu_torch.stats import fleetobs

    cp = _coordinator(args)
    if not cp.supports_obs_segments():
        print("coordinator has no obs-segment support; nothing to "
              "merge", file=sys.stderr)
        return 2
    scope = fleetobs.default_scope()
    segments = cp.list_obs_segments(scope)
    if not segments:
        print(f"no obs segments under scope {scope!r} — are workers "
              f"running with observability export on?", file=sys.stderr)
        return 2
    transfer_filter = "" if args.fleet == "all" else args.fleet
    doc = fleetobs.export_fleet_chrome_trace(
        segments, transfer_id=transfer_filter)
    with open(args.out, "w") as fh:
        json.dump(doc, fh)
    other = doc["otherData"]
    view = fleetobs.merge_segments(segments)
    cons = view["conservation"]
    print(f"fleet trace: {len(doc['traceEvents'])} events from "
          f"{other['processes']} process(es) "
          f"({other['segments']} segments, "
          f"{other['corrupt_segments']} torn) -> {args.out} "
          f"(open in https://ui.perfetto.dev)")
    print(f"fleet conservation: "
          f"{'OK' if cons['ok'] else 'DRIFT ' + json.dumps(cons['drift'])}")
    if transfer_filter and other["processes"] == 0:
        print(f"no spans matched transfer {transfer_filter!r} "
              f"(check the id, or pass 'all')", file=sys.stderr)
        return 1
    return 0


def cmd_fleet(args, device) -> int:
    """Fleet scheduler bench (fleet/bench.py) with every transfer on
    `device`.  Exit 0 only when every transfer delivered, nothing was
    lost or double-admitted, and the Jain fairness index held >= 0.9
    under the skewed tenant mix."""
    from transferia_tpu_torch.fleet.bench import (
        format_report,
        run_fleet_bench,
    )

    report = run_fleet_bench(
        transfers=args.transfers, workers=args.workers,
        lanes=args.lanes, rows=args.rows, seed=args.seed, device=device)
    if args.as_json:
        print(json.dumps(report, indent=1))
    else:
        print(format_report(report))
    return 0 if report["ok"] else 1


def cmd_worker(args, device) -> int:
    """Run one fleet worker process against the durable admission queue
    (`trtpu worker`, fleet/worker.py), its tickets on `device`.
    SIGTERM/SIGINT request a graceful drain: the running transfer yields
    at its next part boundary, the claim is released back to the queue,
    and the process exits 0; a peer resumes the transfer from its
    committed parts."""
    import os

    from transferia_tpu_torch.fleet.worker import FleetWorker

    cp = _coordinator(args)
    if args.coordinator == "memory":
        logging.warning(
            "worker on a memory coordinator: the queue is invisible to "
            "other processes (use --coordinator filestore or s3 for a "
            "real fleet)")
    if args.worker_index >= 0:
        index = args.worker_index
    else:
        # random, not pid-derived: every containerized worker is pid 1,
        # and two workers sharing an id could renew each other's claims
        index = int.from_bytes(os.urandom(3), "big") % 1_000_000
    worker = FleetWorker(
        cp, queue=args.queue, worker_index=index,
        heartbeat_interval=args.heartbeat,
        idle_exit_seconds=args.idle_exit,
        max_tickets=args.max_tickets, device=device)
    if cp.supports_obs_segments():
        # give this process's health port the fleet panes
        from transferia_tpu_torch.stats import fleetobs

        fleetobs.register_runtime(cp, health_scope=f"fleet:{args.queue}")
    stop = threading.Event()

    def handle_sig(signum, frame):
        logging.info("signal %d: draining worker %s", signum,
                     worker.worker_id)
        worker.request_drain()
        stop.set()

    # main() may run in-process (tests, chip_smoke.py): put the previous
    # handlers back once the worker exits
    previous = {s: signal.signal(s, handle_sig)
                for s in (signal.SIGINT, signal.SIGTERM)}
    logging.info("fleet worker %s serving queue %r", worker.worker_id,
                 args.queue)
    try:
        worker.run(stop)
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
    print(f"worker {worker.worker_id}: {worker.tickets_run} ticket(s) "
          f"run")
    return 0


def cmd_top(args) -> int:
    """Resource console: one process over GET /debug/ledger
    (stats/ledger.py format_top), or with --fleet the merged cluster
    pane from the coordinator's obs segments (stats/fleetobs.py).  One
    frame per --interval; --once renders one frame, --json dumps one
    raw snapshot."""
    import time as _time
    import urllib.request

    from transferia_tpu_torch.stats.ledger import format_top

    if args.fleet:
        return cmd_top_fleet(args)
    url = args.url.rstrip("/") + "/debug/ledger"
    frames = 0
    try:
        while True:
            try:
                with urllib.request.urlopen(url, timeout=10) as resp:
                    snap = json.loads(resp.read())
            except (OSError, ValueError) as e:
                print(f"trtpu top: {url}: {e}", file=sys.stderr)
                return 2
            if not isinstance(snap, dict) or "totals" not in snap:
                print(f"trtpu top: {url}: response is not a "
                      f"/debug/ledger snapshot (wrong service?)",
                      file=sys.stderr)
                return 2
            # lag/SLO columns ride the same poll, best-effort
            slo_url = args.url.rstrip("/") + "/debug/slo"
            try:
                with urllib.request.urlopen(slo_url, timeout=10) as r:
                    verdicts = json.loads(r.read())
                if isinstance(verdicts, dict) and "objectives" in verdicts:
                    snap["slo"] = verdicts
            except (OSError, ValueError):
                pass
            if args.as_json:
                print(json.dumps(snap, indent=1))
                return 0
            if frames and sys.stdout.isatty():
                print("\x1b[2J\x1b[H", end="")
            print(format_top(snap, limit=args.limit), flush=True)
            frames += 1
            if args.once or (args.frames and frames >= args.frames):
                return 0
            _time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0


def cmd_top_fleet(args) -> int:
    """`trtpu top --fleet`: every worker process's obs segments read
    through the coordinator and merged (latest cumulative state per
    process, summed across processes): the fleet ledger with per-worker
    liveness ages and merged latency tails."""
    import time as _time

    from transferia_tpu_torch.stats import fleetobs

    cp = _coordinator(args)
    if not cp.supports_obs_segments():
        print("trtpu top --fleet: coordinator has no obs-segment "
              "support", file=sys.stderr)
        return 2
    frames = 0
    try:
        while True:
            try:
                view = fleetobs.read_view(cp)
            except Exception as e:
                print(f"trtpu top --fleet: segment read failed: {e}",
                      file=sys.stderr)
                return 2
            if args.as_json:
                print(fleetobs.dumps_view(view))
                return 0
            if frames and sys.stdout.isatty():
                print("\x1b[2J\x1b[H", end="")
            print(fleetobs.format_fleet_top(view, limit=args.limit),
                  flush=True)
            frames += 1
            if args.once or (args.frames and frames >= args.frames):
                return 0
            _time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0


def _run_demo_snapshot(rows: int, device) -> None:
    """One traced sample->stdout snapshot in this process on `device`
    (what `slo --demo` and `explain demo` judge)."""
    from transferia_tpu_torch.coordinator import MemoryCoordinator
    from transferia_tpu_torch.stats import trace
    from transferia_tpu_torch.stats.registry import Metrics
    from transferia_tpu_torch.tasks import SnapshotLoader

    trace.reset()
    trace.enable(True)
    try:
        SnapshotLoader(_demo_trace_transfer(rows), MemoryCoordinator(),
                       metrics=Metrics(), device=device).upload_tables()
    finally:
        trace.enable(False)


def cmd_slo(args, device) -> int:
    """`trtpu slo`: burn-rate verdicts + freshness watermarks.  URL mode
    polls GET /debug/slo (non-JSON or wrong-shape bodies exit 2);
    --fleet evaluates the coordinator's obs segments; --demo runs the
    sample snapshot on `device` first so the verdicts have data."""
    import urllib.request

    from transferia_tpu_torch.stats import slo

    if args.demo:
        _run_demo_snapshot(args.rows, device)
        view = slo.evaluate(slo.local_segments())
        view["scope"] = "demo"
    elif args.fleet:
        from transferia_tpu_torch.stats import fleetobs

        cp = _coordinator(args)
        if not cp.supports_obs_segments():
            print("trtpu slo --fleet: coordinator has no obs-segment "
                  "support", file=sys.stderr)
            return 2
        scope = fleetobs.default_scope()
        segments = cp.list_obs_segments(scope)
        if not segments:
            print(f"trtpu slo --fleet: no obs segments under scope "
                  f"{scope!r}", file=sys.stderr)
            return 2
        view = slo.evaluate(segments)
        view["scope"] = scope
    else:
        url = args.url.rstrip("/") + "/debug/slo"
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                view = json.loads(resp.read())
        except (OSError, ValueError) as e:
            print(f"trtpu slo: {url}: {e}", file=sys.stderr)
            return 2
        if not isinstance(view, dict) or "objectives" not in view:
            detail = view.get("error") if isinstance(view, dict) \
                else "response is not a /debug/slo payload"
            print(f"trtpu slo: {url}: {detail}", file=sys.stderr)
            return 2
    if args.as_json:
        print(json.dumps(view, indent=1, default=str))
    else:
        print(slo.format_verdicts(view))
    return 0 if view.get("ok") else 1


def cmd_explain(args, device) -> int:
    """`trtpu explain`: critical-path attribution.  `demo` runs the
    traced sample snapshot on `device` and explains its own spans; a
    transfer id merges the coordinator's obs segments (a multi-worker
    critical path through cross-process flow links)."""
    from transferia_tpu_torch.stats import critpath

    if args.target == "demo":
        _run_demo_snapshot(args.rows, device)
        records = critpath.records_from_local()
        report = critpath.explain(records, transfer_id="trace-demo")
    else:
        from transferia_tpu_torch.stats import fleetobs

        cp = _coordinator(args)
        if not cp.supports_obs_segments():
            print("trtpu explain: coordinator has no obs-segment "
                  "support", file=sys.stderr)
            return 2
        scope = fleetobs.default_scope()
        segments = cp.list_obs_segments(scope)
        if not segments:
            print(f"trtpu explain: no obs segments under scope "
                  f"{scope!r} — are workers running with observability "
                  f"export on?", file=sys.stderr)
            return 2
        records = critpath.records_from_segments(segments)
        report = critpath.explain(records, transfer_id=args.target)
    if not report.get("spans"):
        print("trtpu explain: no spans found (tracing off, or the "
              "transfer id matched nothing)", file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps(report, indent=1, default=str))
    else:
        print(critpath.format_report(report))
    return 0


def cmd_validate(args, device) -> int:
    from transferia_tpu_torch.cli.config import load_transfer

    try:
        transfer = load_transfer(args.transfer)
    except Exception as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    # also validate the transformer chain compiles
    from transferia_tpu_torch.transform import build_chain

    try:
        build_chain(transfer.transformation, device=device)
    except Exception as e:
        print(f"INVALID transformation: {e}", file=sys.stderr)
        return 1
    print(f"OK: {transfer.id} ({transfer.type.value}) "
          f"{transfer.src_provider()} -> {transfer.dst_provider()}")
    return 0


def cmd_typesystem_docs(args) -> int:
    """Generate per-provider typesystem.md files."""
    import os

    from transferia_tpu_torch.providers import load_builtin_providers
    from transferia_tpu_torch.typesystem.rules import (
        doc_markdown,
        supported_providers,
    )

    load_builtin_providers()
    os.makedirs(args.out, exist_ok=True)
    for provider in supported_providers():
        path = os.path.join(args.out, f"{provider}.md")
        with open(path, "w") as fh:
            fh.write(doc_markdown(provider))
        print(path)
    return 0


def cmd_describe(args) -> int:
    """Dump endpoint params JSON schemas."""
    import dataclasses

    from transferia_tpu_torch.models.endpoint import _ENDPOINT_REGISTRY
    from transferia_tpu_torch.providers import load_builtin_providers

    load_builtin_providers()
    out = {}
    for (provider, role), cls in sorted(_ENDPOINT_REGISTRY.items()):
        if args.provider and provider != args.provider:
            continue
        fields = {}
        for f in dataclasses.fields(cls):
            default = f.default if f.default is not dataclasses.MISSING \
                else None
            fields[f.name] = {
                "type": str(f.type),
                "default": default.value
                if hasattr(default, "value") else default,
            }
        out[f"{provider}/{role}"] = fields
    print(json.dumps(out, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(cli())
