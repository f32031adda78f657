"""End-to-end pipeline tracing: spans, device telemetry, Perfetto export
(the port's copy of ``transferia_tpu/stats/trace.py``).

The sampling profiler (stats/profiler.py) answers "which frame burns
CPU"; stagetimer answers "how much wall per stage".  Neither shows the
*timeline*: whether device waits overlap host packing, where a batch
stalls between parsequeue and the sink, or when a kernel build lands
inside the measured window.  This module records begin/end spans into a
bounded ring buffer and exports Chrome trace-event JSON loadable in
Perfetto / `chrome://tracing` — the span-level attribution Thallus-style
transport analysis needs (PAPERS.md) and the per-stage transfer
accounting the Arrow Flight benchmarking work shows wire-speed columnar
systems live or die on.

Design constraints:

- near-zero overhead when disabled: `span()` does ONE module-bool check
  and returns a shared no-op singleton — no allocation, no lock;
- thread-safe when enabled: per-thread span stacks (nesting + self-time
  attribution need no lock), one lock only around ring appends;
- monotonic clocks (`time.perf_counter`), microsecond timestamps
  relative to the capture epoch (what the trace-event format expects);
- bounded memory: a `deque(maxlen=capacity)` ring — a forgotten-enabled
  tracer on a long replication run costs a fixed buffer, never OOM.

Span taxonomy (see ARCHITECTURE.md "Tracing & device telemetry"):
roots `part` / `batch` / `replication_attempt` carry identity args
(transfer_id, table, part, batch_seq); stage spans `source_decode`,
`pivot`, `pack`, `device_dispatch`, `device_wait`, `host_post`,
`transform`, `serialize`, `bufferer_flush`, `sink_push`, `sink` nest
under them.  `device_dispatch`/`device_wait` carry byte counts as args.
`decode_readahead` spans live on the prefetcher worker threads
(providers/readahead.py) — decode running there shows as its own
track, overlapping the part's downstream spans.

`DeviceTelemetry` is the always-on counter half: H2D/D2H bytes and
transfer counts, device launches, kernel builds (`compile_events`:
`ops/_build.py::build_all` records one per `nvcc` build, where the
reference hooks jax's backend-compile event), and per-kernel wall time
(host wall from the start of the wait until the results are on the
host, never a CUDA-event reading).  It folds into the
prometheus `Metrics` facade via `fold_into()` (stats/registry.py
DeviceStats).

Causality: every recorded span carries (trace_id, span_id,
parent_id).  The active span context rides a `contextvars.ContextVar`,
so nesting links parent→child automatically on one thread, and the
capture/adopt pair carries it across thread hops (readahead workers,
upload-part pool, the parse queue's pusher, the Asynchronizer) and —
via `wire_format` / `parse_wire` — across a wire hop.  The Chrome export emits flow events for every parent link
that crosses a thread, so one transfer renders as a single
causally-linked timeline in Perfetto even when its spans live on six
threads.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import socket as _socket
import threading
import time
import weakref
import zlib as _zlib
from collections import deque
from typing import NamedTuple, Optional

DEFAULT_CAPACITY = 200_000  # spans; ~100 bytes each -> bounded ~20MB

_enabled = False
_epoch = 0.0
_lock = threading.Lock()
_ring: deque = deque(maxlen=DEFAULT_CAPACITY)
# lifetime count of ring appends (not ring length: the deque evicts);
# the obs-segment exporter (stats/fleetobs.py) reads it as its delta
# mark
_recorded = 0
_tls = threading.local()


class SpanContext(NamedTuple):
    """The propagation token: which trace, which span is 'current'.

    Immutable and tiny on purpose — it crosses thread boundaries by
    value and the wire as `"<trace_id>:<span_id>"`."""

    trace_id: int
    span_id: int


# span/trace ids are process-unique counters salted by (host, pid) so
# ids minted by two processes, on one host or on two, never collide in
# one merged view
_ids = itertools.count(
    ((_zlib.crc32(_socket.gethostname().encode()) & 0xFFFF) << 48)
    + ((os.getpid() & 0xFFFF) << 32) + 1)
_ctx: "contextvars.ContextVar[Optional[SpanContext]]" = \
    contextvars.ContextVar("trtpu_trace_ctx", default=None)


class _NoopSpan:
    """Shared disabled-path singleton: falsy, allocation-free."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def add(self, **args) -> None:
        pass

    def context(self) -> Optional[SpanContext]:
        return None


_NOOP = _NoopSpan()


class Span:
    __slots__ = ("name", "args", "_t0", "_child",
                 "trace_id", "span_id", "parent_id", "_token")

    def __init__(self, name: str, args: Optional[dict] = None):
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._child = 0.0  # seconds covered by nested spans
        self.trace_id = 0
        self.span_id = 0
        self.parent_id = 0
        self._token = None

    def __bool__(self):
        return True

    def add(self, **args) -> None:
        """Attach args discovered mid-span (bytes moved, row counts)."""
        if self.args is None:
            self.args = args
        else:
            self.args.update(args)

    def context(self) -> SpanContext:
        """This span's propagation token (valid after __enter__)."""
        return SpanContext(self.trace_id, self.span_id)

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        parent = _ctx.get()
        self.span_id = next(_ids)
        if parent is not None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            self.trace_id = self.span_id  # a new root starts its trace
        self._token = _ctx.set(SpanContext(self.trace_id, self.span_id))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        dur = t1 - self._t0
        if self._token is not None:
            _ctx.reset(self._token)
            self._token = None
        stack = _tls.stack
        stack.pop()
        depth = len(stack)
        if depth:
            stack[-1]._child += dur
        t = threading.current_thread()
        global _recorded
        with _lock:
            _recorded += 1
            _ring.append((
                self.name, t.ident, t.name,
                self._t0 - _epoch, dur, max(0.0, dur - self._child),
                depth, self.args,
                self.trace_id, self.span_id, self.parent_id,
            ))
        return False


def enable(on: bool = True, capacity: Optional[int] = None) -> None:
    global _enabled, _epoch, _ring
    if capacity is not None and capacity != _ring.maxlen:
        with _lock:
            _ring = deque(_ring, maxlen=capacity)
    if on and not _enabled and _epoch == 0.0:
        _epoch = time.perf_counter()
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Clear the span ring and restart the capture epoch.  Does NOT
    touch TELEMETRY: the device counters are cumulative process state
    (a /metrics scrape depends on them); reset those explicitly."""
    global _epoch
    with _lock:
        _ring.clear()
    _epoch = time.perf_counter()


def span(name: str, **args):
    """The ONE per-site call.  Disabled: one bool check, shared no-op
    singleton back (hot sites attach args via `if sp: sp.add(...)` so
    the disabled path allocates nothing)."""
    if not _enabled:
        return _NOOP
    return Span(name, args or None)


def instant(name: str, ctx: Optional[SpanContext] = None,
            **args) -> None:
    """Point event (kernel builds, retries, chaos fires).  Lands ON the
    active span: the recorded tuple carries the current trace/span ids
    (or an explicit `ctx`), so Perfetto shows the instant inside the
    span that was running when it fired."""
    if not _enabled:
        return
    at = ctx if ctx is not None else _ctx.get()
    trace_id = at.trace_id if at else 0
    parent_id = at.span_id if at else 0
    t = threading.current_thread()
    global _recorded
    with _lock:
        _recorded += 1
        _ring.append((name, t.ident, t.name,
                      time.perf_counter() - _epoch, 0.0, 0.0, -1,
                      args or None, trace_id, 0, parent_id))


def complete(name: str, t0: float, dur: float,
             parent: Optional[SpanContext] = None, **args) -> None:
    """Record a span RETROACTIVELY from wall measurements already taken
    (`t0` in time.perf_counter seconds).  This is how queue-wait style
    intervals — observed only once they end, on whatever thread ends
    them — still land as real spans on the owning trace (fleet ticket
    queue wait, admission→dispatch)."""
    if not _enabled:
        return
    at = parent if parent is not None else _ctx.get()
    span_id = next(_ids)
    trace_id = at.trace_id if at else span_id
    parent_id = at.span_id if at else 0
    t = threading.current_thread()
    global _recorded
    with _lock:
        _recorded += 1
        _ring.append((name, t.ident, t.name, t0 - _epoch, dur,
                      dur, 0, args or None, trace_id, span_id,
                      parent_id))


def current() -> Optional[str]:
    """Innermost active span name on this thread (tests, debugging)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1].name if stack else None


def current_context() -> Optional[SpanContext]:
    """The active span's propagation token (None when tracing is off or
    no span is open).  Capture this BEFORE handing work to another
    thread; the worker re-enters it with `adopted()`."""
    if not _enabled:
        return None
    return _ctx.get()


class adopted:
    """Re-enter a captured SpanContext on another thread:

        ctx = trace.current_context()          # submitting thread
        ...
        with trace.adopted(ctx):               # worker thread
            with trace.span("decode_readahead"):  # parents to ctx
                ...

    A None ctx is a no-op, so call sites never need to branch on
    whether tracing was on at capture time."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[SpanContext]):
        self._ctx = ctx
        self._token = None

    def __enter__(self):
        if self._ctx is not None and _enabled:
            self._token = _ctx.set(self._ctx)
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            _ctx.reset(self._token)
            self._token = None
        return False


def wire_format(ctx: Optional[SpanContext]) -> str:
    """Serialize a context for a wire hop (Flight gRPC metadata, shm
    framing metadata).  Empty string when there is nothing to carry."""
    if ctx is None:
        return ""
    return f"{ctx.trace_id}:{ctx.span_id}"


def parse_wire(s) -> Optional[SpanContext]:
    """Inverse of wire_format; tolerant of junk (a malformed header
    must never fail the data-plane call it rode in on)."""
    if not s:
        return None
    if isinstance(s, bytes):
        s = s.decode("ascii", "replace")
    trace_s, _, span_s = s.partition(":")
    try:
        return SpanContext(int(trace_s), int(span_s))
    except ValueError:
        return None


def spans() -> list[tuple]:
    """Raw recorded tuples (name, tid, tname, t0_s, dur_s, self_s,
    depth, args, trace_id, span_id, parent_id) — depth -1 marks
    instants (span_id 0, parent_id = the span they fired on)."""
    with _lock:
        return list(_ring)


def record_count() -> int:
    """Lifetime number of records appended (monotonic; survives ring
    eviction).  `spans()[-(record_count() - mark):]` is the exporter's
    delta since `mark`; records evicted past the ring's capacity are
    lost, which the obs plane reports as `spans_dropped`."""
    with _lock:
        return _recorded


def spans_with_count() -> tuple[int, list]:
    """(record_count, ring snapshot) under one lock hold: the obs
    exporter's delta window (read apart, concurrent appends could push
    the window's oldest records out of the tail slice unseen)."""
    with _lock:
        return _recorded, list(_ring)


def epoch_unix() -> float:
    """Wall-clock time of this process's capture epoch (the zero point
    of every recorded t0).  The cross-process merge (stats/fleetobs.py)
    aligns processes' timelines by their exported epochs."""
    return time.time() - (time.perf_counter() - _epoch)


# -- export -----------------------------------------------------------------

def export_chrome_trace() -> dict:
    """Chrome trace-event JSON (dict; json.dump it).  Loadable in
    Perfetto and chrome://tracing: "X" complete events with tid/ts/dur
    in microseconds, thread-name metadata, instants as "i", and flow
    events ("s"/"f" pairs keyed by the child span id) for every
    parent→child link that crosses a thread — the arrows that stitch a
    readahead worker's decode, a fleet lane's run, and a Flight
    server-side span onto the submitting timeline."""
    recorded = spans()
    events: list[dict] = []
    seen_threads: dict[int, str] = {}
    # span_id -> (tid, ts_us) for flow-arrow sources
    located: dict[int, tuple[int, float]] = {}
    for rec in recorded:
        name, tid, tname, t0, dur, _self_s, depth, args = rec[:8]
        trace_id, span_id, parent_id = rec[8:11]
        if tid not in seen_threads:
            seen_threads[tid] = tname
        ts = round(t0 * 1e6, 1)
        ev = {
            "name": name,
            "cat": "pipeline",
            "pid": 1,
            "tid": tid,
            "ts": ts,
        }
        if depth < 0:
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = round(dur * 1e6, 1)
            if span_id:
                located[span_id] = (tid, ts)
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        if trace_id:
            ids = ev.setdefault("args", {})
            ids["trace_id"] = trace_id
            if span_id:
                ids["span_id"] = span_id
            if parent_id:
                ids["parent_id"] = parent_id
        events.append(ev)
    flows: list[dict] = []
    for rec in recorded:
        _name, tid, _tn, t0, _dur, _s, depth, _a = rec[:8]
        _trace_id, span_id, parent_id = rec[8:11]
        if depth < 0 or not parent_id:
            continue
        src = located.get(parent_id)
        if src is None or src[0] == tid:
            continue  # same-thread nesting needs no arrow
        ts = round(t0 * 1e6, 1)
        flows.append({"name": "causal", "cat": "flow", "ph": "s",
                      "id": span_id, "pid": 1, "tid": src[0],
                      "ts": src[1]})
        flows.append({"name": "causal", "cat": "flow", "ph": "f",
                      "bp": "e", "id": span_id, "pid": 1, "tid": tid,
                      "ts": ts})
    meta = [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": "transferia-tpu"}},
    ]
    for tid, tname in sorted(seen_threads.items()):
        meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                     "tid": tid, "args": {"name": tname}})
    counters = TELEMETRY.snapshot()
    return {
        "traceEvents": meta + events + flows,
        "displayTimeUnit": "ms",
        "otherData": {"device_telemetry": counters},
    }


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return str(v)


def write_chrome_trace(path: str) -> int:
    """Dump the trace to a file; returns the number of events."""
    doc = export_chrome_trace()
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return len(doc["traceEvents"])


def stage_summary(wall_seconds: Optional[float] = None) -> dict:
    """Per-stage aggregation: calls, p50/p99 ms, total and self seconds,
    bytes moved (summed from span `bytes` args), plus wall span and the
    overlap factor (sum of self-times / wall — >1 means stages overlap
    across threads; the ratio between stages is the signal)."""
    recorded = [s for s in spans() if s[6] >= 0]
    per: dict[str, dict] = {}
    t_min, t_max = None, None
    for name, _tid, _tn, t0, dur, self_s, _depth, args in (
            s[:8] for s in recorded):
        d = per.setdefault(name, {"calls": 0, "total_s": 0.0,
                                  "self_s": 0.0, "bytes": 0,
                                  "durs": []})
        d["calls"] += 1
        d["total_s"] += dur
        d["self_s"] += self_s
        d["durs"].append(dur)
        if args and isinstance(args.get("bytes"), (int, float)):
            d["bytes"] += int(args["bytes"])
        t_min = t0 if t_min is None else min(t_min, t0)
        t_max = max(t_max or 0.0, t0 + dur)
    wall = wall_seconds if wall_seconds else (
        (t_max - t_min) if recorded else 0.0)
    out: dict[str, dict] = {}
    for name, d in per.items():
        durs = sorted(d.pop("durs"))
        n = len(durs)
        d["p50_ms"] = round(durs[max(0, (n + 1) // 2 - 1)] * 1000, 3)
        d["p99_ms"] = round(
            durs[max(0, min(n - 1, int(0.99 * n)))] * 1000, 3)
        d["total_s"] = round(d["total_s"], 4)
        d["self_s"] = round(d["self_s"], 4)
        out[name] = d
    total_self = sum(d["self_s"] for d in out.values())
    return {
        "wall_s": round(wall, 4),
        "overlap_factor": round(total_self / wall, 3) if wall else 0.0,
        "stages": dict(sorted(out.items(),
                              key=lambda kv: -kv[1]["self_s"])),
    }


def format_summary(wall_seconds: Optional[float] = None) -> str:
    """Human table for `trtpu trace` / bench output."""
    s = stage_summary(wall_seconds)
    lines = [
        f"wall={s['wall_s']:.2f}s overlap_factor={s['overlap_factor']}",
        f"{'stage':<18} {'calls':>7} {'p50_ms':>9} {'p99_ms':>9} "
        f"{'total_s':>8} {'self_s':>8} {'bytes':>12}",
    ]
    for name, d in s["stages"].items():
        lines.append(
            f"{name:<18} {d['calls']:>7} {d['p50_ms']:>9.2f} "
            f"{d['p99_ms']:>9.2f} {d['total_s']:>8.2f} "
            f"{d['self_s']:>8.2f} {d['bytes']:>12}")
    tel = TELEMETRY.snapshot()
    if tel["device_launches"] or tel["compile_events"]:
        lines.append(
            f"device: launches={tel['device_launches']} "
            f"h2d={tel['h2d_bytes']}B/{tel['h2d_transfers']}x "
            f"d2h={tel['d2h_bytes']}B/{tel['d2h_transfers']}x "
            f"kernel={tel['kernel_seconds']:.3f}s "
            f"compiles={tel['compile_events']} "
            f"({tel['compile_seconds']:.2f}s)")
    return "\n".join(lines)


_capture_lock = threading.Lock()


def _capture_window(wait: float, cancelled: threading.Event,
                    lock_timeout: float) -> Optional[dict]:
    """One capture cycle (see capture_seconds for the policy).  Holds
    the capture lock for the whole window so concurrent requests can't
    clobber each other's enable-state restore.  The lock acquire is
    BOUNDED and the cancel flag is re-checked after it: an abandoned
    helper whose caller already 503'd must exit instead of queueing
    forever and then running a full reset/enable window nobody reads
    (that both leaked one blocked thread per timed-out request and
    kept clearing the span ring long after the clients were gone)."""
    if not _capture_lock.acquire(timeout=lock_timeout):
        return None
    try:
        if cancelled.is_set():
            return None
        if _enabled:
            time.sleep(wait)
            return export_chrome_trace()
        reset()
        enable(True)
        time.sleep(wait)
        doc = export_chrome_trace()
        enable(False)
        return doc
    finally:
        _capture_lock.release()


def capture_seconds(seconds: float,
                    deadline_grace: float = 15.0) -> dict:
    """The `/debug/trace?seconds=N` implementation.

    When tracing is already on (a `trtpu trace` run, bench --trace, or
    an operator who enabled it), the ring belongs to that capture:
    sample the window WITHOUT resetting — destroying an in-progress
    capture from a debug endpoint would be hostile.  Only a
    tracing-off process gets the reset/enable/disable cycle.

    The window runs on a dedicated HELPER thread with a hard deadline:
    a long capture must never pin the calling HTTP worker past
    `seconds + grace` (earlier versions slept on the request thread
    and, behind the shared capture lock or a keep-alive connection,
    starved every other `/debug/*` endpoint — including `/debug/fleet`
    mid kill-trial).  On deadline the helper is abandoned (it finishes
    its cycle and restores the enable state on its own) and
    TimeoutError is raised for the caller to turn into a 503."""
    wait = max(0.05, min(seconds, 60.0))
    # the helper may also queue behind another capture holding the
    # lock for up to a full window — budget one extra window for that
    deadline = 2 * wait + max(1.0, deadline_grace)
    out: dict = {}
    done = threading.Event()
    cancelled = threading.Event()

    def _run() -> None:
        try:
            out["doc"] = _capture_window(wait, cancelled,
                                         lock_timeout=deadline)
        except BaseException as e:  # surfaced on the caller
            out["err"] = e
        finally:
            done.set()

    t = threading.Thread(target=_run, name="trace-capture",
                         daemon=True)
    t.start()
    if not done.wait(deadline):
        cancelled.set()
        raise TimeoutError(
            f"trace capture exceeded its deadline "
            f"({wait:.0f}s window); helper abandoned")
    if "err" in out:
        raise out["err"]
    if out.get("doc") is None:
        # the helper lost the lock race past its own deadline or was
        # cancelled between acquire and check — same operator story
        raise TimeoutError(
            "trace capture could not take the capture lock "
            "(another capture window in flight)")
    return out["doc"]


def iter_chrome_trace_chunks(doc: Optional[dict] = None,
                             chunk_bytes: int = 64 * 1024):
    """Yield the Chrome trace JSON as a sequence of ~chunk_bytes string
    chunks — the `/debug/trace` endpoint streams these with chunked
    transfer encoding instead of materializing one multi-MB `bytes`.
    Events are accumulated up to the chunk size before yielding: the
    handler's wfile is unbuffered, so one yield per event would mean
    one syscall/TCP segment per ~100-byte event."""
    if doc is None:
        doc = export_chrome_trace()
    buf: list[str] = ['{"traceEvents":[']
    size = len(buf[0])
    first = True
    for ev in doc["traceEvents"]:
        piece = ("" if first else ",") + json.dumps(ev)
        first = False
        buf.append(piece)
        size += len(piece)
        if size >= chunk_bytes:
            yield "".join(buf)
            buf, size = [], 0
    other = {k: v for k, v in doc.items() if k != "traceEvents"}
    tail = json.dumps(other)
    # splice the remaining top-level keys after the events array
    buf.append("]" + ("," + tail[1:-1] if tail != "{}" else "") + "}")
    yield "".join(buf)


# -- device telemetry --------------------------------------------------------

def _ledger():
    """The attribution plane (stats/ledger.py LEDGER): device counters
    route their increments through it under the ambient (transfer,
    tenant, part) scope, which is what makes the ledger's conservation
    invariant hold by construction.  Lazy import: ledger lazily reads
    TELEMETRY back for reconciliation."""
    from transferia_tpu_torch.stats.ledger import LEDGER

    return LEDGER


class DeviceTelemetry:
    """Always-on device-side counters (increments are per-dispatch, not
    per-row — a lock'd int add is noise next to a device launch).

    The sampling profiler cannot see any of these: device waits look
    like idle, H2D/D2H time hides inside the staging copies, and a
    kernel build inside a measured window silently poisons it.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.h2d_bytes = 0
            self.h2d_transfers = 0
            self.d2h_bytes = 0
            self.d2h_transfers = 0
            self.device_launches = 0
            self.compile_events = 0
            self.compile_seconds = 0.0
            self.kernel_seconds = 0.0
            # compressed dispatch plane (ops/dispatch.py): actual bytes
            # staged vs what the raw wire would have shipped, plus the
            # dict-pool residency economics
            self.h2d_encoded_bytes = 0
            self.h2d_raw_equiv_bytes = 0
            self.dict_pool_hits = 0
            self.dict_pool_uploads = 0
            # pool interning (columnar/batch.intern_pool): producers
            # re-creating identical pool bytes converged on one object
            self.dict_pool_share_hits = 0
            # decode-buffer pinning decisions (parquet_native
            # _finish_bytearray): bytes a kept pool VIEW pins beyond the
            # pool itself vs bytes copied out to release the buffer
            self.dict_pool_pinned_bytes = 0
            self.dict_pool_copied_bytes = 0
            # dict-native pipeline honesty pair: columns handled in
            # their code+pool encoding end-to-end vs columns some
            # consumer flattened (Column._materialize) — a dict-heavy
            # snapshot that finishes with nonzero flat materializations
            # has a leak in a code-aware fast path
            self.lazy_dict_preserved = 0
            self.dict_flat_materializations = 0
            # per-target fold baselines: several pipelines may each
            # fold the (process-global) counters into their own
            # Metrics; one shared baseline would split deltas between
            # them arbitrarily
            self._folded: "weakref.WeakKeyDictionary" = \
                weakref.WeakKeyDictionary()

    # Ledger adds happen BEFORE the telemetry increment (and the
    # ledger reads telemetry first in its reconciliation): at any poll
    # the ledger total is >= the telemetry counter for routed fields,
    # so positive drift (telemetry ahead) always means a real
    # attribution bypass, never an increment caught between the two
    # locks.

    def record_h2d(self, nbytes: int) -> None:
        _ledger().add(h2d_bytes=int(nbytes))
        with self._lock:
            self.h2d_bytes += int(nbytes)
            self.h2d_transfers += 1

    def record_d2h(self, nbytes: int) -> None:
        _ledger().add(d2h_bytes=int(nbytes))
        with self._lock:
            self.d2h_bytes += int(nbytes)
            self.d2h_transfers += 1

    def record_launch(self, n: int = 1) -> None:
        _ledger().add(launches=n)
        with self._lock:
            self.device_launches += n

    def record_dispatch(self, encoded_bytes: int,
                        raw_equiv_bytes: int) -> None:
        """One encoded H2D staging: what actually crossed the link vs
        what the uncompressed wire would have shipped."""
        _ledger().add(h2d_encoded_bytes=int(encoded_bytes),
                      h2d_raw_equiv_bytes=int(raw_equiv_bytes))
        with self._lock:
            self.h2d_encoded_bytes += int(encoded_bytes)
            self.h2d_raw_equiv_bytes += int(raw_equiv_bytes)

    def record_pool_hit(self) -> None:
        """A dict pool's hexed form was already device-memoized."""
        with self._lock:
            self.dict_pool_hits += 1

    def record_pool_upload(self) -> None:
        with self._lock:
            self.dict_pool_uploads += 1

    def record_pool_share_hit(self) -> None:
        """A re-created pool matched an interned one by content."""
        with self._lock:
            self.dict_pool_share_hits += 1

    def record_pool_buffer(self, pinned: int = 0, copied: int = 0) -> None:
        """One decode-buffer retention decision: `pinned` extra bytes a
        kept view keeps alive, or `copied` pool bytes memcpy'd out."""
        with self._lock:
            self.dict_pool_pinned_bytes += int(pinned)
            self.dict_pool_copied_bytes += int(copied)

    def record_dict_preserved(self, n: int = 1) -> None:
        """A dict column crossed a pipeline stage still code-encoded."""
        with self._lock:
            self.lazy_dict_preserved += n

    def record_dict_materialize(self) -> None:
        """A lazy dict column flattened to (data, offsets) — the event
        the dict-native reduction plane exists to eliminate."""
        with self._lock:
            self.dict_flat_materializations += 1

    def reset_dict_materializations(self) -> None:
        """Zero the flattening count alone, and every fold target's
        baseline of it (columnar/batch.py
        `reset_flat_materializations`)."""
        with self._lock:
            self.dict_flat_materializations = 0
            for prev in self._folded.values():
                prev["dict_flat_materializations"] = 0

    def record_kernel(self, seconds: float) -> None:
        _ledger().add(kernel_seconds=seconds)
        with self._lock:
            self.kernel_seconds += seconds

    def record_compile(self, seconds: float) -> None:
        _ledger().add(compiles=1, compile_seconds=seconds)
        with self._lock:
            self.compile_events += 1
            self.compile_seconds += seconds

    def snapshot(self) -> dict:
        with self._lock:
            ratio = (self.h2d_raw_equiv_bytes
                     / max(self.h2d_encoded_bytes, 1))
            return {
                "h2d_bytes": self.h2d_bytes,
                "h2d_transfers": self.h2d_transfers,
                "d2h_bytes": self.d2h_bytes,
                "d2h_transfers": self.d2h_transfers,
                "device_launches": self.device_launches,
                "compile_events": self.compile_events,
                "compile_seconds": round(self.compile_seconds, 4),
                "kernel_seconds": round(self.kernel_seconds, 4),
                "h2d_encoded_bytes": self.h2d_encoded_bytes,
                "h2d_raw_equiv_bytes": self.h2d_raw_equiv_bytes,
                "dispatch_compression_ratio": round(ratio, 2),
                "dict_pool_hits": self.dict_pool_hits,
                "dict_pool_uploads": self.dict_pool_uploads,
                "dict_pool_share_hits": self.dict_pool_share_hits,
                "dict_pool_pinned_bytes": self.dict_pool_pinned_bytes,
                "dict_pool_copied_bytes": self.dict_pool_copied_bytes,
                "lazy_dict_preserved": self.lazy_dict_preserved,
                "dict_flat_materializations":
                    self.dict_flat_materializations,
            }

    def fold_into(self, metrics) -> None:
        """Publish deltas since this target's last fold into the
        prometheus Metrics facade (stats/registry.py DeviceStats) —
        counters only inc, so folds carry the delta, making repeated
        folds safe.  The counters are process-global (the device is
        shared), so every pipeline's metrics sees full device
        activity."""
        from transferia_tpu_torch.stats.registry import DeviceStats

        ds = DeviceStats(metrics)
        with self._lock:
            # counters AND baseline read/update under ONE lock hold: a
            # snapshot taken outside it could be stale by the time the
            # baseline updates, regressing prev and re-publishing
            # already-counted deltas on the next fold
            snap = {
                "h2d_bytes": self.h2d_bytes,
                "h2d_transfers": self.h2d_transfers,
                "d2h_bytes": self.d2h_bytes,
                "d2h_transfers": self.d2h_transfers,
                "device_launches": self.device_launches,
                "compile_events": self.compile_events,
                "compile_seconds": self.compile_seconds,
                "kernel_seconds": self.kernel_seconds,
                "h2d_encoded_bytes": self.h2d_encoded_bytes,
                "h2d_raw_equiv_bytes": self.h2d_raw_equiv_bytes,
                "dict_pool_hits": self.dict_pool_hits,
                "dict_pool_uploads": self.dict_pool_uploads,
                "dict_pool_share_hits": self.dict_pool_share_hits,
                "dict_pool_pinned_bytes": self.dict_pool_pinned_bytes,
                "dict_pool_copied_bytes": self.dict_pool_copied_bytes,
                "lazy_dict_preserved": self.lazy_dict_preserved,
                "dict_flat_materializations":
                    self.dict_flat_materializations,
            }
            prev = self._folded.setdefault(metrics, {})
            for key, counter in (
                ("h2d_bytes", ds.h2d_bytes),
                ("h2d_transfers", ds.h2d_transfers),
                ("d2h_bytes", ds.d2h_bytes),
                ("d2h_transfers", ds.d2h_transfers),
                ("device_launches", ds.launches),
                ("compile_events", ds.compiles),
                ("compile_seconds", ds.compile_seconds),
                ("kernel_seconds", ds.kernel_seconds),
                ("h2d_encoded_bytes", ds.h2d_encoded_bytes),
                ("h2d_raw_equiv_bytes", ds.h2d_raw_equiv_bytes),
                ("dict_pool_hits", ds.dict_pool_hits),
                ("dict_pool_uploads", ds.dict_pool_uploads),
                ("dict_pool_share_hits", ds.dict_pool_share_hits),
                ("dict_pool_pinned_bytes", ds.dict_pool_pinned_bytes),
                ("dict_pool_copied_bytes", ds.dict_pool_copied_bytes),
                ("lazy_dict_preserved", ds.lazy_dict_preserved),
                ("dict_flat_materializations",
                 ds.dict_flat_materializations),
            ):
                delta = snap[key] - prev.get(key, 0)
                if delta > 0:
                    counter.inc(delta)
                prev[key] = snap[key]
            # ratio is a gauge (an absolute, not a delta): raw-equiv
            # over encoded across the process lifetime
            if self.h2d_encoded_bytes:
                ds.compression_ratio.set(
                    self.h2d_raw_equiv_bytes / self.h2d_encoded_bytes)


TELEMETRY = DeviceTelemetry()
