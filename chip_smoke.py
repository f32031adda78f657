#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (transferia_tpu_torch) on one CUDA card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (one JSON line each, then the kernels line, the card line and the
final line):
  1. build: compile every CUDA kernel from the checkout's sources;
  2. kernels: each kernel against its plain PyTorch version on the card
     (and against hashlib / the host evaluator), exact equality;
  3. main_path: 2,000,000 ClickBench-shaped rows (made as bench.py makes
     them, seed 42) through build_chain(...).apply in 131072-row batches
     with device placement and the default chunking; the output must be
     byte-identical to the host strategy on the same batches, and every
     kernel must have been launched;
  4. timing: each kernel at the main path's chunk shapes, beside its
     plain version, a PyTorch library call where one exists, and its
     bound on an H100 (3.35 TB/s HBM, 67 T 32-bit ops/s).
Any failure raises and exits non-zero.  Without CUDA it exits 2 and
prints no result.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.columnar.batch import Column, ColumnBatch
from transferia_tpu_torch.ops import _build
from transferia_tpu_torch.ops.decode import (
    MODE_BITS,
    MODE_DELTA,
    MODE_FOR,
    pack_mask_words,
    pred_decode,
    pred_decode_plain,
    unpack_plain,
)
from transferia_tpu_torch.ops.dispatch import (
    encode_pred_column,
    pack_bits_host,
)
from transferia_tpu_torch.ops.fused import _chunk_rows, pow2_blocks
from transferia_tpu_torch.ops.linkprobe import probe_link
from transferia_tpu_torch.ops.sha256 import (
    OPS_PER_COMPRESSION,
    _hmac_key_states,
    _words_to_bytes,
    prepare_padded_blocks,
    sha256_hmac,
    sha256_hmac_plain,
    sha256_padded,
)
from transferia_tpu_torch.predicate import compile_mask, parse
from transferia_tpu_torch.predicate.device import (
    compile_mask_program,
    device_compatible,
    eval3_torch,
    pred3vl_mask,
)
from transferia_tpu_torch.runtime.device import resolve_device
from transferia_tpu_torch.transform import build_chain
from transferia_tpu_torch.transform.fused import (
    DeviceFusedStep,
    set_placement,
)

ROWS = 2_000_000          # bench.py BENCH_ROWS default
BATCH_ROWS = 131_072      # bench.py BENCH_BATCH_ROWS default
CONFIG = {"transformers": [   # bench.py make_transfer
    {"mask_field": {"columns": ["URL"], "salt": "bench-salt"}},
    {"filter_rows": {"filter": "RegionID < 400 AND ResolutionWidth >= 390"}},
]}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT32_OPS_PER_S = 67e12     # H100 SXM non-tensor 32-bit peak

KERNEL_META = {
    "sha256_hmac": ("transferia_tpu_torch/csrc/sha256_hmac.cu",
                    "transferia_tpu/ops/sha256.py:257"),
    "pred_decode": ("transferia_tpu_torch/csrc/pred_decode.cu",
                    "transferia_tpu/ops/decode.py:142"),
    "pred3vl_mask": ("transferia_tpu_torch/csrc/pred3vl_mask.cu",
                     "transferia_tpu/predicate/device.py:131"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def require_equal(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    err = max_abs_diff(a, b)
    if err != 0:
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version (max abs err {err})")
    return err


# -- phase 2: kernels against their plain versions ---------------------------

def check_sha256_hmac(dev: torch.device) -> int:
    rng = np.random.default_rng(3)
    lens = [0, 1, 8, 55, 56, 63, 64, 100, 119, 120, 150, 183, 200, 247]
    lens += list(rng.integers(0, 248, 200))
    msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]
    data = np.frombuffer(b"".join(msgs), dtype=np.uint8)
    offsets = np.zeros(len(msgs) + 1, dtype=np.int32)
    offsets[1:] = np.cumsum([len(m) for m in msgs])
    err = 0
    # SHA mode against hashlib
    blocks, nb, mb = prepare_padded_blocks(data, offsets)
    got = sha256_padded(torch.from_numpy(blocks).to(dev),
                        torch.from_numpy(nb).to(dev), mb)
    want = [hashlib.sha256(m).digest() for m in msgs]
    if [bytes(r) for r in _words_to_bytes(
            got.cpu().numpy().view(np.uint32))] != want:
        raise AssertionError("sha256_hmac (SHA mode) differs from hashlib")
    # HMAC mode: short, 64-byte and >64-byte keys; pad rows (n_blocks 0)
    for key in (b"k", bytes(range(64)), b"long-key" * 13):
        inner, outer = _hmac_key_states(key, dev)
        blocks, nb, mb = prepare_padded_blocks(data, offsets, prefix_len=64,
                                               max_blocks=4)
        blocks = np.pad(blocks, ((0, 24), (0, 0)))
        nb = np.pad(nb, (0, 24))
        b_t = torch.from_numpy(blocks).to(dev)
        nb_t = torch.from_numpy(nb).to(dev)
        got = sha256_hmac(b_t, nb_t, inner, outer, 4)
        err = max(err, require_equal(
            got, sha256_hmac_plain(b_t, nb_t, inner, outer, 4),
            "sha256_hmac"))
        hexes = [bytes(r).hex() for r in _words_to_bytes(
            got.cpu().numpy().view(np.uint32))[:len(msgs)]]
        want = [hmac.new(key, m, hashlib.sha256).hexdigest() for m in msgs]
        if hexes != want:
            raise AssertionError("sha256_hmac differs from hashlib HMAC")
    return err


def check_pred_decode(dev: torch.device) -> int:
    rng = np.random.default_rng(4)
    err = 0

    def both(mode, words, n, bw, base=0, mins=None, frame=0, what=""):
        w = torch.from_numpy(words.view(np.int32).copy()).to(dev)
        m = torch.from_numpy(mins).to(dev) if mins is not None else None
        got = pred_decode(mode, w, n, bw, base, m, frame)
        return require_equal(
            got, pred_decode_plain(mode, w, n, bw, base, m, frame), what)

    for n in (32768, 1000):
        bits = rng.integers(0, 2, n).astype(np.uint64)
        err = max(err, both(MODE_BITS, pack_bits_host(bits, 1), n, 1,
                            what="bits"))
        for bw in range(1, 33):
            vals = rng.integers(0, 2**bw, n, dtype=np.uint64)
            words = pack_bits_host(vals, bw)
            base = int(rng.integers(-2**31, 2**31))
            err = max(err, both(MODE_DELTA, words, n, bw, base=base,
                                what=f"delta bw={bw}"))
            if n % 256 == 0:
                mins = rng.integers(-2**31, 2**31, n // 256).astype(np.int32)
                err = max(err, both(MODE_FOR, words, n, bw, mins=mins,
                                    frame=256, what=f"for bw={bw}"))
    # the encoder's own wire: 30-bit delta cap, a multi-tile scan over
    # the largest bucket, and a 32-bit FOR span that wraps int32
    n = 1 << 20
    # alternating steps of just under 2^29: zigzag codes need 30 bits
    walk = ((np.arange(n) % 2) * (2**29 - 2001)
            + rng.integers(0, 1000, n)).astype(np.int32)
    spec, arrs = encode_pred_column("x", walk, None, n, n, True)
    if spec.kind != "delta" or spec.bit_width != 30:
        raise AssertionError(f"expected a 30-bit delta wire, got {spec}")
    w = torch.from_numpy(arrs[0].view(np.int32).copy()).to(dev)
    got = pred_decode(MODE_DELTA, w, n, 30, int(arrs[1]))
    err = max(err, require_equal(got, torch.from_numpy(walk).to(dev),
                                 "delta 30-bit cap vs source values"))
    span = np.tile(np.array([-2**31, 2**31 - 1], dtype=np.int64), 128)
    rel = (span - span.min()).astype(np.uint64)
    w = torch.from_numpy(pack_bits_host(rel, 32).view(np.int32).copy()).to(dev)
    mins = torch.tensor([-2**31], dtype=torch.int32, device=dev)
    got = pred_decode(MODE_FOR, w, 256, 32, mins=mins, frame=256)
    err = max(err, require_equal(got, torch.from_numpy(
        span.astype(np.int32)).to(dev), "for 32-bit span"))
    return err


PRED_CASES = [
    "b = true", "b != false", "i8 < -3", "u8 >= 200", "i16 BETWEEN -50 AND 50",
    "u16 > 30000", "i32 <= 12345", "f = 1.5", "f != 1.5", "f < 0",
    "f > 0.5 OR f IS NULL", "f IN (1.5, 2.5, NULL)", "f NOT IN (1.5)",
    "i16 IN (1, 2, 3)", "i16 NOT IN (1, NULL)", "i32 IS NULL",
    "i32 IS NOT NULL", "NOT i32 IS NULL", "i8 = NULL", "NOT i8 > 0",
    "NOT (i8 > 0 AND u8 < 100)", "NOT (i8 > 0 OR f < 0.5)",
    "(b = true OR i16 > 0) AND NOT (u16 < 100 OR i32 >= 0)",
    "i16 > 2.5", "u8 <= 100.5", "",
]
PRED_SCHEMA = new_table_schema([
    ("b", "boolean"), ("i8", "int8"), ("u8", "uint8"), ("i16", "int16"),
    ("u16", "uint16"), ("i32", "int32"), ("f", "float"),
])


def pred_columns(n: int, seed: int) -> dict[str, tuple[np.ndarray,
                                                      np.ndarray]]:
    rng = np.random.default_rng(seed)
    f = rng.choice(np.array([0.0, 0.5, 1.5, 2.5, -1.0, np.nan],
                            dtype=np.float32), n)
    data = {
        "b": rng.integers(0, 2, n).astype(np.bool_),
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "u8": rng.integers(0, 256, n).astype(np.uint8),
        "i16": rng.integers(-100, 100, n).astype(np.int16),
        "u16": rng.integers(0, 65536, n).astype(np.uint16),
        "i32": rng.integers(-2**31, 2**31, n).astype(np.int32),
        "f": f,
    }
    return {k: (v, rng.random(n) > 0.2) for k, v in data.items()}


def check_pred3vl_mask(dev: torch.device) -> int:
    err = 0
    for n in (32768, 999):
        cols_np = pred_columns(n, seed=n)
        batch = ColumnBatch(TableID("", "t"), PRED_SCHEMA, {
            k: Column(k, PRED_SCHEMA.find(k).data_type, d, None, v)
            for k, (d, v) in cols_np.items()})
        for text in PRED_CASES:
            node = parse(text)
            if not device_compatible(node, PRED_SCHEMA):
                raise AssertionError(f"{text!r} is not device-eligible")
            program = compile_mask_program(node)
            cols = [(torch.from_numpy(cols_np[c][0]).to(dev),
                     torch.from_numpy(cols_np[c][1]).to(dev))
                    for c in program.columns]
            got = pred3vl_mask(program, cols, n, False, dev)
            want = eval3_torch(node, dict(zip(program.columns, cols)), n,
                               dev)
            err = max(err, require_equal(got, want, f"pred3vl {text!r}"))
            host = compile_mask(node)(batch)
            if not np.array_equal(got.cpu().numpy(), host):
                raise AssertionError(f"pred3vl {text!r} differs from the "
                                     "host evaluator")
            if n % 32 == 0:
                packed = pred3vl_mask(program, cols, n, True, dev)
                err = max(err, require_equal(
                    packed, pack_mask_words(want, n), f"packed {text!r}"))
    return err


# -- phase 3: the main path ---------------------------------------------------

def _flat(strings: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unicode array -> (flat utf-8 bytes, int32 offsets)."""
    bufs = [s.encode() for s in strings.tolist()]
    offsets = np.zeros(len(bufs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in bufs], out=offsets[1:])
    return (np.frombuffer(b"".join(bufs), dtype=np.uint8),
            offsets.astype(np.int32))


def clickbench_rows(n: int):
    """The columns bench.py generate_dataset writes, drawn in the same
    order from the same seed (values identical to its parquet)."""
    rng = np.random.default_rng(42)
    watch_id = rng.integers(0, 2**62, n, dtype=np.int64)
    user_id = rng.integers(0, 10_000_000, n, dtype=np.int64)
    counter_id = rng.integers(0, 5000, n).astype(np.int32)
    region_id = rng.integers(0, 500, n).astype(np.int32)
    event_time = (1_700_000_000 + rng.integers(0, 86_400 * 30, n)).astype(
        np.int64)
    res_w = rng.choice(
        np.array([1280, 1366, 1536, 1920, 2560, 360, 390], dtype=np.int32), n)
    is_mobile = (rng.random(n) < 0.4).astype(np.int8)
    host_ids = rng.integers(0, 997, n)
    path_ids = rng.integers(0, 10_000_019, n)
    urls = np.char.add(
        np.char.add("https://example-", host_ids.astype("U4")),
        np.char.add(".com/page/", path_ids.astype("U9")),
    )
    titles = np.char.add("Title ", rng.integers(0, 99_991, n).astype("U6"))
    phrase_pool = np.array(["", "", "", "buy tpu", "fast etl",
                            "weather tomorrow", "наушники"], dtype=object)
    phrases = phrase_pool[rng.integers(0, len(phrase_pool), n)]
    schema = new_table_schema([
        ("WatchID", "int64"), ("UserID", "int64"), ("CounterID", "int32"),
        ("RegionID", "int32"), ("EventTime", "datetime"),
        ("ResolutionWidth", "int32"), ("IsMobile", "int8"),
        ("URL", "utf8"), ("Title", "utf8"), ("SearchPhrase", "utf8"),
    ])
    fixed = {"WatchID": watch_id, "UserID": user_id,
             "CounterID": counter_id, "RegionID": region_id,
             "EventTime": event_time, "ResolutionWidth": res_w,
             "IsMobile": is_mobile}
    var = {"URL": _flat(urls), "Title": _flat(titles),
           "SearchPhrase": _flat(phrases)}
    return schema, fixed, var


def clickbench_batches(schema, fixed, var, n: int) -> list[ColumnBatch]:
    tid = TableID("", "hits")
    out = []
    for lo in range(0, n, BATCH_ROWS):
        hi = min(lo + BATCH_ROWS, n)
        cols = {}
        for cs in schema:
            if cs.name in fixed:
                cols[cs.name] = Column(cs.name, cs.data_type,
                                       fixed[cs.name][lo:hi])
            else:
                data, off = var[cs.name]
                cols[cs.name] = Column(
                    cs.name, cs.data_type, data[off[lo]:off[hi]],
                    off[lo:hi + 1] - off[lo])
        out.append(ColumnBatch(tid, schema, cols))
    return out


def run_chain(batches, placement: str, dev) -> tuple[list, float, object]:
    set_placement(placement)
    try:
        chain = build_chain(CONFIG, device=dev)
        step = chain.plan_for(batches[0].table_id, batches[0].schema).steps
        t0 = time.perf_counter()
        outs = [chain.apply(b) for b in batches]
        torch.cuda.synchronize(dev)
        return outs, time.perf_counter() - t0, step
    finally:
        set_placement(None)


def batches_identical(a: ColumnBatch, b: ColumnBatch) -> bool:
    if a.schema != b.schema or a.n_rows != b.n_rows:
        return False
    for name in a.schema.names():
        x, y = a.column(name), b.column(name)
        if not np.array_equal(x.data, y.data):
            return False
        if (x.offsets is None) != (y.offsets is None) or (
                x.offsets is not None
                and not np.array_equal(x.offsets, y.offsets)):
            return False
        if (x.validity is None) != (y.validity is None) or (
                x.validity is not None
                and not np.array_equal(x.validity, y.validity)):
            return False
    return True


# -- phase 4: timing ------------------------------------------------------------

def kernel_ms(fn, dev, iters: int = 20, reps: int = 5) -> float:
    """Median device time of one call: a sleep kernel holds the stream
    while the host enqueues `iters` calls, so the events bracket device
    work only."""
    fn()
    torch.cuda.synchronize(dev)
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def wall_ms(fn, dev, reps: int = 3) -> float:
    """Median event-timed wall of one call (plain versions: thousands of
    small launches, bound by the host's enqueue)."""
    fn()
    torch.cuda.synchronize(dev)
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_kernels(batch: ColumnBatch, chunk: int, dev) -> dict:
    """Each kernel at the shapes the main path gives it: the first chunk
    of a ClickBench batch."""
    rows = batch.slice(0, chunk)
    url = rows.column("URL")
    mb = pow2_blocks(int(np.diff(url.offsets).max()))
    blocks, nb, _ = prepare_padded_blocks(url.data, url.offsets,
                                          prefix_len=64, max_blocks=mb)
    b_t = torch.from_numpy(blocks).to(dev)
    nb_t = torch.from_numpy(nb).to(dev)
    inner, outer = _hmac_key_states(b"bench-salt", dev)
    n_comp = int(np.minimum(nb, mb).sum()) + chunk
    # name -> (kernel call, plain call, library call or None, bound)
    calls = {"sha256_hmac": (
        lambda: sha256_hmac(b_t, nb_t, inner, outer, mb),
        lambda: sha256_hmac_plain(b_t, nb_t, inner, outer, mb),
        None,
        bound(b_t.numel() + 4 * chunk + 64 + 32 * chunk,
              OPS_PER_COMPRESSION * n_comp))}

    region = rows.column("RegionID").data
    spec, arrs = encode_pred_column("RegionID", region, None, chunk,
                                       chunk, True)
    if spec.kind != "delta":
        raise AssertionError(f"RegionID shipped as {spec}, not delta")
    w = torch.from_numpy(arrs[0].view(np.int32).copy()).to(dev)
    base, bw = int(arrs[1]), spec.bit_width
    zz = unpack_plain(w, bw, chunk)
    deltas = ((zz >> 1) ^ -(zz & 1)).to(torch.int32)
    calls["pred_decode"] = (
        lambda: pred_decode(MODE_DELTA, w, chunk, bw, base),
        lambda: pred_decode_plain(MODE_DELTA, w, chunk, bw, base),
        lambda: torch.cumsum(deltas, 0, dtype=torch.int32),
        # ~10 ops per value: unpack, zigzag, scan add
        bound(w.numel() * 4 + 4 * chunk, 10 * chunk))

    program = compile_mask_program(
        parse("RegionID < 400 AND ResolutionWidth >= 390"))
    cols = [(torch.from_numpy(rows.column(c).data.copy()).to(dev), None)
            for c in program.columns]
    calls["pred3vl_mask"] = (
        lambda: pred3vl_mask(program, cols, chunk, True, dev),
        lambda: pack_mask_words(eval3_torch(
            program.node, dict(zip(program.columns, cols)), chunk, dev),
            chunk),
        None,
        # ~4 ops per instruction per row
        bound(sum(d.numel() * d.element_size() for d, _ in cols)
              + chunk // 8, 4 * len(program.instrs) * chunk))

    out = {}
    for name, (kernel, plain, library, (bound_ms, bound_by)) in calls.items():
        out[name] = dict(
            max_abs_err=require_equal(kernel(), plain(), f"{name} at the "
                                      "main path's shapes"),
            ms=kernel_ms(kernel, dev), plain_ms=wall_ms(plain, dev),
            library_ms=kernel_ms(library, dev) if library else None,
            bound_ms=bound_ms, bound_by=bound_by)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a card",
              file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(dev)} ({smi})"

    t0 = time.perf_counter()
    builds = _build.build_all()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "card": smi, "libraries": {
              name: {"seconds": round(b.seconds, 3),
                     "ptxas": [ln.strip() for ln in b.log.splitlines()
                               if "registers" in ln or "spill" in ln]}
              for name, b in builds.items()}})

    errs = {"sha256_hmac": check_sha256_hmac(dev),
            "pred_decode": check_pred_decode(dev),
            "pred3vl_mask": check_pred3vl_mask(dev)}
    torch.cuda.synchronize(dev)
    emit({"phase": "kernels", "check": "exact", "max_abs_err": errs})

    t0 = time.perf_counter()
    schema, fixed, var = clickbench_rows(ROWS)
    batches = clickbench_batches(schema, fixed, var, ROWS)
    gen_s = time.perf_counter() - t0
    link = probe_link(dev)
    chunk = _chunk_rows(dev)
    _build.reset_launch_counts()
    dev_outs, dev_s, steps = run_chain(batches, "device", dev)
    launches = _build.launch_counts()
    if len(steps) != 1 or not isinstance(steps[0], DeviceFusedStep):
        raise AssertionError(f"main path planned {steps}, not one "
                             "DeviceFusedStep")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    host_outs, host_s, _ = run_chain(batches, "host", dev)
    kept = sum(b.n_rows for b in dev_outs)
    want = int(((fixed["RegionID"] < 400)
                & (fixed["ResolutionWidth"] >= 390)).sum())
    if kept != want:
        raise AssertionError(f"kept {kept} rows, expected {want}")
    for i, (a, b) in enumerate(zip(dev_outs, host_outs)):
        if not batches_identical(a, b):
            raise AssertionError(f"batch {i}: device output differs from "
                                 "the host strategy")
    emit({"phase": "main_path", "card": card, "rows": ROWS,
          "batch_rows": BATCH_ROWS, "chunk_rows": chunk,
          "kept": kept, "launches": launches,
          "device_seconds": dev_s, "device_rows_per_s": ROWS / dev_s,
          "host_seconds": host_s, "host_rows_per_s": ROWS / host_s,
          "data_gen_seconds": gen_s, "link": link.describe(),
          "identical_to_host": True})

    timing = time_kernels(batches[0], chunk or 32768, dev)
    kernels = []
    for name, t in timing.items():
        source, replaces = KERNEL_META[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            **t, "max_abs_err": max(errs[name], t["max_abs_err"]),
            "check": "exact",
        })
    emit({"phase": "timing", "card": card, "shape_rows": chunk or 32768})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
