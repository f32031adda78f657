#!/usr/bin/env python3
"""Time the redesigned kernels of one checkout, so that two checkouts can
be compared on one card in one command.

Imports `transferia_tpu_torch` (and the same checkout's `chip_smoke`, for
its data) from the checkout named by PYTHONPATH:

    for t in OLD . . OLD; do PYTHONPATH=$t python3 tools/kernel_ab.py; done

It uses only the wrappers' public signatures, which every version of the
port keeps.  Shapes:
- K-B's delta scan over ClickBench's RegionID delta wire (seed 42) at
  65,536 values (a 32,768-row chunk in its bucket), 131,072 and
  1,048,576; K11 over 4,194,304 codes of 17 bits into a 131,072-entry
  pool (bench.py's decode shape, seed 13) and, a synthetic shape that no
  path launches, of 12 bits into a 4,096-entry pool;
- K10 in reduce mode into one accumulator, launch after launch with no
  fill between (as the fingerprint adds batch after batch), over a
  131,072-row ClickBench batch (fingerprint_flat's batch size, 7 fixed
  and 3 string columns; and each kind of column alone) and
  fingerprint_dict's first batch (262,144
  rows: an int64 and three dictionary columns); var_accumulators over
  that batch's 4,096-value URL pool; and, a synthetic shape that no path
  launches, K10 and var_accumulators over 131,072 strings of 65 to 300
  bytes (seed 29), longer than any path's;
- the shard histogram in fused mode over 65,536 rows (one shard of
  main_path_mesh's batch), masks packed, 16 bins (the programs' default)
  and 4, and in step mode over 262,144 rows (one shard of mesh_step),
  float64 scores, 16 bins;
- K-C at the main path's bucket: a 32,768-row ClickBench chunk (seed 42)
  of RegionID and ResolutionWidth padded to 65,536 rows, the keep mask
  packed, with the main path's predicate and with a 70-literal OR of
  equalities on RegionID (null where the checkout refuses to lower it);
- the digest gather at dispatch_mesh's shape: one shard's 65,536 codes
  of bench.py's dispatch batch into a 4,097-row digest table.
Each time is the median of 5 runs of 20 launches held behind a sleep
kernel, as chip_smoke.py's `kernel_ms`.  Prints one JSON line; needs a
card.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
import transferia_tpu_torch
from transferia_tpu_torch.abstract.schema import new_table_schema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.ops import rowhash
from transferia_tpu_torch.ops.decode import (
    MODE_DELTA,
    decode_dict_run,
    pred_decode,
)
from transferia_tpu_torch.ops.dispatch import (
    encode_pred_column,
    pack_bits_host,
)
from transferia_tpu_torch.parallel.fusedmesh import digest_gather
from transferia_tpu_torch.parallel.mesh import (
    shard_hist_fused,
    shard_hist_step,
)
from transferia_tpu_torch.predicate import parse
from transferia_tpu_torch.predicate.device import (
    compile_mask_program,
    pred3vl_mask,
)

K_C_MAIN = "RegionID < 400 AND ResolutionWidth >= 390"
K_C_OR70 = " OR ".join(f"RegionID = {i}" for i in range(70))


def kernel_ms(fn, dev, iters: int = 20, reps: int = 5) -> float:
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


def region_ids(n: int) -> np.ndarray:
    """chip_smoke.clickbench_rows's RegionID: its fourth draw of seed 42."""
    rng = np.random.default_rng(42)
    rng.integers(0, 2**62, n, dtype=np.int64)
    rng.integers(0, 10_000_000, n, dtype=np.int64)
    rng.integers(0, 5000, n)
    return rng.integers(0, 500, n).astype(np.int32)


def delta_ms(region: np.ndarray, rows: int, bucket: int, dev) -> float:
    spec, arrs = encode_pred_column("RegionID", region[:rows], None, rows,
                                    bucket, True)
    w = torch.from_numpy(arrs[0].view(np.int32).copy()).to(dev)
    base, bw = int(arrs[1]), spec.bit_width
    return kernel_ms(lambda: pred_decode(MODE_DELTA, w, bucket, bw, base),
                     dev)


def dict_ms(k: int, bw: int, seed: int, dev) -> float:
    rng = np.random.default_rng(seed)
    n = 1 << 22
    pool = torch.from_numpy(
        rng.integers(-10**9, 10**9, k).astype(np.int32)).to(dev)
    codes = rng.integers(0, k, n, dtype=np.uint64)
    words = torch.from_numpy(
        pack_bits_host(codes, bw).view(np.int32).copy()).to(dev)
    return kernel_ms(lambda: decode_dict_run(words, pool, bw, n), dev)


def on_card(batch, dev):
    """A batch's canonical columns, every buffer on the card."""
    cols, n = rowhash.prep_batch(batch, dev)
    fields = ("bits", "data", "offsets", "codes", "acc1", "acc2", "validity")
    return [dataclasses.replace(c, **{
        f: getattr(c, f).to(dev) for f in fields
        if getattr(c, f) is not None}) for c in cols], n


def lanes_ms(batch, dev) -> float:
    cols, n = on_card(batch, dev)
    acc = torch.zeros(4, dtype=torch.int32, device=dev)
    return kernel_ms(lambda: rowhash.rowhash_lanes(cols, n, acc), dev)


def columns_of(batch, specs) -> ColumnBatch:
    """The batch's columns named by `specs` (ColSchemas) alone."""
    return ColumnBatch(batch.table_id, new_table_schema(
        [(cs.name, cs.data_type) for cs in specs]),
        {cs.name: batch.column(cs.name) for cs in specs})


def k10_ms(dev) -> dict:
    schema, fixed, var = chip_smoke.clickbench_rows(chip_smoke.BATCH_ROWS)
    flat = chip_smoke.clickbench_batches(schema, fixed, var,
                                         chip_smoke.BATCH_ROWS)[0]
    # the batch's 7 fixed and 3 string columns on their own
    parts = {"fixed": columns_of(flat, [cs for cs in schema
                                        if cs.name in fixed]),
             "var": columns_of(flat, [cs for cs in schema
                                      if cs.name not in fixed])}
    encoded = chip_smoke.dict_batches(flat=False)[0]
    pool = encoded.column("URL").dict_enc.pool
    data = torch.from_numpy(pool.values_data).to(dev)
    offsets = torch.from_numpy(pool.values_offsets).to(dev)
    rng = np.random.default_rng(29)
    lens = rng.integers(65, 301, chip_smoke.BATCH_ROWS)
    long_offsets = chip_smoke._offsets_from_lengths(lens)
    long_data = rng.integers(0, 256, int(lens.sum()), dtype=np.uint8)
    schema_long = new_table_schema([("s", "utf8")])
    long = ColumnBatch(chip_smoke.TableID("", "long"), schema_long, {
        "s": chip_smoke.Column("s", schema_long.find("s").data_type,
                               long_data, long_offsets, None)})
    ld = torch.from_numpy(long_data).to(dev)
    lo = torch.from_numpy(long_offsets).to(dev)
    return {
        "rowhash_flat_131072": lanes_ms(flat, dev),
        "rowhash_dict_262144": lanes_ms(encoded, dev),
        "rowhash_flat_fixed_131072": lanes_ms(parts["fixed"], dev),
        "rowhash_flat_var_131072": lanes_ms(parts["var"], dev),
        "var_accumulators_4096": kernel_ms(
            lambda: rowhash.var_accumulators(data, offsets), dev),
        "rowhash_long_var_131072": lanes_ms(long, dev),
        "var_accumulators_long_131072": kernel_ms(
            lambda: rowhash.var_accumulators(ld, lo), dev),
    }


def hist_ms(dev) -> dict:
    rng = np.random.default_rng(17)
    n = 65_536
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (n, 8)).astype(
        np.int32)).to(dev)
    pred = rng.random(n) < 0.8 * 6 / 7  # main_path's keep ratio
    keep_w, valid_w = (chip_smoke.mask_layout(b, "packed", dev)
                       for b in (pred, np.ones(n, dtype=bool)))
    step_n = chip_smoke.STEP_ROWS_PER_DEVICE
    dig = torch.from_numpy(rng.integers(-2**31, 2**31, (1, step_n, 8))
                           .astype(np.int32)).to(dev)
    ages = torch.from_numpy(rng.integers(0, 99, step_n).astype(
        np.int32)).to(dev)
    scores = torch.from_numpy(rng.uniform(0, 100, step_n)).to(dev)
    return {
        "shard_hist_fused_65536_16": kernel_ms(
            lambda: shard_hist_fused(words, 16, valid_w, keep_w), dev),
        "shard_hist_fused_65536_4": kernel_ms(
            lambda: shard_hist_fused(words, 4, valid_w, keep_w), dev),
        "shard_hist_step_262144_16": kernel_ms(
            lambda: shard_hist_step(dig, ages, scores, 16), dev),
    }


def pred_ms(dev) -> dict:
    _, fixed, _ = chip_smoke.clickbench_rows(32_768)
    cols = {c: (torch.from_numpy(np.pad(fixed[c], (0, 32_768), mode="edge"))
                .to(dev), None) for c in ("RegionID", "ResolutionWidth")}
    out = {}
    for name, text in (("pred3vl_65536", K_C_MAIN),
                       ("pred3vl_or70_65536", K_C_OR70)):
        try:
            program = compile_mask_program(parse(text))
        except ValueError:  # a checkout whose K-C refuses the program
            out[name] = None
            continue
        slots = [cols[c] for c in program.columns]
        out[name] = kernel_ms(
            lambda: pred3vl_mask(program, slots, 65_536, True, dev), dev)
    return out


def gather_ms(dev) -> dict:
    values, batch_data = chip_smoke.dispatch_data()
    codes = torch.from_numpy(batch_data[0][0][:65_536].copy()).to(dev)
    table = torch.from_numpy(np.random.default_rng(17).integers(
        -2**31, 2**31, (len(values) + 1, 8)).astype(np.int32)).to(dev)
    return {"digest_gather_65536": kernel_ms(
        lambda: digest_gather(table, codes), dev)}


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: needs a card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    region = region_ids(2_000_000)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    ms = {
        "delta_65536": delta_ms(region, 32_768, 65_536, dev),
        "delta_131072": delta_ms(region, 131_072, 131_072, dev),
        "delta_1048576": delta_ms(region, 1 << 20, 1 << 20, dev),
        "dict_131072_pool": dict_ms(1 << 17, 17, 13, dev),
        "dict_4096_pool": dict_ms(4096, 12, 19, dev),
        **k10_ms(dev),
        **hist_ms(dev),
        **pred_ms(dev),
        **gather_ms(dev),
    }
    print(json.dumps({"package": transferia_tpu_torch.__file__,
                      "card": smi, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
