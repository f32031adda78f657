#!/usr/bin/env python3
"""Time K-B's delta scan and K11's dictionary decode of one checkout.

Imports `transferia_tpu_torch` from the checkout named by PYTHONPATH, so
two checkouts can be timed in turn on one card, in one command:

    for t in OLD . . OLD; do PYTHONPATH=$t python3 tools/decode_ab.py; done

It uses only the wrappers' public signatures (`pred_decode`,
`decode_dict_run`, `encode_pred_column`, `pack_bits_host`), which every
version of the port keeps.  Shapes: K-B over ClickBench's RegionID delta
wire (chip_smoke.py's rows: seed 42) at 65,536 values (a 32,768-row
chunk in its bucket), 131,072 and 1,048,576; K11 over 4,194,304 codes
of 17 bits into a 131,072-entry pool (bench.py's decode shape, seed 13)
and, a synthetic shape that no path launches, of 12 bits into a
4,096-entry pool.  Each time is the median of 5
runs of 20 launches held behind a sleep kernel, as chip_smoke.py's
`kernel_ms`.  Prints one JSON line; needs a card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

import transferia_tpu_torch
from transferia_tpu_torch.ops.decode import (
    MODE_DELTA,
    decode_dict_run,
    pred_decode,
)
from transferia_tpu_torch.ops.dispatch import (
    encode_pred_column,
    pack_bits_host,
)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_ab: needs a card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
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
    }
    print(json.dumps({"package": transferia_tpu_torch.__file__,
                      "card": smi, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
