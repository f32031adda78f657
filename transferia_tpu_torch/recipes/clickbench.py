"""bench.py's ClickBench-shaped dataset, generated without pyarrow.

`clickbench_rows(n)` draws the columns bench.py's `generate_dataset`
writes, in the same order from the same seed (values identical to its
Parquet file); `write_clickbench` writes them as that file is laid out
(131,072-row groups, SNAPPY) with the recipe Parquet writer, and returns
the number of rows the bench's transfer keeps (`RegionID < 400 AND
ResolutionWidth >= 390`), bench.py's completeness ground truth.
"""

from __future__ import annotations

import numpy as np

from transferia_tpu_torch.abstract.schema import TableSchema, new_table_schema
from transferia_tpu_torch.recipes.parquet_writer import write_parquet

ROW_GROUP_ROWS = 131_072  # bench.py BENCH_BATCH_ROWS


def flat_strings(strings: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unicode array -> (flat utf-8 bytes, int32 offsets)."""
    bufs = [s.encode() for s in strings.tolist()]
    offsets = np.zeros(len(bufs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in bufs], out=offsets[1:])
    return (np.frombuffer(b"".join(bufs), dtype=np.uint8).copy(),
            offsets.astype(np.int32))


def clickbench_rows(n: int) -> tuple[TableSchema, dict, dict]:
    """(schema, fixed columns, var-width (bytes, offsets) columns)."""
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
    var = {"URL": flat_strings(urls), "Title": flat_strings(titles),
           "SearchPhrase": flat_strings(phrases)}
    return schema, fixed, var


def slice_rows(rows, lo: int, hi: int) -> tuple[TableSchema, dict, dict]:
    """Rows [lo, hi) of a clickbench_rows output (var-width offsets
    rebased): one object of a dataset cut into several."""
    schema, fixed, var = rows
    out = {}
    for name, (data, offsets) in var.items():
        a, b = int(offsets[lo]), int(offsets[hi])
        out[name] = (data[a:b], (offsets[lo:hi + 1] - a).astype(np.int32))
    return schema, {k: v[lo:hi] for k, v in fixed.items()}, out


def write_clickbench(path: str, n: int, rows=None,
                     row_group_rows: int = ROW_GROUP_ROWS
                     ) -> tuple[int, int]:
    """Write n rows (or the given clickbench_rows output) as bench.py's
    file; returns (file size in bytes, rows the transfer keeps)."""
    schema, fixed, var = rows if rows is not None else clickbench_rows(n)
    size = write_parquet(path, schema, {**fixed, **var}, n,
                         row_group_rows=row_group_rows)
    kept = (fixed["RegionID"] < 400) & (fixed["ResolutionWidth"] >= 390)
    return size, int(kept.sum())
