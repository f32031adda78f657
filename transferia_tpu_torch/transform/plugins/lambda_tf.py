"""User-function transformer (reference: registry/lambda cloud-function rows
transform + registry/custom).

The port of transferia_tpu/transform/plugins/lambda_tf.py.  The user
function operates on the *columnar* view, a mapping of column name to
torch tensor, and may launch kernels of its own (the SR fan-in config's
`ops.lambdas.bench_lambda` launches K15).  Three forms:

  fn(columns: Mapping[str, tensor]) -> dict[str, tensor|array]  # replace
  fn(columns) -> bool mask                                       # filter
  fn(batch: ColumnBatch) -> ColumnBatch                          # full

Registered callables are referenced by name (`register_lambda`) or by
a ``"module:attr"`` path, resolved at first use.

Where the reference runs a user jax.jit callable on the accelerator or
on XLA's CPU backend (``jax.default_device(cpu)``), the port hands the
function its inputs in one of two places:

  - host: CPU tensors over the batch's own arrays (no copy; a read-only
    array is copied), so the function's torch ops run on the CPU;
  - device: tensors on the chain's device (handed over at plan time,
    `Transformer.bind_device`), each column staged only when the
    function reads it, through a pinned host copy and a non-blocking
    copy to the card, so the link carries only what the function uses,
    as jax.jit's arguments do.

The function's outputs, tensors or arrays, are cut to the batch's rows
before they come back to the host, and the call is timed through that
copy, so the placement's EWMA scores finished work.

The reference's two schedule-level protections are kept as they are:

  - shape bucketing (columns/mask modes): inputs pad with zeros to the
    next power-of-2 row count from BUCKET_MIN and outputs slice back, so
    a function that compiles or tunes per shape sees O(log n) shapes.
    Rows are the contract unit, so elementwise semantics hold and the
    padded tail is discarded.  Opt out with bucket: false for functions
    over the whole row axis.
  - link-aware placement (the fused step's policy): host first, one
    unscored warm-up call per strategy, the device probed only when the
    link model (ops/linkprobe.py) predicts it within PROBE_HEADROOM of
    the host, the loser re-probed every REPROBE_EVERY batches, an EWMA
    of 0.7/0.3 per strategy.  TRANSFERIA_TPU_PLACEMENT=device|host pins
    it (transform/fused.py `placement_mode`).

One difference: a dictionary-encoded column is recognised as
variable-width from its type, so it is not flattened (the reference's
``col.offsets`` test flattens it); the output is the same.
"""

from __future__ import annotations

import importlib
import logging
import threading
import time
from collections.abc import Mapping
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import Column, ColumnBatch
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device
from transferia_tpu_torch.transform.base import TransformResult, Transformer
from transferia_tpu_torch.transform.registry import register_transformer

logger = logging.getLogger(__name__)

_LAMBDAS: dict[str, Callable] = {}


def register_lambda(name: str, fn: Callable) -> None:
    """Register a named user function for lambda_transformer configs."""
    _LAMBDAS[name] = fn


def _resolve(ref: str) -> Callable:
    if ref in _LAMBDAS:
        return _LAMBDAS[ref]
    if ":" in ref:
        mod, attr = ref.split(":", 1)
        return getattr(importlib.import_module(mod), attr)
    raise KeyError(
        f"unknown lambda {ref!r}; register via register_lambda or use "
        f"'module:function' form"
    )


class _Columns(Mapping):
    """The function's view of a batch's fixed-width columns on one
    device, each made a tensor when first read: on the CPU a tensor over
    the array itself, on a card a pinned copy sent without blocking."""

    def __init__(self, arrays: dict[str, np.ndarray], device: torch.device):
        self._arrays = arrays
        self._device = device
        self._staged: dict[str, torch.Tensor] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        t = self._staged.get(name)
        if t is None:
            arr = self._arrays[name]
            t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
            if self._device.type != "cpu":
                pinned = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
                pinned.copy_(t)
                t = pinned.to(self._device, non_blocking=True)
            self._staged[name] = t
        return t

    def __iter__(self) -> Iterator[str]:
        return iter(self._arrays)

    def __len__(self) -> int:
        return len(self._arrays)


def _to_host(v: Any, n_rows: int) -> np.ndarray:
    """One output cut to the batch's rows, then brought to the host."""
    if isinstance(v, torch.Tensor):
        return v[:n_rows].cpu().numpy()
    return np.asarray(v)[:n_rows]


@register_transformer("lambda")
class LambdaTransformer(Transformer):
    """config: function: "name" | "module:attr"; mode: columns|mask|batch;
    tables: optional include list; bucket: pad to power-of-2 rows."""

    # placement probing (mirrors transform/fused.py DeviceFusedStep)
    REPROBE_EVERY = 256
    PROBE_HEADROOM = 4.0
    BUCKET_MIN = 256

    def __init__(self, function: str | Callable, mode: str = "columns",
                 tables: Optional[list[str]] = None,
                 bucket: bool = True):
        # resolution is lazy for dotted paths: transfer configs must
        # validate on machines where the user module isn't importable —
        # but the value's TYPE is still checked eagerly
        if not callable(function) and not isinstance(function, str):
            raise ValueError(
                f"lambda: function must be a callable or a "
                f"'module:attr' string, got {type(function).__name__}"
            )
        self._fn = function if callable(function) else None
        self._ref = function if isinstance(function, str) else None
        if mode not in ("columns", "mask", "batch"):
            raise ValueError(f"lambda: bad mode {mode!r}")
        self.mode = mode
        self.fn_name = function if isinstance(function, str) else \
            getattr(function, "__name__", "callable")
        self.tables = [TableID.parse(t) for t in tables] if tables else None
        self.bucket = bool(bucket)
        self.device: Optional[torch.device] = None  # bound at plan time
        self._ns_row = {"host": -1.0, "device": -1.0}
        # first call per strategy pays compiles/builds: warm, don't score
        self._warmed = {"host": False, "device": False}
        self._batch_no = 0
        self._choice_logged = False
        self._device_gated = False
        self._bucket_logged = False
        # sink workers push concurrently through the same transformer;
        # guard the placement state (an unguarded race can score a
        # warm-up call and poison the EWMA for good)
        self._state_lock = threading.Lock()

    @property
    def fn(self) -> Callable:
        if self._fn is None:
            self._fn = _resolve(self._ref)
        return self._fn

    def bind_device(self, device: DeviceLike) -> None:
        self.device = resolve_device(device)

    def _target(self) -> torch.device:
        """The device strategy's device (CUDA when no chain bound one)."""
        if self.device is None:
            self.device = resolve_device(None)
        return self.device

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        if self.tables is None:
            return True
        return any(table.include_matches(p) for p in self.tables)

    # -- placement + bucketing ------------------------------------------------
    def _predict_device_ns_row(self, n_rows: int, in_bytes: int) -> float:
        """Link-model estimate: two syncs plus moving the input columns
        over and a similar volume back (cheap next to a local card,
        ruinous through a tunneled link)."""
        from transferia_tpu_torch.ops.linkprobe import probe_link

        link = probe_link(self._target())
        s = (2 * link.launch_overhead_s
             + in_bytes / link.h2d_bytes_per_s
             + in_bytes / link.d2h_bytes_per_s
             + n_rows / 10e6)
        return s * 1e9 / max(n_rows, 1)

    def _pick_strategy(self, n_rows: int, in_bytes: int) -> str:
        from transferia_tpu_torch.transform.fused import placement_mode

        mode = placement_mode()
        if mode in ("device", "host"):
            return mode
        host_ns, dev_ns = self._ns_row["host"], self._ns_row["device"]
        if host_ns < 0:
            return "host"  # includes the unscored warm-up call
        if dev_ns < 0:
            predicted = self._predict_device_ns_row(n_rows, in_bytes)
            if predicted > host_ns * self.PROBE_HEADROOM:
                if not self._device_gated:
                    self._device_gated = True
                    logger.info(
                        "lambda %s placement: host (device gated by link "
                        "model: predicted %.0fns/row vs host %.0fns/row)",
                        self.fn_name, predicted, host_ns)
                return "host"
            return "device"
        winner = "host" if host_ns <= dev_ns else "device"
        if self._batch_no % self.REPROBE_EVERY == self.REPROBE_EVERY - 1:
            loser = "device" if winner == "host" else "host"
            if loser == "device":
                predicted = self._predict_device_ns_row(n_rows, in_bytes)
                if predicted > host_ns * self.PROBE_HEADROOM:
                    return winner
            return loser
        if not self._choice_logged:
            self._choice_logged = True
            logger.info("lambda %s placement: %s (host %.0fns/row, "
                        "device %.0fns/row)", self.fn_name, winner,
                        host_ns, dev_ns)
        return winner

    def _call_fn(self, arrays: dict[str, np.ndarray], n_rows: int):
        """Run the user fn with shape bucketing and measured placement."""
        run_arrays = arrays
        if self.bucket and n_rows > 0:
            m = self.BUCKET_MIN
            while m < n_rows:
                m <<= 1
            if m != n_rows:
                if not self._bucket_logged:
                    self._bucket_logged = True
                    logger.info(
                        "lambda %s: shape bucketing active (inputs pad "
                        "to power-of-2 rows; per-ROW fns only — a fn "
                        "computing across the row axis must set "
                        "bucket: false)", self.fn_name)
                pad = m - n_rows
                run_arrays = {
                    k: np.concatenate([v, np.zeros(pad, v.dtype)])
                    for k, v in arrays.items()
                }
        in_bytes = sum(v.nbytes for v in run_arrays.values())
        with self._state_lock:
            strategy = self._pick_strategy(n_rows, in_bytes)
            self._batch_no += 1
            # claim the warm-up slot atomically: exactly one concurrent
            # call absorbs the compile unscored
            warming = not self._warmed[strategy]
            if warming:
                self._warmed[strategy] = True
        device = (torch.device("cpu") if strategy == "host"
                  else self._target())
        t0 = time.perf_counter()
        out = self.fn(_Columns(run_arrays, device))
        # bring the rows back (waits for any device work), then score
        if isinstance(out, dict):
            out = {k: _to_host(v, n_rows) for k, v in out.items()}
        else:
            out = _to_host(out, n_rows)
        ns_row = (time.perf_counter() - t0) * 1e9 / max(n_rows, 1)
        if not warming:
            with self._state_lock:
                prev = self._ns_row[strategy]
                self._ns_row[strategy] = (ns_row if prev < 0
                                          else 0.7 * prev + 0.3 * ns_row)
        return out

    def apply(self, batch: ColumnBatch) -> TransformResult:
        if self.mode == "batch":
            return TransformResult(self.fn(batch))
        arrays = {
            name: col.data for name, col in batch.columns.items()
            if not col.ctype.is_variable_width
        }
        if self.mode == "mask":
            mask = np.asarray(
                self._call_fn(arrays, batch.n_rows)).astype(np.bool_)
            return TransformResult(batch.filter(mask))
        out = self._call_fn(arrays, batch.n_rows)
        cols = dict(batch.columns)
        for name, arr in out.items():
            arr = np.asarray(arr)
            old = cols.get(name)
            fixed = old is not None and not old.ctype.is_variable_width
            # a var-width column's buffer is uint8 (its type's np_dtype)
            same = old is not None and arr.dtype == (
                old.data.dtype if fixed else old.ctype.np_dtype)
            ctype = old.ctype if same else _infer_ctype(arr)
            cols[name] = Column(name, ctype, arr, None,
                                old.validity if fixed else None)
        schema = batch.schema.with_types({
            name: cols[name].ctype for name in out if name in cols
        })
        return TransformResult(batch.with_columns(cols, schema))

    def describe(self) -> str:
        return f"lambda({self.fn_name})"


_CTYPES = {
    "int8": CanonicalType.INT8, "int16": CanonicalType.INT16,
    "int32": CanonicalType.INT32, "int64": CanonicalType.INT64,
    "uint8": CanonicalType.UINT8, "uint16": CanonicalType.UINT16,
    "uint32": CanonicalType.UINT32, "uint64": CanonicalType.UINT64,
    "float32": CanonicalType.FLOAT, "float64": CanonicalType.DOUBLE,
    "bool": CanonicalType.BOOLEAN,
}


def _infer_ctype(arr: np.ndarray) -> CanonicalType:
    key = str(arr.dtype)
    if key not in _CTYPES:
        raise ValueError(f"lambda produced unsupported dtype {arr.dtype}")
    return _CTYPES[key]
